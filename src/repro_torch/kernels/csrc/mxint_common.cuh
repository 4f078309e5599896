// Shared device stages of the MXInt kernels (sm_90a).
//
// Every stage computes exactly what the plain PyTorch versions in
// repro_torch/kernels/*.py compute: powers of two are built from exponent
// bits, rounding is rintf (half to even), every multiply and add that the
// plain versions round separately is an explicit __fmul_rn / __fadd_rn
// (and the build passes -fmad=false), and row sums run in one fixed order:
// each lane adds its blocks in turn, then a butterfly over the 32 lanes.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace mx {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 16;     // act blocks held in registers
constexpr int kMaxLut = 256;      // shared-memory LUT copy
constexpr unsigned kFull = 0xffffffffu;

// exact 2^n as float32: normal from the exponent field, subnormal from the
// mantissa bits, 0 below 2^-149, inf above 2^127
__device__ __forceinline__ float pow2i(int n) {
  if (n > 127) return __int_as_float(0x7f800000);
  if (n >= -126) return __int_as_float((n + 127) << 23);
  if (n >= -149) return __int_as_float(1 << (n + 149));
  return 0.0f;
}

// shared exponent of a block: floor(log2(amax)) - (mant_bits - 2), 0 for an
// all-zero block, clipped to the int8 range
__device__ __forceinline__ int block_exp(float amax, int mant_bits) {
  if (!(amax > 0.0f)) return 0;
  float a = fmaxf(amax, 1.17549435e-38f);               // float32 tiny
  int k = ((__float_as_int(a) >> 23) & 0xff) - 127;      // floor(log2 a)
  int e = k - (mant_bits - 2);
  return min(max(e, -127), 127);
}

__device__ __forceinline__ float quant_mant(float x, float inv_scale,
                                            float lim) {
  return fminf(fmaxf(rintf(__fmul_rn(x, inv_scale)), -lim), lim);
}

__device__ __forceinline__ float block_amax(const float* p, int b) {
  float a = 0.0f;
  for (int i = 0; i < b; ++i) a = fmaxf(a, fabsf(p[i]));
  return a;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// butterfly: level 16 adds lanes (i, i+16), then 8, 4, 2, 1; every lane
// ends with the same bits (float add is commutative)
__device__ __forceinline__ float warp_sum_tree(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int lut_index(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

// 1/sqrt(var) through the LUT with the Eq. 9 even/odd exponent split
__device__ __forceinline__ float rsqrt_lut_stage(float var, const float* lut,
                                                 int n, float idx_scale) {
  var = fmaxf(var, 5.9604644775390625e-08f);              // 2^-24
  int ve;
  float vm = frexpf(var, &ve);
  vm = __fmul_rn(vm, 2.0f);
  ve -= 1;
  bool odd = (ve & 1) != 0;
  float u = odd ? __fmul_rn(vm, 0.5f) : vm;
  int e_half = odd ? ((ve + 1) >> 1) : (ve >> 1);          // floor division
  int idx = lut_index(floorf(__fmul_rn(__fsub_rn(u, 0.5f), idx_scale)), n);
  return __fmul_rn(lut[idx], pow2i(-e_half));
}

// 2^z for z <= 0 as 2^max(n, -126) * LUT_pow2(r), r = z - floor(z)
__device__ __forceinline__ float exp2_datapath(float z, const float* lut,
                                               int n_entries) {
  float n = floorf(z);
  float r = __fsub_rn(z, n);
  int idx = lut_index(floorf(__fmul_rn(r, (float)n_entries)), n_entries);
  int ni = (int)fmaxf(n, -126.0f);
  return __fmul_rn(lut[idx], pow2i(ni));
}

// quantize-dequantize a block of b values in place onto the MXInt grid
__device__ __forceinline__ void grid_requant(float (&y)[kMaxBlock], int b,
                                             int mant_bits, float lim) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i)
    if (i < b) amax = fmaxf(amax, fabsf(y[i]));
  int e = block_exp(amax, mant_bits);
  float inv = pow2i(-e), scale = pow2i(e);
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i)
    if (i < b) y[i] = __fmul_rn(quant_mant(y[i], inv, lim), scale);
}

// load a LUT into shared memory (call before __syncthreads)
__device__ __forceinline__ void load_lut(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// Fig. 3 LayerNorm of one row, one warp per row
// ---------------------------------------------------------------------------
struct LnParams {
  const float* gamma;
  const float* beta;
  const float* lut;        // shared-memory rsqrt LUT
  int d, block, mant_bits, lut_n, rms_only;
  float inv_d, lut_scale, lim;
};

struct LnRow {
  int emax;
  float mean, inv;
};

// row statistics: block-quantize, align to the row-max exponent, integer
// mean, variance in the fixed lane order, rsqrt LUT
__device__ __forceinline__ LnRow ln_row_stats(const float* x,
                                              const LnParams& p, int lane) {
  const int nb = p.d / p.block;
  int emax = -128;
  for (int b = lane; b < nb; b += kWarp)
    emax = max(emax, block_exp(block_amax(x + b * p.block, p.block),
                               p.mant_bits));
  emax = warp_max_i(emax);
  int isum = 0;
  for (int b = lane; b < nb; b += kWarp) {
    const float* xb = x + b * p.block;
    int e = block_exp(block_amax(xb, p.block), p.mant_bits);
    float inv = pow2i(-e);
    int sh = min(emax - e, 31);
    for (int i = 0; i < p.block; ++i)
      isum += ((int)quant_mant(xb[i], inv, p.lim)) >> sh;
  }
  isum = warp_sum_i(isum);
  LnRow st;
  st.emax = emax;
  st.mean = p.rms_only ? 0.0f : __fmul_rn((float)isum, p.inv_d);
  float acc = 0.0f;
  for (int b = lane; b < nb; b += kWarp) {
    const float* xb = x + b * p.block;
    int e = block_exp(block_amax(xb, p.block), p.mant_bits);
    float inv = pow2i(-e);
    int sh = min(emax - e, 31);
    for (int i = 0; i < p.block; ++i) {
      float mi = (float)(((int)quant_mant(xb[i], inv, p.lim)) >> sh);
      float c = p.rms_only ? mi : __fsub_rn(mi, st.mean);
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
  }
  acc = warp_sum_tree(acc);
  st.inv = rsqrt_lut_stage(__fmul_rn(acc, p.inv_d), p.lut, p.lut_n,
                           p.lut_scale);
  return st;
}

// the normalized values of block b of the row: (c * inv) * gamma + beta
__device__ __forceinline__ void ln_block(const float* x, int b,
                                         const LnParams& p, const LnRow& st,
                                         float (&y)[kMaxBlock]) {
  const float* xb = x + b * p.block;
  int e = block_exp(block_amax(xb, p.block), p.mant_bits);
  float inv = pow2i(-e);
  int sh = min(st.emax - e, 31);
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i) {
    if (i < p.block) {
      int j = b * p.block + i;
      float mi = (float)(((int)quant_mant(xb[i], inv, p.lim)) >> sh);
      float c = p.rms_only ? mi : __fsub_rn(mi, st.mean);
      float v = __fmul_rn(__fmul_rn(c, st.inv), p.gamma[j]);
      y[i] = p.rms_only ? v : __fadd_rn(v, p.beta[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// int8 block-scaled GEMM tile shared by mxint_matmul and mxint_ln_matmul
// ---------------------------------------------------------------------------
// A block of kThreads threads owns kBM rows.  Its prologue fills sA (int8
// act mantissas, row stride K + 16) and sE (one int8 exponent per 16-block)
// for those rows; gemm_tiles then computes its N tiles of kBN columns,
// staging kKC x kBN weight tiles transposed into sW.  Each thread owns 2
// rows x 4 columns and adds, in increasing K order,
//   (float)dot16(a, w) * 2^(e_a + e_w)
// into its f32 accumulators: the dot is exact in int32 and the scale is
// exact, so only the sum across blocks rounds, in the plain version's order.
constexpr int kThreads = 256;
constexpr int kBM = 32;
constexpr int kBN = 64;
constexpr int kKC = 64;
constexpr int kAB = 16;           // act block of the GEMM

__host__ __device__ __forceinline__ int a_stride(int K) { return K + 16; }

__host__ __forceinline__ size_t gemm_smem_bytes(int K) {
  return (size_t)kBM * a_stride(K) + (size_t)kBM * (K / kAB) +
         (size_t)kBN * (kKC + 16) + kMaxLut * sizeof(float) + 64;
}

// shared-memory carve-up: sA | sE | sW | lut (16-byte aligned pieces)
struct GemmSmem {
  int8_t* a;
  int8_t* e;
  int8_t* w;
  float* lut;
};

__device__ __forceinline__ GemmSmem carve(unsigned char* base, int K) {
  GemmSmem s;
  size_t off = 0;
  s.a = (int8_t*)(base + off);
  off += (size_t)kBM * a_stride(K);
  s.e = (int8_t*)(base + off);
  off += ((size_t)kBM * (K / kAB) + 15) & ~(size_t)15;
  s.w = (int8_t*)(base + off);
  off += (size_t)kBN * (kKC + 16);
  s.lut = (float*)(base + off);
  return s;
}

// quantize one 16-block of values into int8 mantissas + exponent
__device__ __forceinline__ void act_quant16(const float (&v)[kMaxBlock],
                                            int mant_bits, float lim,
                                            int8_t* dst_m, int8_t* dst_e) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kAB; ++i) amax = fmaxf(amax, fabsf(v[i]));
  int e = block_exp(amax, mant_bits);
  float inv = pow2i(-e);
#pragma unroll
  for (int i = 0; i < kAB; ++i) dst_m[i] = (int8_t)quant_mant(v[i], inv, lim);
  *dst_e = (int8_t)e;
}

__device__ __forceinline__ int dot16(const int8_t* a, const int8_t* w) {
  const int4 av = *reinterpret_cast<const int4*>(a);
  const int4 wv = *reinterpret_cast<const int4*>(w);
  int s = __dp4a(av.x, wv.x, 0);
  s = __dp4a(av.y, wv.y, s);
  s = __dp4a(av.z, wv.z, s);
  return __dp4a(av.w, wv.w, s);
}

// adds the block products of the K range [kbase, kbase + kc) of the kBN
// columns at n0 into acc, in increasing K order; s.a / s.e hold the
// range's quantized rows, with row strides a_ld and e_ld
__device__ __forceinline__ void gemm_tile_range(
    const GemmSmem& s, const int8_t* __restrict__ wm,
    const int8_t* __restrict__ we, float (&acc)[2][4], int kbase, int kc,
    int a_ld, int e_ld, int N, int w_block, int n0) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int nkb = kc / kAB;
  for (int k0 = 0; k0 < kc; k0 += kKC) {
    __syncthreads();
    // stage W[kbase+k0 : +kKC, n0:n0+kBN] transposed: sW[n][k]
    for (int i = tid; i < kKC * kBN; i += kThreads) {
      int kk = i / kBN, nn = i % kBN;
      int k = k0 + kk, n = n0 + nn;
      s.w[nn * (kKC + 16) + kk] =
          (k < kc && n < N) ? wm[(size_t)(kbase + k) * N + n] : (int8_t)0;
    }
    __syncthreads();
    for (int j = 0; j < kKC / kAB; ++j) {
      const int kb = k0 / kAB + j;
      if (kb >= nkb) break;
      const int kbw = (kbase + kb * kAB) / w_block;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + tx * 4 + c;
        const int ew = n < N ? (int)we[(size_t)kbw * N + n] : 0;
        const int8_t* wcol = s.w + (tx * 4 + c) * (kKC + 16) + j * kAB;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = ty * 2 + r;
          const int dot = dot16(s.a + row * a_ld + kb * kAB, wcol);
          const int ea = (int)s.e[row * e_ld + kb];
          acc[r][c] = __fadd_rn(acc[r][c],
                                __fmul_rn((float)dot, pow2i(ea + ew)));
        }
      }
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
}

__device__ __forceinline__ void store_tile(const float (&acc)[2][4],
                                           float* __restrict__ out, int m0,
                                           int M, int N, int n0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + ty * 2 + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < N) out[(size_t)row * N + n] = acc[r][c];
    }
  }
}

// the block's N tiles over the whole K, whose quantized rows s holds
__device__ void gemm_tiles(const GemmSmem& s, const int8_t* __restrict__ wm,
                           const int8_t* __restrict__ we,
                           float* __restrict__ out, int m0, int M, int K,
                           int N, int w_block, int tile0, int n_tiles) {
  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = (tile0 + t) * kBN;
    if (n0 >= N) break;
    float acc[2][4];
    zero_tile(acc);
    gemm_tile_range(s, wm, we, acc, 0, K, a_stride(K), K / kAB, N, w_block,
                    n0);
    store_tile(acc, out, m0, M, N, n0);
  }
}

// grid shape: enough blocks to cover the card twice; each block owns
// n_per consecutive N tiles of its row tile, at most max_per
__host__ __forceinline__ void gemm_grid(int M, int N, dim3* grid,
                                        int* n_per, int max_per = INT_MAX) {
  const int gx = (M + kBM - 1) / kBM;
  const int tiles = (N + kBN - 1) / kBN;
  int gy = (2 * 132 + gx - 1) / gx;
  gy = gy < tiles ? gy : tiles;
  gy = gy > 1 ? gy : 1;
  *n_per = (tiles + gy - 1) / gy;
  *n_per = *n_per < max_per ? *n_per : max_per;
  gy = (tiles + *n_per - 1) / *n_per;
  *grid = dim3(gx, gy);
}

}  // namespace mx
