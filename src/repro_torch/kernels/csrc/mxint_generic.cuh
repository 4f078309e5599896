// The generic routes of the MXInt kernels (sm_90a): every format the
// reference's kernels take that the fast routes do not.  Since the GEMM
// core runs int16 planes and act blocks that do not nest by segment
// (mxint_common.cuh, V 3-4), the generic GEMM keeps only int32 planes
// (W17-W24), act mantissas of 17-24 bits, K or w_block off 16, segment
// dots that may pass 2^31 (int64), float activations (quantize_act=False)
// and, fused, the LN blocks the core's LN stage does not take on its
// route (past 16 and not a power of two, or unaligned rows).
//
// A route, not a fallback: the wrappers pick it by format before the launch
// (kernels/mxint_matmul.py:matmul_route, mxint_ln_matmul.ln_matmul_route,
// mxint_layernorm.ln_route, mxint_softmax.softmax_route,
// mxint_gelu.gelu_route), and each computes what its plain version
// computes, bit for bit:
//
//  - ln_row_generic: the Fig. 3 LayerNorm of one row by one warp, at any
//    act block and alignment.  Lane l takes the row's act blocks l, l + 32,
//    ... and walks each element by element; every pass re-reads the row
//    (from L1/L2), so nothing is staged: the row-max exponent, the integer
//    row sum (int64: 24-bit mantissas over long rows pass 2^31), the
//    variance in warp_row_sum's order, the rsqrt LUT read by index from
//    device memory through the read-only path (any length), then the
//    scaled output and its requantization.
//  - generic_gemm: y = Q_act(x) @ (w_mant * 2^w_exp) summed by segment,
//    the intersection of an act block with a weight block, in increasing
//    K order: the segment's integer dot (int32, or int64 where it may pass
//    2^31), converted with one rounding, then acc + (float)dot *
//    (2^e_a * 2^e_w) in two rounded steps, as the GEMM core and the plain
//    version add them.  Any act block that divides K, any K, int8, int16
//    or int32 planes, act mantissas of 2-24 bits.  A CTA owns bm (at most
//    32) rows and kGenBN columns; thread (warp w, lane l) owns rows w + 8 i
//    and columns l + 32 j.  It first finds the act block exponents of its
//    rows (from x, or from the fused kernel's normalized rows in shared
//    memory), then stages kGenTK K steps at a time: the act mantissas,
//    quantized with those exponents, and the weight mantissas, as int32.
//    With float activations (quantize_act=False) it stages x and the exact
//    weights m * 2^e as float64 and adds the float64 products in K order,
//    rounded once to f32 at the end.
//
// What bounds them: the GEMM's products run on the CUDA cores (int32, or
// float64), one multiply-add a product, with a shared-memory load for
// every two; the row kernels re-read their rows.  Simple kernels that are
// right: their times sit beside their bounds in PERF.md.
#pragma once

#include "mxint_common.cuh"

namespace mx {

constexpr int kGenThreads = 256;
constexpr int kGenBN = 128;       // a CTA's columns: 4 a lane, 32 apart
constexpr int kGenTK = 32;        // K steps staged at once
constexpr int kGenMaxRows = 32;   // a CTA's rows: 4 a warp, 8 apart
constexpr int kGenRowsPerThread = kGenMaxRows / 8;
constexpr int kGenColsPerThread = kGenBN / kWarp;
constexpr int kGenMaxMantBits = 24;
constexpr int kRowWarps = 8;      // rows a CTA of the generic row kernels

// shared memory of a generic GEMM CTA of bm rows (kernels/mxint_matmul.py:
// generic_smem_bytes): the staged act and weight values (int32, or float64
// for float activations), the fused kernel's normalized rows (f32), the
// act block exponents (int8)
__host__ __device__ __forceinline__ size_t generic_smem_bytes(int bm, int K,
                                                              int ab,
                                                              int quant,
                                                              int ln_d) {
  const size_t eb = quant ? 4 : 8;
  const size_t exps = quant ? ((size_t)bm * (K / ab) + 15) / 16 * 16 : 0;
  return (size_t)kGenTK * (bm + kGenBN) * eb + (size_t)bm * ln_d * 4 + exps;
}

__host__ __forceinline__ bool generic_rows_ok(int bm) {
  return bm >= 1 && bm <= kGenMaxRows && (bm & (bm - 1)) == 0;
}

__device__ __forceinline__ float ld_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// gamma or beta at element j (bf16 or f32 by a flag; null: 0)
__device__ __forceinline__ float ld_param(const void* p, int bf16, int j) {
  if (p == nullptr) return 0.0f;
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[j])
              : __ldg(static_cast<const float*>(p) + j);
}

// 2^e exactly as float64, e in [-127, 127]
__device__ __forceinline__ double pow2d(int e) {
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// max |x| over a block of b elements
template <typename T>
__device__ __forceinline__ float block_amax_g(const T* p, int b) {
  float a = 0.0f;
  for (int i = 0; i < b; ++i) a = fmaxf(a, fabsf(ld_f32(p + i)));
  return a;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 1/sqrt(var) through a LUT in device memory (rsqrt_lut_stage's steps)
__device__ __forceinline__ float rsqrt_lut_g(float var,
                                             const float* __restrict__ lut,
                                             int n, float idx_scale) {
  var = fmaxf(var, 5.9604644775390625e-08f);              // 2^-24
  int ve;
  float vm = frexpf(var, &ve);
  vm = __fmul_rn(vm, 2.0f);
  ve -= 1;
  const bool odd = (ve & 1) != 0;
  const float u = odd ? __fmul_rn(vm, 0.5f) : vm;
  const int e_half = odd ? ((ve + 1) >> 1) : (ve >> 1);
  const int idx =
      lut_index(floorf(__fmul_rn(__fsub_rn(u, 0.5f), idx_scale)), n);
  return __fmul_rn(__ldg(lut + idx), pow2i(-e_half));
}

struct LnRowArgs {
  const void* gamma;
  const void* beta;               // null: zero
  const float* lut;               // device memory, any length
  int d, block, mant_bits, lut_n, rms_only, quantize_out, params_bf16;
  int round_bf16;                 // the fused kernel's x.dtype round trip
  float inv_d, lut_scale;
};

// The LayerNorm of one row x (T: f32 or bf16) into out (device or shared
// memory), by the whole warp (see the header)
template <typename T>
__device__ void ln_row_generic(const T* __restrict__ x, float* out,
                               const LnRowArgs& a, int lane) {
  const int B = a.block, nb = a.d / B;
  const float lim = (float)((1 << (a.mant_bits - 1)) - 1);
  int emax = -128;
  for (int b = lane; b < nb; b += kWarp)
    emax = max(emax, block_exp(block_amax_g(x + b * B, B), a.mant_bits));
  emax = warp_max_i(emax);
  // the aligned mantissa of element i of block b (exponent e)
  auto aligned = [&](int b, int e, int i) {
    const float q = quant_mant(ld_f32(x + b * B + i), pow2_e8(-e), lim);
    return (int)q >> min(emax - e, 31);
  };
  float mean = 0.0f;
  if (!a.rms_only) {
    long long isum = 0;
    for (int b = lane; b < nb; b += kWarp) {
      const int e = block_exp(block_amax_g(x + b * B, B), a.mant_bits);
      for (int i = 0; i < B; ++i) isum += aligned(b, e, i);
    }
    mean = __fmul_rn(__ll2float_rn(warp_sum_ll(isum)), a.inv_d);
  }
  float acc = 0.0f;
  for (int b = lane; b < nb; b += kWarp) {
    const int e = block_exp(block_amax_g(x + b * B, B), a.mant_bits);
    for (int i = 0; i < B; ++i) {
      const float mi = (float)aligned(b, e, i);
      const float c = a.rms_only ? mi : __fsub_rn(mi, mean);
      acc = __fadd_rn(acc, __fmul_rn(c, c));
    }
  }
  const float var = __fmul_rn(warp_sum_tree(acc), a.inv_d);
  const float inv = rsqrt_lut_g(var, a.lut, a.lut_n, a.lut_scale);
  const void* beta = a.rms_only ? nullptr : a.beta;
  auto value = [&](int b, int e, int i) {
    const float mi = (float)aligned(b, e, i);
    const float c = a.rms_only ? mi : __fsub_rn(mi, mean);
    const int j = b * B + i;
    const float t = __fmul_rn(__fmul_rn(c, inv),
                              ld_param(a.gamma, a.params_bf16, j));
    return a.rms_only ? t : __fadd_rn(t, ld_param(beta, a.params_bf16, j));
  };
  for (int b = lane; b < nb; b += kWarp) {
    const int e = block_exp(block_amax_g(x + b * B, B), a.mant_bits);
    int eo = 0;
    if (a.quantize_out) {
      float m = 0.0f;
      for (int i = 0; i < B; ++i) m = fmaxf(m, fabsf(value(b, e, i)));
      eo = block_exp(m, a.mant_bits);
    }
    for (int i = 0; i < B; ++i) {
      float y = value(b, e, i);
      if (a.quantize_out)
        y = __fmul_rn(quant_mant(y, pow2_e8(-eo), lim), pow2_e8(eo));
      if (a.round_bf16) y = __bfloat162float(__float2bfloat16_rn(y));
      out[b * B + i] = y;
    }
  }
}

template <typename W>
__device__ __forceinline__ int w_int(W w) { return (int)w; }

__device__ __forceinline__ float dot_to_f32(int d) { return __int2float_rn(d); }
__device__ __forceinline__ float dot_to_f32(long long d) {
  return __ll2float_rn(d);
}

// The generic GEMM over this CTA's rows [m0, m0 + rows) of xa (row stride
// lda: x in device memory, or the fused kernel's rows in shared memory);
// smem: the CTA's dynamic shared memory, exps: its act block exponents
// (bm x K / ab int8).  QUANT false: float activations (ACC unused).
template <typename W, typename ACC, bool QUANT>
__device__ void generic_gemm(const float* xa, int lda, int rows,
                             const W* __restrict__ wm,
                             const int8_t* __restrict__ we,
                             float* __restrict__ out, int m0, int K, int N,
                             int w_block, int ab, int mant_bits, int bm,
                             unsigned char* smem, int8_t* exps) {
  using E = typename std::conditional<QUANT, int, double>::type;
  E* sA = reinterpret_cast<E*>(smem);          // [kk][r], kGenTK x bm
  E* sW = sA + kGenTK * bm;                    // [kk][c], kGenTK x kGenBN
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n0 = blockIdx.y * kGenBN;
  const int nbA = K / ab;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  if (QUANT) {
    for (int i = tid; i < bm * nbA; i += blockDim.x) {
      const int r = i / nbA, b = i - r * nbA;
      float a = 0.0f;
      if (r < rows) {
        const float* p = xa + (size_t)r * lda + (size_t)b * ab;
        for (int j = 0; j < ab; ++j) a = fmaxf(a, fabsf(p[j]));
      }
      exps[i] = (int8_t)block_exp(a, mant_bits);
    }
    __syncthreads();
  }
  float acc[kGenRowsPerThread][kGenColsPerThread];
  ACC dot[kGenRowsPerThread][kGenColsPerThread];
  double accd[QUANT ? 1 : kGenRowsPerThread][QUANT ? 1 : kGenColsPerThread];
#pragma unroll
  for (int i = 0; i < kGenRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kGenColsPerThread; ++j) {
      acc[i][j] = 0.0f;
      dot[i][j] = 0;
      if constexpr (!QUANT) accd[i][j] = 0.0;
    }
  // the current act and weight blocks, their ends and scales
  int ai = 0, wi = 0, na = ab, nw = w_block;
  float pa[kGenRowsPerThread], pw[kGenColsPerThread];
  auto load_pa = [&]() {
#pragma unroll
    for (int i = 0; i < kGenRowsPerThread; ++i) {
      const int r = warp + 8 * i;
      pa[i] = pow2_e8(r < bm ? exps[r * nbA + ai] : 0);
    }
  };
  auto load_pw = [&]() {
#pragma unroll
    for (int j = 0; j < kGenColsPerThread; ++j) {
      const int c = n0 + lane + kWarp * j;
      pw[j] = pow2_e8(c < N ? (int)we[(size_t)wi * N + c] : 0);
    }
  };
  if (QUANT) {
    load_pa();
    load_pw();
  }
  for (int k0 = 0; k0 < K; k0 += kGenTK) {
    const int kn = min(kGenTK, K - k0);
    // act values, row by row (a row's kGenTK steps are adjacent in x)
    for (int i = tid; i < kGenTK * bm; i += blockDim.x) {
      const int r = i / kGenTK, kk = i - r * kGenTK;
      E v = 0;
      if (kk < kn && r < rows) {
        const float xv = xa[(size_t)r * lda + k0 + kk];
        if constexpr (QUANT) {
          const int e = exps[r * nbA + (k0 + kk) / ab];
          v = (int)quant_mant(xv, pow2_e8(-e), lim);
        } else {
          v = (double)xv;
        }
      }
      sA[kk * bm + r] = v;
    }
    for (int i = tid; i < kGenTK * kGenBN; i += blockDim.x) {
      const int kk = i / kGenBN, c = i - kk * kGenBN;
      E v = 0;
      if (kk < kn && n0 + c < N) {
        const size_t at = (size_t)(k0 + kk) * N + n0 + c;
        if constexpr (QUANT)
          v = w_int(wm[at]);
        else
          v = (double)w_int(wm[at]) *
              pow2d(we[(size_t)((k0 + kk) / w_block) * N + n0 + c]);
      }
      sW[i] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      E av[kGenRowsPerThread], wv[kGenColsPerThread];
#pragma unroll
      for (int i = 0; i < kGenRowsPerThread; ++i) {
        const int r = warp + 8 * i;
        av[i] = r < bm ? sA[kk * bm + r] : (E)0;
      }
#pragma unroll
      for (int j = 0; j < kGenColsPerThread; ++j)
        wv[j] = sW[kk * kGenBN + lane + kWarp * j];
      if constexpr (QUANT) {
#pragma unroll
        for (int i = 0; i < kGenRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kGenColsPerThread; ++j)
            dot[i][j] += (ACC)av[i] * (ACC)wv[j];
        const int k1 = k0 + kk + 1;
        if (k1 == na || k1 == nw) {          // a segment ends
#pragma unroll
          for (int i = 0; i < kGenRowsPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kGenColsPerThread; ++j) {
              acc[i][j] = __fadd_rn(
                  acc[i][j], __fmul_rn(dot_to_f32(dot[i][j]),
                                       __fmul_rn(pa[i], pw[j])));
              dot[i][j] = 0;
            }
          if (k1 == na && k1 < K) {
            ++ai;
            na += ab;
            load_pa();
          }
          if (k1 == nw && k1 < K) {
            ++wi;
            nw += w_block;
            load_pw();
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kGenRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kGenColsPerThread; ++j)
            accd[i][j] = __dadd_rn(accd[i][j], __dmul_rn(av[i], wv[j]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kGenRowsPerThread; ++i) {
    const int r = warp + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kGenColsPerThread; ++j) {
      const int c = n0 + lane + kWarp * j;
      if (c >= N) continue;
      float y;
      if constexpr (QUANT)
        y = acc[i][j];
      else
        y = __double2float_rn(accd[i][j]);
      out[(size_t)(m0 + r) * N + c] = y;
    }
  }
}

// y = Q_act(x) @ W (or x @ W, !QUANT) over rows of x in device memory
template <typename W, typename ACC, bool QUANT>
__global__ void __launch_bounds__(kGenThreads)
mxint_matmul_generic_kernel(const float* __restrict__ x,
                            const W* __restrict__ wm,
                            const int8_t* __restrict__ we,
                            float* __restrict__ out, int M, int K, int N,
                            int w_block, int ab, int mant_bits, int bm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * bm;
  int8_t* exps = reinterpret_cast<int8_t*>(
      smem + generic_smem_bytes(bm, K, ab, QUANT, 0) -
      (QUANT ? ((size_t)bm * (K / ab) + 15) / 16 * 16 : 0));
  generic_gemm<W, ACC, QUANT>(x + (size_t)m0 * K, K, min(bm, M - m0), wm, we,
                              out, m0, K, N, w_block, ab, mant_bits, bm, smem,
                              exps);
}

// the instance of a format: plane bytes (1, 2, 4), int64 dots, quantize_act
template <template <typename, typename, bool> class F>
__host__ const void* generic_instance(int w_bytes, int wide, int quant) {
  if (!quant) {
    if (w_bytes == 1) return F<int8_t, int, false>::fn();
    if (w_bytes == 2) return F<int16_t, int, false>::fn();
    if (w_bytes == 4) return F<int32_t, int, false>::fn();
    return nullptr;
  }
  if (wide) {
    if (w_bytes == 1) return F<int8_t, long long, true>::fn();
    if (w_bytes == 2) return F<int16_t, long long, true>::fn();
    if (w_bytes == 4) return F<int32_t, long long, true>::fn();
    return nullptr;
  }
  if (w_bytes == 1) return F<int8_t, int, true>::fn();
  if (w_bytes == 2) return F<int16_t, int, true>::fn();
  if (w_bytes == 4) return F<int32_t, int, true>::fn();
  return nullptr;
}

// the generic format checks both GEMM entries share
__host__ __forceinline__ bool generic_format_ok(int K, int w_block, int ab,
                                                int mant_bits, int quant,
                                                int bm) {
  return K >= 1 && w_block >= 1 && ab >= 1 && K % w_block == 0 &&
         K % ab == 0 && generic_rows_ok(bm) &&
         (!quant || (mant_bits >= 2 && mant_bits <= kGenMaxMantBits));
}

}  // namespace mx
