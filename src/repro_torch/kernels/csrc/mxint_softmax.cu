// MXInt row softmax (paper Eq. 14-20), sm_90a, one warp per row.
// Counterpart of repro/kernels/mxint_softmax.py:mxint_softmax.
//
// Bound by memory: each row is read once and its probabilities written
// once.  softmax_geometry (kernels/mxint_softmax.py) picks one of two
// routes from the shape and alignment alone:
//  - softmax_regs_kernel: the warp loads its row into registers once
//    (lane l holds blocks l, l+32, ...: at act block 1 element l + 32 k),
//    computes each element's block exponent, aligned mantissa and 2^z once,
//    takes lambda and the mantissa max by warp max, sums in the fixed lane
//    order, divides, requantizes and stores once.  E (a template
//    parameter) bounds the elements a lane holds, so every register index
//    is static; V = 4 moves a lane's elements in float4 (act block a
//    multiple of 4, 16-byte aligned rows).
//  - softmax_long_kernel: rows longer than the registers hold, and act
//    blocks past 32 elements a lane; four passes re-read the row (L1/L2
//    resident): lambda, the max aligned mantissa, the sum of 2^z, then
//    the Eq. 20 divide and the optional act-grid quantization of the
//    output.  Blocks up to kMaxBlock keep a block's mantissas and outputs
//    in registers; longer ones (up to kMaxRowBlock) walk the block
//    element by element in every pass and compute each output twice
//    (the block's amax, then the values).
// Both add each lane's elements in order (block by block, element by
// element), then a butterfly over the 32 lanes: warp_row_sum's order.
#include "mxint_common.cuh"
#include "mxint_generic.cuh"
#include "launch_query.cuh"

using namespace mx;

constexpr int kRowThreads = 256;

// aligned mantissas of block b (at most kMaxBlock elements) and its
// exponent, in registers
__device__ __forceinline__ void aligned_block(const float* xr, int b,
                                              int block, int mant_bits,
                                              float lim, int emax,
                                              int (&mi)[kMaxBlock]) {
  const float* xb = xr + b * block;
  int e = block_exp(block_amax(xb, block), mant_bits);
  float inv = pow2i(-e);
  int sh = min(emax - e, 31);
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i)
    if (i < block) mi[i] = ((int)quant_mant(xb[i], inv, lim)) >> sh;
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

// a longer block's quantization aligned to lambda, element by element:
// element i's mantissa is (int)quant_mant(xb[i], inv, lim) >> sh
struct AlignedBlock {
  const float* xb;
  float inv, lim;
  int sh;

  __device__ __forceinline__ AlignedBlock(const float* xr, int b, int block,
                                          int mant_bits, float lim_,
                                          int emax)
      : xb(xr + b * block), lim(lim_) {
    const int e = block_exp(block_amax(xb, block), mant_bits);
    inv = pow2i(-e);
    sh = min(emax - e, 31);
  }
  __device__ __forceinline__ int operator[](int i) const {
    return ((int)quant_mant(xb[i], inv, lim)) >> sh;
  }
};

__device__ __forceinline__ float p_of(int mi, int mmax, float plam,
                                      float log2e, const float* lut, int n) {
  float t = (float)mi - (float)mmax;                    // exact integers
  float z = __fmul_rn(__fmul_rn(t, plam), log2e);
  return exp2_datapath(z, lut, n);
}

// ---------------------------------------------------------------------------
// register route
// ---------------------------------------------------------------------------
// Element e of a lane is element e % block of its (e / block)-th block;
// the lane walks its elements V at a time from e = 0 and, at each block's
// end, skips the 31 blocks of the other lanes.
__device__ __forceinline__ void lane_step(int V, int block, int& j,
                                          int& off) {
  j += V;
  off += V;
  if (j == block) {
    j = 0;
    off += (kWarp - 1) * block;
  }
}

template <int V, int E>
__device__ __forceinline__ void load_v(float (&v)[E], int e, const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
  } else {
    v[e] = *p;
  }
}

template <int V, int E>
__device__ __forceinline__ void store_v(const float (&v)[E], int e,
                                        float* p) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[e], v[e + 1], v[e + 2],
                                                v[e + 3]);
  else
    *p = v[e];
}

// m[e] = max |v| over the block of element e: a running max from each
// block's first element, then each block's last value copied back over it
// (max is exact in any order)
template <int E>
__device__ __forceinline__ void block_max_abs(const float (&v)[E],
                                              uint32_t last, float (&m)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float a = fabsf(v[e]);
    const bool first = e == 0 || ((last >> (e > 0 ? e - 1 : 0)) & 1u);
    m[e] = first ? a : fmaxf(m[e > 0 ? e - 1 : 0], a);
  }
#pragma unroll
  for (int e = E - 2; e >= 0; --e)
    if (!((last >> e) & 1u)) m[e] = m[e + 1];
}

// B1: act block 1 (the block parameter is then ignored), so every element
// carries its own exponent and the block scans fold away
template <int E, int V, bool B1>
__global__ void __launch_bounds__(kRowThreads)
softmax_regs_kernel(const float* __restrict__ x,
                    const float* __restrict__ lut_g, float* __restrict__ y,
                    int rows, int n, int block_arg, int mant_bits, int lut_n,
                    float log2e, int quantize_out) {
  __shared__ float lut[kMaxLut];
  load_lut(lut, lut_g, lut_n);
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;                       // warp-uniform
  const int block = B1 ? 1 : block_arg;
  const float* xr = x + (size_t)row * n;
  float* yr = y + (size_t)row * n;
  const int nb = n / block;
  const int cnt = (nb - lane + kWarp - 1) / kWarp * block;  // lane's elements
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  // the one read of the row; bit e of last: element e ends its block
  float v[E];
  uint32_t last = 0;
  {
    int off = lane * block, j = 0;
#pragma unroll
    for (int e = 0; e < E; e += V) {
      if (e < cnt) {
        load_v<V>(v, e, xr + off);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[e + i] = 0.0f;
      }
      if (j + V == block) last |= 1u << (e + V - 1);
      lane_step(V, block, j, off);
    }
  }
  // block exponents, then lambda
  float bm[E];
  block_max_abs(v, last, bm);
  int eb[E];
  int emax = -128;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    eb[e] = block_exp(bm[e], mant_bits);
    if (e < cnt) emax = max(emax, eb[e]);
  }
  emax = warp_max_i(emax);
  // aligned mantissas, then their max
  int mi[E];
  int mmax = INT_MIN;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < cnt) {
      const int sh = min(emax - eb[e], 31);
      mi[e] = ((int)quant_mant(v[e], pow2i(-eb[e]), lim)) >> sh;
      mmax = max(mmax, mi[e]);
    }
  }
  mmax = warp_max_i(mmax);
  // 2^z once per element, the row sum in the lane order, then the butterfly
  const float plam = pow2i(emax);
  float p[E];
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    p[e] = 0.0f;
    if (e < cnt) {
      p[e] = p_of(mi[e], mmax, plam, log2e, lut, lut_n);
      acc = __fadd_rn(acc, p[e]);
    }
  }
  acc = warp_sum_tree(acc);
  int s_e;
  const float s_m = frexpf(acc, &s_e);               // LZC + shift in HW
  const float s_scale = pow2i(-s_e);
  // Eq. 20 divide and the optional act-grid quantization (a slot past the
  // lane's elements is skipped, warp-uniformly where no lane holds it)
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (e < cnt) p[e] = __fmul_rn(__fdiv_rn(p[e], s_m), s_scale);
  if (quantize_out) {
    block_max_abs(p, last, bm);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < cnt) {
        const int eo = block_exp(bm[e], mant_bits);
        p[e] = __fmul_rn(quant_mant(p[e], pow2i(-eo), lim), pow2i(eo));
      }
    }
  }
  // the one write
  int off = lane * block, j = 0;
#pragma unroll
  for (int e = 0; e < E; e += V) {
    if (e < cnt) store_v<V>(p, e, yr + off);
    lane_step(V, block, j, off);
  }
}

// ---------------------------------------------------------------------------
// long route
// ---------------------------------------------------------------------------
// f(i, m) for each element i of block b and its aligned mantissa m: from
// registers for blocks up to kMaxBlock (kRegs), else re-read one by one
template <bool kRegs, typename F>
__device__ __forceinline__ void each_aligned(const float* xr, int b,
                                             int block, int mant_bits,
                                             float lim, int emax, F f) {
  if constexpr (kRegs) {
    int mi[kMaxBlock];
    aligned_block(xr, b, block, mant_bits, lim, emax, mi);
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block) f(i, mi[i]);
  } else {
    const AlignedBlock mi(xr, b, block, mant_bits, lim, emax);
    for (int i = 0; i < block; ++i) f(i, mi[i]);
  }
}

// kRegs: act blocks up to kMaxBlock, each block's mantissas and outputs in
// registers; else any block up to kMaxRowBlock, re-read in every pass
template <bool kRegs>
__global__ void __launch_bounds__(kRowThreads)
softmax_long_kernel(const float* __restrict__ x,
                    const float* __restrict__ lut_g, float* __restrict__ y,
                    int rows, int n, int block, int mant_bits, int lut_n,
                    float log2e, int quantize_out) {
  __shared__ float lut[kMaxLut];
  load_lut(lut, lut_g, lut_n);
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;                       // warp-uniform
  const float* xr = x + (size_t)row * n;
  float* yr = y + (size_t)row * n;
  const int nb = n / block;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  // pass 1: lambda, the row-max block exponent
  int emax = -128;
  for (int b = lane; b < nb; b += kWarp)
    emax = max(emax, block_exp(block_amax(xr + b * block, block), mant_bits));
  emax = warp_max_i(emax);
  // pass 2: max of the aligned mantissas
  int mmax = INT_MIN;
  for (int b = lane; b < nb; b += kWarp)
    each_aligned<kRegs>(xr, b, block, mant_bits, lim, emax,
                        [&](int, int m) { mmax = max(mmax, m); });
  mmax = warp_max_i(mmax);
  const float plam = pow2i(emax);
  // pass 3: row sum of 2^z, lane order then butterfly
  float acc = 0.0f;
  for (int b = lane; b < nb; b += kWarp)
    each_aligned<kRegs>(xr, b, block, mant_bits, lim, emax, [&](int, int m) {
      acc = __fadd_rn(acc, p_of(m, mmax, plam, log2e, lut, lut_n));
    });
  acc = warp_sum_tree(acc);
  int s_e;
  const float s_m = frexpf(acc, &s_e);               // LZC + shift in HW
  const float s_scale = pow2i(-s_e);
  // pass 4: Eq. 20 divide, optional output quantization, write
  for (int b = lane; b < nb; b += kWarp) {
    if constexpr (kRegs) {
      float v[kMaxBlock];
      each_aligned<kRegs>(xr, b, block, mant_bits, lim, emax,
                          [&](int i, int m) {
        v[i] = __fmul_rn(__fdiv_rn(p_of(m, mmax, plam, log2e, lut, lut_n),
                                   s_m), s_scale);
      });
      if (quantize_out) grid_requant(v, block, mant_bits, lim);
#pragma unroll
      for (int i = 0; i < kMaxBlock; ++i)
        if (i < block) yr[b * block + i] = v[i];
    } else {
      const AlignedBlock mi(xr, b, block, mant_bits, lim, emax);
      auto prob = [&](int i) {
        return __fmul_rn(__fdiv_rn(p_of(mi[i], mmax, plam, log2e, lut, lut_n),
                                   s_m), s_scale);
      };
      float inv = 1.0f, scale = 1.0f;
      if (quantize_out) {               // grid_requant over the block
        float amax = 0.0f;
        for (int i = 0; i < block; ++i) amax = fmaxf(amax, fabsf(prob(i)));
        const int e = block_exp(amax, mant_bits);
        inv = pow2i(-e);
        scale = pow2i(e);
      }
      for (int i = 0; i < block; ++i) {
        const float v = prob(i);
        yr[b * block + i] =
            quantize_out ? __fmul_rn(quant_mant(v, inv, lim), scale) : v;
      }
    }
  }
}

using RowKernel = void (*)(const float*, const float*, float*, int, int, int,
                           int, int, float, int);

// the register-route instance for per_lane elements a lane (a power of two
// up to 32; float4 instances from 4), or nullptr
template <int V, bool B1>
RowKernel regs_kernel(int per_lane) {
  switch (per_lane) {
    case 1:
      if constexpr (V == 1) return softmax_regs_kernel<1, V, B1>;
      break;
    case 2:
      if constexpr (V == 1) return softmax_regs_kernel<2, V, B1>;
      break;
    case 4: return softmax_regs_kernel<4, V, B1>;
    case 8: return softmax_regs_kernel<8, V, B1>;
    case 16: return softmax_regs_kernel<16, V, B1>;
    case 32: return softmax_regs_kernel<32, V, B1>;
  }
  return nullptr;
}

// per_lane 0: the long route; else the register route with per_lane >=
// the elements a lane holds and vec 4 or 1 (softmax_geometry)
extern "C" int mxint_softmax_launch(const float* x, const float* lut,
                                    float* y, int rows, int n, int block,
                                    int mant_bits, int lut_n, float log2e,
                                    int quantize_out, int per_lane, int vec,
                                    int grid, void* stream) {
  if (block < 1 || block > kMaxRowBlock || n % block != 0 ||
      lut_n > kMaxLut ||
      (long long)grid * (kRowThreads / kWarp) < rows)
    return (int)cudaErrorInvalidValue;
  RowKernel k = block <= kMaxBlock ? softmax_long_kernel<true>
                                   : softmax_long_kernel<false>;
  if (per_lane != 0) {
    const int need = (n / block + kWarp - 1) / kWarp * block;
    const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
    if (vec == 4 && block % 4 == 0 && aligned)
      k = regs_kernel<4, false>(per_lane);
    else if (vec == 1)
      k = block == 1 ? regs_kernel<1, true>(per_lane)
                     : regs_kernel<1, false>(per_lane);
    else
      k = nullptr;
    if (k == nullptr || per_lane < need) return (int)cudaErrorInvalidValue;
  }
  QUERY_OR_LAUNCH(k, dim3(grid), dim3(kRowThreads), 0);
  k<<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
      x, lut, y, rows, n, block, mant_bits, lut_n, log2e, quantize_out);
  return (int)cudaGetLastError();
}

// The generic route: a warp a row, lane l over the row's act blocks l,
// l + 32, ... element by element (any block that divides the row), four
// passes over the row (the row-max exponent, the largest aligned
// mantissa, 2^z and its sum in warp_row_sum's order, the output); the
// pow2 LUT read by index from device memory (r_bits up to 16: 256 KB).
__global__ void __launch_bounds__(kRowWarps * kWarp)
softmax_generic_kernel(const float* __restrict__ x,
                       const float* __restrict__ lut, float* __restrict__ y,
                       int rows, int n, int block, int mant_bits, int lut_n,
                       float log2e, int quantize_out) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp, nb = n / block;
  const float* xr = x + (size_t)row * n;
  float* yr = y + (size_t)row * n;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  int emax = -128;
  for (int b = lane; b < nb; b += kWarp)
    emax = max(emax, block_exp(block_amax_g(xr + b * block, block),
                               mant_bits));
  emax = warp_max_i(emax);
  auto aligned = [&](int b, int e, int i) {
    const float q = quant_mant(__ldg(xr + b * block + i), pow2_e8(-e), lim);
    return (int)q >> min(emax - e, 31);
  };
  auto bexp = [&](int b) {
    return block_exp(block_amax_g(xr + b * block, block), mant_bits);
  };
  int mmax = INT_MIN;
  for (int b = lane; b < nb; b += kWarp) {
    const int e = bexp(b);
    for (int i = 0; i < block; ++i) mmax = max(mmax, aligned(b, e, i));
  }
  mmax = warp_max_i(mmax);
  const float fmax_ = (float)mmax, plam = pow2i(emax);
  // 2^z of element i of block b (exponent e), z = (m - max) 2^lambda log2 e
  auto p_of = [&](int b, int e, int i) {
    const float t = __fsub_rn((float)aligned(b, e, i), fmax_);
    const float z = __fmul_rn(__fmul_rn(t, plam), log2e);
    const float f = floorf(z);
    const float r = __fsub_rn(z, f);
    const int idx =
        lut_index(floorf(__fmul_rn(r, (float)lut_n)), lut_n);
    return __fmul_rn(__ldg(lut + idx), pow2i((int)fmaxf(f, -126.0f)));
  };
  float acc = 0.0f;
  for (int b = lane; b < nb; b += kWarp) {
    const int e = bexp(b);
    for (int i = 0; i < block; ++i) acc = __fadd_rn(acc, p_of(b, e, i));
  }
  int se;
  const float sm = frexpf(warp_sum_tree(acc), &se);      // Eq. 20
  const float sinv = pow2i(-se);
  auto y_of = [&](int b, int e, int i) {
    return __fmul_rn(__fdiv_rn(p_of(b, e, i), sm), sinv);
  };
  for (int b = lane; b < nb; b += kWarp) {
    const int e = bexp(b);
    int eo = 0;
    if (quantize_out) {
      float m = 0.0f;
      for (int i = 0; i < block; ++i) m = fmaxf(m, fabsf(y_of(b, e, i)));
      eo = block_exp(m, mant_bits);
    }
    for (int i = 0; i < block; ++i) {
      float v = y_of(b, e, i);
      if (quantize_out)
        v = __fmul_rn(quant_mant(v, pow2_e8(-eo), lim), pow2_e8(eo));
      yr[b * block + i] = v;
    }
  }
}

extern "C" int mxint_softmax_generic_launch(const float* x, const float* lut,
                                            float* y, int rows, int n,
                                            int block, int mant_bits,
                                            int lut_n, float log2e,
                                            int quantize_out, int grid,
                                            void* stream) {
  if (rows < 1 || block < 1 || n % block != 0 || lut_n < 1 ||
      mant_bits < 2 || mant_bits > kGenMaxMantBits ||
      (long long)grid * kRowWarps < rows)
    return (int)cudaErrorInvalidValue;
  QUERY_OR_LAUNCH(softmax_generic_kernel, dim3(grid),
                  dim3(kRowWarps * kWarp), 0);
  softmax_generic_kernel<<<grid, kRowWarps * kWarp, 0,
                           (cudaStream_t)stream>>>(
      x, lut, y, rows, n, block, mant_bits, lut_n, log2e, quantize_out);
  return (int)cudaGetLastError();
}

LAUNCH_QUERY_ENTRY(mxint_softmax)
