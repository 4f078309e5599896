// MXInt GELU / SiLU LUT datapath (paper Eq. 12), sm_90a.
// Counterpart of repro/kernels/mxint_gelu.py:mxint_gelu.
// Per act block: quantize the block, look up the LUT between -a and a
// (identity above, 0 below), requantize onto the block's own exponent with
// the +-(2^(m-1) - 1) clip of the Pallas kernel.
//
// Bound by memory: every element is read once and written once.
// gelu_geometry (kernels/mxint_gelu.py) picks the route from the shape and
// alignment, and sizes the grid from the SM count; both routes walk the
// tensor grid-stride:
//  - gelu_vec4_kernel (power-of-two act blocks 4-128, 16-byte aligned):
//    each lane moves one float4, so a warp instruction covers 512
//    contiguous bytes; an act block is block / 4 adjacent lanes (up to
//    the warp), which take its amax by __shfl_xor_sync (max is exact in
//    any order).
//  - gelu_scalar_kernel<true> (any other block up to 128): one thread per
//    act block, which reads it twice (its amax, then its elements).
//  - gelu_scalar_kernel<false>, the generic route (longer blocks, LUTs
//    past kMaxLut entries): the same walk at any block, the LUT read from
//    device memory.
#include "mxint_common.cuh"
#include "mxint_generic.cuh"
#include "launch_query.cuh"

using namespace mx;

constexpr int kMaxEltThreads = 256;

struct GeluArgs {
  float lim, domain, idx_scale;
  int lut_n;
};

// one element of a block with exponent e (inv = 2^-e, scale = 2^e)
__device__ __forceinline__ float gelu_elem(float x, float inv, float scale,
                                           const GeluArgs& a,
                                           const float* lut) {
  const float xq = __fmul_rn(quant_mant(x, inv, a.lim), scale);
  const int idx = lut_index(
      floorf(__fmul_rn(__fadd_rn(xq, a.domain), a.idx_scale)), a.lut_n);
  const float g = xq >= a.domain ? xq : (xq <= -a.domain ? 0.0f : lut[idx]);
  // g / 2^e: inv is exactly 2^-e for every e in [-127, 127], so the
  // rounded product is the rounded quotient, bit for bit
  const float m = fminf(fmaxf(rintf(__fmul_rn(g, inv)), -a.lim), a.lim);
  return __fmul_rn(m, scale);
}

__global__ void __launch_bounds__(kMaxEltThreads)
gelu_vec4_kernel(const float4* __restrict__ x, const float* __restrict__ lut_g,
                 float4* __restrict__ y, long long n4, int group,
                 int mant_bits, GeluArgs a) {
  __shared__ float lut[kMaxLut];
  load_lut(lut, lut_g, a.lut_n);
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop runs warp-uniformly (the shuffles need every lane); n4 is a
  // whole number of blocks, so a block's lanes are all live or all idle
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x -
                        lane;
       base < n4; base += stride) {
    const long long q = base + lane;
    const bool live = q < n4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (live) v = x[q];
    float amax = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                       fmaxf(fabsf(v.z), fabsf(v.w)));
    for (int off = 1; off < group; off <<= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    const int e = block_exp(amax, mant_bits);
    const float inv = pow2i(-e), scale = pow2i(e);
    if (live)
      y[q] = make_float4(gelu_elem(v.x, inv, scale, a, lut),
                         gelu_elem(v.y, inv, scale, a, lut),
                         gelu_elem(v.z, inv, scale, a, lut),
                         gelu_elem(v.w, inv, scale, a, lut));
  }
}

// kSharedLut: the LUT copied to shared memory (at most kMaxLut entries),
// else read from device memory through the read-only path (any length:
// the generic route)
template <bool kSharedLut>
__global__ void __launch_bounds__(kMaxEltThreads)
gelu_scalar_kernel(const float* __restrict__ x,
                   const float* __restrict__ lut_g, float* __restrict__ y,
                   long long n_blocks, int block, int mant_bits, GeluArgs a) {
  const float* lut = lut_g;
  if constexpr (kSharedLut) {
    __shared__ float lut_s[kMaxLut];
    load_lut(lut_s, lut_g, a.lut_n);
    __syncthreads();
    lut = lut_s;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < n_blocks; b += stride) {
    const float* xb = x + b * block;
    float* yb = y + b * block;
    const int e = block_exp(block_amax_g(xb, block), mant_bits);
    const float inv = pow2i(-e), scale = pow2i(e);
    for (int i = 0; i < block; ++i)
      yb[i] = gelu_elem(__ldg(xb + i), inv, scale, a, lut);
  }
}

// vec 4: the float4 route (power-of-two blocks 4-128, 16-byte aligned),
// vec 1: the scalar route (blocks up to 128, a LUT in shared memory),
// vec 0: the generic route (the scalar route's walk at any block and
// mantissa width up to 24 bits, the LUT in device memory); threads and
// grid from gelu_geometry
extern "C" int mxint_gelu_launch(const float* x, const float* lut, float* y,
                                 long long numel, int block, int mant_bits,
                                 int lut_n, float domain, float idx_scale,
                                 int vec, int threads, int grid,
                                 void* stream) {
  if (block < 1 || numel % block != 0 || lut_n < 1 ||
      (vec != 0 && (block > kMaxRowBlock || lut_n > kMaxLut)) ||
      mant_bits < 2 || mant_bits > kGenMaxMantBits || threads < kWarp ||
      threads > kMaxEltThreads || threads % kWarp != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const GeluArgs a{(float)((1 << (mant_bits - 1)) - 1), domain, idx_scale,
                   lut_n};
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    if (block < 4 || (block & (block - 1)) != 0 || (uintptr_t)x % 16 ||
        (uintptr_t)y % 16)
      return (int)cudaErrorInvalidValue;
    QUERY_OR_LAUNCH(gelu_vec4_kernel, dim3(grid), dim3(threads), 0);
    gelu_vec4_kernel<<<grid, threads, 0, s>>>(
        reinterpret_cast<const float4*>(x), lut, reinterpret_cast<float4*>(y),
        numel / 4, block / 4, mant_bits, a);
  } else if (vec == 1) {
    QUERY_OR_LAUNCH(gelu_scalar_kernel<true>, dim3(grid), dim3(threads), 0);
    gelu_scalar_kernel<true><<<grid, threads, 0, s>>>(
        x, lut, y, numel / block, block, mant_bits, a);
  } else if (vec == 0) {
    QUERY_OR_LAUNCH(gelu_scalar_kernel<false>, dim3(grid), dim3(threads), 0);
    gelu_scalar_kernel<false><<<grid, threads, 0, s>>>(
        x, lut, y, numel / block, block, mant_bits, a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

LAUNCH_QUERY_ENTRY(mxint_gelu)
