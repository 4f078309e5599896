// MXInt row softmax (paper Eq. 14-20), sm_90a, one warp per row.
// Counterpart of repro/kernels/mxint_softmax.py:mxint_softmax.
// Four passes re-read the row (L1/L2 resident): row-max exponent lambda,
// max aligned mantissa, sum of 2^z in the fixed lane order, then the
// Eq. 20 divide and the optional act-grid quantization of the output.
#include "mxint_common.cuh"

using namespace mx;

constexpr int kRowThreads = 256;

// aligned mantissas of block b and its exponent
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

__device__ __forceinline__ float p_of(int mi, int mmax, float plam,
                                      float log2e, const float* lut, int n) {
  float t = (float)mi - (float)mmax;                    // exact integers
  float z = __fmul_rn(__fmul_rn(t, plam), log2e);
  return exp2_datapath(z, lut, n);
}

__global__ void __launch_bounds__(kRowThreads)
mxint_softmax_kernel(const float* __restrict__ x,
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
  for (int b = lane; b < nb; b += kWarp) {
    int mi[kMaxBlock];
    aligned_block(xr, b, block, mant_bits, lim, emax, mi);
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block) mmax = max(mmax, mi[i]);
  }
  mmax = warp_max_i(mmax);
  const float plam = pow2i(emax);
  // pass 3: row sum of 2^z, lane order then butterfly
  float acc = 0.0f;
  for (int b = lane; b < nb; b += kWarp) {
    int mi[kMaxBlock];
    aligned_block(xr, b, block, mant_bits, lim, emax, mi);
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block) acc = __fadd_rn(acc, p_of(mi[i], mmax, plam, log2e, lut,
                                               lut_n));
  }
  acc = warp_sum_tree(acc);
  int s_e;
  const float s_m = frexpf(acc, &s_e);               // LZC + shift in HW
  const float s_scale = pow2i(-s_e);
  // pass 4: Eq. 20 divide, optional output quantization, write
  for (int b = lane; b < nb; b += kWarp) {
    int mi[kMaxBlock];
    aligned_block(xr, b, block, mant_bits, lim, emax, mi);
    float v[kMaxBlock];
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block)
        v[i] = __fmul_rn(__fdiv_rn(p_of(mi[i], mmax, plam, log2e, lut, lut_n),
                                   s_m), s_scale);
    if (quantize_out) grid_requant(v, block, mant_bits, lim);
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block) yr[b * block + i] = v[i];
  }
}

extern "C" int mxint_softmax_launch(const float* x, const float* lut,
                                    float* y, int rows, int n, int block,
                                    int mant_bits, int lut_n, float log2e,
                                    int quantize_out, void* stream) {
  if (block > kMaxBlock || n % block != 0 || lut_n > kMaxLut)
    return (int)cudaErrorInvalidValue;
  const int per = kRowThreads / kWarp;
  mxint_softmax_kernel<<<(rows + per - 1) / per, kRowThreads, 0,
                         (cudaStream_t)stream>>>(
      x, lut, y, rows, n, block, mant_bits, lut_n, log2e, quantize_out);
  return (int)cudaGetLastError();
}
