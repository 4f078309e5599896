// MXInt LayerNorm / RMSNorm (paper Fig. 3), sm_90a, one warp per row.
// Counterpart of repro/kernels/mxint_layernorm.py:mxint_layernorm.
#include "mxint_common.cuh"

using namespace mx;

constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
mxint_layernorm_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ lut_g, float* __restrict__ y,
                       int rows, int d, int block, int mant_bits, float inv_d,
                       int lut_n, float lut_scale, int rms_only,
                       int quantize_out) {
  __shared__ float lut[kMaxLut];
  load_lut(lut, lut_g, lut_n);
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;                       // warp-uniform
  LnParams p;
  p.gamma = gamma;
  p.beta = beta;
  p.lut = lut;
  p.d = d;
  p.block = block;
  p.mant_bits = mant_bits;
  p.lut_n = lut_n;
  p.rms_only = rms_only;
  p.inv_d = inv_d;
  p.lut_scale = lut_scale;
  p.lim = (float)((1 << (mant_bits - 1)) - 1);
  const float* xr = x + (size_t)row * d;
  float* yr = y + (size_t)row * d;
  const LnRow st = ln_row_stats(xr, p, lane);
  for (int b = lane; b < d / block; b += kWarp) {
    float v[kMaxBlock];
    ln_block(xr, b, p, st, v);
    if (quantize_out) grid_requant(v, block, mant_bits, p.lim);
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < block) yr[b * block + i] = v[i];
  }
}

extern "C" int mxint_layernorm_launch(const float* x, const float* gamma,
                                      const float* beta, const float* lut,
                                      float* y, int rows, int d, int block,
                                      int mant_bits, float inv_d, int lut_n,
                                      float lut_scale, int rms_only,
                                      int quantize_out, void* stream) {
  if (block > kMaxBlock || d % block != 0 || lut_n > kMaxLut)
    return (int)cudaErrorInvalidValue;
  const int per = kRowThreads / kWarp;
  mxint_layernorm_kernel<<<(rows + per - 1) / per, kRowThreads, 0,
                           (cudaStream_t)stream>>>(
      x, gamma, beta, lut, y, rows, d, block, mant_bits, inv_d, lut_n,
      lut_scale, rms_only, quantize_out);
  return (int)cudaGetLastError();
}
