// MXInt GELU / SiLU LUT datapath (paper Eq. 12), sm_90a.
// Counterpart of repro/kernels/mxint_gelu.py:mxint_gelu.
// One thread per act block: quantize the block, look up the LUT between
// -a and a (identity above, 0 below), requantize onto the block's own
// exponent with the +-(2^(m-1) - 1) clip of the Pallas kernel.
#include "mxint_common.cuh"

using namespace mx;

constexpr int kEltThreads = 256;

__global__ void __launch_bounds__(kEltThreads)
mxint_gelu_kernel(const float* __restrict__ x, const float* __restrict__ lut_g,
                  float* __restrict__ y, long long n_blocks, int block,
                  int mant_bits, int lut_n, float domain, float idx_scale) {
  __shared__ float lut[kMaxLut];
  load_lut(lut, lut_g, lut_n);
  __syncthreads();
  const long long b = (long long)blockIdx.x * kEltThreads + threadIdx.x;
  if (b >= n_blocks) return;
  const float* xb = x + b * block;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  const int e = block_exp(block_amax(xb, block), mant_bits);
  const float inv = pow2i(-e), scale = pow2i(e);
  float v[kMaxBlock];
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i) {
    if (i < block) {
      const float xq = __fmul_rn(quant_mant(xb[i], inv, lim), scale);
      const int idx = lut_index(
          floorf(__fmul_rn(__fadd_rn(xq, domain), idx_scale)), lut_n);
      const float g = xq >= domain ? xq : (xq <= -domain ? 0.0f : lut[idx]);
      const float m = fminf(fmaxf(rintf(__fdiv_rn(g, scale)), -lim), lim);
      v[i] = __fmul_rn(m, scale);
    }
  }
  float* yb = y + b * block;
#pragma unroll
  for (int i = 0; i < kMaxBlock; ++i)
    if (i < block) yb[i] = v[i];
}

extern "C" int mxint_gelu_launch(const float* x, const float* lut, float* y,
                                 long long numel, int block, int mant_bits,
                                 int lut_n, float domain, float idx_scale,
                                 void* stream) {
  if (block > kMaxBlock || numel % block != 0 || lut_n > kMaxLut)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = numel / block;
  const long long grid = (n_blocks + kEltThreads - 1) / kEltThreads;
  mxint_gelu_kernel<<<(unsigned)grid, kEltThreads, 0, (cudaStream_t)stream>>>(
      x, lut, y, n_blocks, block, mant_bits, lut_n, domain, idx_scale);
  return (int)cudaGetLastError();
}
