// Fused MXInt LayerNorm -> matmul, sm_90a.
// Counterpart of repro/kernels/mxint_ln_matmul.py:mxint_ln_matmul.
// Each block normalizes its kBM rows (Fig. 3 LN, grid requantization, act
// quantization) into shared memory, then runs its N tiles against them.
#include "mxint_common.cuh"

using namespace mx;

__global__ void __launch_bounds__(kThreads)
mxint_ln_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ lut_g,
                       const int8_t* __restrict__ wm,
                       const int8_t* __restrict__ we, float* __restrict__ out,
                       int M, int d, int N, int w_block, int mant_bits,
                       float inv_d, int lut_n, float lut_scale, int rms_only,
                       int n_per) {
  extern __shared__ __align__(16) unsigned char smem[];
  GemmSmem s = carve(smem, d);
  load_lut(s.lut, lut_g, lut_n);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m0 = blockIdx.x * kBM;
  const int nkb = d / kAB;
  const int sa = a_stride(d);
  LnParams p;
  p.gamma = gamma;
  p.beta = beta;
  p.lut = s.lut;
  p.d = d;
  p.block = kAB;
  p.mant_bits = mant_bits;
  p.lut_n = lut_n;
  p.rms_only = rms_only;
  p.inv_d = inv_d;
  p.lut_scale = lut_scale;
  p.lim = (float)((1 << (mant_bits - 1)) - 1);
  for (int r = warp; r < kBM; r += kThreads / kWarp) {
    const int row = m0 + r;
    if (row < M) {
      const float* xr = x + (size_t)row * d;
      const LnRow st = ln_row_stats(xr, p, lane);
      for (int b = lane; b < nkb; b += kWarp) {
        float y[kMaxBlock];
        ln_block(xr, b, p, st, y);
        grid_requant(y, kAB, mant_bits, p.lim);   // LN output quantization
        act_quant16(y, mant_bits, p.lim, s.a + r * sa + b * kAB,
                    s.e + r * nkb + b);
      }
    } else {
      for (int b = lane; b < nkb; b += kWarp) {
#pragma unroll
        for (int i = 0; i < kAB; ++i) s.a[r * sa + b * kAB + i] = 0;
        s.e[r * nkb + b] = 0;
      }
    }
  }
  gemm_tiles(s, wm, we, out, m0, M, d, N, w_block, blockIdx.y * n_per, n_per);
}

extern "C" int mxint_ln_matmul_launch(const float* x, const float* gamma,
                                      const float* beta, const float* lut,
                                      const int8_t* wm, const int8_t* we,
                                      float* out, int M, int d, int N,
                                      int w_block, int mant_bits, float inv_d,
                                      int lut_n, float lut_scale, int rms_only,
                                      void* stream) {
  if (d % kAB != 0 || w_block % kAB != 0 || lut_n > kMaxLut)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      mxint_ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  int n_per;
  gemm_grid(M, N, &grid, &n_per);
  mxint_ln_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, gamma, beta, lut, wm, we, out, M, d, N, w_block, mant_bits, inv_d,
      lut_n, lut_scale, rms_only, n_per);
  return (int)cudaGetLastError();
}
