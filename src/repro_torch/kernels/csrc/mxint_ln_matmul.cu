// Fused MXInt LayerNorm -> matmul, sm_90a.
// Counterpart of repro/kernels/mxint_ln_matmul.py:mxint_ln_matmul.
// Each CTA normalizes its bm rows (Fig. 3 LN, grid requantization, act
// quantization) into shared memory while the first weight stages load,
// then streams its column tiles against them through the GEMM core.
#include "mxint_common.cuh"

using namespace mx;

__global__ void __launch_bounds__(kMaxThreads, 1)
mxint_ln_matmul_kernel(const float* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ lut_g,
                       const int8_t* __restrict__ wm,
                       const int8_t* __restrict__ we, float* __restrict__ out,
                       int M, int d, int N, int w_block, int mant_bits,
                       float inv_d, int lut_n, float lut_scale, int rms_only,
                       GemmGeom g, int vec, int vec_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GemmSmem s = carve(smem, g, d);
  const int tiles = (N + g.bn - 1) / g.bn;
  const int tile0 = blockIdx.y * g.n_per;
  const WStream ws{wm, we, N, w_block, 0, d, tile0 * g.bn,
                   min(g.n_per, tiles - tile0), (d + g.bk - 1) / g.bk, vec,
                   vec_shift};
  stream_begin(ws, g, s.w);
  load_lut(s.lut, lut_g, lut_n);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m0 = blockIdx.x * g.bm;
  const int nkb = d / kAB;
  const int sa = a_stride(d), se = e_stride(d);
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
  for (int r = warp; r < g.bm; r += blockDim.x / kWarp) {
    const int row = m0 + r;
    if (row < M) {
      const float* xr = x + (size_t)row * d;
      const LnRow st = ln_row_stats(xr, p, lane);
      for (int b = lane; b < nkb; b += kWarp) {
        float y[kMaxBlock];
        ln_block(xr, b, p, st, y);
        grid_requant(y, kAB, mant_bits, p.lim);   // LN output quantization
        act_quant16(y, mant_bits, p.lim, s.a + r * sa + b * kAB,
                    s.e + r * se + b);
      }
    } else {
      for (int b = lane; b < nkb; b += kWarp) {
#pragma unroll
        for (int i = 0; i < kAB; ++i) s.a[r * sa + b * kAB + i] = 0;
        s.e[r * se + b] = 0;
      }
    }
  }
  float acc[1][2][4];
  zero_acc(acc[0]);
  stream_run<1>(s, ws, g, sa, se, m0, M, acc, out);
}

extern "C" int mxint_ln_matmul_launch(const float* x, const float* gamma,
                                      const float* beta, const float* lut,
                                      const int8_t* wm, const int8_t* we,
                                      float* out, int M, int d, int N,
                                      int w_block, int mant_bits, float inv_d,
                                      int lut_n, float lut_scale, int rms_only,
                                      int bm, int bn, int n_per, int bk,
                                      int ns, void* stream) {
  const GemmGeom g{bm, bn, n_per, bk, ns};
  if (d % kAB != 0 || w_block % kAB != 0 || lut_n > kMaxLut || !geom_ok(g))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(g, d);
  const void* fn = (const void*)mxint_ln_matmul_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = copy_width(N, bn, wm, we);
  const int vec_shift = log2i(bn / vec);
  const int tiles = (N + bn - 1) / bn;
  const dim3 grid((M + bm - 1) / bm, (tiles + n_per - 1) / n_per);
  void* args[] = {(void*)&x, (void*)&gamma, (void*)&beta, (void*)&lut,
                  (void*)&wm, (void*)&we, (void*)&out, (void*)&M,
                  (void*)&d, (void*)&N, (void*)&w_block, (void*)&mant_bits,
                  (void*)&inv_d, (void*)&lut_n, (void*)&lut_scale,
                  (void*)&rms_only, (void*)&g, (void*)&vec,
                  (void*)&vec_shift};
  err = cudaLaunchKernel(fn, grid, dim3(gemm_threads(bm)), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
