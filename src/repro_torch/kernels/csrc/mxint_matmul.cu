// MXInt matmul with in-kernel activation quantization, sm_90a.
// Counterpart of repro/kernels/mxint_matmul.py:mxint_matmul (quantize_act).
// y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N], act block 16.
#include "mxint_common.cuh"

using namespace mx;

__global__ void __launch_bounds__(kThreads)
mxint_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ wm,
                    const int8_t* __restrict__ we, float* __restrict__ out,
                    int M, int K, int N, int w_block, int mant_bits,
                    int n_per) {
  extern __shared__ __align__(16) unsigned char smem[];
  GemmSmem s = carve(smem, K);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int m0 = blockIdx.x * kBM;
  const int nkb = K / kAB;
  const int sa = a_stride(K);
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  // prologue: quantize this block's kBM rows of x once, into shared memory
  for (int r = warp; r < kBM; r += kThreads / kWarp) {
    const int row = m0 + r;
    for (int b = lane; b < nkb; b += kWarp) {
      int8_t* dm = s.a + r * sa + b * kAB;
      if (row < M) {
        float v[kMaxBlock];
        const float* xb = x + (size_t)row * K + b * kAB;
#pragma unroll
        for (int i = 0; i < kAB; ++i) v[i] = xb[i];
        act_quant16(v, mant_bits, lim, dm, s.e + r * nkb + b);
      } else {
#pragma unroll
        for (int i = 0; i < kAB; ++i) dm[i] = 0;
        s.e[r * nkb + b] = 0;
      }
    }
  }
  gemm_tiles(s, wm, we, out, m0, M, K, N, w_block, blockIdx.y * n_per, n_per);
}

extern "C" int mxint_matmul_launch(const float* x, const int8_t* wm,
                                   const int8_t* we, float* out, int M, int K,
                                   int N, int w_block, int mant_bits,
                                   void* stream) {
  if (K % kAB != 0 || w_block % kAB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      mxint_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  int n_per;
  gemm_grid(M, N, &grid, &n_per);
  mxint_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, wm, we, out, M, K, N, w_block, mant_bits, n_per);
  return (int)cudaGetLastError();
}
