// MXInt matmul with in-kernel activation quantization, sm_90a.
// Counterpart of repro/kernels/mxint_matmul.py:mxint_matmul (quantize_act).
// y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N], act block 16.
#include "mxint_common.cuh"

using namespace mx;

// A block stages the quantized rows of at most kMaxChunk columns of x in
// shared memory.  A longer K (Llama-3-8B's FFN wo has 14336) is walked in
// kMaxChunk-wide chunks inside the one launch: each chunk is quantized in
// turn and its block products are added onto the partial sums of all the
// block's N tiles, which stay in registers (at most kMaxTiles tiles per
// block).  The sums run in increasing K order, as for a short K and as in
// the plain version.
constexpr int kMaxChunk = 4096;
constexpr int kMaxTiles = 8;

// quantize x[m0 : m0 + kBM, k0 : k0 + kc] into s (row strides a_ld, e_ld);
// rows past M are zero
__device__ __forceinline__ void quantize_rows(const GemmSmem& s,
                                              const float* __restrict__ x,
                                              int M, int K, int m0, int k0,
                                              int kc, int a_ld, int e_ld,
                                              int mant_bits, float lim) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nkb = kc / kAB;
  for (int r = warp; r < kBM; r += kThreads / kWarp) {
    const int row = m0 + r;
    for (int b = lane; b < nkb; b += kWarp) {
      int8_t* dm = s.a + r * a_ld + b * kAB;
      if (row < M) {
        float v[kMaxBlock];
        const float* xb = x + (size_t)row * K + k0 + b * kAB;
#pragma unroll
        for (int i = 0; i < kAB; ++i) v[i] = xb[i];
        act_quant16(v, mant_bits, lim, dm, s.e + r * e_ld + b);
      } else {
#pragma unroll
        for (int i = 0; i < kAB; ++i) dm[i] = 0;
        s.e[r * e_ld + b] = 0;
      }
    }
  }
}

// K <= kMaxChunk: quantize this block's kBM rows of x once, then run its
// N tiles against them
__global__ void __launch_bounds__(kThreads)
mxint_matmul_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ wm,
                    const int8_t* __restrict__ we, float* __restrict__ out,
                    int M, int K, int N, int w_block, int mant_bits,
                    int n_per) {
  extern __shared__ __align__(16) unsigned char smem[];
  GemmSmem s = carve(smem, K);
  const int m0 = blockIdx.x * kBM;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  quantize_rows(s, x, M, K, m0, 0, K, a_stride(K), K / kAB, mant_bits, lim);
  gemm_tiles(s, wm, we, out, m0, M, K, N, w_block, blockIdx.y * n_per, n_per);
}

// K > kMaxChunk: the chunks of K in order, each quantized once and run
// against all of the block's n_per <= kMaxTiles tiles
__global__ void __launch_bounds__(kThreads)
mxint_matmul_chunked_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ wm,
                            const int8_t* __restrict__ we,
                            float* __restrict__ out, int M, int K, int N,
                            int w_block, int mant_bits, int n_per) {
  extern __shared__ __align__(16) unsigned char smem[];
  GemmSmem s = carve(smem, kMaxChunk);
  const int a_ld = a_stride(kMaxChunk), e_ld = kMaxChunk / kAB;
  const int m0 = blockIdx.x * kBM;
  const int tile0 = blockIdx.y * n_per;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  float acc[kMaxTiles][2][4];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) zero_tile(acc[t]);
  for (int k0 = 0; k0 < K; k0 += kMaxChunk) {
    const int kc = K - k0 < kMaxChunk ? K - k0 : kMaxChunk;
    __syncthreads();            // the last chunk's reads of s are done
    quantize_rows(s, x, M, K, m0, k0, kc, a_ld, e_ld, mant_bits, lim);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      const int n0 = (tile0 + t) * kBN;
      if (t < n_per && n0 < N)
        gemm_tile_range(s, wm, we, acc[t], k0, kc, a_ld, e_ld, N, w_block,
                        n0);
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    const int n0 = (tile0 + t) * kBN;
    if (t < n_per && n0 < N) store_tile(acc[t], out, m0, M, N, n0);
  }
}

extern "C" int mxint_matmul_launch(const float* x, const int8_t* wm,
                                   const int8_t* we, float* out, int M, int K,
                                   int N, int w_block, int mant_bits,
                                   void* stream) {
  if (K % kAB != 0 || w_block % kAB != 0) return (int)cudaErrorInvalidValue;
  const bool chunked = K > kMaxChunk;
  const size_t smem = gemm_smem_bytes(chunked ? kMaxChunk : K);
  const void* fn = chunked ? (const void*)mxint_matmul_chunked_kernel
                           : (const void*)mxint_matmul_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  int n_per;
  gemm_grid(M, N, &grid, &n_per, chunked ? kMaxTiles : INT_MAX);
  if (chunked)
    mxint_matmul_chunked_kernel<<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(
        x, wm, we, out, M, K, N, w_block, mant_bits, n_per);
  else
    mxint_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        x, wm, we, out, M, K, N, w_block, mant_bits, n_per);
  return (int)cudaGetLastError();
}
