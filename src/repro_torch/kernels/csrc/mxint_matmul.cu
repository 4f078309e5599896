// MXInt matmul with in-kernel activation quantization, sm_90a.
// Counterpart of repro/kernels/mxint_matmul.py:mxint_matmul (quantize_act).
// y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N], act block 16.
#include "mxint_common.cuh"

using namespace mx;

// A CTA stages the quantized rows of at most kMaxChunk columns of x in
// shared memory.  A longer K (Llama-3-8B's FFN wo has 14336) is walked in
// kMaxChunk-wide chunks inside the one launch: each chunk is quantized in
// turn and its block products are added onto the partial sums of the CTA's
// (at most kMaxAccTiles) column tiles, which stay in registers.  The sums
// run in increasing K order, as for a short K and as in the plain version.
constexpr int kMaxChunk = 4096;

// quantize x[m0 : m0 + bm, k0 : k0 + kc] into s (row strides a_ld, e_ld);
// rows past M are zero
__device__ __forceinline__ void quantize_rows(const GemmSmem& s,
                                              const float* __restrict__ x,
                                              int M, int K, int m0, int k0,
                                              int kc, int a_ld, int e_ld,
                                              int mant_bits, float lim,
                                              int bm) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nkb = kc / kAB;
  for (int r = warp; r < bm; r += blockDim.x / kWarp) {
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

// K <= kMaxChunk: quantize the CTA's rows of x once (while the first weight
// stages load), then stream its column tiles against them.  K > kMaxChunk:
// the chunks of K in order, each quantized once and streamed against all
// of the CTA's n_per <= kMaxAccTiles tiles.
template <bool CHUNKED>
__global__ void __launch_bounds__(kMaxThreads, 1)
mxint_matmul_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ wm,
                    const int8_t* __restrict__ we, float* __restrict__ out,
                    int M, int K, int N, int w_block, int mant_bits,
                    GemmGeom g, int vec, int vec_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc_max = CHUNKED ? kMaxChunk : K;
  const GemmSmem s = carve(smem, g, kc_max);
  const int a_ld = a_stride(kc_max), e_ld = e_stride(kc_max);
  const int m0 = blockIdx.x * g.bm;
  const int tiles = (N + g.bn - 1) / g.bn;
  const int tile0 = blockIdx.y * g.n_per;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  WStream ws{wm, we, N, w_block, 0, K, tile0 * g.bn,
             min(g.n_per, tiles - tile0), (K + g.bk - 1) / g.bk, vec,
             vec_shift};
  if (!CHUNKED) {
    float acc[1][2][4];
    zero_acc(acc[0]);
    stream_begin(ws, g, s.w);
    quantize_rows(s, x, M, K, m0, 0, K, a_ld, e_ld, mant_bits, lim, g.bm);
    stream_run<1>(s, ws, g, a_ld, e_ld, m0, M, acc, out);
    return;
  }
  float acc[kMaxAccTiles][2][4];
#pragma unroll
  for (int t = 0; t < kMaxAccTiles; ++t) zero_acc(acc[t]);
  for (int k0 = 0; k0 < K; k0 += kMaxChunk) {
    ws.kbase = k0;
    ws.kc = min(K - k0, kMaxChunk);
    ws.nst = (ws.kc + g.bk - 1) / g.bk;
    __syncthreads();            // the last chunk's reads of s are done
    stream_begin(ws, g, s.w);
    quantize_rows(s, x, M, K, m0, k0, ws.kc, a_ld, e_ld, mant_bits, lim,
                  g.bm);
    stream_run<kMaxAccTiles>(s, ws, g, a_ld, e_ld, m0, M, acc, nullptr);
  }
  const WarpTile w = warp_tile(g, m0, M);
#pragma unroll
  for (int t = 0; t < kMaxAccTiles; ++t)
    if (t < ws.n_tiles && w.rows > 0)
      store_tile(acc[t], w, out, m0, N, g.bn, ws.n0 + t * g.bn);
}

extern "C" int mxint_matmul_launch(const float* x, const int8_t* wm,
                                   const int8_t* we, float* out, int M, int K,
                                   int N, int w_block, int mant_bits, int bm,
                                   int bn, int n_per, int bk, int ns,
                                   void* stream) {
  const GemmGeom g{bm, bn, n_per, bk, ns};
  const bool chunked = K > kMaxChunk;
  // the act tile is int8: a mantissa wider than 8 bits would wrap
  if (K % kAB != 0 || w_block % kAB != 0 || !geom_ok(g) ||
      (chunked && n_per > kMaxAccTiles) || mant_bits < 2 || mant_bits > 8)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(g, chunked ? kMaxChunk : K);
  const void* fn = chunked ? (const void*)mxint_matmul_kernel<true>
                           : (const void*)mxint_matmul_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = copy_width(N, bn, wm, we);
  const int vec_shift = log2i(bn / vec);
  const int tiles = (N + bn - 1) / bn;
  const dim3 grid((M + bm - 1) / bm, (tiles + n_per - 1) / n_per);
  void* args[] = {(void*)&x, (void*)&wm, (void*)&we, (void*)&out,
                  (void*)&M, (void*)&K, (void*)&N, (void*)&w_block,
                  (void*)&mant_bits, (void*)&g, (void*)&vec,
                  (void*)&vec_shift};
  err = cudaLaunchKernel(fn, grid, dim3(gemm_threads(bm)), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
