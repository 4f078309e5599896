// MXInt matmul with in-kernel activation quantization, sm_90a.
// Counterpart of repro/kernels/mxint_matmul.py:mxint_matmul (quantize_act).
// y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N] on the GEMM core
// (mxint_common.cuh): int8 or int16 planes, act mantissas of 2-16 bits, K
// and w_block multiples of 16, any act block that divides K (V 0-2 where
// it nests in the k16 steps and the weight blocks, V 3-4 by segment),
// segment dots below 2^31.  Every other format of the reference (int32
// planes, 17-24-bit acts, K or w_block off 16, int64 dots) and float
// activations (quantize_act=False) take the generic route
// (mxint_generic.cuh, mxint_matmul_generic_launch below).
#include "mxint_common.cuh"
#include "mxint_generic.cuh"
#include "launch_query.cuh"

using namespace mx;

// A CTA stages the quantized rows of at most kc columns of x in shared
// memory (kc from gemm_geometry: 4096, less where the act format's tile
// would not fit).  A longer K (Llama-3-8B's FFN wo has 14336) is walked in
// kc-wide chunks inside the one launch: each chunk is quantized in turn and
// its block products are added onto the partial sums of the CTA's (at
// most kMaxAccTiles) column tiles, which stay in registers.  The sums run
// in increasing K order, as for a short K and as in the plain version.
constexpr int kMaxChunk = 4096;

// V 1-4: one lane an act block of ab elements: its amax, then its
// mantissas (int8 or int16) and exponent
template <int V>
__device__ __forceinline__ void quantize_rows_any(
    const GemmSmem& s, const float* __restrict__ x, int M, int K, int m0,
    int k0, int kc, int a_ld, int e_ld, int mant_bits, float lim, int bm,
    int ab) {
  using A = ActT<V>;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nb = kc / ab;
  A* sa = reinterpret_cast<A*>(s.a);
  for (int r = warp; r < bm; r += blockDim.x / kWarp) {
    const int row = m0 + r;
    for (int b = lane; b < nb; b += kWarp) {
      A* dm = sa + r * a_ld + b * ab;
      if (row < M) {
        const float* xb = x + (size_t)row * K + k0 + b * ab;
        const int e = block_exp(block_amax(xb, ab), mant_bits);
        const float inv = pow2i(-e);
        for (int i = 0; i < ab; ++i) dm[i] = (A)quant_mant(xb[i], inv, lim);
        s.e[r * e_ld + b] = (int8_t)e;
      } else {
        for (int i = 0; i < ab; ++i) dm[i] = 0;
        s.e[r * e_ld + b] = 0;
      }
    }
  }
}

// quantize x[m0 : m0 + bm, k0 : k0 + kc] into s (row strides a_ld, e_ld);
// rows past M are zero
template <int V>
__device__ __forceinline__ void quantize_rows(const GemmSmem& s,
                                              const float* __restrict__ x,
                                              int M, int K, int m0, int k0,
                                              int kc, int a_ld, int e_ld,
                                              int mant_bits, float lim,
                                              int bm, int ab) {
  if constexpr (V != 0) {
    quantize_rows_any<V>(s, x, M, K, m0, k0, kc, a_ld, e_ld, mant_bits, lim,
                         bm, ab);
    return;
  }
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

// K <= kc: quantize the CTA's rows of x once (while the first weight
// stages load), then stream its column tiles against them.  K > kc: the
// chunks of K in order, each quantized once and streamed against all of
// the CTA's n_per <= kMaxAccTiles tiles.
template <bool CHUNKED, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
mxint_matmul_kernel(const float* __restrict__ x,
                    const int8_t* __restrict__ wm,
                    const int8_t* __restrict__ we, float* __restrict__ out,
                    int M, int K, int N, int w_block, int mant_bits,
                    int ab_arg, int kc_arg, GemmGeom g, CopyPlan cp,
                    int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  // V 0: act block 16 and chunks of kMaxChunk, as compile-time constants
  // (the launcher sends V 0 nothing else), so the core's shared-memory
  // strides fold into its address arithmetic
  const int ab = V == 0 ? kAB : ab_arg;
  const int kc = V == 0 ? kMaxChunk : kc_arg;
  const int kc_max = CHUNKED ? kc : K;
  const GemmSmem s = carve(smem, g, kc_max, ab, sizeof(ActT<V>), wb);
  const int a_ld = a_stride(kc_max), e_ld = e_stride(kc_max / ab);
  const int m0 = blockIdx.x * g.bm;
  const int tiles = (N + g.bn - 1) / g.bn;
  const int tile0 = blockIdx.y * g.n_per;
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  WStream ws{wm, we, N, w_block, 0, K, tile0 * g.bn,
             min(g.n_per, tiles - tile0), (K + g.bk - 1) / g.bk, cp.vec,
             cp.vec_shift, ab, wb, cp.vm, cp.vm_shift};
  if (!CHUNKED) {
    float acc[1][2][4];
    zero_acc(acc[0]);
    stream_begin(ws, g, s.w);
    quantize_rows<V>(s, x, M, K, m0, 0, K, a_ld, e_ld, mant_bits, lim, g.bm,
                     ab);
    stream_run<1, V>(s, ws, g, a_ld, e_ld, m0, M, acc, out);
    return;
  }
  float acc[kMaxAccTiles][2][4];
#pragma unroll
  for (int t = 0; t < kMaxAccTiles; ++t) zero_acc(acc[t]);
  for (int k0 = 0; k0 < K; k0 += kc) {
    ws.kbase = k0;
    ws.kc = min(K - k0, kc);
    ws.nst = (ws.kc + g.bk - 1) / g.bk;
    __syncthreads();            // the last chunk's reads of s are done
    stream_begin(ws, g, s.w);
    quantize_rows<V>(s, x, M, K, m0, k0, ws.kc, a_ld, e_ld, mant_bits, lim,
                     g.bm, ab);
    stream_run<kMaxAccTiles, V>(s, ws, g, a_ld, e_ld, m0, M, acc, nullptr);
  }
  const WarpTile w = warp_tile(g, m0, M);
#pragma unroll
  for (int t = 0; t < kMaxAccTiles; ++t)
    if (t < ws.n_tiles && w.rows > 0)
      store_tile(acc[t], w, out, m0, N, g.bn, ws.n0 + t * g.bn);
}

// ab: the act block; kc: the K columns a CTA stages at once (K > kc walks
// K in chunks) up to kMaxChunk, whole act blocks and k16 steps; bk whole
// act blocks (V 0-2) or k16 steps (V 3-4, whose segments run on across
// stages); w_bytes: 1 or 2 (int8 or int16 planes, wm their bytes).  The
// act tile holds int16 mantissas at most: a mantissa wider than 16 bits
// would wrap.
extern "C" int mxint_matmul_launch(const float* x, const int8_t* wm,
                                   const int8_t* we, float* out, int M, int K,
                                   int N, int w_block, int mant_bits, int ab,
                                   int bm, int bn, int n_per, int bk, int ns,
                                   int kc, int w_bytes, void* stream) {
  const GemmGeom g{bm, bn, n_per, bk, ns};
  const bool chunked = K > kc;
  if (K % kAB != 0 || w_block < kAB || w_block % kAB != 0 ||
      K % w_block != 0 || ab < 1 || K % ab != 0 || !geom_ok(g) ||
      mant_bits < 2 || mant_bits > 16 || (w_bytes != 1 && w_bytes != 2) ||
      wide_dot(ab, w_block, mant_bits, w_bytes))
    return (int)cudaErrorInvalidValue;
  int V = act_variant(ab, mant_bits, w_block, w_bytes);
  const int unit = V <= 2 && ab > kAB ? ab : kAB;
  const int c_unit = V <= 2 ? unit : seg_unit(ab);
  if (bk % unit != 0 || kc < c_unit || kc > kMaxChunk || kc % c_unit != 0 ||
      (chunked && n_per > kMaxAccTiles))
    return (int)cudaErrorInvalidValue;
  // V 0 takes only the full chunk (a narrower one runs V 1, which also
  // takes act block 16)
  if (V == 0 && chunked && kc != kMaxChunk) V = 1;
  const size_t smem = gemm_smem_bytes(g, chunked ? kc : K, ab,
                                      V == 2 || V == 4 ? 2 : 1, w_bytes);
  const void* kernels[2][5] = {
      {(const void*)mxint_matmul_kernel<false, 0>,
       (const void*)mxint_matmul_kernel<false, 1>,
       (const void*)mxint_matmul_kernel<false, 2>,
       (const void*)mxint_matmul_kernel<false, 3>,
       (const void*)mxint_matmul_kernel<false, 4>},
      {(const void*)mxint_matmul_kernel<true, 0>,
       (const void*)mxint_matmul_kernel<true, 1>,
       (const void*)mxint_matmul_kernel<true, 2>,
       (const void*)mxint_matmul_kernel<true, 3>,
       (const void*)mxint_matmul_kernel<true, 4>}};
  const void* fn = kernels[chunked][V];
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const CopyPlan cp = copy_plan(N, bn, wm, we, w_bytes);
  const int tiles = (N + bn - 1) / bn;
  const dim3 grid((M + bm - 1) / bm, (tiles + n_per - 1) / n_per);
  void* args[] = {(void*)&x, (void*)&wm, (void*)&we, (void*)&out,
                  (void*)&M, (void*)&K, (void*)&N, (void*)&w_block,
                  (void*)&mant_bits, (void*)&ab, (void*)&kc, (void*)&g,
                  (void*)&cp, (void*)&w_bytes};
  QUERY_OR_LAUNCH(fn, grid, dim3(gemm_threads(bm)), smem);
  err = cudaLaunchKernel(fn, grid, dim3(gemm_threads(bm)), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W, typename ACC, bool Q>
struct MatmulGeneric {
  static const void* fn() {
    return (const void*)mxint_matmul_generic_kernel<W, ACC, Q>;
  }
};

// The generic route: w_bytes 1, 2 or 4 (int8, int16 or int32 planes);
// wide: int64 segment dots; quant 0: float activations; bm: a CTA's rows
// (a power of two up to kGenMaxRows, from generic_rows on the host).
extern "C" int mxint_matmul_generic_launch(const float* x, const void* wm,
                                           const int8_t* we, float* out,
                                           int M, int K, int N, int w_block,
                                           int mant_bits, int ab, int w_bytes,
                                           int wide, int quant, int bm,
                                           void* stream) {
  if (M < 1 || N < 1 ||
      !generic_format_ok(K, w_block, ab, mant_bits, quant, bm))
    return (int)cudaErrorInvalidValue;
  const void* fn = generic_instance<MatmulGeneric>(w_bytes, wide, quant);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = generic_smem_bytes(bm, K, ab, quant, 0);
  const dim3 grid((M + bm - 1) / bm, (N + kGenBN - 1) / kGenBN);
  QUERY_OR_LAUNCH(fn, grid, dim3(kGenThreads), smem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x, (void*)&wm, (void*)&we, (void*)&out,
                  (void*)&M, (void*)&K, (void*)&N, (void*)&w_block,
                  (void*)&ab, (void*)&mant_bits, (void*)&bm};
  err = cudaLaunchKernel(fn, grid, dim3(kGenThreads), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

LAUNCH_QUERY_ENTRY(mxint_matmul)
