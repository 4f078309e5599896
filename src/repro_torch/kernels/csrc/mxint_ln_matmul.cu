// Fused MXInt LayerNorm -> matmul, sm_90a.
// Counterpart of repro/kernels/mxint_ln_matmul.py:mxint_ln_matmul.
// Each CTA normalizes its bm rows (Fig. 3 LN, grid requantization, act
// quantization) into shared memory while the first weight stages load,
// then streams its n_per column tiles against them through the GEMM core
// (any of its variants: int8 or int16 planes, any act block the LN stage
// takes, nested in the weight blocks or not): the LN runs once a row tile
// and column group.  A rsqrt LUT of at most kMaxLut entries is copied to
// shared memory, a longer one (the 13-bit vanilla LUT) read by index from
// device memory, once a row.  Every other format of the reference takes
// the generic route (mxint_ln_matmul_generic_launch below).
#include "mxint_common.cuh"
#include "mxint_generic.cuh"
#include "launch_query.cuh"

using namespace mx;

// The prologue: the shared row stage ln_rows (mxint_common.cuh) on every
// thread of the CTA, staged in place: each row's slot of sA (A: int8, or
// int16 at 9-16 bits; stride d + 16) holds its mantissas, sE its block
// exponents, and the row's padding past d its LnRowVars; phase 4
// overwrites each piece with the LN output's act mantissas (the grid
// requantization's, which act quantization keeps) and each block's
// exponent.  Rows past M are zero.  V: the GEMM core's variant; wb: plane
// bytes.
template <typename T, int P, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
mxint_ln_matmul_kernel(const T* __restrict__ x, const void* gamma,
                       const void* beta, const float* __restrict__ lut_g,
                       const int8_t* __restrict__ wm,
                       const int8_t* __restrict__ we, float* __restrict__ out,
                       int M, int d, int N, int w_block, int mant_bits,
                       int ab_arg, float inv_d, int lut_n, float lut_scale,
                       int rms_only, int params_bf16, GemmGeom g, CopyPlan cp,
                       int wb) {
  using A = ActT<V>;
  const int ab = V == 0 ? kAB : ab_arg;     // a compile-time 16 in V 0
  extern __shared__ __align__(16) unsigned char smem[];
  const GemmSmem s = carve(smem, g, d, ab, sizeof(A), wb);
  const int tiles = (N + g.bn - 1) / g.bn;
  const int tile0 = blockIdx.y * g.n_per;
  const WStream ws{wm, we, N, w_block, 0, d, tile0 * g.bn,
                   min(g.n_per, tiles - tile0), (d + g.bk - 1) / g.bk, cp.vec,
                   cp.vec_shift, ab, wb, cp.vm, cp.vm_shift};
  stream_begin(ws, g, s.w);
  const bool lut_smem = lut_n <= kMaxLut;
  if (lut_smem) load_lut(s.lut, lut_g, lut_n);
  const int m0 = blockIdx.x * g.bm;
  const int rows = min(g.bm, M - m0);
  const int sa = a_stride(d), se = e_stride(d / ab);
  A* sm = reinterpret_cast<A*>(s.a);
  const LnStage<A> st{sm, sa, s.e, se,
                      reinterpret_cast<unsigned char*>(sm + d),
                      (int)(sa * sizeof(A))};
  if (threadIdx.x < g.bm) st.vars(threadIdx.x) = LnRowVars{-128, 0, 0.0f,
                                                           0.0f};
  const int row16 = d * (int)sizeof(A) / 16;       // 16-byte words of a row
  for (int r = rows; r < g.bm; ++r) {
    for (int c = threadIdx.x; c < row16; c += blockDim.x)
      reinterpret_cast<int4*>(sm + r * sa)[c] = make_int4(0, 0, 0, 0);
    for (int c = threadIdx.x; c < d / ab; c += blockDim.x) s.e[r * se + c] = 0;
  }
  __syncthreads();
  const int ilim = (1 << (mant_bits - 1)) - 1;
  const float lim = (float)ilim;
  const LnArgs a{x + (size_t)m0 * d, gamma, beta, lut_smem ? s.lut : lut_g,
                 rows, d, ab,
                 mant_bits, lut_n, rms_only, params_bf16, inv_d, lut_scale,
                 lim};
  // the LN output onto the act grid (grid_requant): its mantissas are also
  // its act quantization's, and its exponent is, but for a block whose
  // mantissas are all 0 (act exponent 0): quantizing grid values again is
  // exact (tests/test_torch_kernels.py checks every mant_bits 2-16).  bf16
  // rows: the plain version's round trip of the LN output through x.dtype
  // is exact up to 8 mantissa bits (bf16 holds 8 significant bits); past
  // them the grid values are rounded to bf16 and act-quantized anew.
  ln_rows<T, P>(a, st, [=](const LnPiece& pc,
                           float (&y)[kPieceSlots<P>]) {
    float amax = group_amax<P>(y, pc.n, pc.G);
    int e = block_exp(amax, mant_bits);
    float inv = pow2_e8(-e);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if (mant_bits > 8) {                           // CTA-uniform
        const float scale = pow2_e8(e);
#pragma unroll
        for (int i = 0; i < kPieceSlots<P>; ++i)
          if (i < pc.n)
            y[i] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(
                small_i2f(quant_mant_small(y[i], inv, ilim)), scale)));
        amax = group_amax<P>(y, pc.n, pc.G);
        e = block_exp(amax, mant_bits);
        inv = pow2_e8(-e);
      }
    }
    int q[kPieceSlots<P>];
#pragma unroll
    for (int i = 0; i < kPieceSlots<P>; ++i)
      q[i] = i < pc.n ? quant_mant_small(y[i], inv, ilim) : 0;
    if (!pc.valid) return;
    store_staged<P>(sm + pc.r * sa + pc.j, pc.n, q);
    if (pc.leader)
      s.e[pc.r * se + pc.b] =
          quant_mant_small(amax, inv, ilim) == 0 ? 0 : (int8_t)e;
  });
  float acc[1][2][4];
  zero_acc(acc[0]);
  stream_run<1, V>(s, ws, g, sa, se, m0, M, acc, out);
}

template <typename T, int P, int V>
static int launch(const void* x, const void* gamma, const void* beta,
                  const float* lut, const int8_t* wm, const int8_t* we,
                  float* out, int M, int d, int N, int w_block, int mant_bits,
                  int ab, float inv_d, int lut_n, float lut_scale,
                  int rms_only, int params_bf16, const GemmGeom& g, int wb,
                  cudaStream_t stream) {
  const size_t smem = gemm_smem_bytes(g, d, ab, sizeof(ActT<V>), wb);
  const void* fn = (const void*)mxint_ln_matmul_kernel<T, P, V>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const CopyPlan cp = copy_plan(N, g.bn, wm, we, wb);
  const int tiles = (N + g.bn - 1) / g.bn;
  const dim3 grid((M + g.bm - 1) / g.bm, (tiles + g.n_per - 1) / g.n_per);
  const T* xt = static_cast<const T*>(x);
  void* args[] = {(void*)&xt, (void*)&gamma, (void*)&beta, (void*)&lut,
                  (void*)&wm, (void*)&we, (void*)&out, (void*)&M,
                  (void*)&d, (void*)&N, (void*)&w_block, (void*)&mant_bits,
                  (void*)&ab, (void*)&inv_d, (void*)&lut_n, (void*)&lut_scale,
                  (void*)&rms_only, (void*)&params_bf16, (void*)&g,
                  (void*)&cp, (void*)&wb};
  QUERY_OR_LAUNCH(fn, grid, dim3(gemm_threads(g.bm)), smem);
  err = cudaLaunchKernel(fn, grid, dim3(gemm_threads(g.bm)), args, smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x f32 or bf16 (x_bf16), gamma and beta f32 or bf16 (params_bf16), beta
// may be null; lut: the rsqrt LUT in device memory, any length; ab: the
// act block; ln_vec: the LN stage's P = 4 route (power-of-two act blocks
// 4-256; x, gamma and beta aligned to four of their elements), else a
// block a thread (act blocks up to 16); act mantissas of 2-16 bits (the LN
// stage and the act tile hold int16 at most); w_bytes: 1 or 2 (int8 or
// int16 planes, wm their bytes)
extern "C" int mxint_ln_matmul_launch(const void* x, const void* gamma,
                                      const void* beta, const float* lut,
                                      const int8_t* wm, const int8_t* we,
                                      float* out, int M, int d, int N,
                                      int w_block, int mant_bits, int ab,
                                      float inv_d, int lut_n, float lut_scale,
                                      int rms_only, int x_bf16,
                                      int params_bf16, int ln_vec, int bm,
                                      int bn, int n_per, int bk, int ns,
                                      int w_bytes, void* stream) {
  const GemmGeom g{bm, bn, n_per, bk, ns};
  const int xa = x_bf16 ? 8 : 16, pa = params_bf16 ? 8 : 16;
  if (d % kAB != 0 || w_block < kAB || w_block % kAB != 0 ||
      d % w_block != 0 || lut_n < 1 || !geom_ok(g) || ab < 1 ||
      d % ab != 0 || mant_bits < 2 || mant_bits > 16 ||
      (w_bytes != 1 && w_bytes != 2) ||
      wide_dot(ab, w_block, mant_bits, w_bytes) ||
      (ln_vec ? (ab < 4 || ab > kMaxLnBlock || (ab & (ab - 1)) != 0 ||
                 (uintptr_t)x % xa != 0 || (uintptr_t)gamma % pa != 0 ||
                 (uintptr_t)beta % pa != 0)
              : ab > kMaxBlock))
    return (int)cudaErrorInvalidValue;
  const int V = act_variant(ab, mant_bits, w_block, w_bytes);
  if (bk % (V <= 2 && ab > kAB ? ab : kAB) != 0)
    return (int)cudaErrorInvalidValue;
  auto cs = (cudaStream_t)stream;
#define LNMM_LAUNCH(T, P, V)                                                \
  return launch<T, P, V>(x, gamma, beta, lut, wm, we, out, M, d, N,         \
                         w_block, mant_bits, ab, inv_d, lut_n, lut_scale,   \
                         rms_only, params_bf16, g, w_bytes, cs)
#define LNMM_ROUTES(V)                                                      \
  if (x_bf16) {                                                             \
    if (ln_vec) LNMM_LAUNCH(__nv_bfloat16, 4, V);                           \
    LNMM_LAUNCH(__nv_bfloat16, 0, V);                                       \
  }                                                                         \
  if (ln_vec) LNMM_LAUNCH(float, 4, V);                                     \
  LNMM_LAUNCH(float, 0, V)
  switch (V) {
    case 0: LNMM_ROUTES(0);
    case 1: LNMM_ROUTES(1);
    case 2: LNMM_ROUTES(2);
    case 3: LNMM_ROUTES(3);
    default: LNMM_ROUTES(4);
  }
#undef LNMM_ROUTES
#undef LNMM_LAUNCH
}

// The generic route: warp w normalizes the CTA's rows w, w + 8, ... with
// ln_row_generic into shared memory (f32, onto the act grid, through
// x.dtype and back), then the CTA runs generic_gemm over them.
template <typename T, typename W, typename ACC>
__global__ void __launch_bounds__(kGenThreads)
mxint_ln_matmul_generic_kernel(const T* __restrict__ x, LnRowArgs ln,
                               const W* __restrict__ wm,
                               const int8_t* __restrict__ we,
                               float* __restrict__ out, int M, int N,
                               int w_block, int bm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = ln.d, ab = ln.block;
  const int m0 = blockIdx.x * bm, rows = min(bm, M - m0);
  float* sx = reinterpret_cast<float*>(smem + (size_t)kGenTK * (bm + kGenBN) *
                                                  sizeof(int));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int r = warp; r < bm; r += kGenThreads / kWarp) {
    if (r < rows) {
      ln_row_generic<T>(x + (size_t)(m0 + r) * d, sx + (size_t)r * d, ln,
                        lane);
    } else {
      for (int j = lane; j < d; j += kWarp) sx[(size_t)r * d + j] = 0.0f;
    }
  }
  __syncthreads();
  generic_gemm<W, ACC, true>(sx, d, rows, wm, we, out, m0, d, N, w_block, ab,
                             ln.mant_bits, bm, smem,
                             reinterpret_cast<int8_t*>(sx + (size_t)bm * d));
}

template <typename T>
struct LnMatmulGeneric {
  template <typename W, typename ACC, bool Q>
  struct Of {
    static const void* fn() {
      if constexpr (Q)
        return (const void*)mxint_ln_matmul_generic_kernel<T, W, ACC>;
      else
        return nullptr;
    }
  };
};

// The generic route (every format of the reference the core route does
// not take): any LN block and alignment, any LUT length, int8, int16 or
// int32 planes (w_bytes), act mantissas of 2-24 bits; wide: int64 segment
// dots; quant must be 1; bm: a CTA's rows (generic_rows on the host).
extern "C" int mxint_ln_matmul_generic_launch(
    const void* x, const void* gamma, const void* beta, const float* lut,
    const void* wm, const int8_t* we, float* out, int M, int d, int N,
    int w_block, int mant_bits, int ab, int w_bytes, int wide, int quant,
    int bm, float inv_d, int lut_n, float lut_scale, int rms_only,
    int x_bf16, int params_bf16, void* stream) {
  if (M < 1 || N < 1 || quant != 1 || lut_n < 1 ||
      !generic_format_ok(d, w_block, ab, mant_bits, 1, bm))
    return (int)cudaErrorInvalidValue;
  const void* fn =
      x_bf16 ? generic_instance<LnMatmulGeneric<__nv_bfloat16>::Of>(
                   w_bytes, wide, 1)
             : generic_instance<LnMatmulGeneric<float>::Of>(w_bytes, wide, 1);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = generic_smem_bytes(bm, d, ab, 1, d);
  const dim3 grid((M + bm - 1) / bm, (N + kGenBN - 1) / kGenBN);
  QUERY_OR_LAUNCH(fn, grid, dim3(kGenThreads), smem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const LnRowArgs ln{gamma, beta, lut, d, ab, mant_bits, lut_n, rms_only,
                     1, params_bf16, x_bf16, inv_d, lut_scale};
  void* args[] = {(void*)&x, (void*)&ln, (void*)&wm, (void*)&we,
                  (void*)&out, (void*)&M, (void*)&N, (void*)&w_block,
                  (void*)&bm};
  err = cudaLaunchKernel(fn, grid, dim3(kGenThreads), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

LAUNCH_QUERY_ENTRY(mxint_ln_matmul)
