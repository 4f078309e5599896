// MXInt LayerNorm / RMSNorm (paper Fig. 3), sm_90a.
// Counterpart of repro/kernels/mxint_layernorm.py:mxint_layernorm.
//
// Bound by memory: each row is read once and written once.  A CTA of
// kLnThreads threads normalizes R <= kLnMaxRows consecutive rows with the
// shared row stage ln_rows (mxint_common.cuh): every thread reads, quantizes
// and aligns its pieces of the rows, the mantissas are staged as int32 in
// shared memory (any mant_bits), one warp a row adds the variance in the
// fixed lane order, and every thread writes its pieces' outputs (optionally
// requantized onto the act grid).  ln_geometry (kernels/mxint_layernorm.py)
// picks the route from the shape, dtype and alignment: P = 4 (float4 / bf16
// quad accesses; power-of-two act blocks 4-128, a block over 1-32 lanes)
// or a block a thread (P = 0, act blocks up to 16), and R.
// Rows whose stage does not fit shared memory (GS) are staged in a global
// scratch buffer instead, one row a CTA.  x is f32 or bf16 (T), gamma and
// beta f32 or bf16 (a flag), beta may be null; y is f32.
#include "mxint_common.cuh"
#include "mxint_generic.cuh"
#include "launch_query.cuh"

using namespace mx;

constexpr int kLnThreads = 256;
constexpr int kLnMaxRows = 8;
// CTAs an SM holds at once on the shared-stage route (registers capped to
// fit): DeiT-Base's 394 CTAs of 8 rows then run in one wave on 132 SMs
constexpr int kLnCtasPerSm = 3;

// int32 words of a row's global stage: d mantissas, then d / block exponent
// bytes, padded to 16 bytes (ln_stage_words in kernels/mxint_layernorm.py)
__host__ __device__ __forceinline__ int gs_stride(int d, int block) {
  return (d + (d / block + 3) / 4 + 3) & ~3;
}

// every pointer (null passes) a multiple of v bytes
__host__ __forceinline__ bool aligned_to(int v, const void* a, const void* b,
                                         const void* c) {
  for (const void* p : {a, b, c})
    if ((uintptr_t)p % v != 0) return false;
  return true;
}

template <typename T, int P, bool GS>
__global__ void __launch_bounds__(kLnThreads, GS ? 1 : kLnCtasPerSm)
mxint_layernorm_kernel(const T* __restrict__ x, const void* gamma,
                       const void* beta, const float* __restrict__ lut_g,
                       float* __restrict__ y, int32_t* __restrict__ scratch,
                       int rows, int d, int block, int mant_bits, float inv_d,
                       int lut_n, float lut_scale, int rms_only,
                       int params_bf16, int quantize_out, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lut[kMaxLut];
  __shared__ LnRowVars rv[kLnMaxRows];
  const int R = rows_per_cta, nb = d / block;
  const int r0 = blockIdx.x * R;
  LnStage<int32_t> st;
  if (GS) {                 // one row: mantissas, then its block exponents
    st.m = scratch + (size_t)blockIdx.x * gs_stride(d, block);
    st.e = reinterpret_cast<int8_t*>(st.m + d);
  } else {
    st.m = reinterpret_cast<int32_t*>(smem);
    st.e = reinterpret_cast<int8_t*>(smem + (size_t)R * d * 4);
  }
  st.m_ld = d;
  st.e_ld = nb;
  st.rv = reinterpret_cast<unsigned char*>(rv);
  st.rv_ld = sizeof(LnRowVars);
  load_lut(lut, lut_g, lut_n);
  if (threadIdx.x < R) rv[threadIdx.x] = LnRowVars{-128, 0, 0.0f, 0.0f};
  __syncthreads();
  const float lim = (float)((1 << (mant_bits - 1)) - 1);
  const LnArgs a{x + (size_t)r0 * d, gamma, beta, lut, min(R, rows - r0), d,
                 block, mant_bits, lut_n, rms_only, params_bf16, inv_d,
                 lut_scale, lim};
  float* yr = y + (size_t)r0 * d;
  ln_rows<T, P>(a, st, [=](const LnPiece& pc,
                           float (&v)[kPieceSlots<P>]) {
    if (quantize_out) group_requant<P>(v, pc.n, pc.G, mant_bits, lim);
    if (!pc.valid) return;
    float* dst = yr + (size_t)pc.r * d + pc.j;
    if constexpr (P == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kMaxBlock; ++i)
        if (i < pc.n) dst[i] = v[i];
    }
  });
}

template <typename T, int P, bool GS>
static int launch(const void* x, const void* gamma, const void* beta,
                  const float* lut, float* y, int32_t* scratch, int rows,
                  int d, int block, int mant_bits, float inv_d, int lut_n,
                  float lut_scale, int rms_only, int params_bf16,
                  int quantize_out, int rows_per_cta, size_t smem,
                  cudaStream_t stream) {
  const void* fn = (const void*)mxint_layernorm_kernel<T, P, GS>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  QUERY_OR_LAUNCH(fn, dim3((rows + rows_per_cta - 1) / rows_per_cta),
                  dim3(kLnThreads), smem);
  mxint_layernorm_kernel<T, P, GS>
      <<<(rows + rows_per_cta - 1) / rows_per_cta, kLnThreads, smem,
         stream>>>(static_cast<const T*>(x), gamma, beta, lut, y, scratch,
                   rows, d, block, mant_bits, inv_d, lut_n, lut_scale,
                   rms_only, params_bf16, quantize_out, rows_per_cta);
  return (int)cudaGetLastError();
}

// vec: the P = 4 route (act block 4, 8 or 16; x, gamma, beta and y aligned
// to four of their elements); scratch non-null: the global-stage route, one
// row a CTA, gs_stride(d, block) int32 a row
extern "C" int mxint_layernorm_launch(
    const void* x, const void* gamma, const void* beta, const float* lut,
    float* y, void* scratch, int rows, int d, int block, int mant_bits,
    float inv_d, int lut_n, float lut_scale, int rms_only, int quantize_out,
    int x_bf16, int params_bf16, int vec, int rows_per_cta, void* stream) {
  const bool gs = scratch != nullptr;
  if (block < 1 || block > (vec ? kMaxRowBlock : kMaxBlock) ||
      d % block != 0 || lut_n > kMaxLut ||
      rows_per_cta < 1 || rows_per_cta > kLnMaxRows ||
      (gs && rows_per_cta != 1) ||
      (vec && (block < 4 || (block & (block - 1)) != 0 ||
               !aligned_to(x_bf16 ? 8 : 16, x, y, nullptr) ||
               !aligned_to(params_bf16 ? 8 : 16, gamma, beta, nullptr) ||
               (uintptr_t)y % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      gs ? 0 : (size_t)rows_per_cta * (d * 4 + d / block);
  auto* s = static_cast<int32_t*>(scratch);
  auto cs = (cudaStream_t)stream;
#define LN_LAUNCH(T, P, GS)                                                 \
  return launch<T, P, GS>(x, gamma, beta, lut, y, s, rows, d, block,        \
                          mant_bits, inv_d, lut_n, lut_scale, rms_only,     \
                          params_bf16, quantize_out, rows_per_cta, smem, cs)
  if (x_bf16) {
    if (vec) {
      if (gs) LN_LAUNCH(__nv_bfloat16, 4, true);
      LN_LAUNCH(__nv_bfloat16, 4, false);
    }
    if (gs) LN_LAUNCH(__nv_bfloat16, 0, true);
    LN_LAUNCH(__nv_bfloat16, 0, false);
  }
  if (vec) {
    if (gs) LN_LAUNCH(float, 4, true);
    LN_LAUNCH(float, 4, false);
  }
  if (gs) LN_LAUNCH(float, 0, true);
  LN_LAUNCH(float, 0, false);
#undef LN_LAUNCH
}

// The generic route (mxint_generic.cuh): a warp a row, any act block that
// divides d, any alignment, any LUT length (read from device memory).
template <typename T>
__global__ void __launch_bounds__(kRowWarps * kWarp)
layernorm_generic_kernel(const T* __restrict__ x, float* __restrict__ y,
                         int rows, LnRowArgs a) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  ln_row_generic<T>(x + (size_t)row * a.d, y + (size_t)row * a.d, a,
                    threadIdx.x % kWarp);
}

extern "C" int mxint_layernorm_generic_launch(
    const void* x, const void* gamma, const void* beta, const float* lut,
    float* y, int rows, int d, int block, int mant_bits, float inv_d,
    int lut_n, float lut_scale, int rms_only, int quantize_out, int x_bf16,
    int params_bf16, int grid, void* stream) {
  if (rows < 1 || block < 1 || d % block != 0 || lut_n < 1 ||
      mant_bits < 2 || mant_bits > kGenMaxMantBits ||
      (long long)grid * kRowWarps < rows)
    return (int)cudaErrorInvalidValue;
  const LnRowArgs a{gamma, beta, lut, d, block, mant_bits, lut_n, rms_only,
                    quantize_out, params_bf16, 0, inv_d, lut_scale};
  auto cs = (cudaStream_t)stream;
  if (x_bf16) {
    QUERY_OR_LAUNCH(layernorm_generic_kernel<__nv_bfloat16>, dim3(grid),
                    dim3(kRowWarps * kWarp), 0);
    layernorm_generic_kernel<<<grid, kRowWarps * kWarp, 0, cs>>>(
        static_cast<const __nv_bfloat16*>(x), y, rows, a);
  } else {
    QUERY_OR_LAUNCH(layernorm_generic_kernel<float>, dim3(grid),
                    dim3(kRowWarps * kWarp), 0);
    layernorm_generic_kernel<<<grid, kRowWarps * kWarp, 0, cs>>>(
        static_cast<const float*>(x), y, rows, a);
  }
  return (int)cudaGetLastError();
}

LAUNCH_QUERY_ENTRY(mxint_layernorm)
