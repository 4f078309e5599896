// Online-softmax attention with the MXInt softmax datapath, sm_90a.
//
// Counterparts of repro/kernels/flash_attention.py: flash_attention (its
// pallas_call at line 252) and flash_attention_decode (line 366).  Both
// run one device loop, attend_rows below, which is the CUDA form of the
// reference's _softmax_block_update (Eq. 2-3 score quantization per tile,
// the Eq. 14-19 exp datapath, the rescale alpha in float exp, Eq. 20
// through frexp at the flush).
//
//   flash_attention:         one CTA per (batch*head, block of 32 query
//                            rows); q (BH, Sq, D), k/v (BH/g, Sk, D), the
//                            query head b reads KV head b / g (GQA, no copy).
//   flash_attention_decode:  one CTA per (batch, KV head, up to 8 of its G
//                            query rows); q (B, Hkv, G, D), k/v in the cache's
//                            native (B, W, Hkv, D) layout, valid (B, W).
//
// The key axis is walked in 128-key tiles from key 0, in order, inside the
// CTA.  The result depends on where the tiles fall: each tile has its own
// Eq. 2-3 shared exponents and row-max requantize, interior tiles quantize
// unnormalized P on the act grid while the last one is normalized first.
// So the tile is 128 keys wide and the k loop is sequential; it must never
// be split across CTAs (flash-decoding's split-K would change the answer).
// Speed work parallelises over heads, rows and D, not over k.
//
// Lanes past the real key count are wrapper padding in the reference
// (kv_len / w_len): they take the fill 2^-100 for the quantizer and are
// invisible after it.  Model-masked lanes (causal, window, an invalid ring
// slot) take -2e38 before the quantizer and join the Eq. 19 sum as the
// datapath's 2^-126 tail.  The two masks stay apart, as in the reference.
//
// What bounds it on the card: at the Llama-3-8B shapes the score and P.V
// products are f32 on CUDA cores (no tensor cores: the products must sum
// in the plain version's order), so operations bound it, not bytes.  This
// first design stages each K and then V tile in shared memory as f32 (row
// stride D + 1, no bank conflicts), keeps the scores, the row stages and
// the running (m, l, acc) in shared memory, and runs the row stages one
// warp per row with lane l holding keys l, l + 32, l + 64, l + 96.
//
// Every sum runs in one fixed order that the plain versions in
// kernels/flash_attention.py repeat: q.k over d in increasing order, P.V
// over the keys of a tile in increasing order, the row sum lane by lane
// then a butterfly.  Multiplies and adds are rounded one by one.
#include <cuda_bf16.h>

#include "mxint_common.cuh"

using namespace mx;

namespace {

constexpr int kTileK = 128;
constexpr int kMaxD = 128;
constexpr int kPerLane = kTileK / kWarp;          // 4 keys per lane
constexpr float kNegInf = -2.0e38f;               // the masking sentinel
constexpr float kNegInfHalf = -1.0e38f;           // fully-masked-row guard
constexpr float kMinL = 1e-30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max_f(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// max over an aligned group of `group` lanes (a power of two <= 32)
__device__ __forceinline__ float group_max_f(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// snap one value onto the MXInt grid of its act block; a block is `group`
// consecutive lanes of one column, so the amax is a lane-group max
__device__ __forceinline__ float grid_requant_lane(float y, int group,
                                                   int mant_bits, float lim) {
  const int e = block_exp(group_max_f(fabsf(y), group), mant_bits);
  return __fmul_rn(quant_mant(y, pow2i(-e), lim), pow2i(e));
}

// Cephes expf for x <= 0 (0 below -104): exp(x) = 2^n * P(r), about 1
// ulp, from rounded multiplies and adds only; exp_nonpos in
// kernels/flash_attention.py runs the same operations in the same order.
__device__ __forceinline__ float exp_nonpos(float x) {
  x = fminf(fmaxf(x, -104.0f), 0.0f);
  const float n = floorf(__fadd_rn(__fmul_rn(x, 0x1.715476p+0f), 0.5f));
  x = __fsub_rn(x, __fmul_rn(n, 0x1.63p-1f));
  x = __fsub_rn(x, __fmul_rn(n, -0x1.bd0106p-13f));
  float y = __fadd_rn(__fmul_rn(x, 0x1.a0d2cep-13f), 0x1.6e879cp-10f);
  y = __fadd_rn(__fmul_rn(y, x), 0x1.11121p-7f);
  y = __fadd_rn(__fmul_rn(y, x), 0x1.555382p-5f);
  y = __fadd_rn(__fmul_rn(y, x), 0x1.555554p-3f);
  y = __fadd_rn(__fmul_rn(y, x), 0.5f);
  y = __fadd_rn(__fadd_rn(__fmul_rn(y, __fmul_rn(x, x)), x), 1.0f);
  return __fmul_rn(y, pow2i((int)n));
}

struct Problem {
  int n_rows;       // query rows of this (batch, head) problem
  int n_keys;       // real keys: Sk, or the ring width W
  int d;
  int key_stride;   // elements between consecutive keys of k and v
  int causal, window;
  int mxint, quantize;
  int block, mant_bits, lut_n;
  float scale, log2e;
};

// shared memory, in floats: q rows | K or V tile | scores | acc | row state
// | LUT
__host__ __device__ constexpr size_t smem_floats(int rows) {
  return (size_t)rows * kMaxD + (size_t)kTileK * (kMaxD + 1) +
         (size_t)rows * kTileK + (size_t)rows * kMaxD + 5 * (size_t)rows +
         kMaxLut;
}

// One tile's row stages for row r (one warp): mask, Eq. 2-3 quantization,
// exp datapath, rescale, row sum, and the P written back for the P.V
// product.  Row state: m, l (running), alpha, and at the flush l_m, 2^-l_e.
__device__ __forceinline__ void row_stages(float* srow, const int* valid,
                                           int qpos, int k0, bool last,
                                           const Problem& p, const float* lut,
                                           float* m_s, float* l_s,
                                           float* alpha_s, float* lm_s,
                                           float* inv_s, int lane) {
  const float lim = (float)((1 << (p.mant_bits - 1)) - 1);
  float s[kPerLane];
  bool real[kPerLane], keep[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int j = lane + kWarp * c, key = k0 + j;
    real[c] = key < p.n_keys;
    bool ok = true;
    if (real[c] && valid != nullptr) ok = valid[key] != 0;
    if (p.causal) ok = ok && qpos >= key;
    if (p.window > 0) ok = ok && (qpos - key) < p.window;
    keep[c] = ok;
    s[c] = ok ? srow[j] : kNegInf;
  }
  if (p.quantize) {
    int e[kPerLane];
    int emax = -128;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      if (!real[c]) s[c] = pow2i(-100);                 // the pad fill
      e[c] = block_exp(group_max_f(fabsf(s[c]), p.block), p.mant_bits);
      emax = max(emax, e[c]);
    }
    emax = warp_max_i(emax);
    const float plam = pow2i(emax);
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int sh = min(emax - e[c], 31);
      const int mi = ((int)quant_mant(s[c], pow2i(-e[c]), lim)) >> sh;
      s[c] = __fmul_rn((float)mi, plam);
    }
  }
  float tmax = -INFINITY;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    if (!real[c]) s[c] = kNegInf;
    tmax = fmaxf(tmax, s[c]);
  }
  const float m_prev = *m_s;
  const float m_new = fmaxf(m_prev, warp_max_f(tmax));
  float pr[kPerLane];
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const float t = __fsub_rn(s[c], m_new);
    pr[c] = p.mxint ? exp2_datapath(__fmul_rn(t, p.log2e), lut, p.lut_n)
                    : exp_nonpos(t);
    const bool live = keep[c] && real[c];
    float pl;
    if (p.quantize) {
      pl = real[c] ? pr[c] : 0.0f;      // masked lanes join the Eq. 19 sum
    } else {
      pr[c] = live ? pr[c] : 0.0f;
      pl = pr[c];
    }
    acc = __fadd_rn(acc, pl);
  }
  const float psum = warp_sum_tree(acc);
  float alpha = exp_nonpos(__fsub_rn(m_prev, m_new));
  if (m_prev <= kNegInfHalf) alpha = 0.0f;
  const float l_new = __fadd_rn(__fmul_rn(*l_s, alpha), psum);
  float lm = 1.0f, inv = 1.0f;
  if (last) {
    int le;
    lm = frexpf(fmaxf(l_new, kMinL), &le);              // Eq. 20
    inv = pow2i(-le);
  }
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    float out = pr[c];
    if (p.quantize) {
      const bool live = keep[c] && real[c];
      if (last) out = __fmul_rn(__fdiv_rn(pr[c], lm), inv);
      out = grid_requant_lane(out, p.block, p.mant_bits, lim);
      out = live ? out : 0.0f;
    }
    srow[lane + kWarp * c] = out;
  }
  __syncwarp();
  if (lane == 0) {
    *m_s = m_new;
    *l_s = l_new;
    *alpha_s = alpha;
    *lm_s = lm;
    *inv_s = inv;
  }
}

// The whole key loop for up to ROWS query rows of one (batch, head).
// q/out point at row 0 of the problem (row stride d); rows [row0, row0 +
// ROWS) are this CTA's.  k/v point at key 0 (key stride p.key_stride);
// valid, when given, at the problem's (n_keys,) validity row.
template <typename T, int ROWS, int THREADS>
__device__ void attend_rows(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ valid,
                            const float* __restrict__ lut_g,
                            T* __restrict__ out, int row0, const Problem& p) {
  static_assert(THREADS % kTileK == 0 && (ROWS * kTileK) % THREADS == 0,
                "thread mapping");
  constexpr int kRowStep = THREADS / kTileK;
  constexpr int kRowsPerThread = ROWS / kRowStep;
  constexpr int kWarps = THREADS / kWarp;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                   // ROWS x d
  float* skv = sq + ROWS * kMaxD;                     // 128 x (d + 1)
  float* ss = skv + kTileK * (kMaxD + 1);             // ROWS x 128
  float* sacc = ss + ROWS * kTileK;                   // ROWS x d
  float* sm = sacc + ROWS * kMaxD;
  float* sl = sm + ROWS;
  float* salpha = sl + ROWS;
  float* slm = salpha + ROWS;
  float* sinv = slm + ROWS;
  float* lut = sinv + ROWS;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int d = p.d, kd = d + 1;
  const int rows = min(ROWS, p.n_rows - row0);

  load_lut(lut, lut_g, p.lut_n);
  for (int i = tid; i < ROWS * d; i += THREADS) {
    const int r = i / d;
    sq[i] = r < rows ? to_f32(q[(size_t)(row0 + r) * d + i % d]) : 0.0f;
    sacc[i] = 0.0f;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    sm[r] = kNegInf;
    sl[r] = 0.0f;
  }
  __syncthreads();

  const int n_tiles = (p.n_keys + kTileK - 1) / kTileK;
  const int jt = tid % kTileK, rb = tid / kTileK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileK;
    const int nk = min(kTileK, p.n_keys - k0);
    const bool last = t == n_tiles - 1;
    // K tile -> shared memory (f32, row stride d + 1)
    for (int i = tid; i < kTileK * d; i += THREADS) {
      const int j = i / d, c = i % d;
      skv[j * kd + c] =
          j < nk ? to_f32(k[(size_t)(k0 + j) * p.key_stride + c]) : 0.0f;
    }
    __syncthreads();
    // scores: thread (jt, rb) owns key jt of rows rb, rb + kRowStep, ...
    {
      float acc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
      for (int c = 0; c < d; ++c) {
        const float kv = skv[jt * kd + c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i] = __fadd_rn(acc[i],
                             __fmul_rn(sq[(rb + kRowStep * i) * d + c], kv));
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        ss[(rb + kRowStep * i) * kTileK + jt] = __fmul_rn(acc[i], p.scale);
    }
    __syncthreads();
    // row stages, one warp per row
    for (int r = warp; r < rows; r += kWarps)
      row_stages(ss + r * kTileK, valid, row0 + r, k0, last, p, lut, sm + r,
                 sl + r, salpha + r, slm + r, sinv + r, lane);
    __syncthreads();
    // V tile -> shared memory, over the K tile
    for (int i = tid; i < kTileK * d; i += THREADS) {
      const int j = i / d, c = i % d;
      skv[j * kd + c] =
          j < nk ? to_f32(v[(size_t)(k0 + j) * p.key_stride + c]) : 0.0f;
    }
    __syncthreads();
    // P.V over the tile's real keys in order, then the running update
    const int col = jt;
    if (col < d) {
      float dot[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) dot[i] = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float vv = skv[j * kd + col];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          dot[i] = __fadd_rn(dot[i],
                             __fmul_rn(ss[(rb + kRowStep * i) * kTileK + j],
                                       vv));
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rb + kRowStep * i;
        if (r >= rows) continue;
        const float a = __fmul_rn(sacc[r * d + col], salpha[r]);
        if (last && p.quantize) {
          const float o = __fadd_rn(
              __fmul_rn(__fdiv_rn(a, slm[r]), sinv[r]), dot[i]);
          store(out + (size_t)(row0 + r) * d + col, o);
        } else {
          const float acc = __fadd_rn(a, dot[i]);
          if (last)
            store(out + (size_t)(row0 + r) * d + col,
                  __fmul_rn(__fdiv_rn(acc, slm[r]), sinv[r]));
          else
            sacc[r * d + col] = acc;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kFlashRows = 32, kFlashThreads = 256;
constexpr int kDecodeRows = 8, kDecodeThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* q, const T* k, const T* v, const float* lut, T* out,
             int groups, Problem p) {
  const int bh = blockIdx.y;
  const size_t qoff = (size_t)bh * p.n_rows * p.d;
  const size_t koff = (size_t)(bh / groups) * p.n_keys * p.d;
  attend_rows<T, kFlashRows, kFlashThreads>(
      q + qoff, k + koff, v + koff, nullptr, lut, out + qoff,
      blockIdx.x * kFlashRows, p);
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const T* q, const T* k, const T* v, const int* valid,
              const float* lut, T* out, int hkv, Problem p) {
  const int b = blockIdx.y / hkv, h = blockIdx.y % hkv;
  const size_t qoff = (size_t)blockIdx.y * p.n_rows * p.d;
  const size_t koff = ((size_t)b * p.n_keys * hkv + h) * p.d;
  attend_rows<T, kDecodeRows, kDecodeThreads>(
      q + qoff, k + koff, v + koff, valid + (size_t)b * p.n_keys, lut,
      out + qoff, blockIdx.x * kDecodeRows, p);
}

// above 48 KB a kernel's dynamic shared memory needs an explicit opt-in
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_problem(const Problem& p) {
  const int b = p.block;
  return p.d < 1 || p.d > kMaxD || p.lut_n > kMaxLut || b < 1 || b > kWarp ||
         (b & (b - 1)) != 0 || p.n_keys < 1 || p.n_rows < 1;
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const float* lut, void* out,
    int bh, int sq, int sk, int d, int groups, int causal, int window,
    int mxint, int quantize, int block, int mant_bits, int lut_n, float scale,
    float log2e, int bf16, void* stream) {
  Problem p{sq, sk, d, d, causal, window, mxint, quantize, block, mant_bits,
            lut_n, scale, log2e};
  if (bad_problem(p) || groups < 1 || bh % groups != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kFlashRows - 1) / kFlashRows, bh);
  const size_t smem = smem_floats(kFlashRows) * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    auto* kern = flash_kernel<__nv_bfloat16>;
    int rc = allow_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, kFlashThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, lut, (__nv_bfloat16*)out, groups, p);
  } else {
    auto* kern = flash_kernel<float>;
    int rc = allow_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, kFlashThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, lut, (float*)out,
        groups, p);
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, const int* valid,
    const float* lut, void* out, int b, int hkv, int g, int w, int d,
    int mxint, int quantize, int block, int mant_bits, int lut_n, float scale,
    float log2e, int bf16, void* stream) {
  Problem p{g, w, d, hkv * d, 0, 0, mxint, quantize, block, mant_bits, lut_n,
            scale, log2e};
  if (bad_problem(p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((g + kDecodeRows - 1) / kDecodeRows, b * hkv);
  const size_t smem = smem_floats(kDecodeRows) * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    auto* kern = decode_kernel<__nv_bfloat16>;
    int rc = allow_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, kDecodeThreads, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, valid, lut, (__nv_bfloat16*)out, hkv, p);
  } else {
    auto* kern = decode_kernel<float>;
    int rc = allow_smem(kern, smem);
    if (rc) return rc;
    kern<<<grid, kDecodeThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, valid, lut,
        (float*)out, hkv, p);
  }
  return (int)cudaGetLastError();
}
