// Online-softmax attention with the MXInt softmax datapath, sm_90a.
//
// Counterparts of repro/kernels/flash_attention.py: flash_attention (its
// pallas_call at line 252) and flash_attention_decode (line 366).  Every
// kernel here is the CUDA form of the reference's _softmax_block_update
// (Eq. 2-3 score quantization per tile, the Eq. 14-19 exp datapath, the
// rescale alpha in float exp, Eq. 20 through frexp at the flush).
//
//   flash_attention, bf16:   flash_mma_kernel, one CTA per (KV head, block
//                            of 128 / G query positions) for all G query
//                            heads of that KV head; q (BH, Sq, D), k/v
//                            (BH/g, Sk, D), D a multiple of 16.
//   flash_attention, f32:    flash_kernel over attend_rows, one CTA per
//                            (batch*head, block of 32 query rows).
//   flash_attention_decode:  decode_kernel, one CTA per (batch, KV head,
//                            up to 8 of its G query rows, slice of the D
//                            output columns); q (B, Hkv, G, D), k/v in the
//                            cache's native (B, W, Hkv, D) layout, valid
//                            (B, W).
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
// Two routes for flash_attention, by the operands' dtype:
//
// - bf16, the dtype the model serves and scores in: q.k and P.V run on the
//   bf16 tensor cores (mma.sync m16n8k16; the bf16 products are exact in
//   f32, the sums run in the tensor cores' order), K/V tiles come through
//   cp.async double buffers and ldmatrix, and the row stages run in
//   registers on the mma accumulator layout (flash_mma_kernel below).  P
//   on the MXInt act grid (quantized scores) of at most kBf16MantBits bits
//   is exact in bf16, so one mma takes it; any other P (wider act
//   mantissas, or float P) is split into bf16 hi + mid + lo (f32's 24
//   bits), three mmas.  A block visits only the tiles tile_span gives it
//   (no trailing tile under causal, no leading tile a window hides); that
//   is exact, see attend_rows in kernels/flash_attention.py.  What bounds
//   it: the MXInt row stages, about 70-100 f32 and integer instructions
//   per score of a visited tile on the CUDA cores, far above the
//   products' tensor-core time and the bytes; the kernel is templated on
//   the datapath mode and act block so that they are straight-line code,
//   and at 255 registers a thread one 8-warp CTA fits an SM.  Its sums
//   have no fixed order, so the card holds it to the plain version within
//   a tolerance (chip_smoke.py).
// - f32: the ordered kernel (attend_rows below).  Every sum runs in one
//   fixed order that the plain versions repeat: q.k over d in increasing
//   order, P.V over the keys of a tile in increasing order, the row sum
//   lane by lane then a butterfly; multiplies and adds are rounded one by
//   one, so the card holds it to the plain version bit for bit.  Its
//   products are f32 on CUDA cores, so operations bound it.  It stages each
//   K and then V tile in shared memory as f32 (row stride D + 1, no bank
//   conflicts), keeps the scores, the row stages and the running (m, l,
//   acc) in shared memory, and runs the row stages one warp per row with
//   lane l holding keys l, l + 32, l + 64, l + 96; it walks every tile.
//
// flash_attention_decode, both dtypes, runs decode_kernel: the same ordered
// sums and the same row stages (row_stages), so it too is bit for bit with
// its plain version, on its own geometry (see its note below): column
// slices over more CTAs, cp.async tiles, and a stop at each batch row's
// last valid tile.
#include <cuda_bf16.h>

#include "mxint_common.cuh"
#include "launch_query.cuh"

using namespace mx;

namespace {

constexpr int kTileK = 128;
constexpr int kMaxD = 256;          // head dims the kernels take
constexpr int kNarrowD = 128;       // the widest head dim of the base layouts
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

// max over aligned groups of `group` lanes (a power of two <= 32), of a
// lane's kPerLane values at once, so that their shuffles overlap
__device__ __forceinline__ void group_max_lanes(float (&v)[kPerLane],
                                                int group) {
  for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < kPerLane; ++c)
      v[c] = fmaxf(v[c], __shfl_xor_sync(kFull, v[c], off));
  }
}

// exactly pow2i(n), from selects instead of branches: in the unrolled row
// stages of flash_mma_kernel pow2i's early returns became a branch per
// value, which kept the compiler from interleaving the values' work
__device__ __forceinline__ float pow2_sel(int n) {
  const int c = min(max(n, -150), 128);
  const int sub = c >= -149 ? 1 << max(c + 149, 0) : 0;
  return __int_as_float(c >= -126 ? (c + 127) << 23 : sub);
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
  return __fmul_rn(y, pow2_sel((int)n));
}

// exp2_datapath of mxint_common.cuh with pow2_sel for pow2i: the same
// stages and values
__device__ __forceinline__ float exp2_datapath_sel(float z, const float* lut,
                                                   int n_entries) {
  float n = floorf(z);
  float r = __fsub_rn(z, n);
  int idx = lut_index(floorf(__fmul_rn(r, (float)n_entries)), n_entries);
  int ni = (int)fmaxf(n, -126.0f);
  return __fmul_rn(lut[idx], pow2_sel(ni));
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

// shared memory of the ordered kernel for head dims up to maxd, in
// floats: q rows | K or V tile | scores | acc | row state | LUT
__host__ __device__ constexpr size_t smem_floats(int rows, int maxd) {
  return (size_t)rows * maxd + (size_t)kTileK * (maxd + 1) +
         (size_t)rows * kTileK + (size_t)rows * maxd + 5 * (size_t)rows +
         kMaxLut;
}

// The causal and window mask of this lane's keys k0 + lane + 32c of a tile
// for query position qpos
__device__ __forceinline__ void lane_keep(int qpos, int k0, const Problem& p,
                                          int lane, bool (&keep)[kPerLane]) {
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int key = k0 + lane + kWarp * c;
    bool ok = true;
    if (p.causal) ok = ok && qpos >= key;
    if (p.window > 0) ok = ok && (qpos - key) < p.window;
    keep[c] = ok;
  }
}

// max over a score act block of up to the whole tile (the generic route):
// up to 32 keys, aligned groups of lanes; 64, the lane's two key groups
// c = 0, 1 (and 2, 3) over the warp; 128, all four
__device__ __forceinline__ void tile_group_max(float (&a)[kPerLane],
                                               int block) {
  group_max_lanes(a, block < kWarp ? block : kWarp);
  if (block >= 2 * kWarp) {
    a[0] = a[1] = fmaxf(a[0], a[1]);
    a[2] = a[3] = fmaxf(a[2], a[3]);
  }
  if (block >= 4 * kWarp) a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], a[2]);
}

// One tile's row stages for row r (one warp): mask, Eq. 2-3 quantization,
// exp datapath, rescale, row sum, and the P written back for the P.V
// product.  Row state: m, l (running), alpha, and at the flush l_m, 2^-l_e.
// WIDE: score act blocks past 32 keys (the generic route).
template <bool WIDE = false>
__device__ __forceinline__ void row_stages(float* srow,
                                           const bool (&keep)[kPerLane],
                                           int k0, bool last,
                                           const Problem& p, const float* lut,
                                           float* m_s, float* l_s,
                                           float* alpha_s, float* lm_s,
                                           float* inv_s, int lane) {
  const float lim = (float)((1 << (p.mant_bits - 1)) - 1);
  float s[kPerLane];
  bool real[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int j = lane + kWarp * c;
    real[c] = k0 + j < p.n_keys;
    s[c] = keep[c] ? srow[j] : kNegInf;
  }
  if (p.quantize) {
    float a[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      if (!real[c]) s[c] = pow2_sel(-100);              // the pad fill
      a[c] = fabsf(s[c]);
    }
    if constexpr (WIDE)
      tile_group_max(a, p.block);
    else
      group_max_lanes(a, p.block);
    int e[kPerLane];
    int emax = -128;
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      e[c] = block_exp(a[c], p.mant_bits);
      emax = max(emax, e[c]);
    }
    emax = warp_max_i(emax);
    const float plam = pow2_sel(emax);
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int sh = min(emax - e[c], 31);
      const int mi = ((int)quant_mant(s[c], pow2_sel(-e[c]), lim)) >> sh;
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
    pr[c] = p.mxint ? exp2_datapath_sel(__fmul_rn(t, p.log2e), lut, p.lut_n)
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
    inv = pow2_sel(-le);
  }
  if (p.quantize) {
    // P onto the act grid, block by block (normalized first on the last
    // tile); masked and padding lanes then 0
    float a[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      if (last) pr[c] = __fmul_rn(__fdiv_rn(pr[c], lm), inv);
      a[c] = fabsf(pr[c]);
    }
    if constexpr (WIDE)
      tile_group_max(a, p.block);
    else
      group_max_lanes(a, p.block);
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int e = block_exp(a[c], p.mant_bits);
      pr[c] = __fmul_rn(quant_mant(pr[c], pow2_sel(-e), lim), pow2_sel(e));
      pr[c] = keep[c] && real[c] ? pr[c] : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) srow[lane + kWarp * c] = pr[c];
  __syncwarp();
  if (lane == 0) {
    *m_s = m_new;
    *l_s = l_new;
    *alpha_s = alpha;
    *lm_s = lm;
    *inv_s = inv;
  }
}

// The whole key loop for up to ROWS query rows of one (batch, head), f32
// operands, head dims up to MAXD.  q/out point at row 0 of the problem
// (row stride d); rows [row0, row0 + ROWS) are this CTA's.  k/v point at
// key 0 (key stride p.key_stride).
template <int ROWS, int THREADS, int MAXD>
__device__ void attend_rows(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ lut_g,
                            float* __restrict__ out, int row0,
                            const Problem& p) {
  static_assert(THREADS % kTileK == 0 && (ROWS * kTileK) % THREADS == 0,
                "thread mapping");
  constexpr int kRowStep = THREADS / kTileK;
  constexpr int kRowsPerThread = ROWS / kRowStep;
  constexpr int kWarps = THREADS / kWarp;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                   // ROWS x d
  float* skv = sq + ROWS * MAXD;                      // 128 x (d + 1)
  float* ss = skv + kTileK * (MAXD + 1);              // ROWS x 128
  float* sacc = ss + ROWS * kTileK;                   // ROWS x d
  float* sm = sacc + ROWS * MAXD;
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
    for (int r = warp; r < rows; r += kWarps) {
      bool keep[kPerLane];
      lane_keep(row0 + r, k0, p, lane, keep);
      row_stages(ss + r * kTileK, keep, k0, last, p, lut, sm + r, sl + r,
                 salpha + r, slm + r, sinv + r, lane);
    }
    __syncthreads();
    // V tile -> shared memory, over the K tile
    for (int i = tid; i < kTileK * d; i += THREADS) {
      const int j = i / d, c = i % d;
      skv[j * kd + c] =
          j < nk ? to_f32(v[(size_t)(k0 + j) * p.key_stride + c]) : 0.0f;
    }
    __syncthreads();
    // P.V over the tile's real keys in order, then the running update;
    // thread (jt, rb) owns columns jt, jt + 128
    for (int col = jt; col < d; col += kTileK) {
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

// 32 rows a CTA: at head dim 256 the shared memory is 210 KB of the 227
// KB a block may take (64 rows would not fit)
constexpr int kFlashRows = 32, kFlashThreads = 256;

// the ordered route of flash_attention: float32 operands, head dims up to
// MAXD (the layout of 128 below it, of 256 above)
template <int MAXD>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const float* q, const float* k, const float* v,
             const float* lut, float* out, int groups, Problem p) {
  const int bh = blockIdx.y;
  const size_t qoff = (size_t)bh * p.n_rows * p.d;
  const size_t koff = (size_t)(bh / groups) * p.n_keys * p.d;
  attend_rows<kFlashRows, kFlashThreads, MAXD>(
      q + qoff, k + koff, v + koff, lut, out + qoff,
      blockIdx.x * kFlashRows, p);
}

// ---------------------------------------------------------------------------
// bf16 flash_attention on the tensor cores
// ---------------------------------------------------------------------------
// One CTA takes one KV head and a block of kMmaRows / G query positions for
// all G query heads that read it (row i: head i / P, position p0 + i % P),
// so each K/V tile is loaded once for G heads.  Eight warps own 16 rows
// each.  K and V tiles sit in shared memory as bf16 (row stride D + 8, so
// ldmatrix is free of bank conflicts), double-buffered with cp.async; the
// CTA's Q rows stay in shared memory for the whole k loop (in registers
// they pushed the kernel past 255 registers).  S = Q K^T and O +=
// P V run on mma.sync m16n8k16 (bf16 x bf16 products, exact; f32 sums in
// the tensor cores' order).  The row stages run on the accumulator
// layout: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of
// the warp, keys 8j + 2t and 8j + 2t + 1 of every 8-key n-tile j, so a
// row's 128 keys live in one quad and every row reduction (act-block
// amax, exponent max, row max, row sum) is in-thread work plus
// __shfl_xor_sync over offsets 1 and 2.
constexpr int kMmaRows = 128;
// the widest act mantissa whose grid values bf16 holds exactly: b bits
// carry b - 1 significant bits, bf16 carries 8
constexpr int kBf16MantBits = 9;
constexpr int kMmaWarps = kMmaRows / 16;
constexpr int kMmaThreads = kMmaWarps * kWarp;
constexpr int kNT = kTileK / 8;                    // 8-key n-tiles per tile
constexpr int kMaxDT = kNarrowD / 8;               // 8-wide n-tiles of O

__host__ __device__ constexpr int kv_stride(int d) { return d + 8; }

// shared memory: K tiles (2) | V tiles (2) | the CTA's Q rows | LUT
__host__ __device__ constexpr size_t mma_smem_bytes(int d) {
  return (size_t)4 * kTileK * kv_stride(d) * 2 +
         (size_t)kMmaRows * kv_stride(d) * 2 + kMaxLut * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !ok (keys past the end)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}


__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ int quad_max_i(int v) {
  v = max(v, __shfl_xor_sync(kFull, v, 1));
  return max(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(kFull, v, 2));
}

// One row's keys in this lane: x[j][e] is key 8j + 2t + e of the lane's
// NT n-tiles.  a[j] becomes the amax of the act block (B keys, a power of
// two from 2 to 32) that holds keys 8j + 2t and 8j + 2t + 1: a block of B
// >= 8 keys is B / 8 n-tiles across the quad, a block of 4 keys a pair of
// lanes, a block of 2 keys the lane's own pair.
template <int B, int NT>
__device__ __forceinline__ void pair_block_amax(const float (&x)[NT][2],
                                                float (&a)[NT]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j] = fmaxf(fabsf(x[j][0]), fabsf(x[j][1]));
  if (B >= 16) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) a[j] = fmaxf(a[j], a[j + 1]);
  }
  if (B >= 32) {
#pragma unroll
    for (int j = 0; j < NT; j += 4) a[j] = fmaxf(a[j], a[j + 2]);
  }
  constexpr int step = B >= 32 ? 4 : B >= 16 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j % step) continue;
    if (B >= 4) a[j] = fmaxf(a[j], __shfl_xor_sync(kFull, a[j], 1));
    if (B >= 8) a[j] = fmaxf(a[j], __shfl_xor_sync(kFull, a[j], 2));
  }
  if (B >= 32) {
#pragma unroll
    for (int j = 0; j < NT; ++j) a[j] = a[j & ~3];
  } else if (B >= 16) {
#pragma unroll
    for (int j = 0; j < NT; ++j) a[j] = a[j & ~1];
  }
}

struct SameRow {
  __device__ __forceinline__ int operator()(int v) const { return v; }
};

// Eq. 2-3 on one row: quantize per act block, requantize to the row's max
// exponent, dequantize (exact); x holds the masked, pad-filled scores.
// row_max(v) takes the quad's max exponent to the row's (the identity
// where the quad holds the whole row)
template <int B, int NT, typename RowMax = SameRow>
__device__ __forceinline__ void quantize_scores_row(float (&x)[NT][2],
                                                    int mant_bits, float lim,
                                                    RowMax row_max = {}) {
  int eb[NT];
  int emax = -128;
  if (B >= 2) {
    float a[NT];
    pair_block_amax<B>(x, a);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      eb[j] = block_exp(a[j], mant_bits);
      emax = max(emax, eb[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        emax = max(emax, block_exp(fabsf(x[j][e]), mant_bits));
  }
  emax = row_max(quad_max_i(emax));
  const float plam = pow2_sel(emax);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ev = B >= 2 ? eb[j] : block_exp(fabsf(x[j][e]), mant_bits);
      const int sh = min(emax - ev, 31);
      const int mi = ((int)quant_mant(x[j][e], pow2_sel(-ev), lim)) >> sh;
      x[j][e] = __fmul_rn((float)mi, plam);
    }
}

// snap one row onto the MXInt act grid, block by block
template <int B, int NT>
__device__ __forceinline__ void grid_requant_row(float (&x)[NT][2],
                                                 int mant_bits, float lim) {
  if (B >= 2) {
    float a[NT];
    pair_block_amax<B>(x, a);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int e = block_exp(a[j], mant_bits);
      const float inv = pow2_sel(-e), sc = pow2_sel(e);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[j][h] = __fmul_rn(quant_mant(x[j][h], inv, lim), sc);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = block_exp(fabsf(x[j][h]), mant_bits);
        x[j][h] = __fmul_rn(quant_mant(x[j][h], pow2_sel(-e), lim), pow2_sel(e));
      }
  }
}

// first and last key tile that query positions [first, last] can see;
// tile_span in kernels/flash_attention.py is the same function
__device__ __forceinline__ void tile_span(int first, int last, int n_tiles,
                                          const Problem& p, int* t0,
                                          int* t1) {
  *t1 = n_tiles - 1;
  if (p.causal) *t1 = min(*t1, last / kTileK);
  *t0 = 0;
  if (p.window > 0) *t0 = min(max(0, first - p.window + 1) / kTileK, *t1);
}

// kQuant: quantized scores (Eq. 2-3, P on the act grid); kMxint: the
// Eq. 14-19 exp datapath (else float exp); kB: the act block; kSplit: P
// goes into P.V as bf16 hi + mid + lo (float P, or act mantissas wider
// than kBf16MantBits), else as one bf16 (exact).  Compile-time, so that
// the row stages are straight-line code
template <bool kQuant, bool kMxint, int kB, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ lut_g,
                 __nv_bfloat16* __restrict__ out, int groups, Problem p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, ks = kv_stride(d);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + 2 * kTileK * ks;
  __nv_bfloat16* sq = sv + 2 * kTileK * ks;
  float* lut = reinterpret_cast<float*>(sq + kMmaRows * ks);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane / 4, tq = lane % 4;
  const int P = kMmaRows / groups;                  // positions per CTA
  const int n_blocks = gridDim.y;
  const int p0 = (n_blocks - 1 - (int)blockIdx.y) * P;  // longest first
  const int kvh = blockIdx.x;
  const int n_tiles = (p.n_keys + kTileK - 1) / kTileK;
  int t0, t1;
  tile_span(p0, min(p0 + P, p.n_rows) - 1, n_tiles, p, &t0, &t1);
  const __nv_bfloat16* kb = k + (size_t)kvh * p.n_keys * d;
  const __nv_bfloat16* vb = v + (size_t)kvh * p.n_keys * d;
  const int chunks = d / 8;                          // 16-byte row chunks

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * kTileK;
    __nv_bfloat16* dk = sk + buf * kTileK * ks;
    __nv_bfloat16* dv = sv + buf * kTileK * ks;
    for (int i = tid; i < kTileK * chunks; i += kMmaThreads) {
      const int j = i / chunks, c = (i % chunks) * 8;
      const bool ok = k0 + j < p.n_keys;
      const size_t off = ok ? (size_t)(k0 + j) * d + c : 0;
      cp_async16(dk + j * ks + c, kb + off, ok);
      cp_async16(dv + j * ks + c, vb + off, ok);
    }
  };
  // row i of the CTA: query head i / P at position p0 + i % P (idle past
  // the heads or the positions); its offset in q and out, in rows
  auto row_at = [&](int i, bool* ok) {
    const int head = i / P, pos = p0 + i % P;
    *ok = head < groups && pos < p.n_rows;
    return *ok ? ((size_t)kvh * groups + head) * p.n_rows + pos : 0;
  };
  for (int i = tid; i < kMmaRows * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    bool ok;
    const size_t row = row_at(r, &ok);
    cp_async16(sq + r * ks + c, q + row * d + c, ok);
  }
  load_tile(t0, 0);
  cp_async_commit();
  load_lut(lut, lut_g, p.lut_n);

  // this lane's two rows: h = 0 is row g of the warp, h = 1 row g + 8
  int pos[2];
  bool row_ok[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = warp * 16 + g + 8 * h;
    pos[h] = p0 + i % P;
    orow[h] = out + row_at(i, &row_ok[h]) * d;
  }
  float o[kMaxDT][4];
#pragma unroll
  for (int n = 0; n < kMaxDT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  const float lim = (float)((1 << (p.mant_bits - 1)) - 1);
  // ldmatrix row addresses of this lane (matrix lane / 8, row lane % 8)
  const int mi = lane / 8, mr = lane % 8;
  const int k_key = (mi / 2) * 8 + mr, k_col = (mi % 2) * 8;
  const int v_key = (mi % 2) * 8 + mr, v_col = (mi / 2) * 8;
  const __nv_bfloat16* wq = sq + (warp * 16 + v_key) * ks + v_col;

  for (int t = t0; t <= t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t < t1) load_tile(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* tk = sk + buf * kTileK * ks;
    const __nv_bfloat16* tv = sv + buf * kTileK * ks;
    const int k0 = t * kTileK;
    const bool last = t == n_tiles - 1;

    // S = Q K^T
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNarrowD / 16; ++kk) {
      if (kk * 16 >= d) break;
      uint32_t qa[4];                     // rows of the warp, d 16kk..+15
      ldsm_x4(qa, wq + kk * 16);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, tk + (jp * 16 + k_key) * ks + kk * 16 + k_col);
        mma_bf16(s[2 * jp], qa, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
      }
    }

    // row stages, one row of the lane at a time
    float alpha[2], lm[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the masks as bounds on c = 8j + e (this lane's key k0 + 2t + c),
      // tested where needed: registers are the scarce resource here
      const int rel = k0 + 2 * tq;
      const int khi = p.causal ? pos[h] - rel : INT_MAX;
      const int klo = p.window > 0 ? pos[h] - p.window + 1 - rel : INT_MIN;
      const int kreal = p.n_keys - rel;
      auto keep = [&](int j, int e) {
        return 8 * j + e >= klo && 8 * j + e <= khi;
      };
      auto real = [&](int j, int e) { return 8 * j + e < kreal; };
      float x[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[j][e] = keep(j, e) ? __fmul_rn(s[j][2 * h + e], p.scale)
                               : kNegInf;
          if (kQuant && !real(j, e)) x[j][e] = pow2_sel(-100);  // pad fill
        }
      if constexpr (kQuant) quantize_scores_row<kB>(x, p.mant_bits, lim);
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!real(j, e)) x[j][e] = kNegInf;
          tmax = fmaxf(tmax, x[j][e]);
        }
      const float m_prev = m_run[h];
      const float m_new = fmaxf(m_prev, quad_max(tmax));
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dt = __fsub_rn(x[j][e], m_new);
          float pr = kMxint ? exp2_datapath_sel(__fmul_rn(dt, p.log2e), lut,
                                             p.lut_n)
                             : exp_nonpos(dt);
          if constexpr (kQuant) {
            acc = __fadd_rn(acc, real(j, e) ? pr : 0.0f);
          } else {
            pr = keep(j, e) && real(j, e) ? pr : 0.0f;
            acc = __fadd_rn(acc, pr);
          }
          x[j][e] = pr;
        }
      const float psum = quad_sum(acc);
      float al = exp_nonpos(__fsub_rn(m_prev, m_new));
      if (m_prev <= kNegInfHalf) al = 0.0f;
      const float l_new = __fadd_rn(__fmul_rn(l_run[h], al), psum);
      lm[h] = 1.0f;
      inv[h] = 1.0f;
      if (last) {
        int le;
        lm[h] = frexpf(fmaxf(l_new, kMinL), &le);            // Eq. 20
        inv[h] = pow2_sel(-le);
      }
      if constexpr (kQuant) {
        if (last) {
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[j][e] = __fmul_rn(__fdiv_rn(x[j][e], lm[h]), inv[h]);
        }
        grid_requant_row<kB>(x, p.mant_bits, lim);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(keep(j, e) && real(j, e))) x[j][e] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s[j][2 * h + e] = x[j][e];
      alpha[h] = al;
      m_run[h] = m_new;
      l_run[h] = l_new;
    }

    // O = O * alpha (and, on the last tile of the quantized datapath, the
    // flush's / l_m * 2^-l_e before the last P.V joins), then O += P V
    const bool flush_first = last && kQuant;
#pragma unroll
    for (int n = 0; n < kMaxDT; ++n) {
      if (n * 8 >= d) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        float a = __fmul_rn(o[n][c], alpha[h]);
        if (flush_first) a = __fmul_rn(__fdiv_rn(a, lm[h]), inv[h]);
        o[n][c] = a;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      // the P fragment of keys 16kk .. 16kk + 15 is S's n-tiles 2kk, 2kk+1
      uint32_t pa[4], pm[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v0 = s[2 * kk + (r >> 1)][2 * (r & 1)];
        float v1 = s[2 * kk + (r >> 1)][2 * (r & 1) + 1];
        pa[r] = pack_bf16(v0, v1);
        if constexpr (kSplit) {      // P to f32 precision: hi + mid + lo
          v0 = __fsub_rn(v0, bf16_round(v0));
          v1 = __fsub_rn(v1, bf16_round(v1));
          pm[r] = pack_bf16(v0, v1);
          pl[r] = pack_bf16(__fsub_rn(v0, bf16_round(v0)),
                            __fsub_rn(v1, bf16_round(v1)));
        }
      }
#pragma unroll
      for (int dp = 0; dp < kMaxDT / 2; ++dp) {
        if (dp * 16 >= d) break;
        uint32_t b[4];
        ldsm_x4_trans(b, tv + (kk * 16 + v_key) * ks + dp * 16 + v_col);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
        if constexpr (kSplit) {
          mma_bf16(o[2 * dp], pm, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pm, b[2], b[3]);
          mma_bf16(o[2 * dp], pl, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    if (last && !kQuant) {
#pragma unroll
      for (int n = 0; n < kMaxDT; ++n) {
        if (n * 8 >= d) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[n][c] = __fmul_rn(__fdiv_rn(o[n][c], lm[c >> 1]), inv[c >> 1]);
      }
    }
    __syncthreads();              // the buffer is refilled two tiles on
  }
  if (t1 < n_tiles - 1) {
    // the tiles after t1 are fully masked for every row of the block: all
    // they would do is the last tile's normalization
    float lmv[2], invv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int le;
      lmv[h] = frexpf(fmaxf(l_run[h], kMinL), &le);
      invv[h] = pow2_sel(-le);
    }
#pragma unroll
    for (int n = 0; n < kMaxDT; ++n) {
      if (n * 8 >= d) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[n][c] = __fmul_rn(__fdiv_rn(o[n][c], lmv[c >> 1]), invv[c >> 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
#pragma unroll
    for (int n = 0; n < kMaxDT; ++n) {
      if (n * 8 >= d) break;
      *reinterpret_cast<uint32_t*>(orow[h] + n * 8 + 2 * tq) =
          pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 flash_attention at head dims 129-256: two warps a row group
// ---------------------------------------------------------------------------
// At D 256 the narrow kernel's O accumulator (D / 8 n-tiles of 4 floats a
// lane) would double to 128 registers beside S's 64, past the 255 a thread
// has.  Here the two warps of a row group split the work in halves: warp
// half hf computes S for keys [64 hf, 64 hf + 64) of the tile over the
// whole d (the q.k products in the narrow kernel's order: mma steps over
// d in order), runs the row stages on its 64 keys, and owns O's columns
// [128 hf, 128 hf + 128).  The row reductions that span both halves (the
// Eq. 2-3 row exponent max, the row max, the row sum) meet through shared
// memory at a named barrier of the pair, and each warp combines the two
// halves in the same order, so both hold the same m, l, alpha and 2^-l_e.
// P goes through shared memory as f32: each warp writes its half, and
// each reads all 128 keys of its rows for P.V.  A CTA holds 64 rows (4
// row groups, 8 warps); K and V tiles (66 KB each at D 256) are single
// buffers: K of the next tile loads during the row stages and P.V, V of
// the next tile during the next S.
constexpr int kWideRows = 64;
constexpr int kWideGroups = kWideRows / 16;
constexpr int kWideNT = kNT / 2;                   // key n-tiles of a half
constexpr int kWideDT = kNarrowD / 8;              // O n-tiles of a half
constexpr int kPStride = kTileK + 8;               // floats a P row

// shared memory: K tile | V tile | Q rows | P (f32) | exchange | LUT
__host__ __device__ constexpr size_t wide_smem_bytes(int d) {
  return (size_t)2 * kTileK * kv_stride(d) * 2 +
         (size_t)kWideRows * kv_stride(d) * 2 +
         sizeof(float) * ((size_t)kWideRows * kPStride +
                          (size_t)kWideGroups * 3 * 2 * 16 + kMaxLut);
}

__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(64));
}

// The value of this lane's row (quad-reduced already) from both halves of
// the pair, combined in half order: slot[half][row]
struct PairMax {
  float* slot;
  int half, row, group;
  bool writer;
  __device__ __forceinline__ int operator()(int v) const {
    if (writer) reinterpret_cast<int*>(slot)[half * 16 + row] = v;
    pair_sync(group);
    const int* s = reinterpret_cast<const int*>(slot);
    return max(s[row], s[16 + row]);
  }
  __device__ __forceinline__ float max_f(float v) const {
    if (writer) slot[half * 16 + row] = v;
    pair_sync(group);
    return fmaxf(slot[row], slot[16 + row]);
  }
  __device__ __forceinline__ float sum_f(float v) const {
    if (writer) slot[half * 16 + row] = v;
    pair_sync(group);
    return __fadd_rn(slot[row], slot[16 + row]);
  }
};

template <bool kQuant, bool kMxint, int kB, bool kSplit>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_mma_wide_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ lut_g,
                      __nv_bfloat16* __restrict__ out, int groups,
                      Problem p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, ks = kv_stride(d);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + kTileK * ks;
  __nv_bfloat16* sq = sv + kTileK * ks;
  float* sp = reinterpret_cast<float*>(sq + kWideRows * ks);
  float* sx = sp + kWideRows * kPStride;
  float* lut = sx + kWideGroups * 3 * 2 * 16;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / 2, hf = warp % 2;           // row group, half
  const int P = kWideRows / groups;                 // positions per CTA
  const int n_blocks = gridDim.y;
  const int p0 = (n_blocks - 1 - (int)blockIdx.y) * P;  // longest first
  const int kvh = blockIdx.x;
  const int n_tiles = (p.n_keys + kTileK - 1) / kTileK;
  int t0, t1;
  tile_span(p0, min(p0 + P, p.n_rows) - 1, n_tiles, p, &t0, &t1);
  const __nv_bfloat16* kb = k + (size_t)kvh * p.n_keys * d;
  const __nv_bfloat16* vb = v + (size_t)kvh * p.n_keys * d;
  const int chunks = d / 8;                          // 16-byte row chunks

  auto load_kv = [&](const __nv_bfloat16* src, __nv_bfloat16* dst, int t) {
    const int k0 = t * kTileK;
    for (int i = tid; i < kTileK * chunks; i += kMmaThreads) {
      const int j = i / chunks, c = (i % chunks) * 8;
      const bool ok = k0 + j < p.n_keys;
      cp_async16(dst + j * ks + c, src + (ok ? (size_t)(k0 + j) * d + c : 0),
                 ok);
    }
  };
  auto row_at = [&](int i, bool* ok) {
    const int head = i / P, pos = p0 + i % P;
    *ok = head < groups && pos < p.n_rows;
    return *ok ? ((size_t)kvh * groups + head) * p.n_rows + pos : 0;
  };
  for (int i = tid; i < kWideRows * chunks; i += kMmaThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    bool ok;
    const size_t row = row_at(r, &ok);
    cp_async16(sq + r * ks + c, q + row * d + c, ok);
  }
  load_kv(kb, sk, t0);
  cp_async_commit();                               // Q and K(t0)
  load_kv(vb, sv, t0);
  cp_async_commit();                               // V(t0)
  load_lut(lut, lut_g, p.lut_n);

  int pos[2];
  bool row_ok[2];
  __nv_bfloat16* orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = rg * 16 + g + 8 * h;
    pos[h] = p0 + i % P;
    orow[h] = out + row_at(i, &row_ok[h]) * d;
  }
  const int c0 = hf * kNarrowD;                    // this warp's O columns
  float o[kWideDT][4];
#pragma unroll
  for (int n = 0; n < kWideDT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  const float lim = (float)((1 << (p.mant_bits - 1)) - 1);
  const int mi = lane / 8, mr = lane % 8;
  const int k_key = (mi / 2) * 8 + mr, k_col = (mi % 2) * 8;
  const int v_key = (mi % 2) * 8 + mr, v_col = (mi / 2) * 8;
  const __nv_bfloat16* wq = sq + (rg * 16 + v_key) * ks + v_col;
  float* prow = sp + (rg * 16 + g) * kPStride;     // row g; row g + 8 below
  float* xslot = sx + rg * 3 * 2 * 16;

  for (int t = t0; t <= t1; ++t) {
    cp_async_wait_prev();                          // K(t) (and Q) landed
    __syncthreads();
    const int k0 = t * kTileK;
    const bool last = t == n_tiles - 1;

    // S = Q K^T for this half's 64 keys
    float s[kWideNT][4];
#pragma unroll
    for (int j = 0; j < kWideNT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      if (kk * 16 >= d) break;
      uint32_t qa[4];
      ldsm_x4(qa, wq + kk * 16);
#pragma unroll
      for (int jp = 0; jp < kWideNT / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, sk + (hf * 64 + jp * 16 + k_key) * ks + kk * 16 + k_col);
        mma_bf16(s[2 * jp], qa, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
      }
    }
    __syncthreads();                               // K tile read by all
    if (t < t1) load_kv(kb, sk, t + 1);
    cp_async_commit();                             // K(t + 1)

    float alpha[2], lm[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rel = k0 + hf * 64 + 2 * tq;
      const int khi = p.causal ? pos[h] - rel : INT_MAX;
      const int klo = p.window > 0 ? pos[h] - p.window + 1 - rel : INT_MIN;
      const int kreal = p.n_keys - rel;
      auto keep = [&](int j, int e) {
        return 8 * j + e >= klo && 8 * j + e <= khi;
      };
      auto real = [&](int j, int e) { return 8 * j + e < kreal; };
      float x[kWideNT][2];
#pragma unroll
      for (int j = 0; j < kWideNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[j][e] = keep(j, e) ? __fmul_rn(s[j][2 * h + e], p.scale)
                               : kNegInf;
          if (kQuant && !real(j, e)) x[j][e] = pow2_sel(-100);  // pad fill
        }
      if constexpr (kQuant) {
        const PairMax em{xslot + 2 * 16 * 0, hf, g + 8 * h, rg, tq == 0};
        quantize_scores_row<kB>(x, p.mant_bits, lim, em);
      }
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kWideNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!real(j, e)) x[j][e] = kNegInf;
          tmax = fmaxf(tmax, x[j][e]);
        }
      const float m_prev = m_run[h];
      const PairMax mx{xslot + 2 * 16 * 1, hf, g + 8 * h, rg, tq == 0};
      const float m_new = fmaxf(m_prev, mx.max_f(quad_max(tmax)));
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kWideNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dt = __fsub_rn(x[j][e], m_new);
          float pr = kMxint ? exp2_datapath_sel(__fmul_rn(dt, p.log2e), lut,
                                                p.lut_n)
                            : exp_nonpos(dt);
          if constexpr (kQuant) {
            acc = __fadd_rn(acc, real(j, e) ? pr : 0.0f);
          } else {
            pr = keep(j, e) && real(j, e) ? pr : 0.0f;
            acc = __fadd_rn(acc, pr);
          }
          x[j][e] = pr;
        }
      const PairMax sm{xslot + 2 * 16 * 2, hf, g + 8 * h, rg, tq == 0};
      const float psum = sm.sum_f(quad_sum(acc));
      float al = exp_nonpos(__fsub_rn(m_prev, m_new));
      if (m_prev <= kNegInfHalf) al = 0.0f;
      const float l_new = __fadd_rn(__fmul_rn(l_run[h], al), psum);
      lm[h] = 1.0f;
      inv[h] = 1.0f;
      if (last) {
        int le;
        lm[h] = frexpf(fmaxf(l_new, kMinL), &le);            // Eq. 20
        inv[h] = pow2_sel(-le);
      }
      if constexpr (kQuant) {
        if (last) {
#pragma unroll
          for (int j = 0; j < kWideNT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              x[j][e] = __fmul_rn(__fdiv_rn(x[j][e], lm[h]), inv[h]);
        }
        grid_requant_row<kB>(x, p.mant_bits, lim);
#pragma unroll
        for (int j = 0; j < kWideNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!(keep(j, e) && real(j, e))) x[j][e] = 0.0f;
      }
      // this half's P of the row into shared memory
      float* pw = prow + 8 * h * kPStride + hf * 64 + 2 * tq;
#pragma unroll
      for (int j = 0; j < kWideNT; ++j)
        *reinterpret_cast<float2*>(pw + 8 * j) = make_float2(x[j][0], x[j][1]);
      alpha[h] = al;
      m_run[h] = m_new;
      l_run[h] = l_new;
    }

    const bool flush_first = last && kQuant;
#pragma unroll
    for (int n = 0; n < kWideDT; ++n) {
      if (c0 + n * 8 >= d) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        float a = __fmul_rn(o[n][c], alpha[h]);
        if (flush_first) a = __fmul_rn(__fdiv_rn(a, lm[h]), inv[h]);
        o[n][c] = a;
      }
    }
    cp_async_wait_prev();                          // V(t) landed
    __syncthreads();                               // and both halves' P
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      // P of keys 16kk .. 16kk + 15, rows g and g + 8, as an A fragment
      uint32_t pa[4], pmid[4], plo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 pv = *reinterpret_cast<const float2*>(
            prow + 8 * (r & 1) * kPStride + 16 * kk + 8 * (r >> 1) + 2 * tq);
        float v0 = pv.x, v1 = pv.y;
        pa[r] = pack_bf16(v0, v1);
        if constexpr (kSplit) {      // P to f32 precision: hi + mid + lo
          v0 = __fsub_rn(v0, bf16_round(v0));
          v1 = __fsub_rn(v1, bf16_round(v1));
          pmid[r] = pack_bf16(v0, v1);
          plo[r] = pack_bf16(__fsub_rn(v0, bf16_round(v0)),
                             __fsub_rn(v1, bf16_round(v1)));
        }
      }
#pragma unroll
      for (int dp = 0; dp < kWideDT / 2; ++dp) {
        if (c0 + dp * 16 >= d) break;
        uint32_t b[4];
        ldsm_x4_trans(b, sv + (kk * 16 + v_key) * ks + c0 + dp * 16 + v_col);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
        if constexpr (kSplit) {
          mma_bf16(o[2 * dp], pmid, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pmid, b[2], b[3]);
          mma_bf16(o[2 * dp], plo, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], plo, b[2], b[3]);
        }
      }
    }
    if (last && !kQuant) {
#pragma unroll
      for (int n = 0; n < kWideDT; ++n) {
        if (c0 + n * 8 >= d) break;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          o[n][c] = __fmul_rn(__fdiv_rn(o[n][c], lm[c >> 1]), inv[c >> 1]);
      }
    }
    __syncthreads();                               // V tile and P read
    if (t < t1) load_kv(vb, sv, t + 1);
    cp_async_commit();                             // V(t + 1)
  }
  cp_async_wait_all();
  if (t1 < n_tiles - 1) {
    // the tiles after t1 are fully masked for every row of the block: all
    // they would do is the last tile's normalization
    float lmv[2], invv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int le;
      lmv[h] = frexpf(fmaxf(l_run[h], kMinL), &le);
      invv[h] = pow2_sel(-le);
    }
#pragma unroll
    for (int n = 0; n < kWideDT; ++n) {
      if (c0 + n * 8 >= d) break;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[n][c] = __fmul_rn(__fdiv_rn(o[n][c], lmv[c >> 1]), invv[c >> 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
#pragma unroll
    for (int n = 0; n < kWideDT; ++n) {
      if (c0 + n * 8 >= d) break;
      *reinterpret_cast<uint32_t*>(orow[h] + c0 + n * 8 + 2 * tq) =
          pack_bf16(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_attention_decode
// ---------------------------------------------------------------------------
// Replaces repro/kernels/flash_attention.py:322 (flash_attention_decode; its
// pallas_call at :366 over _decode_kernel at :282).  One query position a
// row: the G query heads of a (batch row, KV head) problem read one head of
// the cache ring, in the cache's (B, W, Hkv, D) layout, with the batch
// row's validity row.
//
// What bounds it: its bound is bytes, one pass over the valid slots of K
// and V (Llama-3-8B at batch 4, rows 37/700/1500/2048: 17.6 MB, 0.0053 ms
// at 3.35 TB/s) against 4 G D product operations a key.  But every sum is
// an ordered chain (bit for bit with decode_rows), 128 keys or D long,
// every multiply and add a separate instruction, and the MXInt row stages
// run a warp a row: a CTA's phases are latency-bound chains, and the
// scores and row stages are repeated in each of a problem's n_split CTAs,
// so the SMs' instruction issue limits it long before the bytes do.  The
// design puts a CTA on every SM, overlaps the phases, wastes no rows and
// walks no tile after the last valid slot:
//
// - geometry (decode_geometry in kernels/flash_attention.py): a CTA takes
//   ROWS <= 8 of the problem's G rows (templated: no idle rows at G <= 8)
//   and one slice of `cols` of the D output columns, n_split = ceil(D /
//   cols) slices a problem; Llama's batch 4 (32 problems, G 4, D 128) runs
//   128 CTAs of 4 rows x 32 columns.  Each CTA of a problem computes all its
//   scores and row stages (K is read by the siblings side by side, so L2
//   serves the repeats) and the P.V of its own columns.  The k axis is never
//   split.
// - the tile stop: the rows of a problem share one validity row, so the CTA
//   finds the last tile t_v that holds a valid slot and walks [0, t_v]; a
//   t_v before the ring's last tile runs as an interior tile, then the
//   normalization-only epilogue.  Exact: decode_rows(skip_tiles=True) is the
//   same function and equals the walk over every tile bit for bit.  A
//   served ring (rows <= 1024 of 2048 slots) walks at most half its tiles.
// - a pipeline over warp roles: a tile's phases (scores, row stages, P.V,
//   loads) are each latency-bound chains, too few to fill the SM's
//   schedulers, so they run side by side on warps of their own, with one
//   __syncthreads a step.  In step t, 4 score warps compute tile t + 1's
//   scores (thread j: the ROWS scores of key j, each over d in order); a
//   row warp per row runs tile t's row stages (row_stages: lanes l, l+32,
//   l+64, l+96), its validity read a step early; 4 P.V warps issue the
//   loads of K tile t + 2 and V tile t, then compute tile t - 1's P.V
//   (thread i: the chains (row, column) i, i + 128, ..., each over the
//   tile's real keys in order, the running output in a register).  Scores
//   have three buffers, K, V and alpha two.
// - loads: 16-byte cp.async of K tiles and this CTA's columns of V tiles,
//   kept in their dtype and made f32 at use.  A K row is an odd number of
//   16-byte chunks, so 8 threads reading 16 bytes of 8 consecutive keys
//   hit all 32 banks.  Head dims that are not whole chunks, or unaligned
//   operands, load element by element.
constexpr int kDecMaxRows = 8;
constexpr int kDecGroup = 128;                // score and P.V threads each
constexpr int kScoreStride = kTileK + 4;      // floats between score rows

// threads of a CTA: 4 score warps | 4 P.V warps | a row warp per row
__host__ __device__ constexpr int dec_threads(int rows) {
  return 2 * kDecGroup + rows * kWarp;
}

template <typename T>
__host__ __device__ constexpr int vec_of() {
  return 16 / (int)sizeof(T);                 // elements in 16 bytes
}

// K tile row stride, in elements: whole 16-byte chunks, an odd number
template <typename T>
__host__ __device__ constexpr int dec_k_stride(int d) {
  return (((d + vec_of<T>() - 1) / vec_of<T>()) | 1) * vec_of<T>();
}

template <typename T>
__host__ __device__ constexpr int dec_v_stride(int cols) {
  return (cols + vec_of<T>() - 1) / vec_of<T>() * vec_of<T>();
}

// q rows as f32 in whole 8-value chunks (zero past d)
__host__ __device__ constexpr int dec_q_stride(int d) {
  return (d + 7) / 8 * 8;
}

// shared memory: K tiles (kbuf) | V tiles (2) | q rows | scores (3) | row
// state (m, l, alpha x 2, l_m, 2^-l_e) | LUT | the last valid slot
template <typename T>
__host__ __device__ constexpr size_t dec_smem_bytes(int rows, int d,
                                                    int cols, int kbuf) {
  return (size_t)kTileK *
             (kbuf * dec_k_stride<T>(d) + 2 * dec_v_stride<T>(cols)) *
             sizeof(T) +
         sizeof(float) * ((size_t)rows * (dec_q_stride(d) +
                                          3 * kScoreStride + 6) +
                          kMaxLut) +
         sizeof(int);
}

// 16 bytes of shared memory as f32 values
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // bf16 is the top half of f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// N f32 values from 16-byte aligned shared memory
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + i);
    x[i] = u.x;
    x[i + 1] = u.y;
    x[i + 2] = u.z;
    x[i + 3] = u.w;
  }
}

// rows [0, min(rows, 128)) x chunks [0, n) of 16 bytes from src (row
// stride ss) to dst (row stride ds), thread i0 of nt's share: chunk i = i0
// + nt m is row i / n, column (i % n) * vec, walked without divides; rows
// from `rows` on are zero-filled
template <typename T>
__device__ __forceinline__ void cp_tile(T* dst, int ds, const T* src,
                                        size_t ss, int n, int rows, int i0,
                                        int nt) {
  constexpr int VEC = vec_of<T>();
  const int dj = nt / n, dc = nt % n;
  int j = i0 / n, c = i0 % n;
  while (j < kTileK) {
    const bool ok = j < rows;
    cp_async16(dst + j * ds + c * VEC, src + (ok ? j * ss + c * VEC : 0), ok);
    j += dj;
    c += dc;
    if (c >= n) {
      c -= n;
      ++j;
    }
  }
}

// the same, element by element, by `nt` threads (head dims that are not
// whole chunks, or unaligned operands); rows past `rows` are zero
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ds, const T* src,
                                          size_t ss, int n, int rows, int i0,
                                          int nt) {
  for (int i = i0; i < kTileK * n; i += nt) {
    const int j = i / n, c = i % n;
    if (j < rows)
      dst[j * ds + c] = src[j * ss + c];
    else
      store(dst + j * ds + c, 0.0f);
  }
}

struct DecodeGrid {
  int hkv;          // KV heads
  int row_blocks;   // CTAs along G
  int n_split;      // CTAs along D: column slices
  int cols;         // columns a slice
  int vec;          // 16-byte cp.async loads (D whole chunks, aligned)
  int kbuf;         // K tile buffers: 2, or 1 where two do not fit (f32
                    // at D > 128); with one, the score warps load K
};

template <typename T, int ROWS>
__global__ void __launch_bounds__(dec_threads(ROWS))
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid,
              const float* __restrict__ lut_g, T* __restrict__ out,
              DecodeGrid gr, Problem p) {
  constexpr int VEC = vec_of<T>();
  constexpr int THREADS = dec_threads(ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, W = p.n_keys;
  const int ks = dec_k_stride<T>(d), vs = dec_v_stride<T>(gr.cols);
  const int qs = dec_q_stride(d);
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + gr.kbuf * kTileK * ks;
  float* sq = reinterpret_cast<float*>(sv + 2 * kTileK * vs);
  float* ss = sq + ROWS * qs;                         // 3 x ROWS x 132
  float* sm = ss + 3 * ROWS * kScoreStride;
  float* sl = sm + ROWS;
  float* salpha = sl + ROWS;                          // 2 x ROWS
  float* slm = salpha + 2 * ROWS;
  float* sinv = slm + ROWS;
  float* lut = sinv + ROWS;
  int* s_last = reinterpret_cast<int*>(lut + kMaxLut);

  // blockIdx.x = (problem * row_blocks + row block) * n_split + slice: the
  // slices of a problem run side by side
  int blk = blockIdx.x;
  const int slice = blk % gr.n_split;
  blk /= gr.n_split;
  const int row0 = (blk % gr.row_blocks) * ROWS;
  const int prob = blk / gr.row_blocks;                 // b * hkv + h
  const int b = prob / gr.hkv, h = prob % gr.hkv;
  const int rows = min(ROWS, p.n_rows - row0);
  const int c0 = slice * gr.cols, ncol = min(gr.cols, d - c0);
  const size_t head = ((size_t)b * W * gr.hkv + h) * d;  // key 0 of the head
  const T* kb = k + head;
  const T* vb = v + head + c0;
  const int* vrow = valid + (size_t)b * W;
  const size_t qoff = ((size_t)prob * p.n_rows + row0) * d;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n_tiles = (W + kTileK - 1) / kTileK;
  // roles: score warps 0-3 (thread tid: key tid), P.V warps 4-7 (thread
  // lt), row warps 8.. (row rw)
  const bool is_score = tid < kDecGroup;
  const bool is_pv = !is_score && tid < 2 * kDecGroup;
  const int lt = tid - kDecGroup, rw = warp - 2 * kDecGroup / kWarp;

  // K tile t into buffer t & (kbuf - 1), by the 128 threads i0 of a
  // group, and V tile t (this CTA's columns) into buffer t & 1, by the P.V
  // warps: 16-byte cp.async, or element by element
  const int kmask = gr.kbuf - 1;
  auto load_k = [&](int t, int i0) {
    const int k0 = t * kTileK, n = W - k0;
    T* dst = sk + (t & kmask) * kTileK * ks;
    const T* src = kb + (size_t)k0 * p.key_stride;
    if (gr.vec)
      cp_tile(dst, ks, src, p.key_stride, d / VEC, n, i0, kDecGroup);
    else
      copy_tile(dst, ks, src, p.key_stride, d, n, i0, kDecGroup);
  };
  auto load_v = [&](int t) {
    const int k0 = t * kTileK, n = W - k0;
    T* dst = sv + (t & 1) * kTileK * vs;
    const T* src = vb + (size_t)k0 * p.key_stride;
    if (gr.vec)
      cp_tile(dst, vs, src, p.key_stride, ncol / VEC, n, lt, kDecGroup);
    else
      copy_tile(dst, vs, src, p.key_stride, ncol, n, lt, kDecGroup);
  };

  if (is_pv) load_k(0, lt);
  cp_async_commit();
  load_lut(lut, lut_g, p.lut_n);
  for (int i = tid; i < ROWS * qs; i += THREADS) {
    const int r = i / qs, c = i % qs;
    sq[i] = r < rows && c < d ? to_f32(q[qoff + (size_t)r * d + c]) : 0.0f;
  }
  if (!gr.vec) {
    // the score loop reads K in whole chunks: zero the buffers past d
    const int pad = ks - d;
    for (int i = tid; i < gr.kbuf * kTileK * pad; i += THREADS)
      store(sk + (i / pad) * ks + d + i % pad, 0.0f);
  }
  if (tid < ROWS) {
    sm[tid] = kNegInf;
    sl[tid] = 0.0f;
  }
  if (tid == 0) *s_last = -1;
  __syncthreads();
  // the last valid slot of the ring: the tiles after its tile hold none
  int last_slot = -1;
  for (int i = tid; i < W; i += THREADS)
    if (vrow[i] != 0) last_slot = i;
  last_slot = __reduce_max_sync(kFull, last_slot);
  if (lane == 0) atomicMax(s_last, last_slot);
  cp_async_wait_all();
  __syncthreads();
  const int t_stop = *s_last < 0 ? n_tiles - 1 : *s_last / kTileK;

  // P.V warps: chain lt + 128 i is (row, column) (ch / ncol, ch % ncol)
  const int n_chains = rows * ncol;
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.0f;
  // row warps: the validity of the next tile's keys, loaded a step early
  int vnext[kPerLane];
#pragma unroll
  for (int c = 0; c < kPerLane; ++c) {
    const int key = lane + kWarp * c;
    vnext[c] = key < W ? vrow[key] : 1;
  }

  // step t: scores of tile t + 1, row stages of tile t, P.V of tile t - 1
  for (int t = -1; t <= t_stop + 1; ++t) {
    if (is_score) {
      const int ts = t + 1;
      if (ts <= t_stop) {
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
        const T* kr = sk + (ts & kmask) * kTileK * ks + tid * ks;
        for (int c = 0; c < d; c += VEC) {
          float kf[VEC];
          load_chunk(kr + c, kf);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            float qf[VEC];
            load_f32(sq + r * qs + c, qf);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s[r] = __fadd_rn(s[r], __fmul_rn(qf[e], kf[e]));
          }
        }
        float* so = ss + (ts % 3) * ROWS * kScoreStride + tid;
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          so[r * kScoreStride] = __fmul_rn(s[r], p.scale);
      }
      if (gr.kbuf == 1) {
        // one K buffer: once every score warp has read it, the next tile
        asm volatile("bar.sync 1, %0;\n" ::"r"(kDecGroup));
        if (t + 2 <= t_stop) load_k(t + 2, tid);
        cp_async_commit();
      }
    } else if (is_pv) {
      if (gr.kbuf == 2 && t + 2 <= t_stop) load_k(t + 2, lt);
      if (t >= 0 && t <= t_stop) load_v(t);
      cp_async_commit();
      const int tp = t - 1;
      if (tp >= 0) {
        const int nk = min(kTileK, W - tp * kTileK);
        const bool last = tp == n_tiles - 1;
        const float* sp = ss + (tp % 3) * ROWS * kScoreStride;
        const T* tv = sv + (tp & 1) * kTileK * vs;
        const float* alpha = salpha + (tp & 1) * ROWS;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int ch = lt + kDecGroup * i;
          if (ch >= n_chains) continue;
          const int r = ch / ncol, col = ch % ncol;
          const float* pr = sp + r * kScoreStride;
          const T* vc = tv + col;
          float dot = 0.0f;
          int j = 0;
#pragma unroll 2
          for (; j + 8 <= nk; j += 8) {   // loads of 8 keys, then their adds
            float pj[8], vj[8];
            load_f32(pr + j, pj);
#pragma unroll
            for (int e = 0; e < 8; ++e) vj[e] = to_f32(vc[(j + e) * vs]);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dot = __fadd_rn(dot, __fmul_rn(pj[e], vj[e]));
          }
          for (; j < nk; ++j)
            dot = __fadd_rn(dot, __fmul_rn(pr[j], to_f32(vc[j * vs])));
          const float a = __fmul_rn(acc[i], alpha[r]);
          T* o = out + qoff + (size_t)r * d + c0 + col;
          if (last && p.quantize)
            store(o,
                  __fadd_rn(__fmul_rn(__fdiv_rn(a, slm[r]), sinv[r]), dot));
          else if (last)
            store(o,
                  __fmul_rn(__fdiv_rn(__fadd_rn(a, dot), slm[r]), sinv[r]));
          else
            acc[i] = __fadd_rn(a, dot);
        }
      }
    } else if (t >= 0 && t <= t_stop) {
      const int k0 = t * kTileK;
      bool keep[kPerLane];
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        keep[c] = vnext[c] != 0;
        const int key = k0 + kTileK + lane + kWarp * c;
        if (t < t_stop) vnext[c] = key < W ? vrow[key] : 1;
      }
      if (rw < rows)
        row_stages(ss + (t % 3) * ROWS * kScoreStride + rw * kScoreStride,
                   keep, k0, t == n_tiles - 1, p, lut, sm + rw, sl + rw,
                   salpha + (t & 1) * ROWS + rw, slm + rw, sinv + rw, lane);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (is_pv && t_stop < n_tiles - 1) {
    // stopped before the ring's last tile: all it would do is normalize
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int ch = lt + kDecGroup * i;
      if (ch >= n_chains) continue;
      const int r = ch / ncol, col = ch % ncol;
      int le;
      const float lm = frexpf(fmaxf(sl[r], kMinL), &le);
      store(out + qoff + (size_t)r * d + c0 + col,
            __fmul_rn(__fdiv_rn(acc[i], lm), pow2i(-le)));
    }
  }
}

// above 48 KB a kernel's dynamic shared memory needs an explicit opt-in
template <typename K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct MmaLaunch {
  const __nv_bfloat16 *q, *k, *v;
  const float* lut;
  __nv_bfloat16* out;
  int groups, n_kv;
  Problem p;
  cudaStream_t st;
};

// query rows a CTA of the bf16 route holds at head dim d
int mma_rows(int d) { return d > kNarrowD ? kWideRows : kMmaRows; }

template <bool kQuant, bool kMxint, int kB, bool kSplit = !kQuant>
int launch_mma(const MmaLaunch& l) {
  const bool wide = l.p.d > kNarrowD;
  auto* kern = wide ? flash_mma_wide_kernel<kQuant, kMxint, kB, kSplit>
                    : flash_mma_kernel<kQuant, kMxint, kB, kSplit>;
  const int per_block = mma_rows(l.p.d) / l.groups;
  // x: KV heads, y: position blocks (the kernel walks them longest first)
  const dim3 grid(l.n_kv, (l.p.n_rows + per_block - 1) / per_block);
  const size_t smem = wide ? wide_smem_bytes(l.p.d) : mma_smem_bytes(l.p.d);
  int rc = allow_smem(kern, smem);
  if (rc) return rc;
  QUERY_OR_LAUNCH(kern, grid, dim3(kMmaThreads), smem);
  kern<<<grid, kMmaThreads, smem, l.st>>>(l.q, l.k, l.v, l.lut, l.out,
                                          l.groups, l.p);
  return (int)cudaGetLastError();
}

struct DecodeLaunch {
  const void *q, *k, *v;
  const int* valid;
  const float* lut;
  void* out;
  int n_problems;   // B * Hkv
  DecodeGrid gr;
  Problem p;
  cudaStream_t st;
};

template <typename T, int ROWS>
int launch_decode(DecodeLaunch l) {
  auto* kern = decode_kernel<T, ROWS>;
  int dev = 0, optin = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (rc) return rc;
  l.gr.kbuf =
      dec_smem_bytes<T>(ROWS, l.p.d, l.gr.cols, 2) <= (size_t)optin ? 2 : 1;
  const size_t smem = dec_smem_bytes<T>(ROWS, l.p.d, l.gr.cols, l.gr.kbuf);
  rc = allow_smem(kern, smem);
  if (rc) return rc;
  const unsigned grid =
      (unsigned)l.n_problems * l.gr.row_blocks * l.gr.n_split;
  QUERY_OR_LAUNCH(kern, dim3(grid), dim3(dec_threads(ROWS)), smem);
  kern<<<grid, dec_threads(ROWS), smem, l.st>>>(
      (const T*)l.q, (const T*)l.k, (const T*)l.v, l.valid, l.lut, (T*)l.out,
      l.gr, l.p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode_rows(const DecodeLaunch& l, int rows) {
  switch (rows) {
    case 1: return launch_decode<T, 1>(l);
    case 2: return launch_decode<T, 2>(l);
    case 3: return launch_decode<T, 3>(l);
    case 4: return launch_decode<T, 4>(l);
    case 5: return launch_decode<T, 5>(l);
    case 6: return launch_decode<T, 6>(l);
    case 7: return launch_decode<T, 7>(l);
    default: return launch_decode<T, 8>(l);  // checked: rows <= 8
  }
}

// ---------------------------------------------------------------------------
// the generic route: every format of the reference
// ---------------------------------------------------------------------------
// Any head dim, any G, score act blocks up to 128 (the reference's
// _resolve_block(128, block)), any LUT length, bf16 or f32 operands: what
// neither kernel above takes.  A warp runs one query row through the
// ordered kernel's steps in its order (attend_rows in
// kernels/flash_attention.py): per tile, lane l's keys l + 32 c, each q.k
// over d in order from device memory, then row_stages, then the P.V of
// the lane's columns l, l + 32, ... over the tile's keys in order.  Its q
// row, running acc, scores and row state sit in shared memory; K, V and
// the LUT are read from device memory.  Every tile is walked (the tiles
// the fast kernels skip leave the row state as it is, see attend_rows).
// Decode: row R of (B, Hkv, G) reads the ring of batch row R / (Hkv G), KV
// head R / G % Hkv, keys masked by valid.
constexpr int kGenFlashWarps = 4;

__host__ __device__ __forceinline__ int gen_row_floats(int d) {
  return 2 * d + kTileK + 8;
}

struct GenFlash {
  int rows;        // rows of the launch: bh * sq, or b * hkv * g
  int groups;      // flash: query heads a KV head
  int hkv, g;      // decode
};

template <typename T, bool DECODE>
__global__ void __launch_bounds__(kGenFlashWarps * kWarp)
flash_generic_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ valid,
                     const float* __restrict__ lut, T* __restrict__ out,
                     GenFlash gf, Problem p) {
  extern __shared__ __align__(16) float gsm[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp, d = p.d;
  float* sq_ = gsm + (size_t)warp * gen_row_floats(d);
  float* sacc = sq_ + d;
  float* ss = sacc + d;
  float* st = ss + kTileK;           // m, l, alpha, l_m, 2^-l_e
  size_t row;                        // the output row
  const T* kb;                       // key 0 of this row's K (and V) head
  const int* vrow = nullptr;
  int qpos = 0;
  if constexpr (DECODE) {
    const int R = blockIdx.x * nw + warp;
    if (R >= gf.rows) return;
    const int bi = R / (gf.hkv * gf.g), hh = R / gf.g % gf.hkv;
    row = R;
    kb = k + ((size_t)bi * p.n_keys * gf.hkv + hh) * d;
    vrow = valid + (size_t)bi * p.n_keys;
  } else {
    const int h = blockIdx.y;
    qpos = blockIdx.x * nw + warp;
    if (qpos >= p.n_rows) return;
    row = (size_t)h * p.n_rows + qpos;
    kb = k + (size_t)(h / gf.groups) * p.n_keys * d;
  }
  const T* vb = v + (kb - k);
  for (int c = lane; c < d; c += kWarp) {
    sq_[c] = to_f32(q[row * d + c]);
    sacc[c] = 0.0f;
  }
  if (lane == 0) {
    st[0] = kNegInf;
    st[1] = 0.0f;
  }
  __syncwarp();
  const int n_tiles = (p.n_keys + kTileK - 1) / kTileK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileK;
    const int nk = min(kTileK, p.n_keys - k0);
    const bool last = t == n_tiles - 1;
    bool keep[kPerLane];
#pragma unroll
    for (int c = 0; c < kPerLane; ++c) {
      const int j = lane + kWarp * c;
      float s = 0.0f;
      if (j < nk) {
        const T* kr = kb + (size_t)(k0 + j) * p.key_stride;
        for (int e = 0; e < d; ++e)
          s = __fadd_rn(s, __fmul_rn(sq_[e], to_f32(kr[e])));
      }
      ss[j] = __fmul_rn(s, p.scale);
    }
    if constexpr (DECODE) {
#pragma unroll
      for (int c = 0; c < kPerLane; ++c) {
        const int key = k0 + lane + kWarp * c;
        keep[c] = key >= p.n_keys || vrow[key] != 0;
      }
    } else {
      lane_keep(qpos, k0, p, lane, keep);
    }
    __syncwarp();
    row_stages<true>(ss, keep, k0, last, p, lut, st, st + 1, st + 2, st + 3,
                     st + 4, lane);
    __syncwarp();
    const float alpha = st[2], lm = st[3], inv = st[4];
    for (int col = lane; col < d; col += kWarp) {
      float dot = 0.0f;
      for (int j = 0; j < nk; ++j)
        dot = __fadd_rn(dot, __fmul_rn(ss[j], to_f32(
                                                  vb[(size_t)(k0 + j) *
                                                         p.key_stride +
                                                     col])));
      const float a = __fmul_rn(sacc[col], alpha);
      if (last && p.quantize) {
        store(out + row * d + col,
              __fadd_rn(__fmul_rn(__fdiv_rn(a, lm), inv), dot));
      } else {
        const float acc = __fadd_rn(a, dot);
        if (last)
          store(out + row * d + col, __fmul_rn(__fdiv_rn(acc, lm), inv));
        else
          sacc[col] = acc;
      }
    }
    __syncwarp();
  }
}

bool bad_generic(const Problem& p, int warps) {
  const int b = p.block;
  return p.d < 1 || b < 1 || b > kTileK || (b & (b - 1)) != 0 ||
         p.lut_n < 1 || p.n_keys < 1 || p.n_rows < 1 || warps < 1 ||
         warps > kGenFlashWarps || (p.quantize && !p.mxint);
}

template <typename T, bool DECODE>
int launch_generic(const void* q, const void* k, const void* v,
                   const int* valid, const float* lut, void* out, dim3 grid,
                   int warps, const GenFlash& gf, const Problem& p,
                   cudaStream_t st) {
  auto* kern = flash_generic_kernel<T, DECODE>;
  const size_t smem = (size_t)warps * gen_row_floats(p.d) * sizeof(float);
  int rc = allow_smem(kern, smem);
  if (rc) return rc;
  QUERY_OR_LAUNCH(kern, grid, dim3(warps * kWarp), smem);
  kern<<<grid, warps * kWarp, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, valid, lut, (T*)out, gf, p);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    // the tensor-core route (see the header)
    if (d % 16 != 0 || groups > mma_rows(d)) return (int)cudaErrorInvalidValue;
    if (quantize && !mxint) return (int)cudaErrorInvalidValue;
    const MmaLaunch l{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                      (const __nv_bfloat16*)v, lut, (__nv_bfloat16*)out,
                      groups, bh / groups, p, st};
    if (!mxint) return launch_mma<false, false, 1>(l);
    if (!quantize) return launch_mma<false, true, 1>(l);
    if (mant_bits > kBf16MantBits) {     // P's grid values exceed bf16
      switch (block) {
        case 1: return launch_mma<true, true, 1, true>(l);
        case 2: return launch_mma<true, true, 2, true>(l);
        case 4: return launch_mma<true, true, 4, true>(l);
        case 8: return launch_mma<true, true, 8, true>(l);
        case 16: return launch_mma<true, true, 16, true>(l);
        default: return launch_mma<true, true, 32, true>(l);
      }
    }
    switch (block) {
      case 1: return launch_mma<true, true, 1>(l);
      case 2: return launch_mma<true, true, 2>(l);
      case 4: return launch_mma<true, true, 4>(l);
      case 8: return launch_mma<true, true, 8>(l);
      case 16: return launch_mma<true, true, 16>(l);
      default: return launch_mma<true, true, 32>(l);  // bad_problem: <= 32
    }
  }
  // the ordered route for float32 operands
  const dim3 grid((sq + kFlashRows - 1) / kFlashRows, bh);
  const bool wide = d > kNarrowD;
  auto* kern = wide ? flash_kernel<kMaxD> : flash_kernel<kNarrowD>;
  const size_t smem =
      smem_floats(kFlashRows, wide ? kMaxD : kNarrowD) * sizeof(float);
  int rc = allow_smem(kern, smem);
  if (rc) return rc;
  QUERY_OR_LAUNCH(kern, grid, dim3(kFlashThreads), smem);
  kern<<<grid, kFlashThreads, smem, st>>>((const float*)q, (const float*)k,
                                          (const float*)v, lut, (float*)out,
                                          groups, p);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, const int* valid,
    const float* lut, void* out, int b, int hkv, int g, int w, int d,
    int rows, int cols, int mxint, int quantize, int block, int mant_bits,
    int lut_n, float scale, float log2e, int bf16, void* stream) {
  Problem p{g, w, d, hkv * d, 0, 0, mxint, quantize, block, mant_bits, lut_n,
            scale, log2e};
  const int vec = bf16 ? vec_of<__nv_bfloat16>() : vec_of<float>();
  if (bad_problem(p) || b < 1 || hkv < 1 || rows < 1 || rows > kDecMaxRows ||
      cols < 1 || cols % vec != 0)
    return (int)cudaErrorInvalidValue;
  // the geometry of decode_geometry in kernels/flash_attention.py
  const bool aligned = (((uintptr_t)k | (uintptr_t)v) & 15) == 0;
  const DecodeGrid gr{hkv, (g + rows - 1) / rows, (d + cols - 1) / cols, cols,
                      d % vec == 0 && aligned, 2};
  const DecodeLaunch l{q, k, v, valid, lut, out, b * hkv, gr, p,
                       (cudaStream_t)stream};
  return bf16 ? launch_decode_rows<__nv_bfloat16>(l, rows)
              : launch_decode_rows<float>(l, rows);
}

// the generic route of flash_attention (flash_route in
// kernels/flash_attention.py); warps: query rows a CTA (generic_warps)
extern "C" int flash_generic_launch(
    const void* q, const void* k, const void* v, const float* lut, void* out,
    int bh, int sq, int sk, int d, int groups, int causal, int window,
    int mxint, int quantize, int block, int mant_bits, int lut_n, float scale,
    float log2e, int bf16, int warps, void* stream) {
  const Problem p{sq, sk, d, d, causal, window, mxint, quantize, block,
                  mant_bits, lut_n, scale, log2e};
  if (bad_generic(p, warps) || groups < 1 || bh % groups != 0)
    return (int)cudaErrorInvalidValue;
  const GenFlash gf{bh * sq, groups, 0, 0};
  const dim3 grid((sq + warps - 1) / warps, bh);
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_generic<__nv_bfloat16, false>(q, k, v, nullptr, lut,
                                                    out, grid, warps, gf, p,
                                                    st)
              : launch_generic<float, false>(q, k, v, nullptr, lut, out,
                                             grid, warps, gf, p, st);
}

// the generic route of flash_attention_decode (decode_route)
extern "C" int flash_generic_decode_launch(
    const void* q, const void* k, const void* v, const int* valid,
    const float* lut, void* out, int b, int hkv, int g, int w, int d,
    int mxint, int quantize, int block, int mant_bits, int lut_n, float scale,
    float log2e, int bf16, int warps, void* stream) {
  const Problem p{g, w, d, hkv * d, 0, 0, mxint, quantize, block, mant_bits,
                  lut_n, scale, log2e};
  if (bad_generic(p, warps) || b < 1 || hkv < 1)
    return (int)cudaErrorInvalidValue;
  const GenFlash gf{b * hkv * g, 1, hkv, g};
  const dim3 grid((gf.rows + warps - 1) / warps);
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_generic<__nv_bfloat16, true>(q, k, v, valid, lut, out,
                                                   grid, warps, gf, p, st)
              : launch_generic<float, true>(q, k, v, valid, lut, out, grid,
                                            warps, gf, p, st);
}

LAUNCH_QUERY_ENTRY(flash_attention)
