// Shared device stages of the MXInt kernels (sm_90a).
//
// Every stage computes exactly what the plain PyTorch versions in
// repro_torch/kernels/*.py compute: powers of two are built from exponent
// bits, rounding is rintf (half to even), every multiply and add that the
// plain versions round separately is an explicit __fmul_rn / __fadd_rn
// (and the build passes -fmad=false), and row sums run in one fixed order:
// each lane adds its blocks in turn, then a butterfly over the 32 lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace mx {

constexpr int kWarp = 32;
constexpr int kMaxBlock = 16;     // act blocks held in registers
// the largest act block of the row kernels (one warp of float4 lanes)
// and of the LN stage of the fused kernel (two warps: the GEMM core's
// largest act block)
constexpr int kMaxRowBlock = 128;
constexpr int kMaxLnBlock = 256;
constexpr int kMaxLut = 256;      // shared-memory LUT copy
constexpr unsigned kFull = 0xffffffffu;
// 1.5 * 2^23 as float bits and value: for an integer |v| < 2^22, the bits
// kDotBias + v are the float 1.5 * 2^23 + v exactly, so int and float
// convert by an add each, without the quarter-rate conversion unit (the
// GEMM core's mma adds it as its C input; the LN stage's int8 mantissas)
constexpr int kDotBias = 0x4B400000;
constexpr float kDotBiasF = 12582912.0f;

// (float)v for |v| < 2^22
__device__ __forceinline__ float small_i2f(int v) {
  return __fsub_rn(__int_as_float(kDotBias + v), kDotBiasF);
}

// exact 2^n as float32: normal from the exponent field, subnormal from the
// mantissa bits, 0 below 2^-149, inf above 2^127
__device__ __forceinline__ float pow2i(int n) {
  if (n > 127) return __int_as_float(0x7f800000);
  if (n >= -126) return __int_as_float((n + 127) << 23);
  if (n >= -149) return __int_as_float(1 << (n + 149));
  return 0.0f;
}

// exactly pow2i(e) for an int8 exponent e in [-127, 127]: the exponent
// field, or the subnormal bit pattern of 2^-127.  For two such exponents
// __fmul_rn(pow2_e8(a), pow2_e8(b)) == pow2i(a + b): exact down to 2^-149,
// 0 below, inf above 2^127 (tests/test_torch_kernels.py checks every pair)
__device__ __forceinline__ float pow2_e8(int e) {
  return __int_as_float(max((e + 127) << 23, 0x00400000));
}

// shared exponent of a block: floor(log2(amax)) - (mant_bits - 2), 0 for an
// all-zero block, clipped to the int8 range
__device__ __forceinline__ int block_exp(float amax, int mant_bits) {
  if (!(amax > 0.0f)) return 0;
  float a = fmaxf(amax, 1.17549435e-38f);               // float32 tiny
  int k = ((__float_as_int(a) >> 23) & 0xff) - 127;      // floor(log2 a)
  int e = k - (mant_bits - 2);
  return min(max(e, -127), 127);
}

__device__ __forceinline__ float quant_mant(float x, float inv_scale,
                                            float lim) {
  return fminf(fmaxf(rintf(__fmul_rn(x, inv_scale)), -lim), lim);
}

// (int)quant_mant(x, inv_scale, lim) where |x * inv_scale| < 2^22 (a value
// of a block scaled by its own exponent at mant_bits <= 23): the add of
// 1.5 * 2^23 rounds to the integer, half to even, as rintf does
__device__ __forceinline__ int quant_mant_small(float x, float inv_scale,
                                                int lim) {
  const int q = __float_as_int(__fadd_rn(__fmul_rn(x, inv_scale),
                                         kDotBiasF)) - kDotBias;
  return min(max(q, -lim), lim);
}

__device__ __forceinline__ float block_amax(const float* p, int b) {
  float a = 0.0f;
  for (int i = 0; i < b; ++i) a = fmaxf(a, fabsf(p[i]));
  return a;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// butterfly: level 16 adds lanes (i, i+16), then 8, 4, 2, 1; every lane
// ends with the same bits (float add is commutative)
__device__ __forceinline__ float warp_sum_tree(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int lut_index(float f, int n) {
  return (int)fminf(fmaxf(f, 0.0f), (float)(n - 1));
}

// 1/sqrt(var) through the LUT with the Eq. 9 even/odd exponent split
__device__ __forceinline__ float rsqrt_lut_stage(float var, const float* lut,
                                                 int n, float idx_scale) {
  var = fmaxf(var, 5.9604644775390625e-08f);              // 2^-24
  int ve;
  float vm = frexpf(var, &ve);
  vm = __fmul_rn(vm, 2.0f);
  ve -= 1;
  bool odd = (ve & 1) != 0;
  float u = odd ? __fmul_rn(vm, 0.5f) : vm;
  int e_half = odd ? ((ve + 1) >> 1) : (ve >> 1);          // floor division
  int idx = lut_index(floorf(__fmul_rn(__fsub_rn(u, 0.5f), idx_scale)), n);
  return __fmul_rn(lut[idx], pow2i(-e_half));
}

// 2^z for z <= 0 as 2^max(n, -126) * LUT_pow2(r), r = z - floor(z)
__device__ __forceinline__ float exp2_datapath(float z, const float* lut,
                                               int n_entries) {
  float n = floorf(z);
  float r = __fsub_rn(z, n);
  int idx = lut_index(floorf(__fmul_rn(r, (float)n_entries)), n_entries);
  int ni = (int)fmaxf(n, -126.0f);
  return __fmul_rn(lut[idx], pow2i(ni));
}

// load a LUT into shared memory (call before __syncthreads)
__device__ __forceinline__ void load_lut(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// Fig. 3 LayerNorm / RMSNorm of a CTA's rows, every thread at work
// ---------------------------------------------------------------------------
// The rows are cut into pieces of consecutive elements of one act block:
// P = 4 on the vector route (one 16-byte f32 or 8-byte bf16 access; a
// power-of-two act block of 4-128 spans B / 4 adjacent lanes of a warp,
// its group, and one of 256 the two warps of an aligned pair), or a whole
// block on the scalar route (P = 0: any block up to 16 at any alignment;
// the group is one lane).  Piece p of the CTA's rows is piece
// p % ppr of row p / ppr, and thread t takes pieces t, t + T, ..., so a
// warp's accesses are contiguous.  Four phases, each closed by
// __syncthreads:
//  1. each row read once: the block amax (over the group by shuffles), its
//     exponent e and mantissas q = quant(x * 2^-e), staged with e in
//     shared memory; the row max emax by a warp reduction and an atomicMax
//  2. align in place: m = q >> min(emax - e, 31); the integer row sum
//     (LayerNorm) by a warp reduction and an atomicAdd
//  3. the variance, the one step whose bits depend on its order: warp w
//     takes rows w, w + W, ...; lane l adds c * c over the staged blocks
//     l, l + 32, ... of the row, element by element (a block past 16 in
//     16-element pieces, in order), then the butterfly
//     (warp_row_sum's order); then the rsqrt LUT
//  4. per piece y = (c * inv) * gamma (+ beta), handed to the caller's
//     epilogue, which may overwrite the piece's staged mantissas and its
//     block's exponent (phase 3's reads are behind the barrier)
// Every step but the variance is exact in any order and over any threads.
constexpr int kLnBatch = 8;       // vector-route pieces a thread loads at once

struct __align__(16) LnRowVars {  // a row's scalars in shared memory
  int emax, isum;
  float mean, inv;
};

struct LnArgs {
  const void* x;                  // the CTA's first row (f32 or bf16: T)
  const void* gamma;
  const void* beta;               // null: no beta (zero)
  const float* lut;               // rsqrt LUT: shared memory, or device
                                  // memory past kMaxLut entries
  int rows, d, block, mant_bits, lut_n, rms_only, params_bf16;
  float inv_d, lut_scale, lim;
};

// where a CTA's rows are staged: mantissas (M: int8 or int32) and block
// exponents, row strides in elements, and each row's LnRowVars
template <typename M>
struct LnStage {
  M* m;
  int m_ld;
  int8_t* e;
  int e_ld;
  unsigned char* rv;
  int rv_ld;                      // bytes between rows' LnRowVars

  __device__ __forceinline__ LnRowVars& vars(int r) const {
    return *reinterpret_cast<LnRowVars*>(rv + r * rv_ld);
  }
};

// register slots of a piece: P, or the largest block
template <int P>
constexpr int kPieceSlots = P ? P : kMaxBlock;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);                 // exact
}

// n elements from src as f32: one 16-byte (f32) or 8-byte (bf16) load on
// the vector route
template <int P, typename T>
__device__ __forceinline__ void load_piece(const T* src, int n,
                                           float (&v)[kPieceSlots<P>]) {
  if constexpr (P == 4 && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (P == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(src);
    v[0] = __uint_as_float(q.x << 16);        // bf16 = the high half of f32
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i) v[i] = i < n ? to_f32(src[i]) : 0.0f;
  }
}

// gamma or beta at element j (bf16 or f32 by a flag; null: zeros)
template <int P>
__device__ __forceinline__ void load_param(const void* p, int bf16, int j,
                                           int n,
                                           float (&v)[kPieceSlots<P>]) {
  if (p == nullptr) {
#pragma unroll
    for (int i = 0; i < kPieceSlots<P>; ++i) v[i] = 0.0f;
  } else if (bf16) {
    load_piece<P>(static_cast<const __nv_bfloat16*>(p) + j, n, v);
  } else {
    load_piece<P>(static_cast<const float*>(p) + j, n, v);
  }
}

template <int P, typename M>
__device__ __forceinline__ void load_staged(const M* src, int n,
                                            int (&q)[kPieceSlots<P>]) {
  if constexpr (P == 4 && sizeof(M) == 1) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = (int)(int8_t)(w >> (8 * i));
  } else if constexpr (P == 4 && sizeof(M) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    q[0] = (int)(int16_t)(w.x & 0xffffu);
    q[1] = (int)(int16_t)(w.x >> 16);
    q[2] = (int)(int16_t)(w.y & 0xffffu);
    q[3] = (int)(int16_t)(w.y >> 16);
  } else if constexpr (P == 4) {
    const int4 w = *reinterpret_cast<const int4*>(src);
    q[0] = w.x;
    q[1] = w.y;
    q[2] = w.z;
    q[3] = w.w;
  } else {
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i) q[i] = i < n ? (int)src[i] : 0;
  }
}

template <int P, typename M>
__device__ __forceinline__ void store_staged(M* dst, int n,
                                             const int (&q)[kPieceSlots<P>]) {
  if constexpr (P == 4 && sizeof(M) == 1) {
    *reinterpret_cast<uint32_t*>(dst) =
        (q[0] & 0xff) | ((q[1] & 0xff) << 8) | ((q[2] & 0xff) << 16) |
        ((uint32_t)q[3] << 24);
  } else if constexpr (P == 4 && sizeof(M) == 2) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2((q[0] & 0xffff) | ((uint32_t)q[1] << 16),
                   (q[2] & 0xffff) | ((uint32_t)q[3] << 16));
  } else if constexpr (P == 4) {
    *reinterpret_cast<int4*>(dst) = make_int4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i)
      if (i < n) dst[i] = (M)q[i];
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// max of a over a group of G = 8-64 lanes: xor partners in an aligned
// group of up to a warp; 64: then over warps 2j and 2j + 1, which meet at
// their own named barrier (1 + j; barrier 0 is __syncthreads), so the CTA
// need not; both warps call it the same number of times.  Not inlined: the
// default groups (1-4 lanes) keep their two shuffles and no barrier in
// their code.
__device__ __noinline__ float wide_group_max(float a, int G) {
  __shared__ float xchg[16];            // one slot per warp of 512 threads
  for (int off = 1; off < G && off < kWarp; off <<= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  if (G > kWarp) {
    const int wp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) xchg[wp] = a;
    named_barrier(1 + wp / 2, 2 * kWarp);
    a = fmaxf(a, xchg[wp ^ 1]);
    named_barrier(1 + wp / 2, 2 * kWarp);  // before a later call overwrites
  }
  return a;
}

// max |v| over the piece, then over its group's G lanes (xor partners in
// an aligned group of 1 to 32 lanes; 64: both warps of an aligned pair;
// every lane of the warp calls it)
template <int P>
__device__ __forceinline__ float group_amax(const float (&v)[kPieceSlots<P>],
                                            int n, int G) {
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kPieceSlots<P>; ++i)
    if (i < n) a = fmaxf(a, fabsf(v[i]));
  if constexpr (P == 4) {
    if (G <= 4) {                       // G = 1, 2 or 4: xor 0 is a no-op
      a = fmaxf(a, __shfl_xor_sync(kFull, a, (G - 1) & 1));
      a = fmaxf(a, __shfl_xor_sync(kFull, a, (G - 1) & 2));
    } else {
      a = wide_group_max(a, G);
    }
  }
  return a;
}

// the piece's block quantized onto the MXInt grid in place (grid_requant
// over a block spread over G lanes)
template <int P>
__device__ __forceinline__ void group_requant(float (&y)[kPieceSlots<P>],
                                              int n, int G, int mant_bits,
                                              float lim) {
  const int e = block_exp(group_amax<P>(y, n, G), mant_bits);
  const float inv = pow2_e8(-e), scale = pow2_e8(e);
#pragma unroll
  for (int i = 0; i < kPieceSlots<P>; ++i)
    if (i < n) y[i] = __fmul_rn(quant_mant(y[i], inv, lim), scale);
}

// a thread's walk over its pieces: piece p = t + k T is piece c of row r,
// at element p * n of the rows (row-major, d = ppr * n); each step adds T
// pieces (dr rows and dc pieces), no division in the loop
struct LnWalk {
  int p, r, c, dr, dc, ppr;

  __device__ __forceinline__ LnWalk(int ppr_) : ppr(ppr_) {
    p = threadIdx.x;
    r = threadIdx.x / ppr;
    c = threadIdx.x - r * ppr;
    dr = blockDim.x / ppr;
    dc = blockDim.x - dr * ppr;
  }
  __device__ __forceinline__ void next() {
    p += blockDim.x;
    r += dr;
    c += dc;
    if (c >= ppr) {
      c -= ppr;
      ++r;
    }
  }
};

// a per-row integer fold (max or sum, exact in any order) of the values a
// thread meets on its walk, flushed into the row's LnRowVars slot when the
// row changes.  warp_rows: every warp step lies in one row (ppr a multiple
// of 32), so the flush is warp-uniform: a warp reduction and one
// atomic; else an atomic a lane.  Call add and flush with the whole warp.
template <bool MAX>
struct RowFold {
  int r = -1, acc = MAX ? INT_MIN : 0;
  bool warp_rows;

  __device__ __forceinline__ explicit RowFold(bool wr) : warp_rows(wr) {}

  template <typename M>
  __device__ __forceinline__ void flush(const LnStage<M>& st) {
    if (r < 0) return;
    int v = acc;
    if (warp_rows) {
      v = MAX ? __reduce_max_sync(kFull, v) : __reduce_add_sync(kFull, v);
      if (threadIdx.x % kWarp != 0) return;
    }
    if (MAX)
      atomicMax(&st.vars(r).emax, v);
    else
      atomicAdd(&st.vars(r).isum, v);
  }
  // v of a valid piece of row r (valid is warp-uniform when warp_rows)
  template <typename M>
  __device__ __forceinline__ void add(const LnStage<M>& st, bool valid,
                                      int row, int v) {
    if (!valid) return;
    if (row != r) {
      flush(st);
      r = row;
      acc = MAX ? INT_MIN : 0;
    }
    acc = MAX ? max(acc, v) : acc + v;
  }
};

// the staged mantissas of one block or 16-element piece of a block
// (B <= 16): one, two or four 16-byte loads at B = 16, else element by
// element
template <typename M>
__device__ __forceinline__ void load_block(const M* src, int B,
                                           int (&m)[kMaxBlock]) {
  if (B == kMaxBlock) {
    if constexpr (sizeof(M) == 1) {
      const uint4 w = *reinterpret_cast<const uint4*>(src);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < kMaxBlock; ++i)
        m[i] = (int)(int8_t)(ws[i / 4] >> (8 * (i % 4)));
    } else if constexpr (sizeof(M) == 2) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 w = reinterpret_cast<const uint4*>(src)[q];
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m[8 * q + i] = (int)(int16_t)(ws[i / 2] >> (16 * (i % 2)));
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 w = reinterpret_cast<const int4*>(src)[q];
        m[4 * q] = w.x;
        m[4 * q + 1] = w.y;
        m[4 * q + 2] = w.z;
        m[4 * q + 3] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxBlock; ++i) m[i] = i < B ? (int)src[i] : 0;
  }
}

// a mantissa to and from its stage type M: an int8 (mant_bits <= 8) or
// int16 (<= 16) stage converts by the bias adds, an int32 stage (any
// mant_bits) by the conversion unit
template <typename M>
__device__ __forceinline__ int stage_quant(float x, float inv, float lim,
                                           int ilim) {
  if constexpr (sizeof(M) <= 2)
    return quant_mant_small(x, inv, ilim);
  else
    return (int)quant_mant(x, inv, lim);
}

template <typename M>
__device__ __forceinline__ float stage_f32(int m) {
  if constexpr (sizeof(M) <= 2)
    return small_i2f(m);
  else
    return (float)m;
}

// a piece handed to the epilogue: elements [j, j + n) of row r, in act
// block b, whose G lanes it shares; leader: one lane of the block
struct LnPiece {
  bool valid, leader;
  int r, j, b, n, G;
};

// Normalize the CTA's a.rows rows (the caller has set every row's
// LnRowVars to {-128, 0, 0, 0} and synchronized).  epi(piece, y), y the
// piece's normalized values, is called by every lane of the warp
// (shuffles), valid or not.
template <typename T, int P, typename M, typename Epi>
__device__ __forceinline__ void ln_rows(const LnArgs& a, const LnStage<M>& st,
                                        Epi&& epi) {
  constexpr int PN = kPieceSlots<P>;
  const int T_ = blockDim.x, lane = threadIdx.x % kWarp;
  const int n = P ? P : a.block;              // elements of a piece
  const int G = P ? a.block / P : 1;          // lanes of a block
  const int gshift = __ffs(G) - 1;            // G is a power of two
  const int ppr = a.d / n;
  const int steps = (a.rows * ppr + T_ - 1) / T_;
  const bool warp_rows = ppr % kWarp == 0;
  const int ilim = (int)a.lim;
  const T* x = static_cast<const T*>(a.x);
  constexpr int B1 = P ? kLnBatch : 2;

  // 1. read, block exponents and mantissas, row max
  {
    LnWalk w(ppr);
    RowFold<true> emax(warp_rows);
    for (int k0 = 0; k0 < steps; k0 += B1) {
      float v[B1][PN];
      LnWalk wl = w;
#pragma unroll
      for (int u = 0; u < B1; ++u) {
        if (k0 + u < steps && wl.r < a.rows) {
          load_piece<P>(x + (size_t)wl.p * n, n, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < PN; ++i) v[u][i] = 0.0f;
        }
        wl.next();
      }
#pragma unroll
      for (int u = 0; u < B1; ++u) {
        if (k0 + u >= steps) break;                      // CTA-uniform
        const bool valid = w.r < a.rows;
        const int e = block_exp(group_amax<P>(v[u], n, G), a.mant_bits);
        if (valid) {
          const float inv = pow2_e8(-e);
          int q[PN];
#pragma unroll
          for (int i = 0; i < PN; ++i)
            q[i] = i < n ? stage_quant<M>(v[u][i], inv, a.lim, ilim) : 0;
          store_staged<P>(st.m + w.r * st.m_ld + w.c * n, n, q);
          if (lane % G == 0) st.e[w.r * st.e_ld + (w.c >> gshift)] = (int8_t)e;
        }
        emax.add(st, valid, w.r, e);
        w.next();
      }
    }
    emax.flush(st);
  }
  __syncthreads();

  // 2. align to the row max in place; the integer row sum
  {
    LnWalk w(ppr);
    RowFold<false> isum(warp_rows);
#pragma unroll 4
    for (int k = 0; k < steps; ++k, w.next()) {
      const bool valid = w.r < a.rows;
      int s = 0;
      if (valid) {
        M* mp = st.m + w.r * st.m_ld + w.c * n;
        int q[PN];
        load_staged<P>(mp, n, q);
        const int sh = min(st.vars(w.r).emax -
                               st.e[w.r * st.e_ld + (w.c >> gshift)], 31);
#pragma unroll
        for (int i = 0; i < PN; ++i) {
          q[i] >>= sh;
          s += q[i];
        }
        store_staged<P>(mp, n, q);
      }
      if (!a.rms_only) isum.add(st, valid, w.r, s);
    }
    if (!a.rms_only) isum.flush(st);
  }
  __syncthreads();

  // 3. the variance of each row in the fixed lane order, the rsqrt LUT
  const int nb = a.d / a.block;
  for (int r = threadIdx.x / kWarp; r < a.rows; r += T_ / kWarp) {
    const float mean =
        a.rms_only ? 0.0f : __fmul_rn((float)st.vars(r).isum, a.inv_d);
    const M* row = st.m + r * st.m_ld;
    float acc = 0.0f;
    auto chain = [&](const int (&m)[kMaxBlock], int n) {
#pragma unroll
      for (int i = 0; i < kMaxBlock; ++i) {
        if (i < n) {
          const float mi = stage_f32<M>(m[i]);
          const float c = a.rms_only ? mi : __fsub_rn(mi, mean);
          acc = __fadd_rn(acc, __fmul_rn(c, c));
        }
      }
    };
    if (a.block <= kMaxBlock) {
      for (int b = lane; b < nb; b += kWarp) {
        int m[kMaxBlock];
        load_block(row + b * a.block, a.block, m);
        chain(m, a.block);
      }
    } else {       // a multiple of 16: its 16-element pieces in order
      for (int b = lane; b < nb; b += kWarp) {
        for (int i0 = 0; i0 < a.block; i0 += kMaxBlock) {
          int m[kMaxBlock];
          load_block(row + b * a.block + i0, kMaxBlock, m);
          chain(m, kMaxBlock);
        }
      }
    }
    acc = warp_sum_tree(acc);
    if (lane == 0) {
      st.vars(r).mean = mean;
      st.vars(r).inv = rsqrt_lut_stage(__fmul_rn(acc, a.inv_d), a.lut,
                                       a.lut_n, a.lut_scale);
    }
  }
  __syncthreads();

  // 4. (c * inv) * gamma (+ beta), then the caller's epilogue
  constexpr int B4 = P ? kLnBatch / 2 : 1;
  const void* beta = a.rms_only ? nullptr : a.beta;
  LnWalk w(ppr);
  for (int k0 = 0; k0 < steps; k0 += B4) {
    int q[B4][PN];
    float g[B4][PN], bt[B4][PN];
    LnWalk wl = w;
#pragma unroll
    for (int u = 0; u < B4; ++u) {
      if (k0 + u < steps && wl.r < a.rows) {
        const int j = wl.c * n;
        load_staged<P>(st.m + wl.r * st.m_ld + j, n, q[u]);
        load_param<P>(a.gamma, a.params_bf16, j, n, g[u]);
        load_param<P>(beta, a.params_bf16, j, n, bt[u]);
      } else {
#pragma unroll
        for (int i = 0; i < PN; ++i) q[u][i] = 0, g[u][i] = bt[u][i] = 0.0f;
      }
      wl.next();
    }
#pragma unroll
    for (int u = 0; u < B4; ++u, w.next()) {
      if (k0 + u >= steps) break;                        // CTA-uniform
      const bool valid = w.r < a.rows;
      const LnRowVars rv = st.vars(valid ? w.r : 0);
      float y[PN];
#pragma unroll
      for (int i = 0; i < PN; ++i) {
        const float mi = stage_f32<M>(q[u][i]);
        const float c = a.rms_only ? mi : __fsub_rn(mi, rv.mean);
        const float t = __fmul_rn(__fmul_rn(c, rv.inv), g[u][i]);
        y[i] = a.rms_only ? t : __fadd_rn(t, bt[u][i]);
      }
      epi(LnPiece{valid, lane % G == 0, w.r, w.c * n, w.c >> gshift, n, G},
          y);
    }
  }
}

// ---------------------------------------------------------------------------
// int8 tensor-core GEMM core shared by mxint_matmul and mxint_ln_matmul
// ---------------------------------------------------------------------------
// A CTA of gemm_threads(bm) threads owns a row tile of bm (16, 24 or 32)
// rows and n_per consecutive column tiles of bn columns; gemm_geometry
// (kernels/mxint_matmul.py) picks them from the shape and the card's SM
// count.  The CTA's prologue fills sA (act mantissas, row stride K + 16
// elements: int8, or int16 for 9-16 bits) and sE (one int8 exponent per
// act block) for its rows.  The core
// streams the planes' bk x bn tiles, in their stored [K][N] layout, through
// a ring of ns shared-memory stages by cp.async, each tile once per CTA,
// with the exponent-plane row of each 16-row block beside it.  Each warp
// owns 16 rows and 16 columns of a tile (8 warps side by side on the
// columns for each 16 rows): per act block one mma.sync m16n8k16 s8 per 8
// columns, whose int32 result is the block's exact dot
// (|dot| <= 16 * 128 * 127 < 2^22), then
//   acc = acc + (float)dot * 2^(e_a + e_w)
// as two rounded steps, in increasing K order, as the plain version adds
// them.  No two blocks share an mma and no K range is split, so each output
// element's sum is one thread's, in the plain version's order.
//
// Other act formats (the kernel's V, from the act block and width):
//  V 0  act block 16, 2-8 bits: the path above.
//  V 1  any other act block of 2-8 bits.  A block of B = 16 s (s > 1)
//       k16 steps, B dividing w_block: its s mma.sync chain their int32
//       sums (|dot| <= 256 * 127 * 127 < 2^31), then one scaled add.  A
//       block dividing 16: per k16 step, one mma per block on the A
//       fragments with the columns outside the block zeroed.
//  V 2  9-16 bits, any act block of V 1: the int16 mantissa m = 256 hi +
//       lo splits into its signed high byte and unsigned low byte (the
//       two bytes of the int16 in shared memory); one s8 x s8 and one
//       u8 x s8 mma a step, combined as 256 dot_hi + dot_lo in int32
//       (|dot| <= 256 * 32767 * 127 < 2^31).
//  V 3  int8 or int16 planes (chosen at run time), 2-8-bit acts, any act
//       block that divides K (one that does not nest in the weight block:
//       DeiT's act block 12 against 256-element weight blocks).  The sum
//       runs by segment, the intersection of an act block with a weight
//       block (kernels/mxint_matmul.py:segments), walked k16 step by step:
//       per step, one masked mma (block_mask) per segment that meets it,
//       its int32 sum carried from step to step (and stage to stage) until
//       the segment ends.  The cuts come from arithmetic: the next act
//       boundary or the next weight boundary, whichever comes first (a
//       weight boundary always falls on a step, w_block being a multiple
//       of 16).  An int16 plane's B fragment splits in registers into its
//       signed high byte and unsigned low byte: one s8 x s8 and one s8 x u8
//       mma, 256 dot_hi + dot_lo.
//  V 4  V 3 at 9-16-bit acts: the act tile's int16 split as in V 2, so
//       four mmas a step at int16 planes, 65536 hh + 256 (hl + lh) + ll.
//       The partial dots are combined in uint32 (the segment's dot is below
//       2^31: wide_dot false, which the C entries check).
// V 1-4 convert the block's (segment's) dot with __int2float_rn (round to
// nearest even, as the plain version's float64 dot rounded to float32),
// then add (float)dot * 2^(e_a + e_w) in the same two rounded steps.
constexpr int kMaxThreads = 512;
constexpr int kAB = 16;           // the mma depth: a k16 step of K
constexpr int kMaxAB = 256;       // the largest act block (|dot| < 2^31)
constexpr int kMaxStages = 4;     // depth of the weight ring, at most
constexpr int kWarpCols = 16;     // a warp's columns: two n8 mma tiles
constexpr int kMaxTileCols = 8 * kWarpCols;
constexpr int kMaxAccTiles = 2;   // column tiles a chunked CTA holds

// launch geometry, from gemm_geometry on the host
struct GemmGeom {
  int bm;      // rows of the CTA's tile: 16, 24 or 32
  int bn;      // columns of a tile: a power of two in [4, kMaxTileCols]
  int n_per;   // column tiles per CTA
  int bk;      // K rows of a ring stage: a multiple of 16
  int ns;      // ring stages: 2 .. kMaxStages
};

// threads of a CTA: 8 warps side by side on the columns for each 16 rows
// of the tile, begun or whole (two 256-thread CTAs of a decode batch share
// an SM)
__host__ __forceinline__ int gemm_threads(int bm) {
  return (bm + 15) / 16 * 256;
}

__host__ __device__ __forceinline__ int a_stride(int K) { return K + 16; }

// sA rows: whole 16-row groups, since a warp's A fragments read 16 rows
// (the second group of a 24-row tile reads 8 rows it never fills and
// discards their products)
__host__ __device__ __forceinline__ int a_rows(int bm) {
  return (bm + 15) / 16 * 16;
}

// sE row stride for nb act blocks a row: nb exponents, rounded up to whole
// words and padded to an odd word count, so that the 8 rows a fragment
// reads at one act block fall in 8 distinct banks
__host__ __device__ __forceinline__ int e_stride(int nb) {
  const int w = (nb + 3) / 4;
  return 4 * (w | 1);
}

// an act block V 0-2 take: a multiple of 16 up to kMaxAB dividing
// w_block, or a divisor of 16 (the act block nests in the k16 steps and
// the weight blocks)
__host__ __forceinline__ bool act_block_ok(int ab, int w_block) {
  if (ab >= kAB)
    return ab % kAB == 0 && ab <= kMaxAB && w_block % ab == 0;
  return ab >= 1 && kAB % ab == 0;
}

// the kernel variant of a format (see above): w_bytes 1 or 2 (int8 or
// int16 planes)
__host__ __forceinline__ int act_variant(int ab, int mant_bits, int w_block,
                                         int w_bytes) {
  if (w_bytes != 1 || !act_block_ok(ab, w_block)) return mant_bits > 8 ? 4 : 3;
  return mant_bits > 8 ? 2 : ab == kAB ? 0 : 1;
}

// act mantissas of variant V: int16 in V 2 and 4, else int8
template <int V>
using ActT = std::conditional_t<V == 2 || V == 4, int16_t, int8_t>;

// the K granule of a chunk of V 3 and 4: whole act blocks and k16 steps,
// lcm(ab, 16)
__host__ __forceinline__ int seg_unit(int ab) {
  int a = ab, b = kAB;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return ab / a * kAB;
}

// a segment's dot may pass 2^31 (the generic route's int64 dots): the core
// refuses the format
__host__ __forceinline__ bool wide_dot(int ab, int w_block, int mant_bits,
                                       int w_bytes) {
  const long long w_max = w_bytes == 1 ? 127 : 32767;
  return (long long)(ab < w_block ? ab : w_block) *
             ((1ll << (mant_bits - 1)) - 1) * w_max >= (1ll << 31);
}

// shared row stride of a staged weight tile.  int8 (wb 1): bn bytes (at
// least 16), plus 16 where bn / 16 is a multiple of 4, so that the four
// rows a lane group reads for one B fragment fall in four distinct bank
// quads.  int16 (wb 2): 2 bn bytes (at least 32), plus 32 where that is a
// multiple of 64, so that the four rows' 32-byte pieces fill the 32 banks
__host__ __device__ __forceinline__ int w_stride(int bn, int wb = 1) {
  if (wb == 2) {
    const int l = bn < 16 ? 32 : 2 * bn;
    return (l / 32) % 2 == 0 ? l + 32 : l;
  }
  const int l = bn < 16 ? 16 : bn;
  return (l / 16) % 4 == 0 ? l + 16 : l;
}

// one ring stage: bk mantissa rows, then bk / 16 exponent rows (one int8 a
// column, at the mantissa rows' stride)
__host__ __device__ __forceinline__ int stage_bytes(const GemmGeom& g,
                                                   int wb = 1) {
  return (g.bk + g.bk / kAB) * w_stride(g.bn, wb);
}

__host__ __forceinline__ bool geom_ok(const GemmGeom& g) {
  return (g.bm == 16 || g.bm == 24 || g.bm == 32) && g.bn >= 4 &&
         g.bn <= kMaxTileCols && (g.bn & (g.bn - 1)) == 0 &&
         g.n_per >= 1 && g.bk >= kAB && g.bk % kAB == 0 && g.ns >= 2 &&
         g.ns <= kMaxStages;
}

// kc: the K columns sA holds (K, or the chunk width); ab: the act block;
// a_bytes: 1 or 2 (int8 or int16 act mantissas); wb: plane bytes
__host__ __forceinline__ size_t gemm_smem_bytes(const GemmGeom& g, int kc,
                                                int ab, int a_bytes,
                                                int wb = 1) {
  return (size_t)a_rows(g.bm) * a_stride(kc) * a_bytes +
         (((size_t)g.bm * e_stride(kc / ab) + 15) & ~(size_t)15) +
         (size_t)g.ns * stage_bytes(g, wb) + kMaxLut * sizeof(float);
}

// shared-memory carve-up: sA | sE | weight ring | lut (16-byte aligned)
struct GemmSmem {
  int8_t* a;
  int8_t* e;
  int8_t* w;
  float* lut;
};

__device__ __forceinline__ GemmSmem carve(unsigned char* base,
                                          const GemmGeom& g, int kc, int ab,
                                          int a_bytes, int wb = 1) {
  GemmSmem s;
  size_t off = 0;
  s.a = (int8_t*)(base + off);
  off += (size_t)a_rows(g.bm) * a_stride(kc) * a_bytes;
  s.e = (int8_t*)(base + off);
  off += ((size_t)g.bm * e_stride(kc / ab) + 15) & ~(size_t)15;
  s.w = (int8_t*)(base + off);
  off += (size_t)g.ns * stage_bytes(g, wb);
  s.lut = (float*)(base + off);
  return s;
}

// the widest copy (16, 8 or 4 bytes; 1: byte by byte) that every row
// chunk of a tile allows
__host__ __forceinline__ int copy_width(int N, int bn, const void* wm,
                                        const void* we) {
  for (int v = 16; v >= 4; v >>= 1)
    if (N % v == 0 && bn % v == 0 && (uintptr_t)wm % v == 0 &&
        (uintptr_t)we % v == 0)
      return v;
  return 1;
}

__host__ __forceinline__ int log2i(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// how a CTA's threads copy a stage: the exponent rows (and int8 mantissa
// rows) in chunks of vec bytes, bn / vec threads a row; int16 mantissa rows
// (2 bn bytes) in chunks of vm bytes, 2 bn / vm threads a row
struct CopyPlan {
  int vec, vec_shift, vm, vm_shift;
};

__host__ __forceinline__ CopyPlan copy_plan(int N, int bn, const void* wm,
                                            const void* we, int wb) {
  CopyPlan c;
  c.vec = copy_width(N, bn, wb == 1 ? wm : we, we);
  c.vec_shift = log2i(bn / c.vec);
  c.vm = wb == 1 ? c.vec : copy_width(2 * N, 2 * bn, wm, wm);
  c.vm_shift = wb == 1 ? c.vec_shift : log2i(2 * bn / c.vm);
  return c;
}

// quantize one 16-block of values into int8 mantissas + exponent
__device__ __forceinline__ void act_quant16(const float (&v)[kMaxBlock],
                                            int mant_bits, float lim,
                                            int8_t* dst_m, int8_t* dst_e) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kAB; ++i) amax = fmaxf(amax, fabsf(v[i]));
  int e = block_exp(amax, mant_bits);
  float inv = pow2i(-e);
#pragma unroll
  for (int i = 0; i < kAB; ++i) dst_m[i] = (int8_t)quant_mant(v[i], inv, lim);
  *dst_e = (int8_t)e;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int V>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     shared_addr(dst)),
                 "l"(src), "n"(V));
}

__device__ __forceinline__ void cp_async_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait until at most n - 2 of the committed groups are in flight
__device__ __forceinline__ void wait_ring(int ns) {
  switch (ns) {
    case 2: cp_async_wait_groups<0>(); break;
    case 3: cp_async_wait_groups<1>(); break;
    default: cp_async_wait_groups<2>();
  }
}

// d = a (16 x 16 s8, row) * b (16 x 8 s8, col) + kDotBias, exact in int32
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(kDotBias), "r"(kDotBias),
        "r"(kDotBias), "r"(kDotBias));
}

// staged position of K row r of a tile: each 16-row block keeps its rows in
// the order 4 i + t for r = 4 t + i, so the rows 4t..4t+3 that lane group t
// needs for a B fragment are 4 rows apart and lane groups sit on adjacent
// rows (kernels/mxint_matmul.py:w_row mirrors it)
__device__ __forceinline__ int w_row(int r) {
  return (r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3);
}

// the weight tiles a CTA streams over one K range [kbase, kbase + kc):
// n_tiles column tiles from column n0, each in nst stages of bk rows
struct WStream {
  const int8_t* wm;                     // the mantissa plane's bytes
  const int8_t* we;
  int N, w_block, kbase, kc, n0, n_tiles, nst, vec, vec_shift;
  int ab;                               // the act block
  int wb, vm, vm_shift;                 // plane bytes; int16 row copies
};

template <int V>
__device__ __forceinline__ void copy_chunk(int8_t* dst, const int8_t* src) {
  if constexpr (V == 1)
    *dst = *src;                        // N % 4 != 0: plain byte copies
  else
    cp_async_bytes<V>(dst, src);
}

// a stage's copies: each thread copies chunk c of every step-th row, the
// mantissa rows to their staged rows, then the exponent-plane row of each
// 16-row block
template <int V>
__device__ __forceinline__ void issue_rows(const WStream& ws,
                                           const GemmGeom& g, int8_t* dst,
                                           int r0, int col) {
  const int ld = w_stride(g.bn);
  const int step = blockDim.x >> ws.vec_shift;
  const int rows = min(g.bk, ws.kc - r0);
  const int r1 = threadIdx.x >> ws.vec_shift;
  const int8_t* src = ws.wm + (size_t)(ws.kbase + r0 + r1) * ws.N + col;
  for (int r = r1; r < rows; r += step, src += (size_t)step * ws.N)
    copy_chunk<V>(dst + w_row(r) * ld, src);
  dst += g.bk * ld;
  for (int r = r1; r < rows / kAB; r += step)
    copy_chunk<V>(dst + r * ld,
                  ws.we + (size_t)((ws.kbase + r0 + r * kAB) / ws.w_block) *
                              ws.N + col);
}

// int16 planes: the mantissa rows (2 bn bytes) in chunks of vm bytes from
// byte column colb, then the exponent rows as issue_rows copies them
template <int V>
__device__ __forceinline__ void issue_mant16(const WStream& ws,
                                             const GemmGeom& g, int8_t* dst,
                                             int r0, int colb) {
  const int ld = w_stride(g.bn, 2);
  const size_t row = (size_t)ws.N * 2;
  const int step = blockDim.x >> ws.vm_shift;
  const int rows = min(g.bk, ws.kc - r0);
  const int r1 = threadIdx.x >> ws.vm_shift;
  const int8_t* src = ws.wm + (size_t)(ws.kbase + r0 + r1) * row + colb;
  for (int r = r1; r < rows; r += step, src += step * row)
    copy_chunk<V>(dst + w_row(r) * ld, src);
}

template <int V>
__device__ __forceinline__ void issue_exp16(const WStream& ws,
                                            const GemmGeom& g, int8_t* dst,
                                            int r0, int col) {
  const int ld = w_stride(g.bn, 2);
  const int step = blockDim.x >> ws.vec_shift;
  const int rows = min(g.bk, ws.kc - r0);
  const int r1 = threadIdx.x >> ws.vec_shift;
  for (int r = r1; r < rows / kAB; r += step)
    copy_chunk<V>(dst + r * ld,
                  ws.we + (size_t)((ws.kbase + r0 + r * kAB) / ws.w_block) *
                              ws.N + col);
}

// issue the copies of stream stage j (tile j / nst) into its ring slot;
// a stage past the end issues nothing.  W16: int16 planes
template <bool W16>
__device__ __forceinline__ void issue_stage(const WStream& ws,
                                            const GemmGeom& g, int8_t* ring,
                                            int j) {
  if (j >= ws.n_tiles * ws.nst) return;
  const int t = j / ws.nst;
  const int r0 = (j - t * ws.nst) * g.bk;        // first K row in the range
  const int c = (threadIdx.x & ((1 << ws.vec_shift) - 1)) * ws.vec;
  const int col = ws.n0 + t * g.bn + c;
  int8_t* dst = ring + (j % g.ns) * stage_bytes(g, W16 ? 2 : 1);
  if constexpr (W16) {
    const int cb = (threadIdx.x & ((1 << ws.vm_shift) - 1)) * ws.vm;
    const int colb = 2 * (ws.n0 + t * g.bn) + cb;
    if (colb < 2 * ws.N) {              // 2 N % vm == 0: whole chunks
      switch (ws.vm) {
        case 16: issue_mant16<16>(ws, g, dst + cb, r0, colb); break;
        case 8: issue_mant16<8>(ws, g, dst + cb, r0, colb); break;
        case 4: issue_mant16<4>(ws, g, dst + cb, r0, colb); break;
        default: issue_mant16<1>(ws, g, dst + cb, r0, colb);
      }
    }
    if (col >= ws.N) return;
    dst += g.bk * w_stride(g.bn, 2) + c;
    switch (ws.vec) {
      case 16: issue_exp16<16>(ws, g, dst, r0, col); break;
      case 8: issue_exp16<8>(ws, g, dst, r0, col); break;
      case 4: issue_exp16<4>(ws, g, dst, r0, col); break;
      default: issue_exp16<1>(ws, g, dst, r0, col);
    }
    return;
  }
  if (col >= ws.N) return;              // N % vec == 0: whole chunks
  dst += c;
  switch (ws.vec) {
    case 16: issue_rows<16>(ws, g, dst, r0, col); break;
    case 8: issue_rows<8>(ws, g, dst, r0, col); break;
    case 4: issue_rows<4>(ws, g, dst, r0, col); break;
    default: issue_rows<1>(ws, g, dst, r0, col);
  }
}

__device__ __forceinline__ void stream_begin(const WStream& ws,
                                             const GemmGeom& g, int8_t* ring) {
  for (int j = 0; j < g.ns - 1; ++j) {
    if (ws.wb == 2)
      issue_stage<true>(ws, g, ring, j);
    else
      issue_stage<false>(ws, g, ring, j);
    cp_async_group();
  }
}

__device__ __forceinline__ float dot_value(int d) {
  return __fsub_rn(__int_as_float(d), kDotBiasF);
}

// acc += (float)dot * (pa * pw), the plain version's two rounded steps
__device__ __forceinline__ void scaled_add(float& acc, int d, float pa,
                                           float pw) {
  acc = __fadd_rn(acc, __fmul_rn(dot_value(d), __fmul_rn(pa, pw)));
}

// the warp's place in a tile: rows [r0, r0 + 16) and columns
// [wc, wc + 16); rows counts the rows of the 16 inside the tile and below
// M (a 24-row tile's second warp row holds 8)
struct WarpTile {
  int r0, wc, rows;
};

__device__ __forceinline__ WarpTile warp_tile(const GemmGeom& g, int m0,
                                              int M) {
  const int warp = threadIdx.x / kWarp;
  WarpTile w;
  w.r0 = warp / 8 * 16;
  w.wc = warp % 8 * kWarpCols;
  w.rows = min(16, min(g.bm, M - m0) - w.r0);
  return w;
}

// the shared-memory operands of one act block kb of a warp's tile: the raw
// B bytes, the A fragments and the act exponents of rows g and g + 8
struct BlockIn {
  uint32_t x[4];
  uint32_t a[2];
  int ea[2];
};

template <int NH>
__device__ __forceinline__ void load_block(BlockIn& in, const GemmSmem& s,
                                           const int8_t* wr, int ld,
                                           int r0, int kb, int a_ld,
                                           int e_ld) {
  const int lane = threadIdx.x % kWarp, gq = lane >> 2, tq = lane & 3;
  // lane (g, t) reads columns 2g, 2g + 1 of K rows 4t..4t+3: staged row
  // 4i + t holds K row 4t + i
#pragma unroll
  for (int i = 0; i < 4; ++i)
    in.x[i] = *reinterpret_cast<const uint16_t*>(wr + 4 * i * ld);
  const int r = r0 + gq;
  const int8_t* ar = s.a + r * a_ld + kb * kAB + 4 * tq;
  in.a[0] = *reinterpret_cast<const uint32_t*>(ar);
  in.a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * a_ld);
  in.ea[0] = s.e[r * e_ld + kb];
  in.ea[1] = NH == 2 ? s.e[(r + 8) * e_ld + kb] : 0;
}

// B fragments from a lane's four staged 2-byte pieces: lane (g, t) holds
// K rows 4t..4t+3 of columns 2g (p 0) and 2g + 1 (p 1)
__device__ __forceinline__ void b_frags(const uint32_t (&x)[4],
                                        uint32_t (&b)[2]) {
  const uint32_t x01 = __byte_perm(x[0], x[1], 0x5410);
  const uint32_t x23 = __byte_perm(x[2], x[3], 0x5410);
  b[0] = __byte_perm(x01, x23, 0x6420);
  b[1] = __byte_perm(x01, x23, 0x7531);
}

// one block's products and scaled adds: acc[p][i] is the mma C layout of
// n8 tile p (p 0: the even columns of the 16, p 1: the odd ones), rows g
// (i < 2) and g + 8 (i >= 2); NH 1 skips rows g + 8 (all past the tile)
template <int NH>
__device__ __forceinline__ void mma_block(const BlockIn& in,
                                          float (&acc)[2][4],
                                          const float (&pw)[2][2]) {
  uint32_t b[2];
  b_frags(in.x, b);
  const float pa0 = pow2_e8(in.ea[0]);
  const float pa1 = pow2_e8(in.ea[1]);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int d[4];
    mma_s8(d, in.a[0], in.a[1], b[p]);
    scaled_add(acc[p][0], d[0], pa0, pw[p][0]);
    scaled_add(acc[p][1], d[1], pa0, pw[p][1]);
    if (NH == 2) {
      scaled_add(acc[p][2], d[2], pa1, pw[p][0]);
      scaled_add(acc[p][3], d[3], pa1, pw[p][1]);
    }
  }
}

// a warp's tile over one ring stage: its act blocks kb0 .. in increasing
// order, in runs that share a w_block (and so the column scales pw, read
// from the stage's exponent rows at each run's start); each block's
// operands are loaded while the one before it computes
template <int NH>
__device__ __forceinline__ void mma_stage(const GemmSmem& s,
                                          const int8_t* stage,
                                          const GemmGeom& g,
                                          const WStream& ws, const WarpTile& w,
                                          int kb0, int a_ld, int e_ld,
                                          float (&acc)[2][4]) {
  const int lane = threadIdx.x % kWarp, gq = lane >> 2, tq = lane & 3;
  const int ld = w_stride(g.bn);
  const int nkb = min(g.bk / kAB, ws.kc / kAB - kb0);
  const int8_t* ex = stage + g.bk * ld + w.wc + 4 * tq;
  const int8_t* wr = stage + tq * ld + w.wc + 2 * gq;
  BlockIn cur;
  load_block<NH>(cur, s, wr, ld, w.r0, kb0, a_ld, e_ld);
  for (int k = 0; k < nkb;) {
    const int k_lo = ws.kbase + (kb0 + k) * kAB;       // K index of block k
    const int run = min(nkb, k + ((k_lo / ws.w_block + 1) * ws.w_block -
                                  k_lo) / kAB);
    float pw[2][2];
    pw[0][0] = pow2_e8(ex[k * ld]);
    pw[1][0] = pow2_e8(ex[k * ld + 1]);
    pw[0][1] = pow2_e8(ex[k * ld + 2]);
    pw[1][1] = pow2_e8(ex[k * ld + 3]);
#pragma unroll 2
    for (; k < run; ++k) {
      BlockIn next;
      const int kn = min(k + 1, nkb - 1);
      load_block<NH>(next, s, wr + kn * kAB * ld, ld, w.r0, kb0 + kn, a_ld,
                     e_ld);
      mma_block<NH>(cur, acc, pw);
      cur = next;
    }
  }
}

// ---- V 1 and 2: any act block, 2-16 bits --------------------------------
// d += a * b on the int8 tensor cores: a 16 x 16 and b 16 x 8, each s8 (a
// high byte) or, AU / BU, u8 (a low byte)
template <bool AU, bool BU>
__device__ __forceinline__ void mma_acc(int (&d)[4], uint32_t a0, uint32_t a1,
                                        uint32_t b) {
#define MX_MMA_ACC(TYPES)                                                   \
  asm("mma.sync.aligned.m16n8k16.row.col.s32." TYPES ".s32 "                \
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"               \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])                      \
      : "r"(a0), "r"(a1), "r"(b))
  if constexpr (AU && BU)
    MX_MMA_ACC("u8.u8");
  else if constexpr (AU)
    MX_MMA_ACC("u8.s8");
  else if constexpr (BU)
    MX_MMA_ACC("s8.u8");
  else
    MX_MMA_ACC("s8.s8");
#undef MX_MMA_ACC
}

// the B fragments of one k16 step (load_block's, two n8 tiles)
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* wr,
                                       int ld) {
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const uint16_t*>(wr + 4 * i * ld);
  b_frags(x, b);
}

// the A fragments of rows r and r + 8 at columns col .. col + 3 (col =
// 16 step + 4 t): the s8 words (hi) and, with W, the int16 tile's low
// bytes (lo, u8) beside its high bytes (hi)
template <bool W>
struct AFrag {
  uint32_t hi[2], lo[2];
};

template <bool W>
__device__ __forceinline__ void load_a(AFrag<W>& f, const int8_t* a, int r,
                                       int col, int a_ld) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (W) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const int16_t*>(a) + (r + 8 * h) * a_ld + col);
      f.lo[h] = __byte_perm(v.x, v.y, 0x6420);
      f.hi[h] = __byte_perm(v.x, v.y, 0x7531);
    } else {
      f.hi[h] = *reinterpret_cast<const uint32_t*>(a + (r + 8 * h) * a_ld +
                                                    col);
      f.lo[h] = 0;
    }
  }
}

// the bytes of a lane's A word (columns c .. c + 3) inside the block
// [lo, lo + n) of the step's 16 columns, c = 4 t: lo - c = rel
__device__ __forceinline__ uint32_t block_mask(int rel, int n) {
  const int s = min(max(rel, 0), 4), e = min(max(rel + n, 0), 4);
  return (uint32_t)((1ull << (8 * e)) - (1ull << (8 * s)));
}

template <bool W>
__device__ __forceinline__ void mma_frag(int (&dh)[2][4], int (&dl)[2][4],
                                         const AFrag<W>& f,
                                         const uint32_t (&b)[2],
                                         uint32_t m) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    mma_acc<false, false>(dh[p], f.hi[0] & m, f.hi[1] & m, b[p]);
    if constexpr (W)
      mma_acc<true, false>(dl[p], f.lo[0] & m, f.lo[1] & m, b[p]);
  }
}

// a block's scaled adds: dot = dh (+ 256 dh + dl with W), exact in int32,
// rounded once to float
template <int NH, bool W>
__device__ __forceinline__ void block_adds(float (&acc)[2][4],
                                           const int (&dh)[2][4],
                                           const int (&dl)[2][4], int ea0,
                                           int ea1, const float (&pw)[2][2]) {
  const float pa[2] = {pow2_e8(ea0), pow2_e8(ea1)};
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 2 * NH; ++i) {
      const int d = W ? dh[p][i] * 256 + dl[p][i] : dh[p][i];
      acc[p][i] = __fadd_rn(acc[p][i],
                            __fmul_rn(__int2float_rn(d),
                                      __fmul_rn(pa[i >> 1], pw[p][i & 1])));
    }
}

// mma_stage for V 1 and 2: the act block ab in k16 steps (ab >= 16: ab / 16
// steps a block, a block's first step at a multiple of them, since bk and
// the chunk are multiples of ab) or per step (ab < 16: 16 / ab blocks)
template <int NH, bool W>
__device__ __forceinline__ void mma_stage_any(const GemmSmem& s,
                                              const int8_t* stage,
                                              const GemmGeom& g,
                                              const WStream& ws,
                                              const WarpTile& w, int ks0,
                                              int a_ld, int e_ld,
                                              float (&acc)[2][4]) {
  const int lane = threadIdx.x % kWarp, gq = lane >> 2, tq = lane & 3;
  const int ld = w_stride(g.bn);
  const int nks = min(g.bk / kAB, ws.kc / kAB - ks0);
  const int8_t* ex = stage + g.bk * ld + w.wc + 4 * tq;
  const int8_t* wr = stage + tq * ld + w.wc + 2 * gq;
  const int r = w.r0 + gq;
  const int ab = ws.ab;
  const int steps = ab >= kAB ? ab / kAB : 1;   // k16 steps of a block
  const int per = ab >= kAB ? 1 : kAB / ab;     // blocks of a k16 step
  for (int k = 0; k < nks;) {
    const int k_lo = ws.kbase + (ks0 + k) * kAB;
    const int run = min(nks, k + ((k_lo / ws.w_block + 1) * ws.w_block -
                                  k_lo) / kAB);
    float pw[2][2];
    pw[0][0] = pow2_e8(ex[k * ld]);
    pw[1][0] = pow2_e8(ex[k * ld + 1]);
    pw[0][1] = pow2_e8(ex[k * ld + 2]);
    pw[1][1] = pow2_e8(ex[k * ld + 3]);
    if (per == 1) {
      for (; k < run; k += steps) {
        int dh[2][4] = {}, dl[2][4] = {};
        for (int j = 0; j < steps; ++j) {
          uint32_t b[2];
          load_b(b, wr + (k + j) * kAB * ld, ld);
          AFrag<W> f;
          load_a<W>(f, s.a, r, (ks0 + k + j) * kAB + 4 * tq, a_ld);
          mma_frag<W>(dh, dl, f, b, 0xffffffffu);
        }
        const int eb = (ks0 + k) / steps;
        block_adds<NH, W>(acc, dh, dl, s.e[r * e_ld + eb],
                          NH == 2 ? s.e[(r + 8) * e_ld + eb] : 0, pw);
      }
    } else {
      for (; k < run; ++k) {
        uint32_t b[2];
        load_b(b, wr + k * kAB * ld, ld);
        AFrag<W> f;
        load_a<W>(f, s.a, r, (ks0 + k) * kAB + 4 * tq, a_ld);
        for (int j = 0; j < per; ++j) {
          int dh[2][4] = {}, dl[2][4] = {};
          mma_frag<W>(dh, dl, f, b, block_mask(j * ab - 4 * tq, ab));
          const int eb = (ks0 + k) * per + j;
          block_adds<NH, W>(acc, dh, dl, s.e[r * e_ld + eb],
                            NH == 2 ? s.e[(r + 8) * e_ld + eb] : 0, pw);
        }
      }
    }
  }
}

// ---- V 3 and 4: segments, int8 or int16 planes --------------------------
// The B fragments of one k16 step of an int16 tile: lane (g, t) reads the
// 4-byte pieces (columns 2g, 2g + 1) of K rows 4t..4t+3 and splits each
// int16 into its signed high byte (hi) and unsigned low byte (lo), in the
// layout b_frags gives an int8 tile (tests/test_torch_kernels.py models
// the selectors)
__device__ __forceinline__ void load_b16(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                         const int8_t* wr, int ld) {
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const uint32_t*>(wr + 4 * i * ld);
  const uint32_t l01 = __byte_perm(x[0], x[1], 0x6240);
  const uint32_t l23 = __byte_perm(x[2], x[3], 0x6240);
  const uint32_t h01 = __byte_perm(x[0], x[1], 0x7351);
  const uint32_t h23 = __byte_perm(x[2], x[3], 0x7351);
  lo[0] = __byte_perm(l01, l23, 0x5410);
  lo[1] = __byte_perm(l01, l23, 0x7632);
  hi[0] = __byte_perm(h01, h23, 0x5410);
  hi[1] = __byte_perm(h01, h23, 0x7632);
}

// the open segment's int32 partial dots, one per pair of bytes: act high
// (h) or low (l) byte by plane high or low byte (lo bytes only for int16
// acts, AW, and int16 planes)
template <bool AW>
struct SegDots {
  int hh[2][4], hl[2][4], lh[2][4], ll[2][4];

  __device__ __forceinline__ void zero(bool w16) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hh[p][i] = 0;
        if (w16) hl[p][i] = 0;
        if (AW) lh[p][i] = 0;
        if (AW && w16) ll[p][i] = 0;
      }
  }
};

// a segment's piece of one k16 step: the A fragments with the columns
// outside the piece zeroed (mask m) against the B fragments
template <bool AW>
__device__ __forceinline__ void seg_mma(SegDots<AW>& sd, const AFrag<AW>& f,
                                        const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2], uint32_t m,
                                        bool w16) {
  const uint32_t h0 = f.hi[0] & m, h1 = f.hi[1] & m;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    mma_acc<false, false>(sd.hh[p], h0, h1, bh[p]);
    if (w16) mma_acc<false, true>(sd.hl[p], h0, h1, bl[p]);
  }
  if constexpr (AW) {
    const uint32_t l0 = f.lo[0] & m, l1 = f.lo[1] & m;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mma_acc<true, false>(sd.lh[p], l0, l1, bh[p]);
      if (w16) mma_acc<true, true>(sd.ll[p], l0, l1, bl[p]);
    }
  }
}

// a segment's scaled adds: its exact dot from the partial dots (uint32
// arithmetic; the dot itself is below 2^31), rounded once to float, then
// the two rounded steps; the partial dots restart
template <int NH, bool AW>
__device__ __forceinline__ void seg_adds(float (&acc)[2][4], SegDots<AW>& sd,
                                         bool w16, int ea0, int ea1,
                                         const float (&pw)[2][2]) {
  const float pa[2] = {pow2_e8(ea0), pow2_e8(ea1)};
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 2 * NH; ++i) {
      uint32_t d = (uint32_t)sd.hh[p][i];
      if (w16) d = d * 256u + (uint32_t)sd.hl[p][i];
      if constexpr (AW) {
        uint32_t l = (uint32_t)sd.lh[p][i];
        if (w16) l = l * 256u + (uint32_t)sd.ll[p][i];
        d = d * 256u + l;
      }
      acc[p][i] = __fadd_rn(acc[p][i],
                            __fmul_rn(__int2float_rn((int)d),
                                      __fmul_rn(pa[i >> 1], pw[p][i & 1])));
    }
  sd.zero(w16);
}

// the column scales 2^e_w of a lane's four columns from a staged exponent
// row
__device__ __forceinline__ void load_pw(float (&pw)[2][2], const int8_t* ex) {
  pw[0][0] = pow2_e8(ex[0]);
  pw[1][0] = pow2_e8(ex[1]);
  pw[0][1] = pow2_e8(ex[2]);
  pw[1][1] = pow2_e8(ex[3]);
}

// mma_stage for V 3 and 4: the stage's k16 steps in order; in each, the
// pieces of the segments that meet it, cut where the open segment ends
// (the next act boundary na or weight boundary nw, chunk-relative).  The
// open segment's partial dots sd carry over to the next step and stage.
template <int NH, bool AW>
__device__ __forceinline__ void mma_stage_seg(const GemmSmem& s,
                                              const int8_t* stage,
                                              const GemmGeom& g,
                                              const WStream& ws,
                                              const WarpTile& w, int ks0,
                                              int a_ld, int e_ld,
                                              float (&acc)[2][4],
                                              SegDots<AW>& sd) {
  const int lane = threadIdx.x % kWarp, gq = lane >> 2, tq = lane & 3;
  const bool w16 = ws.wb == 2;
  const int ld = w_stride(g.bn, ws.wb);
  const int nks = min(g.bk / kAB, ws.kc / kAB - ks0);
  const int8_t* ex = stage + g.bk * ld + w.wc + 4 * tq;
  const int8_t* wr = stage + tq * ld + (w.wc + 2 * gq) * ws.wb;
  const int r = w.r0 + gq;
  const int ab = ws.ab;
  int c = ks0 * kAB;                          // the step's first column
  int ai = c / ab;                            // the open act block
  int na = (ai + 1) * ab;
  int nw = ((ws.kbase + c) / ws.w_block + 1) * ws.w_block - ws.kbase;
  float pw[2][2];
  load_pw(pw, ex);
  for (int k = 0; k < nks; ++k, c += kAB) {
    uint32_t bh[2], bl[2] = {0u, 0u};
    const int8_t* wk = wr + k * kAB * ld;
    if (w16)
      load_b16(bh, bl, wk, ld);
    else
      load_b(bh, wk, ld);
    AFrag<AW> f;
    load_a<AW>(f, s.a, r, c + 4 * tq, a_ld);
    const int c1 = c + kAB;
    for (int p0 = c; p0 < c1;) {
      const int end = min(na, nw);            // the open segment's end
      const int p1 = min(end, c1);
      seg_mma<AW>(sd, f, bh, bl, block_mask(p0 - c - 4 * tq, p1 - p0), w16);
      if (p1 == end) {
        seg_adds<NH, AW>(acc, sd, w16, s.e[r * e_ld + ai],
                         NH == 2 ? s.e[(r + 8) * e_ld + ai] : 0, pw);
        if (end == na) {
          ++ai;
          na += ab;
        }
      }
      p0 = p1;
    }
    if (c1 == nw) {                           // the next weight block
      nw += ws.w_block;
      if (k + 1 < nks) load_pw(pw, ex + (k + 1) * ld);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[p][i] = 0.0f;
}

// store a warp's part of the column tile at col0: lane (g, t) holds
// columns 4t..4t+3 of its 16 (even n8 tile: 4t, 4t+2; odd: 4t+1, 4t+3)
__device__ __forceinline__ void store_tile(const float (&acc)[2][4],
                                           const WarpTile& w,
                                           float* __restrict__ out, int m0,
                                           int N, int bn, int col0) {
  const int lane = threadIdx.x % kWarp, gq = lane >> 2, tq = lane & 3;
  const int col = col0 + w.wc + 4 * tq;
  const int end = min(N, col0 + bn);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (gq + 8 * h >= w.rows) continue;
    const float v[4] = {acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1],
                        acc[1][2 * h + 1]};
    float* o = out + (size_t)(m0 + w.r0 + gq + 8 * h) * N + col;
    if (col + 3 < end && N % 4 == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col + c < end) o[c] = v[c];
    }
  }
}

// run the stream whose first stages stream_begin issued: every stage in
// turn, one __syncthreads a stage, the next stages' copies in flight.
// Tile t of the stream adds into acc[min(t, NACC - 1)]; with out given
// (NACC 1) each tile is stored at its last stage and its sums restart.
// A warp whose 16 rows lie past M computes nothing; one whose rows g + 8
// do, or lie past the tile (a decode batch of at most 8 rows; the second
// warp row of a 24-row tile), skips them.
template <int NACC, int V>
__device__ __forceinline__ void stream_run(const GemmSmem& s,
                                           const WStream& ws,
                                           const GemmGeom& g, int a_ld,
                                           int e_ld, int m0, int M,
                                           float (&acc)[NACC][2][4],
                                           float* __restrict__ out) {
  const WarpTile w = warp_tile(g, m0, M);
  const int total = ws.n_tiles * ws.nst;
  // V 3 and 4: the plane bytes at run time, and the open segment's sums
  const bool w16 = V >= 3 && ws.wb == 2;
  SegDots<V == 4> sd;
  for (int j = 0; j < total; ++j) {
    wait_ring(g.ns);
    __syncthreads();                    // stage j and the prologue are in
    if (w16)                            // into stage j - 1's slot
      issue_stage<true>(ws, g, s.w, j + g.ns - 1);
    else
      issue_stage<false>(ws, g, s.w, j + g.ns - 1);
    cp_async_group();
    const int t = j / ws.nst, st = j - t * ws.nst;
    const int col0 = ws.n0 + t * g.bn;
    if (w.rows > 0 && w.wc < g.bn && col0 + w.wc < ws.N) {
      const int8_t* stage = s.w + (j % g.ns) * stage_bytes(g, w16 ? 2 : 1);
      const int kb0 = st * (g.bk / kAB);
      if (V >= 3 && st == 0) sd.zero(w16);      // a tile's first segment
      auto run = [&](float (&a)[2][4]) {
        if constexpr (V == 0) {
          if (w.rows > 8)
            mma_stage<2>(s, stage, g, ws, w, kb0, a_ld, e_ld, a);
          else
            mma_stage<1>(s, stage, g, ws, w, kb0, a_ld, e_ld, a);
        } else if constexpr (V <= 2) {
          if (w.rows > 8)
            mma_stage_any<2, V == 2>(s, stage, g, ws, w, kb0, a_ld, e_ld, a);
          else
            mma_stage_any<1, V == 2>(s, stage, g, ws, w, kb0, a_ld, e_ld, a);
        } else {
          if (w.rows > 8)
            mma_stage_seg<2, V == 4>(s, stage, g, ws, w, kb0, a_ld, e_ld, a,
                                     sd);
          else
            mma_stage_seg<1, V == 4>(s, stage, g, ws, w, kb0, a_ld, e_ld, a,
                                     sd);
        }
      };
      if (NACC == 1 || t == 0)          // static indices: acc stays in
        run(acc[0]);                    // registers
      else
        run(acc[NACC - 1]);
    }
    if (out != nullptr && st == ws.nst - 1) {
      store_tile(acc[0], w, out, m0, ws.N, g.bn, col0);
      zero_acc(acc[0]);
    }
  }
  cp_async_wait_groups<0>();
}

}  // namespace mx
