"""MXInt matmul with in-kernel activation quantization (paper Fig. 2b).

Replaces ``repro/kernels/mxint_matmul.py:mxint_matmul`` (its
``pallas_call`` at line 164, on both its ``quantize_act`` paths) with
``csrc/mxint_matmul.cu``:

    y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N]

``w_mant`` is a (K, N) int8 mantissa plane and ``w_exp`` a
(K / w_block, N) int8 exponent plane.  Each activation block along K is
quantized as ``_quantize_act_tile`` does; the int32 dot of that block with
the int8 weight mantissas is exact, and scaling it by 2^(e_x + e_w) is
exact too, because the act block divides ``w_block`` (or 16, which
divides ``w_block``), so one block pair shares one scale.  The dot is
rounded once to f32 and the scaled block products are added into an f32
accumulator in increasing K order.

Two routes, chosen by format before the launch (``matmul_route``):

- the GEMM core (below) for int8 and int16 planes (the paper's W2-W16),
  K and ``w_block`` multiples of 16, any act block that divides K,
  mantissas of 2-16 bits, and segment dots below 2^31 (``wide_dot``
  false).  The default, block 16 at 2-8 bits on int8 planes, runs one
  ``mma.sync`` a block; a longer block that nests in the weight block
  chains its k16 steps' mma sums, a shorter one that divides 16 masks the
  A fragments per block, and 9-16 bits split each int16 mantissa into
  its signed high and unsigned low byte, one mma each
  (``csrc/mxint_common.cuh``, V 0-2).  Every other format of the core
  (int16 planes; act blocks that do not nest, as DeiT's FFN ``wo`` at act
  block 12 against 256-element weight blocks) runs by segment, the
  intersection of an act block with a weight block, k16 step by k16
  step: a masked mma per segment piece, the segment's int32 sum carried
  until it ends; an int16 plane's bytes split like the acts' (V 3-4);
- the generic route (``csrc/mxint_generic.cuh``) for the formats the core
  does not take: int32 planes (W17-W24), act mantissas of 17-24 bits, K
  or ``w_block`` off 16, segment dots that may pass 2^31, and
  ``quantize_act=False``.  It sums by the same segments, each segment's
  exact integer dot (int64 where it may pass 2^31) rounded once and added
  as the core adds it; float activations take float64 products and sums
  in K order, rounded once.  Its products run on the CUDA cores, so
  operations bound it.

A format outside both (act mantissas past 24 bits, blocks that do not
divide K, planes of another dtype) raises before anything touches the
card.

On the H100, at DeiT-Base batch 16 the FFN ``wo`` reads x (3152, 3072) f32
(38.7 MB), 2.4 MB of planes and writes (3152, 768) f32 (9.7 MB): about
15 us of memory traffic.  Its int8 products take 7.5 us at the tensor-core
rate, but the ordered f32 sum takes two rounded operations per output
element and act block (M N K / 8 in all, 14 us at the published 67
TFLOP/s), so its least time is set by operations, and the kernel is bound
by instruction issue in that epilogue.  The GEMM core
(``csrc/mxint_common.cuh``) runs the products on the int8 tensor cores:
one ``mma.sync`` m16n8k16 per act block and 16 x 8 outputs, whose int32
result is the block's exact dot, then the plain version's two rounded
steps per element.  A CTA (8 warps per 16 rows) quantizes its 16, 24 or
32 rows of x once into shared memory (int8 or int16 mantissas plus one
exponent per act block) while the first weight tiles load, then streams its column
tiles: the planes' tiles go through a ring of stages by ``cp.async``, each
once per CTA.  ``gemm_geometry`` sizes the tiles from the shape and the
card's SM count: 16-row tiles and narrow column tiles at decode, so that
every SM streams a share of the planes.  A K beyond 4096 (Llama-3-8B's FFN ``wo``,
K 14336) does not fit shared memory whole: the same launch then walks K in
4096-wide chunks, quantizes each in turn and adds its block products onto
the partial sums of the CTA's (at most 2) column tiles, which stay in
registers, in the same K order.  One call is one launch.

The plain version (``matmul_blocks``, by segment; ``matmul_float``)
accumulates the same products in the same order, so either route and the
plain version agree bit for bit; against the reference's f32 dot they
differ in the order of the f32 sums across blocks (and where the
reference's f32 products of 24-bit and wider operands round).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.quantize import pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import (LaunchRecord, emit, rects,
                                               spec)
from repro_torch.kernels.mxint_layernorm import (
    GROUP_XCHG_SMEM, MAX_LUT, SMEM_LIMIT, block_quantize_rows, lut_tensor,
    sm_count)

ACT_BLOCK = 16        # the mma depth; the act block of the default path
MAX_ACT_BLOCK = 256   # |dot| <= 256 * 32767 * 127 < 2^31
# act mantissa widths the CUDA kernel takes: its act tile is int8, or int16
# above 8 bits (the plain version, like the reference, takes any width)
MIN_ACT_MANT_BITS, MAX_ACT_MANT_BITS = 2, 16

# the GEMM core's constants (csrc/mxint_common.cuh, csrc/mxint_matmul.cu)
WARP_COLS = 16                      # a warp's columns: two n8 mma tiles
MAX_TILE_COLS = 8 * WARP_COLS       # 8 warps side by side on the columns
DECODE_STAGES = 4                   # weight ring depth at 16-row tiles
MAX_CHUNK = 4096                    # K columns of x held in shared memory
MAX_ACC_TILES = 2                   # column tiles a chunked CTA holds
# weight of gemm_geometry's cost: a CTA's prologue (the act quantization,
# or the fused LayerNorm) in units of one 128-column tile's products, as
# timed on the H100 at DeiT-Base's shapes while the core was tuned; the
# redesigned LN stage costs about the same (mxint_ln_matmul against
# mxint_matmul at the same tiles, PERF.md)
PROLOGUE_TILES = 1.0
# the share of a tile's work that scales with its rows (the ordered f32
# epilogue: 4 of the core's 7 instructions per element and act block);
# the mma, the B fragments and the weight stream scale with 16-row groups
EPILOGUE_SHARE = 4 / 7

launches = 0


@functools.lru_cache(maxsize=None)
def _pow2_table() -> tuple:
    """pow2i(n) for every block scale exponent n = e_x + e_w in [-254,
    254] (both exponents are int8 in [-127, 127])."""
    return tuple(pow2i(torch.arange(-254, 255)).tolist())


_PLAIN_CHUNK = 1 << 22      # scaled segment products the plain version holds

# the largest |mantissa| a plane of each dtype holds: int32 planes carry
# the reference's widest MXInt mantissa, 24 bits (``MXFormat``)
PLANE_MAX = {torch.int8: 127, torch.int16: 2 ** 15 - 1,
             torch.int32: 2 ** 23 - 1}
PLANE_BYTES = {torch.int8: 1, torch.int16: 2, torch.int32: 4}
CORE_PLANES = (torch.int8, torch.int16)    # the GEMM core's plane dtypes
MAX_GEN_MANT_BITS = 24      # act mantissas of the generic route


def segments(K: int, w_block: int, act_block: int):
    """(starts, lengths) of the segments of K: the intersections of an act
    block with a weight block, in increasing K order.  Where one block
    divides the other, the segments are the smaller blocks."""
    cuts = np.union1d(np.arange(0, K, act_block), np.arange(0, K, w_block))
    return cuts, np.diff(np.append(cuts, K))


def _plane_max(w_mant: torch.Tensor) -> int:
    return PLANE_MAX.get(w_mant.dtype, 2 ** 24)


def matmul_blocks(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                  *, w_block: int, act_block: int,
                  act_mant_bits: int) -> torch.Tensor:
    """Plain version: segment products summed in increasing K order.  A
    segment is the intersection of an act block with a weight block (the
    act block itself wherever it divides ``w_block``).  Each segment's dot
    is exact, then rounded once to f32 (float32 products where every
    partial sum stays below 2^24, float64 below 2^53, else the weight
    mantissas split into a high and a low 12 bits whose two float64 dots
    are exact and meet in int64) and scaled by 2^(e_x + e_w).  The scaled
    products are taken for a run of segments at once (at most
    ``_PLAIN_CHUNK`` of them), then added to the f32 sum one segment after
    the other.  Where every scale 2^e_x, 2^e_w and 2^(e_x + e_w) lies in
    the normal range and the dot is exact in float64, the scales go into
    the operands (power-of-two factors, exact), so each dot comes out
    scaled, with no rounding but the f64 dot's own to f32; otherwise each
    dot is multiplied by its scale from a table of ``pow2i``, which
    handles the subnormal and overflowing scales.  Both give the same bits
    where both apply."""
    M, K = x.shape
    N = w_mant.shape[1]
    starts, lens = segments(K, w_block, act_block)
    ns, L = len(starts), int(lens.max())
    xm, xe = block_quantize_rows(x, act_block, act_mant_bits)
    xm = xm.reshape(M, K)
    w_max = _plane_max(w_mant)
    x_max = 2 ** (act_mant_bits - 1) - 1
    top = L * x_max * w_max
    exact = torch.float32 if top < 2 ** 24 else torch.float64
    split = top >= 2 ** 53
    dev = x.device
    if (lens == L).all():
        xs = xm.to(exact).reshape(M, ns, L).transpose(0, 1)  # (ns, M, L)
        wm = w_mant.to(exact).reshape(ns, L, N)
    else:
        # segments of several lengths: gathered and padded with zeros,
        # which leave every dot as it is
        idx = torch.from_numpy(starts[:, None] + np.arange(L)[None, :])
        live = torch.from_numpy(np.arange(L)[None, :] < lens[:, None])
        idx = torch.where(live, idx, 0).to(dev)
        live = live.to(dev)
        xs = torch.where(live, xm[:, idx], 0.0).to(exact).transpose(0, 1)
        wm = torch.where(live[..., None], w_mant[idx].to(exact), 0.0)
    seg = torch.from_numpy(starts).to(dev)
    xe = xe[:, seg // act_block].transpose(0, 1)          # (ns, M)
    we = w_exp.to(torch.int32)[seg // w_block]            # (ns, N)
    x_lo, x_hi = int(xe.min()), int(xe.max())
    w_lo, w_hi = int(we.min()), int(we.max())
    folded = (not split and min(x_lo, w_lo, x_lo + w_lo) >= -126 and
              x_hi + w_hi + top.bit_length() < 128
              and x_hi + x_max.bit_length() < 128
              and w_hi + int(w_max).bit_length() < 128)
    # the weight scales go into the weight planes when they are the
    # smaller of the two (more rows than a segment), else into the dots
    fold_w = folded and M > L
    table = lut_tensor(_pow2_table(), dev)                # pow2i(n - 254)
    if folded:
        xs = xs * table[xe + 254].to(exact)[..., None]
        w_scale = table[we + 254].to(exact)[:, None, :]   # (ns, 1, N)
        if fold_w:
            wm = wm * w_scale
    else:
        xe = xe + 254
    if split:
        w_hi_ = torch.floor(wm / 4096.0)
        w_lo_ = wm - w_hi_ * 4096.0
    acc = torch.zeros(M, N, dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK // max(1, M * N))
    for k0 in range(0, ns, step):
        k1 = min(ns, k0 + step)
        if split:
            prods = (torch.matmul(xs[k0:k1], w_hi_[k0:k1]).to(torch.int64)
                     * 4096 + torch.matmul(xs[k0:k1], w_lo_[k0:k1]).to(
                         torch.int64))
        else:
            prods = torch.matmul(xs[k0:k1], wm[k0:k1])
        if folded and not fold_w:
            prods = prods * w_scale[k0:k1]
        prods = prods.to(torch.float32)
        if not folded:
            prods = prods * table[xe[k0:k1, :, None] + we[k0:k1, None, :]]
        for p in prods:
            acc = acc + p
    return acc


@functools.lru_cache(maxsize=None)
def _pow2_table64() -> tuple:
    return tuple(float(2.0 ** n) for n in range(-127, 128))


def matmul_float(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 *, w_block: int) -> torch.Tensor:
    """Plain version of ``quantize_act=False``: f32 x times the exact
    weights m * 2^e, products and sums in float64 in increasing K order
    (every product of a float32 and a mantissa of at most 24 bits is exact
    in float64), rounded once to f32."""
    M, K = x.shape
    table = torch.tensor(_pow2_table64(), dtype=torch.float64,
                         device=x.device)
    w = w_mant.to(torch.float64) * table[
        w_exp.to(torch.int64) + 127].repeat_interleave(w_block, dim=0)
    xd = x.to(torch.float64)
    acc = torch.zeros(M, w.shape[1], dtype=torch.float64, device=x.device)
    for k in range(K):
        acc = acc + xd[:, k:k + 1] * w[k]
    return acc.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """Launch geometry of the GEMM core: a CTA owns rows
    [x * bm, (x + 1) * bm) and column tiles [y * n_per, (y + 1) * n_per)
    of bn columns each, for grid (x, y); it streams the weight planes in
    stages of bk rows.  ``chunked``: K is walked in MAX_CHUNK chunks.
    ``per_sm``: the CTAs an SM is assumed to hold at once (the waves of
    the cost estimate; the launch contracts check that they fit).
    ``w_bytes``: plane bytes; ``seg``: the core's segment walk (V 3-4)."""
    bm: int
    bn: int
    n_per: int
    bk: int
    ns: int
    chunked: bool
    grid: tuple
    kc: int = MAX_CHUNK     # K columns a CTA stages at once
    per_sm: int = 1
    w_bytes: int = 1
    seg: bool = False

    def args(self):
        return (self.bm, self.bn, self.n_per, self.bk, self.ns)


def w_stride(bn: int, w_bytes: int = 1) -> int:
    """Shared row stride in bytes of a staged weight tile of int8 or
    (``w_bytes`` 2) int16 planes (``w_stride`` in
    ``csrc/mxint_common.cuh``)."""
    if w_bytes == 2:
        width = max(2 * bn, 32)
        return width + 32 if (width // 32) % 2 == 0 else width
    width = max(bn, 16)
    return width + 16 if (width // 16) % 4 == 0 else width


def w_row(r: int) -> int:
    """Staged row of K row r of a tile (``w_row`` in
    ``csrc/mxint_common.cuh``): rows 4 t + i of a 16-row block are kept in
    the order 4 i + t."""
    return (r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3)


def gemm_smem_bytes(bm: int, bn: int, bk: int, ns: int, kc: int,
                    act_block: int = ACT_BLOCK, a_bytes: int = 1,
                    w_bytes: int = 1) -> int:
    """Dynamic shared memory of a CTA that holds kc columns of its rows,
    act mantissas of ``a_bytes`` bytes, planes of ``w_bytes``
    (``gemm_smem_bytes`` in ``csrc/mxint_common.cuh``)."""
    stage = (bk + bk // ACT_BLOCK) * w_stride(bn, w_bytes)
    e_stride = 4 * ((kc // act_block + 3) // 4 | 1)
    a_rows = -(-bm // 16) * 16          # whole 16-row groups
    return (a_rows * (kc + 16) * a_bytes + (bm * e_stride + 15) // 16 * 16
            + ns * stage + MAX_LUT * 4)


def act_unit(act_block: int) -> int:
    """The K granule of a nested act format (V 0-2): bk and the chunk are
    multiples of it (a whole block, and whole k16 steps)."""
    return max(act_block, ACT_BLOCK)


def seg_unit(act_block: int) -> int:
    """The K granule of a chunk of the segment walk (V 3-4): whole act
    blocks and k16 steps, lcm(act_block, 16) (``seg_unit`` in
    ``csrc/mxint_common.cuh``)."""
    return act_block * ACT_BLOCK // math.gcd(act_block, ACT_BLOCK)


def segmented(act_block: int, w_block: int, w_bytes: int = 1) -> bool:
    """The core runs the format by segment (V 3-4): int16 planes, or an
    act block that does not nest (``act_block_ok``)."""
    return w_bytes != 1 or not act_block_ok(act_block, w_block)


@functools.lru_cache(maxsize=None)
def gemm_geometry(M: int, N: int, K: int, n_sm: int, *,
                  fused_ln: bool = False, act_block: int = ACT_BLOCK,
                  wide: bool = False, w_bytes: int = 1,
                  seg: bool = False) -> GemmGeometry:
    """Tiles of the GEMM core for y[M, N] = x[M, K] @ W[K, N] on a card of
    ``n_sm`` SMs.

    Rows: 16 a tile when M <= 16 (a decode batch), else 32 or 24, whichever
    the cost estimate favours (24 fills the card where 32 leaves SMs idle:
    3152 DeiT rows make 132 tiles of 24).  Columns: the widest power-of-two
    tile, at most 128 (8 warps of 16 columns) and at least 4, that still
    gives every SM a CTA; so at decode the planes are streamed by the whole
    card.  With many rows, each CTA takes ``n_per``
    consecutive column tiles, so that it quantizes (or normalizes) its rows
    once for all of them; ``n_per`` minimizes the waves of CTAs over the
    card times each CTA's tiles plus its prologue.  K is never split: one
    thread owns every output element's whole ordered sum.  K beyond
    MAX_CHUNK is walked in chunks, except with ``fused_ln``: the fused
    LayerNorm kernel holds its whole rows.  An act format whose tile does
    not fit (short act blocks: an exponent an element; 9-16 bits: int16
    mantissas) stages narrower chunks, and with ``fused_ln`` fewer rows:
    16-row tiles where 24 or 32 do not fit.  ``wide``: act mantissas of
    9-16 bits; ``w_bytes``: 2 for int16 planes (twice the stage bytes);
    ``seg``: the segment walk (V 3-4), whose stages are whole k16 steps
    and whose chunks whole act blocks (``seg_unit``).  Raises where no
    geometry fits shared memory.  Cached: a decode step asks for the same
    few shapes every call."""
    best = None
    fmt = (fused_ln, act_block, wide, w_bytes, seg)
    for bm in (16,) if M <= 16 else (32, 24):
        got = _tile_geometry(M, N, K, n_sm, bm, *fmt)
        if got is not None and (best is None or got[1] < best[1]):
            best = got
    if best is None and M > 16:
        best = _tile_geometry(M, N, K, n_sm, 16, *fmt)
    if best is None:
        raise ValueError(f"no GEMM tile of {M}x{K}->{N} at act block "
                         f"{act_block}{' (int16)' if wide else ''} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best[0]


def _tile_geometry(M, N, K, n_sm, bm, fused_ln, act_block=ACT_BLOCK,
                   wide=False, w_bytes=1, seg=False):
    """gemm_geometry at row tile bm: (geometry, estimated time in units of
    one 32 x 128 tile's work), or None where nothing fits shared memory."""
    rows = -(-M // bm)
    bn = MAX_TILE_COLS
    while bn > (4 if bm == 16 else WARP_COLS) and \
            rows * -(-N // bn) < n_sm:
        bn //= 2
    # bk: whole act blocks (nested) or k16 steps (segments run on across
    # stages); the chunk: whole act blocks and k16 steps
    unit = ACT_BLOCK if seg else act_unit(act_block)
    c_unit = seg_unit(act_block) if seg else unit
    a_bytes = 2 if wide else 1

    def smem(b, ns, kc):
        return gemm_smem_bytes(bm, bn, b, ns, kc, act_block, a_bytes,
                               w_bytes)

    if bm == 16:
        # a decode batch streams the planes: a deep ring of small stages
        # (of the same bytes at either plane width), two 256-thread CTAs to
        # an SM
        bk0 = -(-min(512, max(128, 8192 // (bn * w_bytes))) // unit) * unit
        ns, bks = DECODE_STAGES, (bk0,) + tuple(
            b for b in (256, 128, 64) if b < bk0 and b % unit == 0)
    else:
        # many rows: the products bound it; two large stages (one
        # __syncthreads per 16 act blocks), one 512-thread CTA to an SM
        ns, bks = 2, tuple(b for b in (256, 128, 64) if b % unit == 0) or \
            (unit,)
    # the K columns staged at once: all of them (fused LN), else chunks of
    # at most MAX_CHUNK, narrower where the tile would not fit
    kcs = (K,) if fused_ln else tuple(
        c for c in range(min(K, MAX_CHUNK) // c_unit * c_unit, 0, -c_unit)
        if c == K or c % 256 == 0 or c == c_unit)
    kc, bk = next(((c, b) for c in kcs for b in bks
                   if smem(b, ns, c) <= SMEM_LIMIT), (None, None))
    if kc is None:
        return None
    chunked = K > kc
    # CTAs an SM holds: two of 256 threads or one of 512, fewer if shared
    # memory runs out
    per_sm = max(1, min(2 if bm == 16 else 1, SMEM_LIMIT // smem(bk, ns, kc)))
    tile = (EPILOGUE_SHARE * bm / 32 + (1 - EPILOGUE_SHARE) * -(-bm // 16)
            / 2) * bn / MAX_TILE_COLS
    prologue = PROLOGUE_TILES * bm / 32
    tiles = -(-N // bn)

    def cost(n_per):
        waves = -(-rows * -(-tiles // n_per) // (n_sm * per_sm))
        return waves * (n_per * tile + prologue)

    n_per = min(range(1, (MAX_ACC_TILES if chunked else tiles) + 1),
                key=cost)
    return (GemmGeometry(bm, bn, n_per, bk, ns, chunked,
                         (rows, -(-tiles // n_per)), kc, per_sm, w_bytes,
                         seg),
            cost(n_per))


def block_mask(rel: int, n: int) -> int:
    """The bytes of a lane's A word (four columns from c) inside the piece
    [c + rel, c + rel + n) (``block_mask`` in ``csrc/mxint_common.cuh``)."""
    lo, hi = min(max(rel, 0), 4), min(max(rel + n, 0), 4)
    return (1 << (8 * hi)) - (1 << (8 * lo))


def segment_walk(K: int, w_block: int, act_block: int, bk: int, kc: int):
    """The pieces the core's segment walk runs (V 3-4, ``mma_stage_seg``
    in ``csrc/mxint_common.cuh``), in order: (k16 step, first column,
    end column, whether the segment ends there) over chunks of ``kc``
    columns and ring stages of ``bk`` rows.  Each stage starts from its
    first column as the kernel does (the open act block and the next act
    and weight boundaries by division, chunk-relative); within it, the
    cuts are the next act boundary ``na`` or weight boundary ``nw``,
    whichever comes first, and the step's end."""
    out = []
    for k0 in range(0, K, kc):
        kcc = min(kc, K - k0)
        for c in range(0, kcc, bk):
            na = (c // act_block + 1) * act_block
            nw = ((k0 + c) // w_block + 1) * w_block - k0
            for _ in range(min(bk, kcc - c) // ACT_BLOCK):
                c1, p0 = c + ACT_BLOCK, c
                while p0 < c1:
                    end = min(na, nw)
                    p1 = min(end, c1)
                    out.append(((k0 + c) // ACT_BLOCK, k0 + p0, k0 + p1,
                                p1 == end))
                    if p1 == end and end == na:
                        na += act_block
                    p0 = p1
                if c1 == nw:
                    nw += w_block
                c = c1
    return out


def gemm_threads(bm: int) -> int:
    """Threads of a GEMM CTA: 8 warps per 16 rows (``gemm_threads`` in
    ``csrc/mxint_common.cuh``)."""
    return -(-bm // 16) * 256


def act_variant(act_block: int, act_mant_bits: int,
                seg: bool = False) -> int:
    """The GEMM core's instance of a format (``act_variant`` in
    ``csrc/mxint_common.cuh``): by segment (``seg``) 3, or 4 at int16 act
    mantissas; else 2 int16 act mantissas, 0 the default block 16, 1 any
    other nested block."""
    if seg:
        return 4 if act_mant_bits > 8 else 3
    return 2 if act_mant_bits > 8 else 0 if act_block == ACT_BLOCK else 1


def gemm_launch(kernel: str, geom: GemmGeometry, M: int, N: int, K: int,
                act_block: int, act_mant_bits: int, operands: tuple,
                label: str = "", fused_ln: bool = False,
                piece: int = 0) -> LaunchRecord:
    """The ``LaunchRecord`` of a GEMM-core launch at ``geom``: the kernel
    instance and the dynamic shared memory as the C entries pick them
    (``mxint_matmul_launch``, ``mxint_ln_matmul`` ``launch``); ``piece``:
    the fused kernel's LN piece (its args lead with it)."""
    V = act_variant(act_block, act_mant_bits, geom.seg)
    kc = K
    if geom.chunked:
        kc = geom.kc
        if V == 0 and geom.kc != MAX_CHUNK:   # V 0 takes the full chunk
            V = 1
    smem = gemm_smem_bytes(geom.bm, geom.bn, geom.bk, geom.ns, kc,
                           act_block, 2 if V in (2, 4) else 1, geom.w_bytes)
    fn = (f"{kernel}_kernel<V{V}>" if fused_ln else
          f"{kernel}_kernel<chunked={int(geom.chunked)}, V{V}>")
    bm, bn, n_per = geom.bm, geom.bn, geom.n_per
    tiles = -(-N // bn)

    def out_tiles():
        x = np.arange(geom.grid[0], dtype=np.int64)[:, None, None]
        t = (np.arange(geom.grid[1], dtype=np.int64)[None, :, None] * n_per
             + np.arange(n_per, dtype=np.int64)[None, None, :])
        t = np.where(t < tiles, t, tiles)           # past the last: empty
        return rects(x * bm, np.minimum(M, (x + 1) * bm), t * bn,
                     np.minimum(N, (t + 1) * bn))

    # the C entries' geometry arguments, the plane bytes last
    args = ((piece,) + geom.args() if fused_ln else
            geom.args() + (geom.kc,)) + (geom.w_bytes,)
    return LaunchRecord(kernel, fn, (geom.grid[0], geom.grid[1], 1),
                        gemm_threads(bm), smem,
                        gemm_static_smem(fused_ln, V, piece), operands,
                        (M, N), out_tiles, geom.per_sm, args, label)


def gemm_static_smem(fused_ln: bool, variant: int, piece: int) -> int:
    """Static shared memory of a GEMM-core kernel instance: the fused
    kernel's LN stage on its four-element route (``piece``) at a run-time
    act block (every variant but 0) holds ``wide_group_max``'s exchange
    slots."""
    return GROUP_XCHG_SMEM if fused_ln and variant and piece else 0


@functools.lru_cache(maxsize=None)
def launch_config(M: int, N: int, K: int, *, w_block: int, act_block: int,
                  act_mant_bits: int, n_sm: int, w_dtype=torch.int8,
                  quantize_act: bool = True, label: str = "") -> LaunchRecord:
    """The launch ``mxint_matmul`` makes for f32 x (M, K) and (K, N)
    planes on a card of ``n_sm`` SMs: the GEMM core where ``matmul_route``
    picks it, else the generic route; raises ``ValueError`` first for a
    format outside both, as the wrapper does."""
    route = matmul_route(K, w_block, act_block, act_mant_bits, w_dtype,
                         quantize_act)
    w_bytes = PLANE_BYTES[w_dtype]
    ops_ = (spec("x", (M, K), torch.float32),
            spec("w_mant", (K, N), w_dtype),
            spec("w_exp", (K // w_block, N), torch.int8),
            spec("out", (M, N), torch.float32,
                 16 if N % 4 == 0 and route == "core" else 0))
    if route != "core":
        return generic_launch("mxint_matmul", M, N, K, w_block, act_block,
                              act_mant_bits, w_dtype, quantize_act, ops_,
                              label)
    geom = gemm_geometry(M, N, K, n_sm, act_block=act_block,
                         wide=act_mant_bits > 8, w_bytes=w_bytes,
                         seg=segmented(act_block, w_block, w_bytes))
    return gemm_launch("mxint_matmul", geom, M, N, K, act_block,
                       act_mant_bits, ops_, label)


# ---------------------------------------------------------------------------
# the routes: the GEMM core, or the generic route beside it
# ---------------------------------------------------------------------------
# The generic route (``csrc/mxint_matmul.cu``, ``generic_gemm`` in
# ``csrc/mxint_generic.cuh``) takes every format of the reference: any act
# block that divides K, nested in the weight block or not, any K, int8,
# int16 or int32 planes, act mantissas of 2-24 bits, and float activations
# (``quantize_act=False``).  A CTA of GEN_THREADS threads owns up to 32
# rows and GEN_BN columns (4 a thread, 32 apart); it stages GEN_TK K steps
# of the act mantissas (int32, quantized from x with the block exponents
# it found first) and of the weight mantissas in shared memory, adds the
# integer products of a segment in int32 (int64 where a segment's dot may
# pass 2^31) and at each segment's end adds (float)dot * 2^(e_a + e_w) in
# the plain version's two rounded steps.  Float activations: float64
# products and sums in K order, rounded once.
GEN_THREADS = 256
GEN_BN = 128
GEN_TK = 32
GEN_MAX_ROWS = 32


def matmul_route(K: int, w_block: int, act_block: int, act_mant_bits: int,
                 w_dtype=torch.int8, quantize_act: bool = True) -> str:
    """'core' (the int8 tensor-core GEMM: int8 or int16 planes, K and
    w_block multiples of 16, 2-16-bit act mantissas, any act block that
    divides K whose chunk granule ``seg_unit`` fits MAX_CHUNK, segment
    dots below 2^31), 'generic' (every other quantized format of the
    reference) or 'float' (``quantize_act=False``, the generic route's
    float64 products).  Raises ``ValueError`` for a format outside them:
    planes of another dtype, blocks that do not divide K, act mantissas
    outside 2-24 bits."""
    if w_dtype not in PLANE_MAX:
        raise ValueError(f"mxint_matmul takes int8, int16 or int32 planes, "
                         f"got {w_dtype}")
    if act_block < 1 or K % act_block or K % w_block:
        raise ValueError(f"act block {act_block} and weight block {w_block} "
                         f"must divide K={K}")
    if not quantize_act:
        return "float"
    if not MIN_ACT_MANT_BITS <= act_mant_bits <= MAX_GEN_MANT_BITS:
        raise ValueError(f"mxint_matmul takes {MIN_ACT_MANT_BITS} <= "
                         f"act_mant_bits <= {MAX_GEN_MANT_BITS}, got "
                         f"{act_mant_bits}")
    core = w_dtype in CORE_PLANES and K % ACT_BLOCK == 0 and \
        w_block % ACT_BLOCK == 0 and act_mant_bits <= MAX_ACT_MANT_BITS \
        and seg_unit(act_block) <= MAX_CHUNK and not wide_dot(
            act_block, w_block, act_mant_bits, w_dtype)
    return "core" if core else "generic"


def wide_dot(act_block: int, w_block: int, act_mant_bits: int,
             w_dtype) -> bool:
    """A segment's dot may pass 2^31: the generic route sums it in int64."""
    return (min(act_block, w_block) * (2 ** (act_mant_bits - 1) - 1)
            * PLANE_MAX[w_dtype] >= 2 ** 31)


def generic_smem_bytes(bm: int, K: int, act_block: int, quantize_act: bool,
                       ln_d: int = 0) -> int:
    """Dynamic shared memory of a generic-route CTA of bm rows
    (``generic_smem_bytes`` in ``csrc/mxint_generic.cuh``): the staged
    act and weight mantissas (int32, or float64 for float activations),
    the fused kernel's normalized rows (f32), the act block exponents."""
    eb = 4 if quantize_act else 8
    exps = -(-bm * (K // act_block) // 16) * 16 if quantize_act else 0
    return GEN_TK * (bm + GEN_BN) * eb + bm * ln_d * 4 + exps


@functools.lru_cache(maxsize=None)
def generic_rows(M: int, K: int, act_block: int, quantize_act: bool,
                 ln_d: int = 0) -> int:
    """Rows of a generic-route CTA: the least power of two that holds M,
    at most GEN_MAX_ROWS, halved until the CTA fits shared memory."""
    bm = min(GEN_MAX_ROWS, 1 << max(0, M - 1).bit_length())
    while bm > 1 and generic_smem_bytes(bm, K, act_block, quantize_act,
                                        ln_d) > SMEM_LIMIT:
        bm //= 2
    if generic_smem_bytes(bm, K, act_block, quantize_act, ln_d) > SMEM_LIMIT:
        raise ValueError(f"a generic GEMM row of K={K} at act block "
                         f"{act_block} does not fit shared memory")
    return bm


_DT = {torch.int8: "int8", torch.int16: "int16", torch.int32: "int32"}


def generic_launch(kernel: str, M: int, N: int, K: int, w_block: int,
                   act_block: int, act_mant_bits: int, w_dtype,
                   quantize_act: bool, operands: tuple, label: str = "",
                   ln_d: int = 0, x_dtype=torch.float32) -> LaunchRecord:
    """The ``LaunchRecord`` of a generic-route launch (``mxint_matmul``, or
    with ``ln_d`` the fused ``mxint_ln_matmul``): CTAs of bm rows by
    GEN_BN columns."""
    bm = generic_rows(M, K, act_block, quantize_act, ln_d)
    grid = (-(-M // bm), -(-N // GEN_BN), 1)
    w = _DT[w_dtype]
    if not quantize_act:
        fn = f"{kernel}_float_kernel<W={w}>"
    else:
        acc = "int64" if wide_dot(act_block, w_block, act_mant_bits,
                                  w_dtype) else "int32"
        T = ("bf16, " if x_dtype == torch.bfloat16 else "f32, ") \
            if ln_d else ""
        fn = f"{kernel}_generic_kernel<{T}W={w}, ACC={acc}>"

    def tiles():
        x = np.arange(grid[0], dtype=np.int64)[:, None]
        y = np.arange(grid[1], dtype=np.int64)[None, :]
        return rects(x * bm, np.minimum(M, (x + 1) * bm), y * GEN_BN,
                     np.minimum(N, (y + 1) * GEN_BN))
    smem = generic_smem_bytes(bm, K, act_block, quantize_act, ln_d)
    return LaunchRecord(kernel, fn, grid, GEN_THREADS, smem, 0, operands,
                        (M, N), tiles, 1, (bm,), label)


def check_planes(K: int, w_mant, w_exp, w_block: int, act_block: int):
    """Raise unless the planes fit x's K and both blocks divide K."""
    N = w_mant.shape[1] if w_mant.dim() == 2 else -1
    if tuple(w_mant.shape) != (K, N) or \
            tuple(w_exp.shape) != (K // w_block, N) or K % w_block or \
            act_block < 1 or K % act_block:
        raise ValueError(
            f"planes {tuple(w_mant.shape)} / {tuple(w_exp.shape)} do not fit "
            f"K={K}, w_block={w_block}, act_block={act_block}")


def act_block_ok(act_block: int, w_block: int) -> bool:
    """The act block nests (the GEMM core's V 0-2): a divisor of 16, or a
    multiple of 16 up to MAX_ACT_BLOCK that divides ``w_block``
    (``act_block_ok`` in ``csrc/mxint_common.cuh``); the core runs any
    other act block by segment."""
    if act_block >= ACT_BLOCK:
        return act_block % ACT_BLOCK == 0 and act_block <= MAX_ACT_BLOCK \
            and w_block % act_block == 0
    return act_block >= 1 and ACT_BLOCK % act_block == 0


@functools.lru_cache(maxsize=None)
def matmul_entry():
    """The C entry point ``mxint_matmul_launch``."""
    return _build.entry("mxint_matmul", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 13 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def generic_entry():
    """The C entry point ``mxint_matmul_generic_launch``."""
    return _build.entry("mxint_matmul_generic", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 10 + [ctypes.c_void_p], lib="mxint_matmul")


def generic_args(K: int, w_block: int, act_block: int, act_mant_bits: int,
                 w_dtype, quantize_act: bool, bm: int) -> tuple:
    """The generic entries' format arguments: w_block, act_mant_bits,
    act_block, plane bytes, int64 dots, quantize_act, bm."""
    wide = quantize_act and wide_dot(act_block, w_block, act_mant_bits,
                                     w_dtype)
    return (w_block, act_mant_bits, act_block,
            torch.tensor([], dtype=w_dtype).element_size(), int(wide),
            int(quantize_act), bm)


def launch_args(x, w_mant, w_exp, out):
    return (x.data_ptr(), w_mant.data_ptr(), w_exp.data_ptr(), out.data_ptr())


generic_launches = 0        # launches of the generic route (within launches)


def mxint_matmul(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 *, w_block: int, act_block: int = 16,
                 act_mant_bits: int = 8,
                 quantize_act: bool = False) -> torch.Tensor:
    """y = Q_act(x) @ (w_mant * 2^w_exp) for x (M, K) f32, or with
    ``quantize_act=False`` (the reference's default) x @ (w_mant *
    2^w_exp).

    A CPU tensor runs the plain version (``matmul_blocks``, or
    ``matmul_float``); a CUDA tensor launches the GEMM core or the generic
    route (``matmul_route``), and raises for any format outside both
    before it touches the card (and where a core format's launch fails:
    no fallback).
    """
    M, K = x.shape
    check_planes(K, w_mant, w_exp, w_block, act_block)
    if x.device.type == "cpu":
        if not quantize_act:
            return matmul_float(x, w_mant, w_exp, w_block=w_block)
        return matmul_blocks(x, w_mant, w_exp, w_block=w_block,
                             act_block=act_block, act_mant_bits=act_mant_bits)
    global launches, generic_launches
    if x.dtype != torch.float32 or w_exp.dtype != torch.int8:
        raise ValueError("mxint_matmul kernel takes f32 x and int8 exponents")
    _build.require_cuda("mxint_matmul", x, w_mant, w_exp)
    N = w_mant.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    rec = launch_config(M, N, K, w_block=w_block, act_block=act_block,
                        act_mant_bits=act_mant_bits, n_sm=sm_count(x.device),
                        w_dtype=w_mant.dtype, quantize_act=quantize_act)
    emit(rec, x=x, w_mant=w_mant, w_exp=w_exp, out=out)
    if len(rec.args) == 1:                        # the generic route
        rc = generic_entry()(*launch_args(x, w_mant, w_exp, out), M, K, N,
                             *generic_args(K, w_block, act_block,
                                           act_mant_bits, w_mant.dtype,
                                           quantize_act, rec.args[0]),
                             _build.stream_ptr(x.device))
        _build.check(rc, "mxint_matmul")
        generic_launches += 1
    else:
        rc = matmul_entry()(*launch_args(x, w_mant, w_exp, out), M, K, N,
                            w_block, act_mant_bits, act_block, *rec.args,
                            _build.stream_ptr(x.device))
        _build.check(rc, "mxint_matmul")
    launches += 1
    return out
