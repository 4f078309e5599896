"""MXInt matmul with in-kernel activation quantization (paper Fig. 2b).

Replaces ``repro/kernels/mxint_matmul.py:mxint_matmul`` (its
``pallas_call`` at line 164, on the ``quantize_act=True`` path the kernel
datapath uses) with ``csrc/mxint_matmul.cu``:

    y[M, N] = Q_act(x)[M, K] @ (w_mant * 2^w_exp)[K, N]

``w_mant`` is a (K, N) int8 mantissa plane and ``w_exp`` a
(K / w_block, N) int8 exponent plane.  Each activation block along K is
quantized as ``_quantize_act_tile`` does; the int32 dot of that block with
the int8 weight mantissas is exact, and scaling it by 2^(e_x + e_w) is
exact too, because the act block divides ``w_block`` (or 16, which
divides ``w_block``), so one block pair shares one scale.  The dot is
rounded once to f32 and the scaled block products are added into an f32
accumulator in increasing K order.

Act formats: blocks that divide 16 (1, 2, 4, 8) and multiples of 16 up to
256 that divide ``w_block``; mantissas of 2-16 bits.  The default, block 16
at 2-8 bits, runs one ``mma.sync`` a block; a longer block chains its
k16 steps' mma sums, a shorter one masks the A fragments per block, and
9-16 bits split each int16 mantissa into its signed high and unsigned low
byte, one mma each (``csrc/mxint_common.cuh``, V 0-2).  Any other act
block, and mantissas past 16 bits, raise before anything touches the
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

The plain version accumulates the same block products in the same order,
so kernel and plain version agree bit for bit; against the reference's
f32 dot they differ in the order of the f32 sums across blocks.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

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


_PLAIN_CHUNK = 1 << 22      # scaled block products the plain version holds


def matmul_blocks(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                  *, w_block: int, act_block: int,
                  act_mant_bits: int) -> torch.Tensor:
    """Plain version: block products summed in increasing K order.  Each
    block's dot is exact, then rounded once to f32 (float32 products where
    every partial sum stays below 2^24, else float64) and scaled by 2^(e_x
    + e_w).  The scaled products are taken for a run of blocks at once (at
    most ``_PLAIN_CHUNK`` of them), then added to the f32 sum one block
    after the other.  Where every scale 2^e_x, 2^e_w and 2^(e_x + e_w)
    lies in the normal range, the scales go into the operands (power-of-two
    factors, exact), so each dot comes out scaled, with no rounding but
    the f64 dot's own to f32; otherwise each dot is multiplied by its scale
    from a table of ``pow2i``, which handles the subnormal and overflowing
    scales.  Both give the same bits where both apply."""
    M, K = x.shape
    N = w_mant.shape[1]
    nb = K // act_block
    xm, xe = block_quantize_rows(x, act_block, act_mant_bits)
    w_max = (torch.iinfo(w_mant.dtype).max if not w_mant.is_floating_point()
             else 2 ** 24)
    x_max = 2 ** (act_mant_bits - 1) - 1
    exact = torch.float32 if act_block * x_max * w_max < 2 ** 24 \
        else torch.float64
    xm = xm.to(exact).transpose(0, 1)                 # (nb, M, act_block)
    wm = w_mant.to(exact).reshape(nb, act_block, N)
    we = w_exp.to(torch.int32).repeat_interleave(w_block // act_block, dim=0)
    xe = xe.transpose(0, 1)                           # (nb, M)
    x_lo, x_hi = int(xe.min()), int(xe.max())
    w_lo, w_hi = int(we.min()), int(we.max())
    folded = (min(x_lo, w_lo, x_lo + w_lo) >= -126 and
              x_hi + w_hi + (act_block * x_max * w_max).bit_length() < 128
              and x_hi + x_max.bit_length() < 128
              and w_hi + int(w_max).bit_length() < 128)
    # the weight scales go into the weight planes when they are the
    # smaller of the two (more rows than an act block), else into the dots
    fold_w = folded and M > act_block
    table = lut_tensor(_pow2_table(), x.device)       # pow2i(n - 254)
    if folded:
        xm = xm * table[xe + 254].to(exact)[..., None]
        w_scale = table[we + 254].to(exact)[:, None, :]   # (nb, 1, N)
        if fold_w:
            wm = wm * w_scale
    else:
        xe = xe + 254
    acc = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_CHUNK // max(1, M * N))
    for k0 in range(0, nb, step):
        k1 = min(nb, k0 + step)
        prods = torch.matmul(xm[k0:k1], wm[k0:k1])
        if folded and not fold_w:
            prods = prods * w_scale[k0:k1]
        prods = prods.to(torch.float32)
        if not folded:
            prods = prods * table[xe[k0:k1, :, None] + we[k0:k1, None, :]]
        for p in prods:
            acc = acc + p
    return acc


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """Launch geometry of the GEMM core: a CTA owns rows
    [x * bm, (x + 1) * bm) and column tiles [y * n_per, (y + 1) * n_per)
    of bn columns each, for grid (x, y); it streams the weight planes in
    stages of bk rows.  ``chunked``: K is walked in MAX_CHUNK chunks.
    ``per_sm``: the CTAs an SM is assumed to hold at once (the waves of
    the cost estimate; the launch contracts check that they fit)."""
    bm: int
    bn: int
    n_per: int
    bk: int
    ns: int
    chunked: bool
    grid: tuple
    kc: int = MAX_CHUNK     # K columns a CTA stages at once
    per_sm: int = 1

    def args(self):
        return (self.bm, self.bn, self.n_per, self.bk, self.ns)


def w_stride(bn: int) -> int:
    """Shared row stride of a staged weight tile (``w_stride`` in
    ``csrc/mxint_common.cuh``)."""
    width = max(bn, 16)
    return width + 16 if (width // 16) % 4 == 0 else width


def w_row(r: int) -> int:
    """Staged row of K row r of a tile (``w_row`` in
    ``csrc/mxint_common.cuh``): rows 4 t + i of a 16-row block are kept in
    the order 4 i + t."""
    return (r & ~15) | ((r & 3) << 2) | ((r >> 2) & 3)


def gemm_smem_bytes(bm: int, bn: int, bk: int, ns: int, kc: int,
                    act_block: int = ACT_BLOCK, a_bytes: int = 1) -> int:
    """Dynamic shared memory of a CTA that holds kc columns of its rows,
    act mantissas of ``a_bytes`` bytes (``gemm_smem_bytes`` in
    ``csrc/mxint_common.cuh``)."""
    stage = (bk + bk // ACT_BLOCK) * w_stride(bn)
    e_stride = 4 * ((kc // act_block + 3) // 4 | 1)
    a_rows = -(-bm // 16) * 16          # whole 16-row groups
    return (a_rows * (kc + 16) * a_bytes + (bm * e_stride + 15) // 16 * 16
            + ns * stage + MAX_LUT * 4)


def act_unit(act_block: int) -> int:
    """The K granule of an act format: bk and the chunk are multiples of
    it (a whole block, and whole k16 steps)."""
    return max(act_block, ACT_BLOCK)


@functools.lru_cache(maxsize=None)
def gemm_geometry(M: int, N: int, K: int, n_sm: int, *,
                  fused_ln: bool = False, act_block: int = ACT_BLOCK,
                  wide: bool = False) -> GemmGeometry:
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
    9-16 bits.  Raises where no geometry fits shared memory.
    Cached: a decode step asks for the same few shapes every call."""
    best = None
    for bm in (16,) if M <= 16 else (32, 24):
        got = _tile_geometry(M, N, K, n_sm, bm, fused_ln, act_block, wide)
        if got is not None and (best is None or got[1] < best[1]):
            best = got
    if best is None and M > 16:
        best = _tile_geometry(M, N, K, n_sm, 16, fused_ln, act_block, wide)
    if best is None:
        raise ValueError(f"no GEMM tile of {M}x{K}->{N} at act block "
                         f"{act_block}{' (int16)' if wide else ''} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best[0]


def _tile_geometry(M, N, K, n_sm, bm, fused_ln, act_block=ACT_BLOCK,
                   wide=False):
    """gemm_geometry at row tile bm: (geometry, estimated time in units of
    one 32 x 128 tile's work), or None where nothing fits shared memory."""
    rows = -(-M // bm)
    bn = MAX_TILE_COLS
    while bn > (4 if bm == 16 else WARP_COLS) and \
            rows * -(-N // bn) < n_sm:
        bn //= 2
    unit = act_unit(act_block)
    a_bytes = 2 if wide else 1

    def smem(b, ns, kc):
        return gemm_smem_bytes(bm, bn, b, ns, kc, act_block, a_bytes)

    if bm == 16:
        # a decode batch streams the planes: a deep ring of small stages,
        # two 256-thread CTAs to an SM
        bk0 = -(-min(512, max(128, 8192 // bn)) // unit) * unit
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
        c for c in range(min(K, MAX_CHUNK) // unit * unit, 0, -unit)
        if c == K or c % 256 == 0 or c == unit)
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
                         (rows, -(-tiles // n_per)), kc, per_sm),
            cost(n_per))


def gemm_threads(bm: int) -> int:
    """Threads of a GEMM CTA: 8 warps per 16 rows (``gemm_threads`` in
    ``csrc/mxint_common.cuh``)."""
    return -(-bm // 16) * 256


def act_variant(act_block: int, act_mant_bits: int) -> int:
    """The GEMM core's instance of an act format (``act_variant`` in
    ``csrc/mxint_common.cuh``): 2 int16 act mantissas, 0 the default block
    16, 1 any other block."""
    return 2 if act_mant_bits > 8 else 0 if act_block == ACT_BLOCK else 1


def gemm_launch(kernel: str, geom: GemmGeometry, M: int, N: int, K: int,
                act_block: int, act_mant_bits: int, operands: tuple,
                label: str = "", fused_ln: bool = False) -> LaunchRecord:
    """The ``LaunchRecord`` of a GEMM-core launch at ``geom``: the kernel
    instance and the dynamic shared memory as the C entries pick them
    (``mxint_matmul_launch``, ``mxint_ln_matmul`` ``launch``)."""
    V = act_variant(act_block, act_mant_bits)
    kc = K
    if geom.chunked:
        kc = geom.kc
        if V == 0 and geom.kc != MAX_CHUNK:   # V 0 takes the full chunk
            V = 1
    smem = gemm_smem_bytes(geom.bm, geom.bn, geom.bk, geom.ns, kc,
                           act_block, 2 if V == 2 else 1)
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

    args = geom.args() if fused_ln else geom.args() + (geom.kc,)
    return LaunchRecord(kernel, fn, (geom.grid[0], geom.grid[1], 1),
                        gemm_threads(bm), smem, gemm_static_smem(fused_ln, V),
                        operands, (M, N), out_tiles, geom.per_sm, args,
                        label)


def gemm_static_smem(fused_ln: bool, variant: int) -> int:
    """Static shared memory of a GEMM-core kernel instance: the fused
    kernel's LN stage at act blocks other than 16 and at 9-16 bits holds
    ``wide_group_max``'s exchange slots."""
    return GROUP_XCHG_SMEM if fused_ln and variant else 0


@functools.lru_cache(maxsize=None)
def launch_config(M: int, N: int, K: int, *, w_block: int, act_block: int,
                  act_mant_bits: int, n_sm: int, w_dtype=torch.int8,
                  label: str = "") -> LaunchRecord:
    """The launch ``mxint_matmul`` makes for f32 x (M, K) and (K, N)
    planes on a card of ``n_sm`` SMs; raises ``ValueError`` first for a
    format outside the kernel's domain, as the wrapper does."""
    check_act_format(act_mant_bits, act_block, w_block)
    if w_dtype != torch.int8 or K % ACT_BLOCK or K % w_block or \
            K % act_block or w_block % act_block:
        raise ValueError("mxint_matmul kernel takes f32 x, int8 planes and "
                         f"K a multiple of {ACT_BLOCK}")
    geom = gemm_geometry(M, N, K, n_sm, act_block=act_block,
                         wide=act_mant_bits > 8)
    ops_ = (spec("x", (M, K), torch.float32),
            spec("w_mant", (K, N), torch.int8),
            spec("w_exp", (K // w_block, N), torch.int8),
            spec("out", (M, N), torch.float32, 16 if N % 4 == 0 else 0))
    return gemm_launch("mxint_matmul", geom, M, N, K, act_block,
                       act_mant_bits, ops_, label)


def check_planes(K: int, w_mant, w_exp, w_block: int, act_block: int):
    """Raise unless the planes fit x's K and the blocks nest."""
    N = w_mant.shape[1] if w_mant.dim() == 2 else -1
    if tuple(w_mant.shape) != (K, N) or \
            tuple(w_exp.shape) != (K // w_block, N) or K % w_block or \
            K % act_block or w_block % act_block:
        raise ValueError(
            f"planes {tuple(w_mant.shape)} / {tuple(w_exp.shape)} do not fit "
            f"K={K}, w_block={w_block}, act_block={act_block}")


def check_act_mant_bits(act_mant_bits: int):
    """Raise unless the kernel's act tile (int8, or int16 above 8 bits)
    holds mantissas of ``act_mant_bits`` bits (clipped to
    +-(2^(b-1) - 1)); a wider mantissa would wrap in the cast to int16."""
    if not MIN_ACT_MANT_BITS <= act_mant_bits <= MAX_ACT_MANT_BITS:
        raise ValueError(
            f"mxint_matmul kernel takes {MIN_ACT_MANT_BITS} <= act_mant_bits "
            f"<= {MAX_ACT_MANT_BITS} (int16 act mantissas), got "
            f"{act_mant_bits}")


def check_act_block(act_block: int, w_block: int):
    """Raise unless the GEMM core takes the act block: a divisor of 16, or
    a multiple of 16 up to MAX_ACT_BLOCK that divides ``w_block``
    (``act_block_ok`` in ``csrc/mxint_common.cuh``)."""
    if act_block >= ACT_BLOCK:
        ok = act_block % ACT_BLOCK == 0 and act_block <= MAX_ACT_BLOCK \
            and w_block % act_block == 0
    else:
        ok = act_block >= 1 and ACT_BLOCK % act_block == 0
    if not ok:
        raise ValueError(
            f"the GEMM core takes act blocks that divide {ACT_BLOCK} or are "
            f"multiples of {ACT_BLOCK} up to {MAX_ACT_BLOCK} dividing "
            f"w_block={w_block}, got {act_block}")


@functools.lru_cache(maxsize=None)
def check_act_format(act_mant_bits: int, act_block: int, w_block: int):
    """``check_act_mant_bits`` and ``check_act_block`` once per format: a
    format that passes is cached, so the launch path pays one lookup."""
    check_act_mant_bits(act_mant_bits)
    check_act_block(act_block, w_block)


@functools.lru_cache(maxsize=None)
def matmul_entry():
    """The C entry point ``mxint_matmul_launch``."""
    return _build.entry("mxint_matmul", [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 12 + [ctypes.c_void_p])


def launch_args(x, w_mant, w_exp, out):
    return (x.data_ptr(), w_mant.data_ptr(), w_exp.data_ptr(), out.data_ptr())


def mxint_matmul(x: torch.Tensor, w_mant: torch.Tensor, w_exp: torch.Tensor,
                 *, w_block: int, act_block: int = 16,
                 act_mant_bits: int = 8) -> torch.Tensor:
    """y = Q_act(x) @ (w_mant * 2^w_exp) for x (M, K) f32.

    A CPU tensor runs the plain version, at any act format; a CUDA tensor
    launches the kernel, which takes 2-16 bits and the act blocks of
    ``check_act_block``, and raises for any other format before it touches
    the card.
    """
    M, K = x.shape
    check_planes(K, w_mant, w_exp, w_block, act_block)
    if x.device.type == "cpu":
        return matmul_blocks(x, w_mant, w_exp, w_block=w_block,
                             act_block=act_block, act_mant_bits=act_mant_bits)
    check_act_format(act_mant_bits, act_block, w_block)
    global launches
    if x.dtype != torch.float32 or K % ACT_BLOCK or \
            w_mant.dtype != torch.int8 or w_exp.dtype != torch.int8:
        raise ValueError("mxint_matmul kernel takes f32 x, int8 planes and "
                         f"K a multiple of {ACT_BLOCK}")
    _build.require_cuda("mxint_matmul", x, w_mant, w_exp)
    N = w_mant.shape[1]
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    rec = launch_config(M, N, K, w_block=w_block, act_block=act_block,
                        act_mant_bits=act_mant_bits, n_sm=sm_count(x.device))
    emit(rec, x=x, w_mant=w_mant, w_exp=w_exp, out=out)
    rc = matmul_entry()(*launch_args(x, w_mant, w_exp, out), M, K, N,
                        w_block, act_mant_bits, act_block, *rec.args,
                        _build.stream_ptr(x.device))
    _build.check(rc, "mxint_matmul")
    launches += 1
    return out
