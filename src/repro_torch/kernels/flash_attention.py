"""Online-softmax (flash) attention with the MXInt softmax datapath.

Replaces ``repro/kernels/flash_attention.py``: ``flash_attention`` (its
``pallas_call`` at line 252) and ``flash_attention_decode`` (line 366), with
``csrc/flash_attention.cu``.  Both walk the key axis in 128-key tiles, in
order, and update a running (m, l, acc) per query row, as the reference's
``_softmax_block_update`` does:

  1. scores q.k * scale; model-masked lanes (causal, window, an invalid
     ring slot) become NEG_INF;
  2. with ``quantize_scores``: Eq. 2-3 quantization of the tile, act blocks
     along the keys, requantized to the tile row's max exponent; wrapper
     padding lanes (keys past the real count) take the fill 2^-100 for the
     quantizer and NEG_INF after it;
  3. p = exp datapath (Eq. 14-19 LUT for ``exp_mode='mxint'``, float exp
     for 'float') of s - m_new; the rescale alpha = exp(m_prev - m_new) is
     float exp, not the LUT, and 0 while the row has seen only masked keys;
  4. the Eq. 19 sum takes model-masked lanes (their 2^-126 tail) but never
     padding; interior tiles put unnormalized P on the act grid, the last
     tile is normalized through frexp first (Eq. 20) and flushed as
     (acc * alpha) / l_m * 2^-l_e + yq @ V.

The tile is 128 keys wide and the k loop is sequential: tiles set the
numerics (their shared exponents, which tile is the last), so the k axis
is never split.  Tiles that the causal or window mask hides from a whole
block of query positions are left out (``tile_span``), and a decode row
stops at the last tile that holds a valid slot (``stop_tiles``); both are
exact, see ``attend_rows``.  The plain versions below take the same tiles
and sum in the ordered kernels' order (q.k over d in order, P.V over a
tile's keys in order, the row sum as ``warp_row_sum`` over lanes holding
keys l, l+32, l+64, l+96), so the card holds the float32
``flash_attention`` and ``flash_attention_decode`` (both dtypes) to them
bit for bit.  The bf16 ``flash_attention`` runs its products on the tensor
cores, whose f32 sums have no fixed order: the card holds it within a
tolerance (``kernel_route``).

Score act blocks are resolved against the 128-key tile first, as the
reference resolves them (``resolve_act_block``: 12 becomes 8).  Formats
the fast kernels do not take (head dims past 256, score act blocks 64
and 128, LUTs past 256 entries, bf16 head dims off the mma depth, more
query heads per KV head than an mma block holds) take the generic route
(``flash_route``, ``decode_route``): ``flash_generic_kernel``, a warp a
query row in ``attend_rows``' order, bit for bit with the plain
versions in both dtypes.

A CPU tensor runs the plain version; a CUDA tensor launches a kernel, or
the wrapper raises.  ``launches`` counts ``flash_attention`` launches and
``decode_launches`` counts ``flash_attention_decode`` launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import luts
from repro_torch.core.mx_types import NEG_INF
from repro_torch.core.quantize import _resolve_block, pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import LaunchRecord, emit, rects, spec
from repro_torch.kernels.mxint_layernorm import (SMEM_LIMIT, WARP,
                                                 block_quantize_rows,
                                                 f32, lut_tensor, sm_count,
                                                 requantize_rows,
                                                 requantize_to_grid,
                                                 warp_row_sum)
from repro_torch.kernels.mxint_softmax import LOG2E, exp2_datapath

TILE_K = 128            # keys per tile, fixed by the numerics
MAX_HEAD_DIM = 256      # head dims the fast kernels take
MAX_ACT_BLOCK = 32      # fast kernels: an act block is lanes of one warp
MMA_K = 16              # bf16 route: head dims are multiples of the mma depth
MMA_ROWS = 128          # bf16 route: query rows (positions x heads) a block
MMA_WIDE_D = 128        # bf16 route: past this head dim, two warps a row
MMA_WIDE_ROWS = 64      # group and this many query rows a block
DECODE_THREADS = 128    # decode kernel: threads a CTA (a key's scores each)
DECODE_MAX_ROWS = 8     # decode kernel: query rows a CTA at most
DECODE_SLICE_BYTES = 256  # decode kernel: widest P.V column slice, bytes
PAD_FILL = 2.0 ** -100  # quantizer fill of padding lanes (see the reference)
_NEG_INF_HALF = NEG_INF / 2
_MIN_L = f32(1e-30)

launches = 0
decode_launches = 0
# launches of the generic route (within launches and decode_launches)
generic_launches = 0
generic_decode_launches = 0


# Cephes ``expf``: exp(x) = 2^n * P(r), n = floor(x log2 e + 1/2), r = x -
# n ln 2 in two parts; about 1 ulp.  The CUDA kernels run the same
# sequence of IEEE operations, so the rescale alpha and the float-mode
# probabilities agree bit for bit with the plain versions on every device.
# ``torch.exp`` and CUDA's ``expf`` are separate implementations, and on
# the CPU build this was developed with, ``torch.exp`` is not even
# reproducible on its first multi-threaded call.
_LN2_HI, _LN2_LO = f32(0.693359375), f32(-2.12194440e-4)
_EXP_POLY = tuple(f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                   8.3334519073e-3, 4.1665795894e-2,
                                   1.6666665459e-1, 5.0000001201e-1))


def exp_nonpos(x: torch.Tensor) -> torch.Tensor:
    """exp(x) for x <= 0 in float32 (0 below -104), from rounded
    multiplies and adds only."""
    x = x.clamp(-104.0, 0.0)
    n = torch.floor(x * LOG2E + 0.5)
    x = x - n * _LN2_HI
    x = x - n * _LN2_LO
    y = x * _EXP_POLY[0] + _EXP_POLY[1]
    for c in _EXP_POLY[2:]:
        y = y * x + c
    y = y * (x * x) + x + 1.0
    return y * pow2i(n.to(torch.int32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _dot_seq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, R, D) x (N, T, D) -> (N, R, T), each sum over d in order."""
    out = torch.zeros(a.shape[0], a.shape[1], b.shape[1], dtype=a.dtype,
                      device=a.device)
    for c in range(a.shape[2]):
        out = out + a[:, :, c:c + 1] * b[:, None, :, c]
    return out


def _pv_seq(p: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """(N, R, T) x (N, T, D) -> (N, R, D), over the first ``n`` keys in
    order (the rest are padding, whose p is 0)."""
    out = torch.zeros(p.shape[0], p.shape[1], v.shape[2], dtype=p.dtype,
                      device=p.device)
    for j in range(n):
        out = out + p[:, :, j:j + 1] * v[:, None, j, :]
    return out


def _tile_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sums of (N, R, 128) in the kernel's order: lane l adds keys l,
    l+32, l+64, l+96 in turn, then the lanes meet in a butterfly."""
    n, r, t = p.shape
    lanes = p.reshape(n * r, t // WARP, WARP).transpose(1, 2)
    return warp_row_sum(lanes).reshape(n, r, 1)


def _grid(y: torch.Tensor, block: int, mant_bits: int) -> torch.Tensor:
    n, r, t = y.shape
    return requantize_to_grid(y.reshape(n * r, t), block,
                              mant_bits).reshape(n, r, t)


def attend_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask, *, exp_mode: str, r_bits: int, quantize_scores: bool,
                act_block: int, mant_bits: int, scale: float,
                span=None) -> torch.Tensor:
    """Plain version of the key loop both kernels run.

    q: (N, R, D); k, v: (N, S, D); mask(k0, n, r0, r1) -> bool model mask
    of keys [k0, k0 + n) for rows [r0, r1), broadcastable to (N, r1 - r0,
    n).  Inputs of any float dtype are read as f32; returns (N, R, D) f32.

    ``span(t) -> (r0, r1)``: the rows that visit tile t (None: every row
    visits every tile).  The last tile is tile ``n_tiles - 1`` whoever
    visits it.  A row that stops before it ran its last visited tile as an
    interior one and is normalized after the loop, ``(acc / l_m) *
    2^-l_e``: that is all the fully masked tiles it skipped would have done
    (they leave m, l and acc as they are), so skipping them is exact.
    """
    q = q.to(torch.float32)
    N, R, D = q.shape
    S = k.shape[1]
    dev = q.device
    lut = lut_tensor(luts.pow2_table(r_bits), dev)
    m = torch.full((N, R, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((N, R, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((N, R, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(acc)
    n_tiles = -(-S // TILE_K)
    if n_tiles == 0:
        raise ValueError("attention over zero keys")
    if span is None:
        span = lambda t: (0, R)  # noqa: E731
    for t in range(n_tiles):
        r0, r1 = span(t)
        if r0 >= r1:
            continue
        k0 = t * TILE_K
        nk = min(TILE_K, S - k0)
        last = t == n_tiles - 1
        kt = torch.zeros((N, TILE_K, D), dtype=torch.float32, device=dev)
        vt = torch.zeros_like(kt)
        kt[:, :nk] = k[:, k0:k0 + nk].to(torch.float32)
        vt[:, :nk] = v[:, k0:k0 + nk].to(torch.float32)
        real = (torch.arange(TILE_K, device=dev) < nk)[None, None, :]
        mk = mask(k0, nk, r0, r1)
        keep = torch.ones(mk.shape[:-1] + (TILE_K,), dtype=torch.bool,
                          device=dev)
        keep[..., :nk] = mk
        n = r1 - r0
        m_r, l_r, acc_r = m[:, r0:r1], l[:, r0:r1], acc[:, r0:r1]
        s = _dot_seq(q[:, r0:r1], kt) * scale
        s = torch.where(keep, s, NEG_INF)
        if quantize_scores:
            s = torch.where(real, s, PAD_FILL)
            mq, e = block_quantize_rows(s.reshape(N * n, TILE_K), act_block,
                                        mant_bits)
            mf, lam = requantize_rows(mq, e)
            s = (mf.reshape(N * n, TILE_K) * pow2i(lam)).reshape(N, n, TILE_K)
        s = torch.where(real, s, NEG_INF)
        m_new = torch.maximum(m_r, s.amax(dim=-1, keepdim=True))
        if exp_mode == "mxint":
            p = exp2_datapath((s - m_new) * LOG2E, lut, r_bits)
        else:
            p = exp_nonpos(s - m_new)
        alpha = exp_nonpos(m_r - m_new)
        alpha = torch.where(m_r <= _NEG_INF_HALF, 0.0, alpha)
        live = keep & real
        if quantize_scores:
            psum = _tile_sum(torch.where(real, p, 0.0))
        else:
            p = torch.where(live, p, 0.0)
            psum = _tile_sum(p)
        l_new = l_r * alpha + psum
        if last:
            l_m, l_e = torch.frexp(torch.clamp(l_new, min=_MIN_L))
            inv = pow2i(-l_e)
            if quantize_scores:
                y = (p / l_m) * inv
                yq = torch.where(live, _grid(y, act_block, mant_bits), 0.0)
                o = ((acc_r * alpha) / l_m) * inv + _pv_seq(yq, vt, nk)
            else:
                o = ((acc_r * alpha + _pv_seq(p, vt, nk)) / l_m) * inv
            out[:, r0:r1] = o
            continue
        if quantize_scores:
            p = torch.where(live, _grid(p, act_block, mant_bits), 0.0)
        acc[:, r0:r1] = acc_r * alpha + _pv_seq(p, vt, nk)
        l[:, r0:r1] = l_new
        m[:, r0:r1] = m_new
    # the rows that stopped before the last tile: its normalization alone
    a, b = span(n_tiles - 1)
    for lo, hi in ((0, min(a, R)), (max(a, b), R)):
        if lo < hi:
            l_m, l_e = torch.frexp(torch.clamp(l[:, lo:hi], min=_MIN_L))
            out[:, lo:hi] = (acc[:, lo:hi] / l_m) * pow2i(-l_e)
    return out


def tile_span(first: int, last: int, n_tiles: int, causal: bool,
              window: int):
    """(first, last) key tile that the query positions [first, last] visit:
    with ``causal`` none after the tile of the last position, with a
    ``window`` none before the tile of the first key the first position
    sees.  The tiles left out are fully masked for every one of these
    positions.  The CUDA kernels compute the same span per block."""
    t1 = n_tiles - 1
    if causal:
        t1 = min(t1, last // TILE_K)
    t0 = 0
    if window > 0:
        t0 = min(max(0, first - window + 1) // TILE_K, t1)
    return t0, t1


def flash_rows(q, k, v, *, causal: bool, window: int, kv_groups: int,
               skip_tiles: bool = True, **kw) -> torch.Tensor:
    """Plain version of ``flash_attention``: q (BH, Sq, D), k/v (BH/g, Sk,
    D) -> (BH, Sq, D) f32.  The g query heads of a KV head fold into its
    rows position-major (row = position * g + head), so K/V are not copied
    per query head and a block of positions is a range of rows.

    With ``skip_tiles`` each block of 128 positions visits only the tiles
    of its ``tile_span``, as the kernels do; without it every row visits
    every tile.  The two agree bit for bit."""
    bh, sq, d = q.shape
    g = kv_groups
    qf = q.reshape(bh // g, g, sq, d).transpose(1, 2).reshape(
        bh // g, sq * g, d)
    pos = (torch.arange(sq * g, device=q.device) // g)[None, :, None]

    def mask(k0, n, r0, r1):
        p = pos[:, r0:r1]
        kp = torch.arange(k0, k0 + n, device=q.device)[None, None, :]
        ok = torch.ones_like(p - kp, dtype=torch.bool)
        if causal:
            ok = ok & (p >= kp)
        if window > 0:
            ok = ok & ((p - kp) < window)
        return ok

    span = None
    if skip_tiles:
        n_tiles = -(-k.shape[1] // TILE_K)
        spans = [tile_span(b0, min(b0 + TILE_K, sq) - 1, n_tiles, causal,
                           window) for b0 in range(0, sq, TILE_K)]

        def span(t):
            # spans rise with the block, so the visitors are a block range
            hit = [i for i, (t0, t1) in enumerate(spans) if t0 <= t <= t1]
            if not hit:
                return 0, 0
            return hit[0] * TILE_K * g, min((hit[-1] + 1) * TILE_K, sq) * g

    o = attend_rows(qf, k, v, mask, span=span, **kw)
    return o.reshape(bh // g, sq, g, d).transpose(1, 2).reshape(bh, sq, d)


def stop_tiles(valid: torch.Tensor) -> list:
    """Per batch row, the last tile of the ring that holds a valid slot
    (the last tile of the ring when none does)."""
    W = valid.shape[1]
    slot = torch.arange(W, device=valid.device)
    last = torch.where(valid != 0, slot, -1).amax(dim=1).tolist()
    return [n // TILE_K if n >= 0 else (W - 1) // TILE_K for n in last]


def decode_rows(q, k, v, valid, *, skip_tiles: bool = True,
                **kw) -> torch.Tensor:
    """Plain version of ``flash_attention_decode``: q (B, Hkv, G, D), k/v
    (B, W, Hkv, D), valid (B, W) -> (B, Hkv, G, D) f32.

    With ``skip_tiles`` the problems of batch row b stop at its
    ``stop_tiles`` tile, as the kernel does: the tiles after it hold no
    valid slot, so they would leave (m, l, acc) as they are (alpha is
    exactly 1, P is 0 on every lane, and the at most 128 * 2^-126 that the
    quantized path's masked lanes add to l >= 1 vanishes in f32), and the
    skipped last tile reduces to the normalization-only epilogue of
    ``attend_rows``.  Without it every row visits every tile.  The two
    agree bit for bit."""
    b, hkv, g, d = q.shape
    W = k.shape[1]
    n_tiles = -(-W // TILE_K)
    stops = stop_tiles(valid) if skip_tiles else [n_tiles - 1] * b
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for stop in sorted(set(stops)):
        idx = torch.tensor([i for i, s in enumerate(stops) if s == stop],
                           device=q.device)
        n = len(idx)
        kf = k[idx].permute(0, 2, 1, 3).reshape(n * hkv, W, d)
        vf = v[idx].permute(0, 2, 1, 3).reshape(n * hkv, W, d)
        ok = (valid[idx] != 0)[:, None, None, :].expand(
            n, hkv, 1, W).reshape(n * hkv, 1, W)
        o = attend_rows(
            q[idx].reshape(n * hkv, g, d), kf, vf,
            lambda k0, nk, r0, r1, ok=ok: ok[:, :, k0:k0 + nk],
            span=lambda t, stop=stop: (0, g) if t <= stop else (0, 0), **kw)
        out[idx] = o.reshape(n, hkv, g, d)
    return out


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------
def _check(name, exp_mode, quantize_scores, act_block, d):
    if exp_mode not in ("float", "mxint"):
        raise ValueError(f"{name}: exp_mode {exp_mode!r}")
    if quantize_scores and exp_mode != "mxint":
        raise ValueError(f"{name}: quantize_scores is the MXInt datapath "
                         f"and needs exp_mode='mxint'")
    if TILE_K % act_block:
        raise ValueError(f"{name}: act block {act_block} does not divide "
                         f"the {TILE_K}-key tile")


def resolve_act_block(act_block: int) -> int:
    """The score act block resolved against the 128-key tile, as the
    reference resolves it (``_resolve_block(128, act_block)``: 12 becomes
    8, 64 and 128 stay)."""
    return _resolve_block(TILE_K, act_block)


def kernel_route(dtype: torch.dtype, d: int, kv_groups: int) -> str:
    """The CUDA kernel that ``flash_attention`` launches for these operands,
    chosen by dtype:

    - 'mma' for bfloat16, the dtype the model serves and scores in: q.k and
      P.V on the bf16 tensor cores (``mma.sync``), the row stages in
      registers.  P enters P.V exactly: as one bf16 where it lies on an
      act grid of at most 9 mantissa bits, else split into three bf16
      parts.  Its f32 sums run in no fixed order, so the card holds it to
      the plain version within a tolerance.  Head dims that are multiples
      of 16 up to 256; at most 128 query heads per KV head up to head dim
      128, 64 past it (where a block holds 64 query rows and two warps
      share a row group's keys and O columns).
    - 'ordered' for float32: the CUDA-core kernel whose sums repeat the
      plain version's order, so the card holds it bit for bit.

    This is a route, not a fallback: anything neither kernel takes raises.
    """
    if dtype == torch.float32:
        return "ordered"
    _check_dtype(dtype)
    if d % MMA_K:
        raise NotImplementedError(
            f"flash_attention: bf16 head dim {d} is not a multiple of "
            f"{MMA_K}, which the tensor-core kernel needs")
    rows = mma_rows(d)
    if kv_groups > rows:
        raise NotImplementedError(
            f"flash_attention: kv_groups {kv_groups} > {rows}, the rows "
            f"of one block of the tensor-core kernel at head dim {d}")
    return "mma"


def mma_rows(d: int) -> int:
    """Query rows a block of the tensor-core kernel holds at head dim d."""
    return MMA_WIDE_ROWS if d > MMA_WIDE_D else MMA_ROWS


def decode_geometry(b: int, hkv: int, g: int, d: int, elem_bytes: int,
                    n_sm: int):
    """Launch geometry of the decode kernel on a card of ``n_sm`` SMs:
    (rows, cols, n_split).

    A CTA takes ``rows`` of the G query rows of one (batch row, KV head)
    problem (G > 8 spread evenly over ceil(G / 8) CTAs) and the P.V
    columns [i * cols, (i + 1) * cols) of column slice i of ``n_split``.
    Each of a problem's CTAs computes all its scores and row stages (the
    k axis is never split) and the P.V of its own columns.  A slice is
    whole 16-byte chunks and at most ``DECODE_SLICE_BYTES`` wide; there
    are no more slices than it takes to give each SM a CTA, nor than it
    takes to give each thread one P.V chain (row, column)."""
    row_blocks = -(-g // DECODE_MAX_ROWS)
    rows = -(-g // row_blocks)
    vec = 16 // elem_bytes
    one_chain = max(vec, DECODE_THREADS // rows // vec * vec)
    fill = -(-n_sm // (b * hkv * row_blocks))
    n_split = max(1, min(fill, -(-d // one_chain)))
    cols = min(-(-d // (n_split * vec)) * vec,
               DECODE_SLICE_BYTES // elem_bytes)
    return rows, cols, -(-d // cols)


# ---------------------------------------------------------------------------
# the generic route: every format of the reference
# ---------------------------------------------------------------------------
# ``flash_generic_kernel`` (csrc/flash_attention.cu) takes what neither
# fast kernel does: any head dim, any number of query heads per KV head,
# score act blocks up to the whole tile, any LUT, bf16 or f32 operands.
# A warp runs one query row through attend_rows' order (a lane's keys l,
# l + 32, l + 64, l + 96 of a tile; q.k over d in order from device
# memory, P.V over the keys in order, a lane's columns l, l + 32, ...),
# with its q row, its running acc and the tile's scores in shared memory
# and the LUT read from device memory.  The decode form reads the ring in
# its native layout and stops at each batch row's last valid tile.
GEN_WARPS = 4           # query rows a CTA of the generic route


def generic_warps(d: int) -> int:
    """Rows (warps) a generic-route CTA holds: GEN_WARPS, fewer where
    their q rows, acc rows and score rows do not fit shared memory."""
    w = min(GEN_WARPS, SMEM_LIMIT // generic_row_bytes(d))
    if w < 1:
        raise ValueError(f"the flash kernels take head dims whose q and acc "
                         f"rows fit shared memory, got {d}")
    return w


def generic_row_bytes(d: int) -> int:
    """Shared memory of one row of the generic route (``gen_row_floats``
    in ``csrc/flash_attention.cu``): q, acc, the tile's scores and the
    row state, f32."""
    return 4 * (2 * d + TILE_K + 8)


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the flash kernels take float32 or bfloat16")


def flash_route(dtype, d: int, kv_groups: int, block: int,
                r_bits: int) -> str:
    """``kernel_route``'s kernel ('mma' or 'ordered') where it takes the
    operands and the format (head dims up to MAX_HEAD_DIM, score act
    blocks up to MAX_ACT_BLOCK, at most _MAX_LUT LUT entries), else
    'generic'; ``block``: the score act block, 1 without quantized
    scores.  Raises for operands of another dtype."""
    _check_dtype(dtype)
    fast = d <= MAX_HEAD_DIM and block <= MAX_ACT_BLOCK and \
        2 ** r_bits <= _MAX_LUT
    if dtype == torch.bfloat16:
        fast = fast and d % MMA_K == 0 and kv_groups <= mma_rows(d)
    return kernel_route(dtype, d, kv_groups) if fast else "generic"


def decode_route(d: int, block: int, r_bits: int) -> str:
    """'decode' (``decode_kernel``: head dims up to MAX_HEAD_DIM, score
    act blocks up to MAX_ACT_BLOCK, at most _MAX_LUT LUT entries), else
    'generic'."""
    return ("decode" if d <= MAX_HEAD_DIM and block <= MAX_ACT_BLOCK
            and 2 ** r_bits <= _MAX_LUT else "generic")


def generic_record(kernel: str, T: str, decode: bool, grid_rows: int,
                   n_cols: int, rows: int, d: int, operands: tuple,
                   label: str, split: int = 1) -> LaunchRecord:
    """The generic route's record: CTAs of ``generic_warps(d)`` rows, over
    ``rows`` output rows of ``split`` problems of ``grid_rows`` rows each
    (flash: grid (row blocks, heads); decode: one problem of every row)."""
    w = generic_warps(d)
    blocks = -(-grid_rows // w)
    grid = (blocks, split, 1)

    def tiles():
        x = np.arange(blocks, dtype=np.int64)[:, None]
        y = np.arange(split, dtype=np.int64)[None, :]
        return rects(y * grid_rows + x * w,
                     y * grid_rows + np.minimum(grid_rows, (x + 1) * w), 0,
                     n_cols)
    return LaunchRecord(kernel, f"flash_generic_kernel<{T}, decode="
                        f"{int(decode)}>", grid, w * WARP,
                        w * generic_row_bytes(d), 0, operands, (rows, n_cols),
                        tiles, 1, (w,), label)


# ---------------------------------------------------------------------------
# launch geometry: Python mirrors of the C host code's values
# ---------------------------------------------------------------------------
FLASH_ROWS, FLASH_THREADS = 32, 256   # the ordered kernel (kFlashRows, ...)
MMA_THREADS = 256                    # both bf16 kernels: 8 warps
SCORE_STRIDE = TILE_K + 4            # decode: floats between score rows
_MAX_LUT = 256


def smem_floats(rows: int, maxd: int) -> int:
    """Shared memory of the ordered kernel in floats (``smem_floats`` in
    ``csrc/flash_attention.cu``): q rows, a K or V tile, scores, acc, the
    row state and the LUT."""
    return (rows * maxd + TILE_K * (maxd + 1) + rows * TILE_K + rows * maxd
            + 5 * rows + _MAX_LUT)


def mma_smem_bytes(d: int) -> int:
    """``mma_smem_bytes``: two K and two V tiles, the CTA's Q rows (bf16,
    row stride d + 8) and the LUT."""
    return 4 * TILE_K * (d + 8) * 2 + MMA_ROWS * (d + 8) * 2 + _MAX_LUT * 4


def wide_smem_bytes(d: int) -> int:
    """``wide_smem_bytes``: a K and a V tile, 64 Q rows, P as f32 rows of
    136, the two warps' exchange and the LUT."""
    groups = MMA_WIDE_ROWS // 16
    return (2 * TILE_K * (d + 8) * 2 + MMA_WIDE_ROWS * (d + 8) * 2 +
            4 * (MMA_WIDE_ROWS * (TILE_K + 8) + groups * 3 * 2 * 16 +
                 _MAX_LUT))


def dec_smem_bytes(rows: int, d: int, cols: int, kbuf: int,
                   elem_bytes: int) -> int:
    """``dec_smem_bytes<T>``: kbuf K tiles and two V column tiles (whole
    16-byte chunks; the K row stride an odd number of them), q rows, three
    score rows, the row state, the LUT and the last valid slot."""
    vec = 16 // elem_bytes
    ks = ((-(-d // vec)) | 1) * vec
    vs = -(-cols // vec) * vec
    return (TILE_K * (kbuf * ks + 2 * vs) * elem_bytes +
            4 * (rows * (-(-d // 8) * 8 + 3 * SCORE_STRIDE + 6) + _MAX_LUT)
            + 4)


def _flash_fn(dtype, d, exp_mode, quantize_scores, act_block, mant_bits):
    if dtype == torch.float32:
        return f"flash_kernel<{MAX_HEAD_DIM if d > MMA_WIDE_D else MMA_WIDE_D}>"
    name = "flash_mma_wide_kernel" if d > MMA_WIDE_D else "flash_mma_kernel"
    q, mx = int(quantize_scores), int(exp_mode == "mxint")
    block = act_block if quantize_scores else 1
    split = int(not quantize_scores or mant_bits > 9)
    return f"{name}<quant={q}, mxint={mx}, B={block}, split={split}>"


@functools.lru_cache(maxsize=None)
def launch_config(bh: int, sq: int, sk: int, d: int, *, kv_groups: int = 1,
                  dtype=torch.bfloat16, exp_mode: str = "mxint",
                  quantize_scores: bool = True, act_block: int = 16,
                  mant_bits: int = 8, r_bits: int = 2,
                  label: str = "") -> LaunchRecord:
    """The launch ``flash_attention`` makes for q (bh, sq, d) over
    (bh / kv_groups, sk, d) K/V: the ``kernel_route`` kernel, its grid of
    (KV heads, position blocks) or (position blocks, heads) and its shared
    memory.  Raises first where the wrapper's checks do."""
    act_block = resolve_act_block(act_block)
    _check("flash_attention", exp_mode, quantize_scores, act_block, d)
    route = flash_route(dtype, d, kv_groups,
                        act_block if quantize_scores else 1, r_bits)
    out = (bh * sq, d)
    if route == "generic":
        ops_ = tuple(spec(n, shape, dtype) for n, shape in (
            ("q", (bh, sq, d)), ("k", (bh // kv_groups, sk, d)),
            ("v", (bh // kv_groups, sk, d)), ("out", (bh, sq, d))))
        return generic_record("flash_attention", _T[dtype], False, sq, d,
                              bh * sq, d, ops_, label, split=bh)
    if route == "mma":
        rows = MMA_WIDE_ROWS if d > MMA_WIDE_D else MMA_ROWS
        per = rows // kv_groups
        grid = (bh // kv_groups, -(-sq // per), 1)
        smem = wide_smem_bytes(d) if d > MMA_WIDE_D else mma_smem_bytes(d)
        threads, vb = MMA_THREADS, 16

        def tiles():
            x = np.arange(grid[0], dtype=np.int64)[:, None, None]
            y = np.arange(grid[1], dtype=np.int64)[None, :, None]
            g = np.arange(kv_groups, dtype=np.int64)[None, None, :]
            p0 = (grid[1] - 1 - y) * per           # longest first
            h = x * kv_groups + g
            return rects(h * sq + p0, h * sq + np.minimum(sq, p0 + per), 0,
                         d)
    else:
        maxd = MAX_HEAD_DIM if d > MMA_WIDE_D else MMA_WIDE_D
        grid = (-(-sq // FLASH_ROWS), bh, 1)
        smem = smem_floats(FLASH_ROWS, maxd) * 4
        threads, vb = FLASH_THREADS, 0

        def tiles():
            x = np.arange(grid[0], dtype=np.int64)[:, None]
            y = np.arange(grid[1], dtype=np.int64)[None, :]
            return rects(y * sq + x * FLASH_ROWS,
                         y * sq + np.minimum(sq, (x + 1) * FLASH_ROWS), 0, d)
    ops_ = tuple(spec(n, shape, dtype, vb) for n, shape in (
        ("q", (bh, sq, d)), ("k", (bh // kv_groups, sk, d)),
        ("v", (bh // kv_groups, sk, d)), ("out", (bh, sq, d))))
    return LaunchRecord(
        "flash_attention", _flash_fn(dtype, d, exp_mode, quantize_scores,
                                     act_block, mant_bits),
        grid, threads, smem, 0, ops_, out, tiles, 1, (), label)


@functools.lru_cache(maxsize=None)
def decode_launch_config(b: int, hkv: int, g: int, W: int, d: int, *,
                         n_sm: int, dtype=torch.bfloat16,
                         exp_mode: str = "mxint",
                         quantize_scores: bool = True, act_block: int = 16,
                         mant_bits: int = 8, r_bits: int = 2,
                         smem_optin: int = SMEM_LIMIT,
                         label: str = "") -> LaunchRecord:
    """The launch ``flash_attention_decode`` makes for q (b, hkv, g, d)
    over a (b, W, hkv, d) ring on a card of ``n_sm`` SMs: the
    ``decode_geometry`` CTAs (problem, row block, column slice) and the
    shared memory of ``launch_decode`` (two K buffers where they fit the
    card's opt-in ``smem_optin``, else one).  Raises first where the
    wrapper's checks do."""
    act_block = resolve_act_block(act_block)
    _check("flash_attention_decode", exp_mode, quantize_scores, act_block, d)
    _check_dtype(dtype)
    if decode_route(d, act_block if quantize_scores else 1,
                    r_bits) == "generic":
        ops_ = (spec("q", (b, hkv, g, d), dtype),
                spec("k", (b, W, hkv, d), dtype),
                spec("v", (b, W, hkv, d), dtype),
                spec("valid", (b, W), torch.int32),
                spec("out", (b, hkv, g, d), dtype))
        return generic_record("flash_attention_decode", _T[dtype], True,
                              b * hkv * g, d, b * hkv * g, d, ops_, label)
    elem = torch.tensor([], dtype=dtype).element_size()
    rows, cols, n_split = decode_geometry(b, hkv, g, d, elem, n_sm)
    row_blocks = -(-g // rows)
    kbuf = 2 if dec_smem_bytes(rows, d, cols, 2, elem) <= smem_optin else 1
    grid = (b * hkv * row_blocks * n_split, 1, 1)

    def tiles():
        blk = np.arange(grid[0], dtype=np.int64)
        sl = blk % n_split
        rb = (blk // n_split) % row_blocks
        prob = blk // n_split // row_blocks
        r0 = prob * g + rb * rows
        return rects(r0, prob * g + np.minimum(g, rb * rows + rows),
                     sl * cols, np.minimum(d, sl * cols + cols))
    ops_ = (spec("q", (b, hkv, g, d), dtype), spec("k", (b, W, hkv, d), dtype),
            spec("v", (b, W, hkv, d), dtype),
            spec("valid", (b, W), torch.int32),
            spec("out", (b, hkv, g, d), dtype))
    return LaunchRecord(
        "flash_attention_decode", f"decode_kernel<{_T[dtype]}, ROWS={rows}>",
        grid,
        2 * DECODE_THREADS + rows * WARP,
        dec_smem_bytes(rows, d, cols, kbuf, elem), 0, ops_, (b * hkv * g, d),
        tiles, 1, (rows, cols), label)


_T = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _kernel_args(x, exp_mode, quantize_scores, act_block, mant_bits,
                 r_bits, scale):
    lut = lut_tensor(luts.pow2_table(r_bits), x.device)
    return lut, [int(exp_mode == "mxint"), int(quantize_scores), act_block,
                 mant_bits, 2 ** r_bits, f32(scale), LOG2E,
                 int(x.dtype == torch.bfloat16)]


_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                     ctypes.c_void_p]
# the generic entries: the format, then the warps a CTA, then the stream
_GEN_TAIL = _TAIL[:-1] + [ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def generic_entry():
    """The C entry point ``flash_generic_launch``."""
    return _build.entry("flash_generic", [ctypes.c_void_p] * 5 +
                        [ctypes.c_int] * 7 + _GEN_TAIL,
                        lib="flash_attention")


@functools.lru_cache(maxsize=None)
def generic_decode_entry():
    """The C entry point ``flash_generic_decode_launch``."""
    return _build.entry("flash_generic_decode", [ctypes.c_void_p] * 6 +
                        [ctypes.c_int] * 5 + _GEN_TAIL,
                        lib="flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    exp_mode: str = "float", r_bits: int = 2,
                    quantize_scores: bool = False, act_block: int = 16,
                    mant_bits: int = 8, scale: float = None,
                    kv_groups: int = 1) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BH // kv_groups, Sk, D), query head b reads KV
    head b // kv_groups.  Any Sq, Sk, D.  Returns (BH, Sq, D) in q's
    dtype.  ``act_block`` is resolved against the 128-key tile.

    A CPU tensor runs the plain version ``flash_rows``.  A CUDA tensor
    launches the kernel that ``flash_route`` picks: in the fast kernels'
    domain by dtype, bfloat16 the tensor-core kernel (D a multiple of 16,
    16-byte aligned operands), float32 the ordered CUDA-core kernel;
    outside it the generic route."""
    bh, sq, d = q.shape
    bhkv, sk, _ = k.shape
    if bh != bhkv * kv_groups:
        raise ValueError(f"{bh} query heads, {bhkv} KV heads, "
                         f"kv_groups {kv_groups}")
    act_block = resolve_act_block(act_block)
    _check("flash_attention", exp_mode, quantize_scores, act_block, d)
    scale = f32(d ** -0.5 if scale is None else scale)
    kw = dict(exp_mode=exp_mode, r_bits=r_bits,
              quantize_scores=quantize_scores, act_block=act_block,
              mant_bits=mant_bits, scale=scale)
    if q.device.type == "cpu":
        return flash_rows(q, k, v, causal=causal, window=window,
                          kv_groups=kv_groups, **kw).to(q.dtype)
    global launches, generic_launches
    lut, tail = _kernel_args(q, exp_mode, quantize_scores, act_block,
                             mant_bits, r_bits, scale)
    _build.require_cuda("flash_attention", q, k, v, lut)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v must share a dtype")
    out = torch.empty_like(q)
    rec = launch_config(bh, sq, sk, d, kv_groups=kv_groups, dtype=q.dtype,
                        exp_mode=exp_mode, quantize_scores=quantize_scores,
                        act_block=act_block, mant_bits=mant_bits,
                        r_bits=r_bits)
    if rec.operands[0].vector_bytes and any(
            t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: the bf16 kernel reads 16-byte "
                         "aligned rows")
    emit(rec, q=q, k=k, v=v, out=out)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lut.data_ptr(),
            out.data_ptr(), bh, sq, sk, d, kv_groups, int(causal),
            int(window), *tail)
    if rec.function.startswith("flash_generic"):
        rc = generic_entry()(*args, *rec.args, _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention")
        generic_launches += 1
    else:
        fn = _build.entry("flash_attention", [ctypes.c_void_p] * 5 +
                          [ctypes.c_int] * 7 + _TAIL)
        rc = fn(*args, _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, *, exp_mode: str = "float",
                           r_bits: int = 2, quantize_scores: bool = False,
                           act_block: int = 16, mant_bits: int = 8,
                           scale: float = None) -> torch.Tensor:
    """Single-position decode over a KV cache ring.  q: (B, Hkv, G, D), the
    G query heads of a KV head as rows; k, v: (B, W, Hkv, D), the cache's
    native layout; valid: (B, W), nonzero where row b's slot holds a live
    key.  Any G, W and D.  Returns (B, Hkv, G, D) in q's dtype.

    A CPU tensor runs the plain version ``decode_rows``; a CUDA tensor
    launches the decode kernel with the ``decode_geometry`` grid, or the
    generic route outside its domain (``decode_route``), or raises."""
    b, hkv, g, d = q.shape
    W = k.shape[1]
    act_block = resolve_act_block(act_block)
    _check("flash_attention_decode", exp_mode, quantize_scores, act_block, d)
    scale = f32(d ** -0.5 if scale is None else scale)
    kw = dict(exp_mode=exp_mode, r_bits=r_bits,
              quantize_scores=quantize_scores, act_block=act_block,
              mant_bits=mant_bits, scale=scale)
    if q.device.type == "cpu":
        return decode_rows(q, k, v, valid, **kw).to(q.dtype)
    global decode_launches, generic_decode_launches
    lut, tail = _kernel_args(q, exp_mode, quantize_scores, act_block,
                             mant_bits, r_bits, scale)
    valid = valid.to(torch.int32)
    _build.require_cuda("flash_attention_decode", q, k, v, valid, lut)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_decode: q, k and v must share a "
                         "dtype")
    out = torch.empty_like(q)
    rec = decode_launch_config(
        b, hkv, g, W, d, n_sm=sm_count(q.device), dtype=q.dtype,
        exp_mode=exp_mode, quantize_scores=quantize_scores,
        act_block=act_block, mant_bits=mant_bits, r_bits=r_bits)
    emit(rec, q=q, k=k, v=v, valid=valid, out=out)
    if rec.function.startswith("flash_generic"):
        rc = generic_decode_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            lut.data_ptr(), out.data_ptr(), b, hkv, g, W, d, *tail,
            *rec.args, _build.stream_ptr(q.device))
        _build.check(rc, "flash_attention_decode")
        generic_decode_launches += 1
        decode_launches += 1
        return out
    rows, cols = rec.args
    fn = _build.entry("flash_attention_decode", [ctypes.c_void_p] * 6 +
                      [ctypes.c_int] * 7 + _TAIL, lib="flash_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            lut.data_ptr(), out.data_ptr(), b, hkv, g, W, d, rows, cols,
            *tail, _build.stream_ptr(q.device))
    _build.check(rc, "flash_attention_decode")
    decode_launches += 1
    return out
