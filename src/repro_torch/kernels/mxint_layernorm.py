"""MXInt LayerNorm / RMSNorm datapath (paper Fig. 3) and the row stages
the other kernels share.

Replaces ``repro/kernels/mxint_layernorm.py:mxint_layernorm`` (its
``pallas_call`` at line 135) with ``csrc/mxint_layernorm.cu``.  Per row:

  1. block-quantize the row (act_block shared exponents),
  2. requantize every block to the row-max exponent by arithmetic shifts,
     saturating at 31,
  3. integer mean, then the variance of the centred mantissas,
  4. clamp the variance at 2^-24, split its exponent into the even and odd
     cases and look up 1/sqrt(u), u in [0.5, 2), in the rsqrt LUT,
  5. scale, gamma and beta, then optionally requantize onto the act grid.

On the H100 the kernel is bound by memory: it reads the (rows, d) row
(f32, or bf16 as a bf16 model hands it) once and writes f32 once, against
a few dozen operations per element.  A CTA of ``LN_THREADS`` threads
normalizes up to ``LN_MAX_ROWS`` rows with the row stage it shares with
``mxint_ln_matmul`` (``ln_rows`` in ``csrc/mxint_common.cuh``): every
thread reads, quantizes and aligns its pieces of the rows (four elements
in one 16-byte f32 or 8-byte bf16 access, an act block over 1-32 adjacent
lanes whose amax meets by shuffles; or a whole act block of at most 16), the
aligned mantissas are staged in shared memory, one warp a row adds the
variance, and every thread writes its pieces.  ``ln_geometry`` picks the
route from the shape, dtype and alignment alone.  The LUT sits in shared
memory and is read by index (the one-hot matmul of the TPU kernel gives
the same exact entry).  Every step is exact in any order but the variance
sum, which runs in a fixed order, each lane over its blocks in turn then a
butterfly over the 32 lanes, and ``warp_row_sum`` below repeats that
order, so kernel and plain version agree bit for bit.

Act blocks the LN stage's routes do not take (past 16 off the vector
route, past 128 or not a power of two on it) and LUTs past ``MAX_LUT``
entries (Table VI's vanilla 13 bits) take the generic route
(``ln_route``; ``ln_row_generic`` in ``csrc/mxint_generic.cuh``): a warp
a row, the same stages and the same variance order, the LUT read from
device memory.  The integer row sum is exact (int64 in the kernels; the
plain version sums in float64 and rounds once, as the kernels convert
their sum).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import luts
from repro_torch.core.quantize import _TINY, pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import (LaunchRecord, emit, row_tiles,
                                               spec)

WARP = 32
SCALAR_MAX_BLOCK = 16   # largest act block a thread holds in registers
MAX_BLOCK = 128      # largest act block of the row kernels: a warp of float4
MAX_LN_BLOCK = 256   # the fused kernel's LN stage: two warps (a named barrier)
MAX_LUT = 256        # entries of the shared-memory LUT copy
SMEM_LIMIT = 232448  # the H100's 227 KB a CTA may use

# the LN stage (ln_rows in csrc/mxint_common.cuh) and the layernorm kernel
LN_THREADS = 256     # a CTA of the layernorm kernel
LN_MAX_ROWS = 8      # rows a CTA normalizes at most
LN_PIECE = 4         # elements of a vector-route piece (one 16/8-byte access)
LN_VEC_BLOCKS = (4, 8, 16, 32, 64, 128, 256)   # act blocks of 1-64 pieces
# the exchange slots of wide_group_max (csrc/mxint_common.cuh), static in
# every kernel instance that may meet two warps of a group (the card's
# cudaFuncGetAttributes, chip_smoke.py's analysis phase)
GROUP_XCHG_SMEM = 4 * 16
# the LUT, the row scalars and the exchange slots
LN_STATIC_SMEM = 4 * MAX_LUT + 16 * LN_MAX_ROWS + GROUP_XCHG_SMEM

launches = 0
generic_launches = 0    # launches of the generic route (within launches)

_LUTS: Dict[Tuple, Tuple[tuple, torch.Tensor]] = {}


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: a constant every
    backend then multiplies with one float32 rounding."""
    return float(np.float32(v))


def resolve_act_block(d: int, act_block: int) -> int:
    """The act block clamped to the row length; raises unless it divides
    the row (the ops resolve blocks first, as ``_resolve_block`` does)."""
    act_block = min(act_block, d)
    if d % act_block:
        raise ValueError(f"act block {act_block} does not divide {d}")
    return act_block


def lut_tensor(table: tuple, device) -> torch.Tensor:
    """A table as a float32 tensor on ``device``, cached by the table's
    identity (the tables come from cached functions, and the cache holds
    each table, so its id is never reused): hashing a 65,536-entry tuple
    at every call took about a millisecond of host time."""
    key = (id(table), str(device))
    hit = _LUTS.get(key)
    if hit is None or hit[0] is not table:
        hit = _LUTS[key] = (table, torch.tensor(table, dtype=torch.float32,
                                                device=device))
    return hit[1]


class LnGeometry(NamedTuple):
    vec: int            # 4: pieces of four elements; 0: an act block a thread
    rows_per_cta: int
    grid: int           # CTAs of LN_THREADS threads
    smem: int           # dynamic shared memory; 0 on the global-stage route
    stage_words: int    # int32 words of a row's global stage; 0: shared

    @property
    def route(self) -> str:
        return ("vec" if self.vec else "scalar") + \
            ("-global" if self.stage_words else "")


def ln_piece(block: int, aligned: bool) -> int:
    """The LN stage's piece: 4 elements (one 16-byte f32 or 8-byte bf16
    access; the act block spans 1-64 lanes) where the block allows and
    every row and scale starts on four elements, else 0 (a block a thread:
    blocks up to 16 at any alignment)."""
    return LN_PIECE if block in LN_VEC_BLOCKS and aligned else 0


def ln_route_ok(block: int, piece: int, max_block: int = MAX_BLOCK) -> bool:
    """The LN stage takes the act block on its route: up to ``max_block``
    on the four-element route, up to SCALAR_MAX_BLOCK a thread (a longer
    block needs its rows and scales on four elements and a power of
    two)."""
    return not (block > max_block or
                (not piece and block > SCALAR_MAX_BLOCK))


# the generic row route (``csrc/mxint_generic.cuh``): a warp a row, lane
# l over the row's act blocks l, l + 32, ... element by element (any
# block, any alignment), re-reading the row from L1/L2 in each pass, the
# LUT read by index from device memory through the read-only path (a
# softmax LUT of 2^16 entries is 256 KB, past a CTA's shared memory)
ROW_WARPS = 8           # rows a CTA of the generic row kernels


def ln_route(rows: int, d: int, block: int, lut_bits: int, n_sm: int,
             aligned: bool = True) -> str:
    """'core' where the LN stage takes the act block on its
    ``ln_geometry`` route and the LUT fits shared memory, else 'generic'
    (any act block that divides the row, any alignment, any LUT)."""
    ok = 2 ** lut_bits <= MAX_LUT and ln_route_ok(
        block, ln_geometry(rows, d, block, n_sm, aligned).vec)
    return "core" if ok else "generic"


def aligned4(*tensors) -> bool:
    """Every tensor given (None passes) starts on four of its elements."""
    return all(t is None or t.data_ptr() % (4 * t.element_size()) == 0
               for t in tensors)


def ln_stage_words(d: int, block: int) -> int:
    """int32 words of one row's global stage: d mantissas, then d / block
    exponent bytes, padded to 16 bytes (``gs_stride`` in
    ``csrc/mxint_layernorm.cu``)."""
    return (d + (d // block + 3) // 4 + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def ln_geometry(rows: int, d: int, block: int, n_sm: int,
                aligned: bool = True) -> LnGeometry:
    """The layernorm kernel's route and grid for (rows, d) rows at act
    block ``block``: the most rows a CTA (at most LN_MAX_ROWS) that still
    give every SM two CTAs and whose stage (int32 mantissas and exponent
    bytes) fits shared memory; a row whose stage does not fit at all is
    staged in global scratch, one row a CTA."""
    row_bytes = 4 * d + d // block
    budget = SMEM_LIMIT - LN_STATIC_SMEM
    R = LN_MAX_ROWS
    while R > 1 and (-(-rows // R) < 2 * n_sm or R * row_bytes > budget):
        R //= 2
    vec = ln_piece(block, aligned)
    if row_bytes > budget:
        return LnGeometry(vec, 1, rows, 0, ln_stage_words(d, block))
    return LnGeometry(vec, R, -(-rows // R), R * row_bytes, 0)


@functools.lru_cache(maxsize=None)
def launch_config(rows: int, d: int, *, act_block: int, lut_bits: int,
                  n_sm: int, x_dtype=torch.float32,
                  params_dtype=torch.float32, aligned: bool = True,
                  label: str = "") -> LaunchRecord:
    """The launch ``mxint_layernorm`` makes for (rows, d) rows on a card of
    ``n_sm`` SMs (``aligned``: rows, scales and output start on four
    elements): the ``ln_geometry`` route, CTAs of LN_THREADS threads, the
    dynamic shared memory of ``mxint_layernorm_launch``.  Raises
    ``ValueError`` first for a format outside the kernel's domain."""
    act_block = resolve_act_block(d, act_block)
    if ln_route(rows, d, act_block, lut_bits, n_sm, aligned) == "generic":
        grid = -(-rows // ROW_WARPS)
        ops_ = (spec("x", (rows, d), x_dtype),
                spec("gamma", (d,), params_dtype),
                spec("beta", (d,), params_dtype),
                spec("out", (rows, d), torch.float32))
        T = "bf16" if x_dtype == torch.bfloat16 else "f32"
        return LaunchRecord(
            "mxint_layernorm", f"layernorm_generic_kernel<{T}>", (grid, 1, 1),
            ROW_WARPS * WARP, 0, 0, ops_, (rows, d),
            row_tiles(rows, d, ROW_WARPS, grid), 1, (grid,), label)
    geom = ln_geometry(rows, d, act_block, n_sm, aligned)
    xb = torch.tensor([], dtype=x_dtype).element_size()
    pb = torch.tensor([], dtype=params_dtype).element_size()
    v = geom.vec
    T = "bf16" if x_dtype == torch.bfloat16 else "f32"
    ops_ = (spec("x", (rows, d), x_dtype, v * xb),
            spec("gamma", (d,), params_dtype, v * pb),
            spec("beta", (d,), params_dtype, v * pb),
            spec("out", (rows, d), torch.float32, 4 * v))
    if geom.stage_words:
        ops_ += (spec("scratch", (rows, geom.stage_words), torch.int32),)
    return LaunchRecord(
        "mxint_layernorm",
        f"mxint_layernorm_kernel<{T}, P={v}, GS={int(bool(geom.stage_words))}>",
        (geom.grid, 1, 1), LN_THREADS, geom.smem, LN_STATIC_SMEM, ops_,
        (rows, d), row_tiles(rows, d, geom.rows_per_cta, geom.grid),
        1, (geom.vec, geom.rows_per_cta), label)


# ---------------------------------------------------------------------------
# shared row stages (plain PyTorch; csrc/mxint_common.cuh holds the CUDA ones)
# ---------------------------------------------------------------------------
def block_quantize_rows(x: torch.Tensor, block: int, mant_bits: int):
    """Quantize (rows, d) along d in blocks.  Returns integer-valued f32
    mantissas (rows, d/block, block) and int32 exponents (rows, d/block)."""
    r, d = x.shape
    xb = x.reshape(r, d // block, block)
    amax = xb.abs().amax(dim=-1)
    _, k = torch.frexp(torch.clamp(amax, min=_TINY))
    e = torch.where(amax > 0, k - 1 - (mant_bits - 2), torch.zeros_like(k))
    e = e.clamp(-127, 127)
    lim = float(2 ** (mant_bits - 1) - 1)
    m = torch.round(xb * pow2i(-e)[..., None]).clamp(-lim, lim)
    return m, e


def requantize_rows(m: torch.Tensor, e: torch.Tensor):
    """Align all blocks of each row to the row-max exponent (Eq. 3):
    floor of m * 2^-shift equals the arithmetic right shift."""
    e_max = e.amax(dim=-1, keepdim=True)
    shift = (e_max - e).clamp(max=31)
    return torch.floor(m * pow2i(-shift)[..., None]), e_max


def requantize_to_grid(y: torch.Tensor, block: int, mant_bits: int):
    """Snap a (rows, d) tile onto the MXInt act grid (quantize-dequantize)."""
    m, e = block_quantize_rows(y, block, mant_bits)
    return (m * pow2i(e)[..., None]).reshape(y.shape)


def warp_row_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum (rows, nblocks, block) over each row in the CUDA kernels' order:
    lane l adds blocks l, l+32, ... element by element, then the 32 lane
    sums meet in a butterfly (16, 8, 4, 2, 1).  Returns (rows, 1)."""
    r, nb, b = v.shape
    pad = (-nb) % WARP
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    v = v.reshape(r, -1, WARP, b)
    acc = torch.zeros(r, WARP, dtype=v.dtype, device=v.device)
    for c in range(v.shape[1]):
        for j in range(b):
            acc = acc + v[:, c, :, j]
    s = WARP
    while s > 1:
        s //= 2
        acc = acc[:, :s] + acc[:, s:2 * s]
    return acc


def rsqrt_lut_stage(var: torch.Tensor, table: torch.Tensor, bits: int):
    """1/sqrt(var) through the LUT with the Eq. 9 even/odd exponent split."""
    var = torch.clamp(var, min=2.0 ** -24)
    v_m, v_e = torch.frexp(var)
    v_m, v_e = v_m * 2.0, v_e - 1
    odd = (v_e % 2) != 0
    u = torch.where(odd, v_m * 0.5, v_m)
    e_half = torch.where(odd, (v_e + 1) // 2, v_e // 2)
    n = 2 ** bits
    idx = torch.floor((u - 0.5) * f32(n / 1.5)).clamp(0, n - 1).long()
    return table[idx] * pow2i(-e_half)


def layernorm_rows(x: torch.Tensor, gamma: torch.Tensor,
                   beta: Optional[torch.Tensor], *, act_block: int,
                   mant_bits: int, lut_bits: int, rms_only: bool,
                   quantize_out: bool) -> torch.Tensor:
    """Plain version of the Fig. 3 LN datapath on a (rows, d) f32 tile."""
    r, d = x.shape
    nb = d // act_block
    table = lut_tensor(luts.rsqrt_table(lut_bits), x.device)
    m, e = block_quantize_rows(x, act_block, mant_bits)
    mf, _ = requantize_rows(m, e)                  # lambda cancels
    inv_d = f32(1.0 / d)
    if rms_only:
        centered = mf
    else:
        # the integer row sum, exact in float64 and rounded once (the
        # kernels sum the integers and convert the sum)
        isum = mf.to(torch.float64).sum(dim=(1, 2)).to(torch.float32)
        centered = mf - (isum * inv_d)[:, None, None]
    var = warp_row_sum(centered * centered) * inv_d
    inv = rsqrt_lut_stage(var, table, lut_bits)[:, :, None]
    y = centered * inv
    y = y * gamma.reshape(nb, act_block)
    if not rms_only:
        y = y + beta.reshape(nb, act_block)
    y = y.reshape(r, d)
    if quantize_out:
        y = requantize_to_grid(y, act_block, mant_bits)
    return y


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------
def mxint_layernorm(x: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor], *, act_block: int = 16,
                    mant_bits: int = 8, lut_bits: int = 5,
                    rms_only: bool = False,
                    quantize_out: bool = False) -> torch.Tensor:
    """(rows, d) MXInt LayerNorm over the last axis; f32 out.

    A CPU tensor runs the plain version (on x as f32); a CUDA tensor
    launches the kernel, which reads f32 or bf16 rows and scales as they
    come (bf16 to f32 is exact) and takes a missing beta as zero.
    """
    rows, d = x.shape
    act_block = resolve_act_block(d, act_block)
    if x.device.type == "cpu":
        if beta is None:
            beta = torch.zeros_like(gamma)
        return layernorm_rows(x.to(torch.float32), gamma, beta,
                              act_block=act_block, mant_bits=mant_bits,
                              lut_bits=lut_bits, rms_only=rms_only,
                              quantize_out=quantize_out)
    global launches, generic_launches
    x, gamma, beta = kernel_operands(x, gamma, beta)
    lut = lut_tensor(luts.rsqrt_table(lut_bits), x.device)
    _build.require_cuda("mxint_layernorm", x, gamma, lut,
                        *([] if beta is None else [beta]))
    out = torch.empty(rows, d, dtype=torch.float32, device=x.device)
    rec = launch_config(rows, d, act_block=act_block, lut_bits=lut_bits,
                        n_sm=sm_count(x.device), x_dtype=x.dtype,
                        params_dtype=gamma.dtype,
                        aligned=aligned4(x, gamma, beta, out))
    stage_words = rec.operands[-1].shape[1] \
        if rec.operands[-1].name == "scratch" else 0
    scratch = (torch.empty(rows * stage_words, dtype=torch.int32,
                           device=x.device) if stage_words else None)
    emit(rec, x=x, gamma=gamma, beta=beta, out=out, scratch=scratch)
    if rec.function.startswith("layernorm_generic"):
        rc = generic_entry()(x.data_ptr(), gamma.data_ptr(),
                None if beta is None else beta.data_ptr(), lut.data_ptr(),
                out.data_ptr(), rows, d, act_block, mant_bits, f32(1.0 / d),
                2 ** lut_bits, f32(2 ** lut_bits / 1.5), int(rms_only),
                int(quantize_out), int(x.dtype == torch.bfloat16),
                int(gamma.dtype == torch.bfloat16), *rec.args,
                _build.stream_ptr(x.device))
        _build.check(rc, "mxint_layernorm")
        generic_launches += 1
        launches += 1
        return out
    fn = _build.entry("mxint_layernorm", [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float] +
        [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), lut.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            rows, d, act_block, mant_bits, f32(1.0 / d), 2 ** lut_bits,
            f32(2 ** lut_bits / 1.5), int(rms_only), int(quantize_out),
            int(x.dtype == torch.bfloat16), int(gamma.dtype == torch.bfloat16),
            *rec.args, _build.stream_ptr(x.device))
    _build.check(rc, "mxint_layernorm")
    launches += 1
    return out


@functools.lru_cache(maxsize=None)
def generic_entry():
    """The C entry point ``mxint_layernorm_generic_launch``."""
    return _build.entry("mxint_layernorm_generic", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float] +
        [ctypes.c_int] * 5 + [ctypes.c_void_p], lib="mxint_layernorm")


def kernel_operands(x: torch.Tensor, gamma: torch.Tensor,
                    beta: Optional[torch.Tensor]):
    """The LN kernels' operands: f32 and bf16 as they come (no device op);
    any other float type, and scales of two different types, as f32 (an
    exact conversion).  Raises unless the scales hold one value a column."""
    def as_kernel(t):
        ok = t.dtype in (torch.float32, torch.bfloat16)
        return t if ok else t.to(torch.float32)

    d = x.shape[-1]
    if gamma.numel() != d or (beta is not None and beta.numel() != d):
        raise ValueError(f"LN scales of {gamma.numel()} and "
                         f"{None if beta is None else beta.numel()} values "
                         f"for rows of {d}")
    x, gamma = as_kernel(x), as_kernel(gamma)
    if beta is not None:
        beta = as_kernel(beta)
        if beta.dtype != gamma.dtype:
            gamma, beta = gamma.to(torch.float32), beta.to(torch.float32)
    return x, gamma, beta


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
