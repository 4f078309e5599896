"""MXInt softmax datapath (paper §III-B-3, Eq. 14-20).

Replaces ``repro/kernels/mxint_softmax.py:mxint_softmax`` (its
``pallas_call`` at line 80) with ``csrc/mxint_softmax.cu``.  Per row:

  1. block-quantize, requantize to the row-max exponent lambda,
  2. subtract the row max on the mantissas,
  3. z = t * 2^lambda * log2(e), split z = n + r,
  4. 2^z = 2^max(n, -126) * LUT_pow2[floor(r * 2^r_bits)],
  5. sum the row, divide in (mantissa, exponent) form through frexp
     (Eq. 20), then optionally requantize onto the act grid.

On the H100 the kernel is bound by memory: DeiT's (B*H*197, 197) score
rows are read once and the probabilities written once.  One warp runs a
row, and ``softmax_geometry`` picks its route from the shape and the
alignment alone:

- the register route (``per_lane`` > 0), for rows whose lane holds at
  most ``REG_MAX_PER_LANE`` elements: the warp reads the row into
  registers once and computes each element's block exponent, aligned
  mantissa and 2^z once, then writes once; with an act block that is a
  multiple of 4 and 16-byte aligned rows in float4;
- the long route (``per_lane`` 0), for longer rows (up to
  ``ops.PAPER_MAX_SCORES`` keys) and for act blocks a lane cannot hold (64
  and 128): four passes re-read the row from L1/L2, each walking a block
  element by element.

Act blocks up to ``MAX_BLOCK`` (128) at any alignment.  Longer blocks
(up to the whole row) and LUTs past ``MAX_LUT`` entries (r_bits up to
16, Table VI's vanilla width: a 65,536-entry table, 256 KB, past a CTA's
shared memory) take the generic route (``softmax_route``): a warp a row,
lane l over the row's blocks l, l + 32, ..., four passes over the row,
the LUT read by index from device memory.

197 is prime, so DeiT's act block resolves to 1 and every element carries
its own exponent.  The pow2 LUT sits in shared memory.  Both routes sum in
the fixed lane-then-butterfly order of ``warp_row_sum``, so kernel and
plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core import luts
from repro_torch.core.quantize import pow2i
from repro_torch.kernels import _build
from repro_torch.kernels.launch_record import (LaunchRecord, emit, row_tiles,
                                               spec)
from repro_torch.kernels.mxint_layernorm import (MAX_BLOCK, MAX_LUT,
                                                 ROW_WARPS, SCALAR_MAX_BLOCK,
                                                 WARP,
                                                 block_quantize_rows, f32,
                                                 lut_tensor, requantize_rows,
                                                 resolve_act_block,
                                                 requantize_to_grid,
                                                 warp_row_sum)

LOG2E = f32(math.log2(math.e))

ROW_THREADS = 256          # a CTA: 8 warps, a row each
# register-route instances: the most elements a lane holds (its blocks
# lane, lane + 32, ... of the row); longer rows take the long route
REG_PER_LANE = (1, 2, 4, 8, 16, 32)
REG_MAX_PER_LANE = REG_PER_LANE[-1]
SMEM_BYTES = 4 * MAX_LUT  # a CTA's shared memory: the LUT copy, either route

launches = 0
generic_launches = 0    # launches of the generic route (within launches)


class SoftmaxGeometry(NamedTuple):
    per_lane: int   # register route: elements a lane holds at most; 0: long
    vec: int        # 4: float4 loads and stores; 1: scalar
    grid: int       # CTAs of ROW_THREADS threads

    @property
    def route(self) -> str:
        return "regs" if self.per_lane else "long"


def lane_elements(n: int, block: int) -> int:
    """The most elements one lane holds: ceil(blocks / 32) blocks."""
    return -(-(n // block) // WARP) * block


@functools.lru_cache(maxsize=None)
def softmax_geometry(rows: int, n: int, block: int,
                     aligned: bool = True) -> SoftmaxGeometry:
    """The kernel's route and grid for (rows, n) f32 rows with act block
    ``block``; ``aligned``: the input and output start on 16 bytes."""
    need = lane_elements(n, block)
    per_lane = next((e for e in REG_PER_LANE if e >= need), 0)
    vec = 4 if per_lane and block % 4 == 0 and aligned else 1
    return SoftmaxGeometry(per_lane, vec,
                           -(-rows // (ROW_THREADS // WARP)))


@functools.lru_cache(maxsize=None)
def launch_config(rows: int, n: int, *, act_block: int, r_bits: int,
                  aligned: bool = True, label: str = "") -> LaunchRecord:
    """The launch ``mxint_softmax`` makes for (rows, n) f32 rows
    (``aligned``: input and output start on 16 bytes): the
    ``softmax_geometry`` route, a warp a row.  Raises ``ValueError`` first
    for a format outside the kernel's domain, as the wrapper does."""
    act_block = resolve_act_block(n, act_block)
    if softmax_route(act_block, r_bits) == "generic":
        grid = -(-rows // ROW_WARPS)
        return LaunchRecord(
            "mxint_softmax", "softmax_generic_kernel", (grid, 1, 1),
            ROW_WARPS * WARP, 0, 0, (spec("x", (rows, n), torch.float32),
                                     spec("out", (rows, n), torch.float32)),
            (rows, n), row_tiles(rows, n, ROW_WARPS, grid), 1, (grid,),
            label)
    geom = softmax_geometry(rows, n, act_block, aligned)
    fn = (f"softmax_regs_kernel<E={geom.per_lane}, V={geom.vec}>"
          if geom.per_lane else
          f"softmax_long_kernel<{int(act_block <= SCALAR_MAX_BLOCK)}>")
    vb = 16 if geom.vec == 4 else 0
    ops_ = (spec("x", (rows, n), torch.float32, vb),
            spec("out", (rows, n), torch.float32, vb))
    return LaunchRecord(
        "mxint_softmax", fn, (geom.grid, 1, 1), ROW_THREADS, 0, SMEM_BYTES,
        ops_, (rows, n),
        row_tiles(rows, n, ROW_THREADS // WARP, geom.grid), 1,
        (geom.per_lane, geom.vec, geom.grid), label)


def softmax_route(act_block: int, r_bits: int) -> str:
    """'core' (the register and long routes: act blocks up to MAX_BLOCK, a
    LUT of at most MAX_LUT entries in shared memory), else 'generic' (any
    act block that divides the row; r_bits up to 16, the LUT read from
    device memory)."""
    return "core" if act_block <= MAX_BLOCK and 2 ** r_bits <= MAX_LUT \
        else "generic"


def exp2_datapath(z: torch.Tensor, table: torch.Tensor, r_bits: int):
    """2^z for z <= 0 as 2^max(n, -126) * LUT_pow2(r)."""
    n = torch.floor(z)
    r = z - n
    nmax = 2 ** r_bits
    idx = torch.floor(r * nmax).clamp(0, nmax - 1).long()
    return table[idx] * pow2i(n.clamp(min=-126.0).to(torch.int32))


def softmax_rows(x: torch.Tensor, *, act_block: int, mant_bits: int,
                 r_bits: int, quantize_out: bool) -> torch.Tensor:
    """Plain version of the Eq. 14-20 row softmax on (rows, n) f32."""
    r, n = x.shape
    table = lut_tensor(luts.pow2_table(r_bits), x.device)
    m, e = block_quantize_rows(x, act_block, mant_bits)
    mf, lam = requantize_rows(m, e)
    t = mf - mf.amax(dim=(1, 2), keepdim=True)          # <= 0, mantissa units
    z = t * pow2i(lam)[:, :, None] * LOG2E
    p = exp2_datapath(z, table, r_bits)
    s_m, s_e = torch.frexp(warp_row_sum(p))             # LZC + shift in HW
    y = (p / s_m[:, :, None]) * pow2i(-s_e)[:, :, None]
    y = y.reshape(r, n)
    if quantize_out:
        y = requantize_to_grid(y, act_block, mant_bits)
    return y


@functools.lru_cache(maxsize=None)
def generic_entry():
    """The C entry point ``mxint_softmax_generic_launch``."""
    return _build.entry("mxint_softmax_generic", [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p], lib="mxint_softmax")


def mxint_softmax(x: torch.Tensor, *, act_block: int = 16, mant_bits: int = 8,
                  r_bits: int = 2, quantize_out: bool = False) -> torch.Tensor:
    """Row softmax over the last axis of a (rows, n) f32 tensor.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    rows, n = x.shape
    act_block = resolve_act_block(n, act_block)
    if x.device.type == "cpu":
        return softmax_rows(x, act_block=act_block, mant_bits=mant_bits,
                            r_bits=r_bits, quantize_out=quantize_out)
    global launches, generic_launches
    if x.dtype != torch.float32:
        raise ValueError("mxint_softmax kernel takes f32 rows")
    lut = lut_tensor(luts.pow2_table(r_bits), x.device)
    _build.require_cuda("mxint_softmax", x, lut)
    out = torch.empty_like(x)
    rec = launch_config(rows, n, act_block=act_block, r_bits=r_bits,
                        aligned=(x.data_ptr() % 16 == 0 and
                                 out.data_ptr() % 16 == 0))
    emit(rec, x=x, out=out)
    if rec.function == "softmax_generic_kernel":
        rc = generic_entry()(x.data_ptr(), lut.data_ptr(), out.data_ptr(), rows, n,
                act_block, mant_bits, 2 ** r_bits, LOG2E, int(quantize_out),
                *rec.args, _build.stream_ptr(x.device))
        _build.check(rc, "mxint_softmax")
        generic_launches += 1
        launches += 1
        return out
    fn = _build.entry("mxint_softmax", [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p])
    rc = fn(x.data_ptr(), lut.data_ptr(), out.data_ptr(), rows, n, act_block,
            mant_bits, 2 ** r_bits, LOG2E, int(quantize_out), *rec.args,
            _build.stream_ptr(x.device))
    _build.check(rc, "mxint_softmax")
    launches += 1
    return out
