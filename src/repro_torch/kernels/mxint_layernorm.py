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

On the H100 the kernel is bound by memory: it reads the (rows, d) f32 row
and writes it back once, against a few dozen operations per element.  The
design runs one warp per row and makes three passes over the row, which
stays in L1/L2; the LUT sits in shared memory and is read by index (the
one-hot matmul of the TPU kernel gives the same exact entry).  The
variance sum runs in a fixed order, each lane over its blocks in turn
then a butterfly over the 32 lanes, and ``warp_row_sum`` below repeats
that order, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import luts
from repro_torch.core.quantize import _TINY, pow2i
from repro_torch.kernels import _build

WARP = 32
MAX_BLOCK = 16       # largest act block the CUDA row stages hold in registers
MAX_LUT = 256        # entries of the shared-memory LUT copy

launches = 0

_LUTS: Dict[Tuple, torch.Tensor] = {}


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
    """A table as a float32 tensor on ``device``, cached."""
    key = (table, str(device))
    t = _LUTS.get(key)
    if t is None:
        t = _LUTS[key] = torch.tensor(table, dtype=torch.float32,
                                      device=device)
    return t


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
        centered = mf - (mf.sum(dim=(1, 2)) * inv_d)[:, None, None]
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
    """(rows, d) f32 MXInt LayerNorm over the last axis.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    rows, d = x.shape
    act_block = resolve_act_block(d, act_block)
    if beta is None:
        beta = torch.zeros_like(gamma)
    if x.device.type == "cpu":
        return layernorm_rows(x, gamma, beta, act_block=act_block,
                              mant_bits=mant_bits, lut_bits=lut_bits,
                              rms_only=rms_only, quantize_out=quantize_out)
    global launches
    gamma, beta = gamma.to(torch.float32), beta.to(torch.float32)
    if x.dtype != torch.float32 or act_block > MAX_BLOCK or \
            2 ** lut_bits > MAX_LUT:
        raise ValueError("mxint_layernorm kernel takes f32 rows, act_block "
                         f"<= {MAX_BLOCK} and at most {MAX_LUT} LUT entries")
    lut = lut_tensor(luts.rsqrt_table(lut_bits), x.device)
    _build.require_cuda("mxint_layernorm", x, gamma, beta, lut)
    out = torch.empty_like(x)
    fn = _build.entry("mxint_layernorm", [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), lut.data_ptr(),
            out.data_ptr(), rows, d, act_block, mant_bits, f32(1.0 / d),
            2 ** lut_bits, f32(2 ** lut_bits / 1.5), int(rms_only),
            int(quantize_out), _build.stream_ptr(x.device))
    _build.check(rc, "mxint_layernorm")
    launches += 1
    return out
