"""MXInt quantization: block-shared exponent plus integer mantissa.

For a block b with elements x_i::

    amax = max_i |x_i|
    e_b  = floor(log2(amax)) - (mant_bits - 2)
    m_i  = clip(round(x_i * 2^-e_b), -(2^(m-1) - 1), 2^(m-1) - 1)
    x_i  ~ m_i * 2^e_b                                        (paper Eq. 2)

Powers of two are built from exponent bits (``pow2i``), never with a float
``exp2``, so every scale is exact.  ``torch.round`` rounds half to even,
as the reference's ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.mx_types import MXFormat

_EXP_MIN, _EXP_MAX = -127, 127
_TINY = float(torch.finfo(torch.float32).tiny)


class MXTensor(NamedTuple):
    """A packed MXInt tensor.

    mantissa: integer tensor, the shape of the source tensor.
    exponent: int8 tensor, the source shape with the block axis divided by
      ``block_size``.
    scale_axis: the block axis, stored negative so that indexing a leading
      stacked-layers dim leaves it valid.
    mant_bits / block_size: static format fields (block may be clamped).
    """

    mantissa: torch.Tensor
    exponent: torch.Tensor
    scale_axis: int
    mant_bits: int
    block_size: int

    def layer(self, i: int) -> "MXTensor":
        """Planes of entry ``i`` of a leading stacked dim (a view)."""
        return self._replace(mantissa=self.mantissa[i],
                             exponent=self.exponent[i])

    def to(self, device) -> "MXTensor":
        return self._replace(mantissa=self.mantissa.to(device),
                             exponent=self.exponent.to(device))


def pow2i(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^n for an integer tensor ``n``, from exponent bits.

    Normal results come from the biased exponent field, subnormal ones
    (n in [-149, -127]) from the mantissa bits; below that 0, above 127 inf.
    """
    n = n.to(torch.int32)
    normal = ((n.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(n) << (n.clamp(-149, -127) + 149)).view(torch.float32)
    out = torch.where(n >= -126, normal,
                      torch.where(n >= -149, sub, torch.zeros_like(normal)))
    return torch.where(n > 127, torch.full_like(out, float("inf")), out)


def _resolve_block(dim: int, block_size: int) -> int:
    """Clamp the block size to the dimension: the block itself when it
    divides ``dim``, ``dim`` when smaller, else the largest divisor of
    ``dim`` below it (197 with block 16 gives 1)."""
    if dim >= block_size and dim % block_size == 0:
        return block_size
    if dim < block_size:
        return dim
    for b in range(block_size, 0, -1):
        if dim % b == 0:
            return b
    return 1


def _shared_exponent(amax: torch.Tensor, mant_bits: int) -> torch.Tensor:
    """e = floor(log2(amax)) - (mant_bits - 2), 0 for an all-zero block,
    saturated to the int8 range; returned as int32."""
    _, k = torch.frexp(torch.clamp(amax, min=_TINY))
    e = k - 1 - (mant_bits - 2)
    e = torch.where(amax > 0, e, torch.zeros_like(e))
    return e.clamp(_EXP_MIN, _EXP_MAX)


def quantize(x: torch.Tensor, fmt: MXFormat, axis: int = -1) -> MXTensor:
    """Quantize ``x`` to MXInt along ``axis``."""
    x = x.to(torch.float32)
    axis = axis % x.ndim
    d = x.shape[axis]
    block = _resolve_block(d, fmt.block_size)
    xb = x.reshape(x.shape[:axis] + (d // block, block) + x.shape[axis + 1:])
    amax = xb.abs().amax(dim=axis + 1)
    e = _shared_exponent(amax, fmt.mant_bits)
    m = torch.round(xb * pow2i(-e).unsqueeze(axis + 1))
    m = m.clamp(fmt.mant_min, fmt.mant_max).reshape(x.shape).to(fmt.mant_dtype)
    return MXTensor(m, e.to(torch.int8), axis - x.ndim, fmt.mant_bits, block)


def dequantize(t: MXTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct x = m * 2^e."""
    scale = pow2i(t.exponent).repeat_interleave(t.block_size, dim=t.scale_axis)
    return (t.mantissa.to(torch.float32) * scale).to(dtype)


def requantize_to_max_exponent(t: MXTensor, axis: int = -1):
    """Align every block along ``axis`` to the max exponent by arithmetic
    right shifts of the mantissas (paper Eq. 3).

    Returns (shifted int32 mantissas, int32 max exponent with the reduced
    axis kept at size 1).  The shift truncates toward -inf, as a barrel
    shifter does, and saturates at 31.
    """
    nd = t.mantissa.ndim
    axis = axis % nd
    if axis != t.scale_axis % nd:
        raise ValueError("requantize must reduce along the block axis")
    e = t.exponent.to(torch.int32)
    e_max = e.amax(dim=axis, keepdim=True)
    shift = (e_max - e).repeat_interleave(t.block_size, dim=axis)
    m = t.mantissa.to(torch.int32) >> shift.clamp(max=31)
    return m, e_max


def pack_weight(w: torch.Tensor, fmt: MXFormat, axis: int = 0) -> MXTensor:
    """Quantize a weight for packed serving storage; ``axis`` is the
    contraction dimension, so each output feature's blocks run along the
    reduction, the layout the matmul kernels consume."""
    return quantize(w, fmt, axis=axis)
