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
    tp_axis: the mesh axis this rank's planes are a shard over, or None
      (whole planes).  Set by ``repro_torch.parallel.sharding``; the
      kernel-mode linear then runs on the local planes and adds the
      collective of ``tp_mode`` over that axis's process group.
    tp_mode: "gather" when the output (last) axis is sharded: each rank
      contracts the whole K for its columns and the slices are gathered,
      bit for bit the single-device result; "psum" when the contraction
      axis is sharded: each rank sums its K rows and the partial products
      are all-reduced, close to but not bit for bit the single-device
      result (two sums added, not one).
    """

    mantissa: torch.Tensor
    exponent: torch.Tensor
    scale_axis: int
    mant_bits: int
    block_size: int
    tp_axis: "str | None" = None
    tp_mode: "str | None" = None

    def layer(self, i: int) -> "MXTensor":
        """Planes of entry ``i`` of a leading stacked dim (a view)."""
        return self._replace(mantissa=self.mantissa[i],
                             exponent=self.exponent[i])

    def to(self, device) -> "MXTensor":
        return self._replace(mantissa=self.mantissa.to(device),
                             exponent=self.exponent.to(device))

    def nbytes_packed(self) -> int:
        """Bytes this tensor occupies in packed storage (sub-byte mantissas
        counted at their true bit cost, as dense bit-packing would give;
        the card's planes hold a byte a mantissa)."""
        n = self.mantissa.numel()
        return int((n * self.mant_bits + self.exponent.numel() * 8 + 7)
                   // 8)


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


def repeat_blocks(t: torch.Tensor, block: int, axis: int) -> torch.Tensor:
    """Each entry of ``t`` repeated ``block`` times along ``axis`` (one per
    element of its block): an expand and a reshape, where
    ``repeat_interleave`` may wait for the device to size its output."""
    axis = axis % t.ndim
    shape = t.shape[:axis + 1] + (block,) + t.shape[axis + 1:]
    out = t.unsqueeze(axis + 1).expand(shape)
    return out.reshape(t.shape[:axis] + (t.shape[axis] * block,) +
                       t.shape[axis + 1:])


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
    """Reconstruct x = m * 2^e: the float32 product, cast to ``dtype``.
    Each block's 2^e broadcasts over the block's elements, so no scale the
    size of the tensor is written."""
    m = t.mantissa
    axis = t.scale_axis % m.ndim
    blocks = m.shape[:axis] + (t.exponent.shape[axis], -1) + m.shape[axis + 1:]
    scale = pow2i(t.exponent).unsqueeze(axis + 1)
    return (m.reshape(blocks).to(torch.float32) * scale).reshape(
        m.shape).to(dtype)


def quantize_dequantize(x: torch.Tensor, fmt: MXFormat,
                        axis: int = -1) -> torch.Tensor:
    """x snapped onto the MXInt grid, in x's dtype."""
    return dequantize(quantize(x, fmt, axis), dtype=x.dtype)


class _FakeQuant(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through backward."""

    @staticmethod
    def forward(ctx, x, mant_bits, block_size, axis):
        fmt = MXFormat(mant_bits=mant_bits, block_size=block_size)
        return quantize_dequantize(x, fmt, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(x: torch.Tensor, mant_bits: int, block_size: int,
               axis: int) -> torch.Tensor:
    """``quantize_dequantize`` whose gradient passes through unchanged."""
    return _FakeQuant.apply(x, mant_bits, block_size, axis)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with c filled into a tensor on x's device: ATen multiplies a
    CUDA tensor by the reciprocal of a host scalar divisor, which can
    differ from the quotient in the last bit; a tensor divisor divides.
    The fill copies nothing from the host, so nothing waits."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def per_tensor_int_qdq(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor integer quantize-dequantize (the paper's IntN
    rows of Table V)."""
    lim = 2 ** (bits - 1)
    amax = torch.clamp(x.abs().amax(), min=1e-12)
    s = div(amax, lim - 1)
    return (torch.clamp(torch.round(x / s), -lim, lim - 1) * s).to(x.dtype)


def fp8_e4m3_qdq(x: torch.Tensor) -> torch.Tensor:
    """e4m3 emulation: 3 explicit mantissa bits (frexp exponent clipped to
    [-6, 9], round half to even), saturating at +-448."""
    xf = x.to(torch.float32)
    _, e = torch.frexp(xf)
    scale = pow2i(3 - e.clamp(-6, 9))
    q = torch.round(xf * scale) / scale
    return torch.clamp(q, -448.0, 448.0).to(x.dtype)


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
    shift = repeat_blocks(e_max - e, t.block_size, axis)
    m = t.mantissa.to(torch.int32) >> shift.clamp(max=31)
    return m, e_max


def pack_weight(w: torch.Tensor, fmt: MXFormat, axis: int = 0) -> MXTensor:
    """Quantize a weight for packed serving storage; ``axis`` is the
    contraction dimension, so each output feature's blocks run along the
    reduction, the layout the matmul kernels consume.  A ``meta`` weight
    (the launch dry run's) has no values: it gets the planes' shapes and
    dtypes alone, as the reference's ``abstract=True`` packing does."""
    if w.device.type != "meta":
        return quantize(w, fmt, axis=axis)
    axis = axis % w.ndim
    block = _resolve_block(w.shape[axis], fmt.block_size)
    e_shape = w.shape[:axis] + (w.shape[axis] // block,) + w.shape[axis + 1:]
    return MXTensor(torch.empty(w.shape, dtype=fmt.mant_dtype, device="meta"),
                    torch.empty(e_shape, dtype=torch.int8, device="meta"),
                    axis - w.ndim, fmt.mant_bits, block)


def packed_bytes(tree) -> int:
    """Total packed bytes of a parameter tree (dicts, lists, ``Param``
    leaves) that may mix ``MXTensor`` planes and plain tensors."""
    if isinstance(tree, MXTensor):
        return tree.nbytes_packed()
    if isinstance(tree, dict):
        return sum(packed_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "value") and hasattr(tree, "axes"):   # a Param
            return packed_bytes(tree.value)
        return sum(packed_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
