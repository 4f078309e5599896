"""MXInt gradient compression for cross-pod data parallelism.

Counterpart of ``repro.core.gradient_compression``: before the pod-level
gradient all-reduce, a gradient is quantized to MXInt (int8 mantissas, a
shared exponent per block of 32: the OCP MXINT8 layout), reduced as its
dequantized values, and the quantization residual is carried to the
next step (error feedback, which keeps SGD convergent).  The pod link
then carries 8.25 bits an element against 32 for float32 (3.88x).

``compressed_psum`` reduces over a process group (the mesh's "pod" axis
in ``make_train_step``): each rank adds its residual to its gradient,
compresses the sum, all-reduces the dequantized payload and keeps the
new residual.  The collective's operand is the dequantized payload, as in
the reference: its information is 8.25 bits an element.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mx_types import MXINT8_OCP, MXFormat
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.models.model_api import Param, tree_map
from repro_torch.parallel import collectives


def compress_leaf(g: torch.Tensor, fmt: MXFormat = MXINT8_OCP):
    """Quantize one gradient leaf, flattened and zero-padded to whole
    blocks; returns (the MXTensor, its dequantized values, the residual
    g - dequantized, the padding)."""
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % fmt.block_size
    if pad:
        flat = F.pad(flat, (0, pad))
    mx = quantize(flat, fmt, axis=-1)
    deq = dequantize(mx)
    residual = flat - deq
    return mx, deq, residual, pad


def compressed_psum(grads: Any, group, error_state: Any,
                    fmt: MXFormat = MXINT8_OCP) -> Tuple[Any, Any]:
    """The sum over ``group``'s ranks of ``grads``, each rank's leaf
    MXInt-compressed with error feedback.  ``error_state`` is a tree of
    residuals shaped like ``grads`` (``init_error_state``).  Returns
    (the reduced float32 gradients, the new residuals); trees of
    ``Param`` leaves keep their axes."""
    def one(g, err):
        gv = g.value if isinstance(g, Param) else g
        ev = err.value if isinstance(err, Param) else err
        x = gv.to(torch.float32) + ev
        _, deq, residual, pad = compress_leaf(x, fmt)
        red = collectives.all_reduce_sum(deq, group)
        n = x.numel()
        red, residual = red[:n].reshape(x.shape), residual[:n].reshape(
            x.shape)
        if isinstance(g, Param):
            return Param(red, g.axes), Param(residual, g.axes)
        return red, residual

    pairs = tree_map(one, grads, error_state)       # leaves: 2-tuples
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def init_error_state(grads: Any) -> Any:
    """Zero residuals shaped like ``grads`` (Param leaves keep their
    axes)."""
    def zeros(g):
        if isinstance(g, Param):
            return Param(torch.zeros_like(g.value), g.axes)
        return torch.zeros_like(g)
    return tree_map(zeros, grads)


def compression_ratio(fmt: MXFormat = MXINT8_OCP,
                      baseline_bits: int = 32) -> float:
    return baseline_bits / fmt.bits_per_element
