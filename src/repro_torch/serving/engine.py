"""Serving: packed-MXInt weights and the ViT classification engine.

``pack_params_mxint`` turns large matmul weights into ``MXTensor`` planes
(int8 mantissas plus int8 shared exponents), the paper's weight format,
with the reference's packing rules.  ``ViTServingEngine`` serves a
classifier on one device in fixed-size batches.  The port runs eagerly, so
there is no compile cache to watch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mx_types import MXINT6_WEIGHT, MXFormat
from repro_torch.core.quantize import pack_weight
from repro_torch.models.model_api import Param, tree_map


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.

    batch: the fixed batch shape; requests are padded or packed to it.
    pack_weights / weight_fmt: pack large matmul weights to MXInt planes.
    """
    batch: int = 8
    pack_weights: bool = False
    weight_fmt: MXFormat = None

    def __post_init__(self):
        if self.pack_weights and self.weight_fmt is None:
            object.__setattr__(self, "weight_fmt", MXINT6_WEIGHT)


_PACK_MIN_SIZE = 1 << 14       # don't pack tiny tensors (norm scales, biases)


def _contraction_axis(p: Param) -> int:
    """Blocks run along the reduction dim of the consuming matmul: axis 1
    of expert stacks, the last axis of vocab/class tables, else the
    second-to-last axis (axis 1 of a layer-stacked (L, d_in, d_out))."""
    axes = p.axes
    if axes and axes[0] == "expert":
        return 1
    if axes and axes[0] in ("vocab", "classes"):
        return len(axes) - 1
    return max(len(axes) - 2, 0)


def _should_pack(p: Param) -> bool:
    shape = tuple(p.value.shape)
    axes = p.axes
    if axes and axes[_contraction_axis(p)] is None:
        return False            # positional tables are added, not matmul'd
    eff = shape[1:] if axes and axes[0] == "layers" else shape
    if len(eff) < 2:
        return False            # norm scales / biases stay unpacked
    if int(np.prod(shape)) < _PACK_MIN_SIZE:
        return False
    return shape[_contraction_axis(p)] >= 16


def pack_params_mxint(params, fmt: MXFormat):
    """Param tree -> Param tree with ``MXTensor`` values on large matmul
    weights, blocks along the contraction axis; everything else as is."""
    def pack(p: Param) -> Param:
        if not _should_pack(p):
            return p
        return Param(pack_weight(p.value.to(torch.float32), fmt,
                                 axis=_contraction_axis(p)), p.axes)

    return tree_map(pack, params)


def params_to(params, device):
    """Move every leaf of a Param tree (packed planes included)."""
    return tree_map(lambda p: Param(p.value.to(device), p.axes), params)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ViTServingEngine runs on cuda by default and no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain versions of the kernels")
    return device


class ViTServingEngine:
    """Batched image classification for ViT/DeiT models on one device.

    With ``pack_weights=True`` and a model config in kernel mode this is
    the paper's deployment: packed int8 planes in device memory and every
    linear and non-linear op in the MXInt kernels.  Every forward runs the
    fixed ``(serve_cfg.batch, H, W, 3)`` shape.
    """

    def __init__(self, model, params, serve_cfg: ServeConfig,
                 device="cuda"):
        self.model = model
        self.cfg = serve_cfg
        self.device = _device(device)
        if serve_cfg.pack_weights:
            params = pack_params_mxint(params, serve_cfg.weight_fmt)
        self.params = params_to(params, self.device)

    @torch.no_grad()
    def logits_batch(self, chunk) -> torch.Tensor:
        """One forward on a (cfg.batch, H, W, 3) numpy chunk; the single
        funnel of ``classify`` and ``ClassifyScheduler``."""
        x = torch.as_tensor(np.asarray(chunk, dtype=np.float32),
                            device=self.device)
        return self.model.logits(self.params, x)

    def classify(self, images):
        """(n, H, W, 3) images -> (labels (n,), logits (n, classes)).

        Served in ``cfg.batch`` chunks, the last one zero-padded (the
        padding rows are dropped from the result)."""
        images = np.asarray(images, dtype=np.float32)
        n, batch = images.shape[0], self.cfg.batch
        chunks = []
        for i in range(0, n, batch):
            chunk = images[i:i + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            chunks.append(self.logits_batch(chunk)[:batch - pad])
        logits = torch.cat(chunks, dim=0)
        return logits.argmax(dim=-1), logits
