"""Parameters of the reference ViT as parameters of the port.

The reference keeps its ViT parameters as a tree of ``Param`` leaves with
blocks stacked on a leading layers axis.  Given that tree unwrapped to
nested dicts of numpy arrays, ``vit_params`` returns the port's Param tree
with the same values and the axes of ``ViT.param_spec``, after which both
packages compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model_api import Param


def vit_params(model, arrays: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the port's Param tree on ``device``.
    Raises if a leaf is missing, extra or of the wrong shape."""
    def conv(spec, arr, path):
        if isinstance(spec, dict):
            if not isinstance(arr, dict) or set(arr) != set(spec):
                raise ValueError(f"{path or 'params'}: keys differ from the "
                                 f"model's parameters")
            return {k: conv(spec[k], arr[k], f"{path}/{k}") for k in spec}
        shape, axes, _ = spec
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return Param(t.to(device=device, dtype=model.cfg.dtype), axes)

    return conv(model.param_spec(), arrays, "")
