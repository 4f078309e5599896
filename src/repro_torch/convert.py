"""Parameters of the reference's models as parameters of the port.

The reference keeps its parameters as a tree of ``Param`` leaves with
blocks stacked on a leading layers axis.  Given that tree unwrapped to
nested dicts of numpy arrays, ``vit_params`` and ``lm_params`` return the
port's Param tree with the same values and the axes of the port model's
``param_spec``, after which both packages compute the same function.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model_api import Param


def _convert(model, spec, arrays, device):
    """Arrays shaped like ``spec`` -> Params; raises if a leaf is missing,
    extra or of the wrong shape."""
    def conv(spec, arr, path):
        if isinstance(spec, dict):
            if not isinstance(arr, dict) or set(arr) != set(spec):
                raise ValueError(f"{path or 'params'}: keys differ from the "
                                 f"model's parameters")
            return {k: conv(spec[k], arr[k], f"{path}/{k}") for k in spec}
        if isinstance(spec, list):
            return [conv(s, a, f"{path}/{i}")
                    for i, (s, a) in enumerate(zip(spec, arr))]
        shape, axes, _ = spec
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return Param(t.to(device=device, dtype=model.cfg.dtype), axes)

    return conv(spec, arrays, "")


def vit_params(model, arrays: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the port's ViT Param tree on
    ``device``."""
    return _convert(model, model.param_spec(), arrays, device)


def lm_params(model, arrays: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """The reference ``DecoderLM``'s parameters as numpy arrays (``embed``,
    ``final_norm``, ``unembed``, and the blocks stacked on a leading axis
    under ``units/u0_attn``; ``tail`` empty) -> the port's Param tree on
    ``device``, whose ``layers`` is a per-layer list.  A MoE layer's
    router and (E, ...) expert stacks come across as its other leaves
    do: layer i's slice of each stacked array."""
    arrays = dict(arrays)
    units, tail = arrays.pop("units", {}), arrays.pop("tail", {})
    if set(units) != {"u0_attn"} or tail:
        raise ValueError("lm_params takes ('attn',) stacks without a tail")
    n = model.cfg.n_layers

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.shape[0] != n:
            raise ValueError(f"stacked leaf with {a.shape[0]} layers, "
                             f"expected {n}")
        return a[i]

    arrays["layers"] = [layer(units["u0_attn"], i) for i in range(n)]
    return _convert(model, model.param_spec(), arrays, device)
