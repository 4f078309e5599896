"""Parameters of the reference's models as parameters of the port.

The reference keeps its parameters as a tree of ``Param`` leaves with
blocks stacked on a leading layers axis.  Given that tree unwrapped to
nested dicts of numpy arrays, ``vit_params``, ``lm_params`` and
``encdec_params`` return the port's Param tree with the same values and
the axes of the port model's ``param_spec``, after which both packages
compute the same function.
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
    ``final_norm``, ``unembed``; under ``units/u{j}_{kind}`` the blocks of
    unit position j stacked on a leading ``n_units`` axis, under
    ``tail/t{j}_{kind}`` the tail's blocks unstacked) -> the port's Param
    tree on ``device``, whose ``layers`` is a per-layer list in the
    reference's order: the unit repeats, then the tail.  A MoE layer's
    router and (E, ...) expert stacks come across as its other leaves
    do: layer i's slice of each stacked array.  A VLM's ``vision_proj``
    comes across as the tables do."""
    cfg = model.cfg
    arrays = dict(arrays)
    units, tail = arrays.pop("units", {}), arrays.pop("tail", {})
    unit_keys = [f"u{j}_{k}" for j, k in enumerate(cfg.unit)]
    tail_keys = [f"t{j}_{k}" for j, k in enumerate(cfg.tail)]
    if set(units) != set(unit_keys) or set(tail) != set(tail_keys):
        raise ValueError(f"units {sorted(units)} / tail {sorted(tail)}: "
                         f"keys differ from the model's {unit_keys} / "
                         f"{tail_keys}")
    n = cfg.resolved_n_units

    arrays["layers"] = [_layer(units[k], u, n) for u in range(n)
                        for k in unit_keys] + [tail[k] for k in tail_keys]
    return _convert(model, model.param_spec(), arrays, device)


def encdec_params(model, arrays: Dict[str, Any],
                  device="cuda") -> Dict[str, Any]:
    """The reference ``EncDecLM``'s parameters as numpy arrays (``embed``,
    ``enc_norm``, ``final_norm``, ``unembed``; ``enc_blocks`` and
    ``dec_blocks`` stacked on a leading layer axis) -> the port's Param
    tree on ``device``, whose ``enc_blocks`` and ``dec_blocks`` are
    per-layer lists."""
    arrays = dict(arrays)
    for key, n in (("enc_blocks", model.cfg.n_encoder_layers),
                   ("dec_blocks", model.cfg.n_layers)):
        if key not in arrays:
            raise ValueError(f"params: no {key}")
        arrays[key] = [_layer(arrays[key], i, n) for i in range(n)]
    return _convert(model, model.param_spec(), arrays, device)


def _layer(tree, i: int, n: int):
    """Layer i of a tree of arrays stacked on a leading axis of n."""
    if isinstance(tree, dict):
        return {k: _layer(v, i, n) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.shape[0] != n:
        raise ValueError(f"stacked leaf with {a.shape[0]} layers, "
                         f"expected {n}")
    return a[i]
