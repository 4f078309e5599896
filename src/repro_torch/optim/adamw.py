"""AdamW on the port's parameter trees (``Param`` leaves or tensors).

Counterpart of ``repro.optim.adamw``.  The moments are float32 whatever
the parameters' dtype (bf16 parameters keep float32 statistics; the
update is computed in float32 and cast back), and they keep the
parameters' ``Param`` wrappers, so they carry the same logical axes.
The update is a plain function of tensors, as the reference's is: it
returns new trees and changes nothing it is given.  A parameter that
was a leaf tensor requiring a gradient comes back as one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.models.model_api import (Param, tree_leaves, tree_map,
                                          tree_unflatten)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar, the updates taken
    mu: Any
    nu: Any


def _value(x) -> torch.Tensor:
    return x.value if isinstance(x, Param) else x


def _like(x, v):
    """``v`` in ``x``'s wrapper: a Param with x's axes, or bare."""
    return Param(v, x.axes) if isinstance(x, Param) else v


def adamw_init(params) -> AdamWState:
    def zeros(p):
        v = _value(p)
        return _like(p, torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device))

    dev = _value(tree_leaves(params)[0]).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root, correctly rounded on every device: taken
    in float64 and rounded once (torch's CPU float32 ``sqrt`` is not
    correctly rounded; the card's and XLA's are)."""
    return torch.sqrt(x.double()).float()


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in ``tree_leaves`` order) of each
    leaf's float32 sum of squares; the root is the correctly rounded
    float32 one (``_sqrt``)."""
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(torch.square(_value(leaf).to(torch.float32)))
        total = s if total is None else total + s
    return _sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    # a tensor divisor: a Python scalar over a tensor is a reciprocal
    # times the scalar in torch, not a rounded quotient
    scale = torch.clamp(torch.full_like(norm, max_norm) /
                        torch.clamp(norm, min=1e-12), max=1.0)

    def one(g):
        v = _value(g)
        return _like(g, (v.to(torch.float32) * scale).to(v.dtype))

    return tree_map(one, grads), norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr: torch.Tensor,
                 cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm); grad_norm is the norm
    before clipping."""
    if cfg.clip_norm > 0:
        grads, norm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        norm = global_norm(grads)
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)

    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        gf = _value(g).to(torch.float32)
        m_new = b1 * _value(m) + (1 - b1) * gf
        v_new = b2 * _value(v) + (1 - b2) * gf * gf
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (_sqrt(vhat) + cfg.eps)
        pv = _value(p)
        pf = pv.to(torch.float32)
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        pn = pf.to(pv.dtype)
        if pv.requires_grad:
            pn.requires_grad_(True)
        new_p.append(_like(p, pn))
        new_m.append(_like(m, m_new))
        new_v.append(_like(v, v_new))
    return (tree_unflatten(params, new_p),
            AdamWState(step, tree_unflatten(state.mu, new_m),
                       tree_unflatten(state.nu, new_v)), norm)
