"""Quantization-aware layer primitives.

Thin forwarding wrappers: each primitive dispatches through the backend
resolved once from the config (``q.datapath``); nothing here branches on
the execution mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.mx_types import QuantConfig
from repro_torch.models.model_api import Param


def linear(x: torch.Tensor, w: Param, b: Optional[Param] = None, *,
           q: QuantConfig, scope: Optional[str] = None) -> torch.Tensor:
    """y = x @ w (+ b); w may hold packed MXInt planes."""
    q = q.scoped(scope)
    return q.datapath.linear(x, w, b, q=q)


def rmsnorm(x: torch.Tensor, gamma: Param, *, q: QuantConfig,
            eps: float = 1e-6) -> torch.Tensor:
    return q.datapath.rmsnorm(x, gamma, q=q, eps=eps)


def layernorm(x: torch.Tensor, gamma: Param, beta: Param, *, q: QuantConfig,
              eps: float = 1e-6, scope: Optional[str] = None) -> torch.Tensor:
    q = q.scoped(scope)
    return q.datapath.layernorm(x, gamma, beta, q=q, eps=eps)


def layernorm_linear(x: torch.Tensor, gamma: Param, beta: Optional[Param],
                     w: Param, b: Optional[Param] = None, *,
                     q: QuantConfig, eps: float = 1e-6,
                     rms_only: bool = False) -> torch.Tensor:
    """Norm followed by a quantized linear: the backend's fused composite
    when it has one, the two-op sequence otherwise (bit-identical)."""
    dp = q.datapath
    if dp.layernorm_linear is not None:
        return dp.layernorm_linear(x, gamma, beta, w, b, q=q, eps=eps,
                                   rms_only=rms_only)
    h = (dp.rmsnorm(x, gamma, q=q, eps=eps) if rms_only
         else dp.layernorm(x, gamma, beta, q=q, eps=eps))
    return dp.linear(h, w, b, q=q)


def act_fn(x: torch.Tensor, kind: str, q: QuantConfig) -> torch.Tensor:
    return q.datapath.act(x, kind, q=q)


def softmax(x: torch.Tensor, q: QuantConfig, axis: int = -1) -> torch.Tensor:
    return q.datapath.softmax(x, q=q, axis=axis)


def prenorm_linears(x, prenorm, weights, q: QuantConfig, eps: float):
    """Decide how a pre-norm feeds its linears: returns (x, prenorm), with
    the norm applied once up front (and prenorm None) unless the backend
    fuses it into every one of ``weights``."""
    if prenorm is None or all(q.datapath.fuses_norm_linear(q, x, w)
                              for w in weights):
        return x, prenorm
    nk, g, b_ = prenorm
    x = (rmsnorm(x, g, q=q, eps=eps) if nk == "rms"
         else layernorm(x, g, b_, q=q, eps=eps))
    return x, None


def ffn(x: torch.Tensor, p, kind: str, q: QuantConfig, prenorm=None,
        eps: float = 1e-6, scope: Optional[str] = None) -> torch.Tensor:
    """The plain GELU MLP: act(x @ wi + bi) @ wo + bo.

    ``prenorm``: optional ('ln'|'rms', gamma, beta), folded into ``wi``
    through the ``layernorm_linear`` composite when the backend fuses it.
    The gated kinds come with the LM slice.
    """
    if kind != "gelu":
        raise NotImplementedError(f"ffn kind {kind!r} comes with the LM slice")
    q = q.scoped(scope)
    x, prenorm = prenorm_linears(x, prenorm, [p["wi"]], q, eps)
    if prenorm is None:
        h = linear(x, p["wi"], p.get("bi"), q=q)
    else:
        nk, g, b_ = prenorm
        h = layernorm_linear(x, g, b_, p["wi"], p.get("bi"), q=q, eps=eps,
                             rms_only=(nk == "rms"))
    return linear(act_fn(h, "gelu", q), p["wo"], p.get("bo"), q=q)
