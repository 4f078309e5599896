"""Quantization-aware layer primitives.

Thin forwarding wrappers: each primitive dispatches through the backend
resolved once from the config (``q.datapath``); nothing here branches on
the execution mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.mx_types import QuantConfig
from repro_torch.core.quantize import MXTensor
from repro_torch.models.model_api import Param


def embed_lookup(tokens: torch.Tensor, table: Param, q: QuantConfig,
                 dtype) -> torch.Tensor:
    """Rows of the embedding table for ``tokens``, through the backend's
    ``weight_value``.  A packed table has its mantissa and exponent rows
    gathered first and only those dequantized: the same bits as
    dequantizing the whole (vocab, d) table, which never happens per step.
    A float table goes through ``weight_value`` whole, since a backend
    that quantize-dequantizes it blocks along the vocab axis."""
    tv = table.value
    if isinstance(tv, MXTensor):
        tv = tv._replace(mantissa=tv.mantissa[tokens],
                         exponent=tv.exponent[tokens])
        return q.datapath.weight_value(tv, q=q, dtype=dtype)
    return q.datapath.weight_value(tv, q=q, dtype=dtype)[tokens]


def unembed(x: torch.Tensor, table: Param, q: QuantConfig) -> torch.Tensor:
    """x (..., d) against the (vocab, d) table: the backend's
    ``weight_value`` of the table (dequantized planes, or quantize-
    dequantized floats in "fake" and "sim") in a plain ``torch.matmul``, a
    product the reference leaves outside any kernel."""
    tf = q.datapath.weight_value(table.value, q=q, dtype=x.dtype)
    return torch.matmul(x, tf.t())


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


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, hd); positions: (..., seq).

    The frequency ladder is float32, as the reference computes it, and is
    built on the host, so every device gets the same bits.  cos and sin of
    the float32 angles run in float64 and round once to float32: the
    correctly rounded values, the same on every device (a CPU and a GPU
    float32 ``cos`` differ in their last bit on about 5% of these angles).
    """
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    # rank-1 frequency ladder on concrete constants, not a datapath op:
    # repro-lint: allow[models-float-nonlinear] positional constants
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32) *
                      (log_theta / half)).to(x.device)
    ang = (positions[..., None].to(torch.float32) * freqs).double()
    cos = torch.cos(ang).float()[..., None, :]
    sin = torch.sin(ang).float()[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn(x: torch.Tensor, p, kind: str, q: QuantConfig, prenorm=None,
        eps: float = 1e-6, scope: Optional[str] = None) -> torch.Tensor:
    """p: wi/wg/wo for the gated kinds ('swiglu': act(x wg) is SiLU,
    'geglu': GELU), wi/wo (+ bi/bo) for the plain GELU MLP:
    gated:  (x wi * act(x wg)) wo;  plain:  act(x wi + bi) wo + bo.

    ``prenorm``: optional ('ln'|'rms', gamma, beta), folded into the input
    linears through the ``layernorm_linear`` composite when the backend
    fuses it.
    """
    q = q.scoped(scope)
    gated = kind in ("swiglu", "geglu")
    if not gated and kind != "gelu":
        raise ValueError(f"ffn kind {kind!r}")
    ins = [p["wi"], p["wg"]] if gated else [p["wi"]]
    x, prenorm = prenorm_linears(x, prenorm, ins, q, eps)

    def in_linear(w, b=None):
        if prenorm is None:
            return linear(x, w, b, q=q)
        nk, g, b_ = prenorm
        return layernorm_linear(x, g, b_, w, b, q=q, eps=eps,
                                rms_only=(nk == "rms"))

    if gated:
        up = in_linear(p["wi"])
        gate = act_fn(in_linear(p["wg"]),
                      "silu" if kind == "swiglu" else "gelu", q)
        return linear(up * gate, p["wo"], q=q)
    h = act_fn(in_linear(p["wi"], p.get("bi")), "gelu", q)
    return linear(h, p["wo"], p.get("bo"), q=q)
