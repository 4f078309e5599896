"""Cache-less multi-head attention (the encoder / ViT path).

Projections, head split and the GQA fold live here; the attention core
dispatches through the backend (``quant.datapath.attention``).  The cache
branches (prefill, decode rings) come with the LM slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.mx_types import QuantConfig
from repro_torch.models import layers as L
from repro_torch.models.model_api import ModelConfig


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, quant: QuantConfig,
              prenorm: Optional[Tuple] = None,
              scope: Optional[str] = None) -> torch.Tensor:
    """Unmasked self-attention over x (b, s, d); returns (b, s, d).

    prenorm: optional ('ln'|'rms', gamma, beta) pre-attention norm; the
    q/k/v projections then ride the fused ``layernorm_linear`` composite
    when the backend provides it.
    """
    quant = quant.scoped(scope)
    b, s, _ = x.shape
    hd = cfg.hd
    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    x, prenorm = L.prenorm_linears(x, prenorm, [p["wq"], p["wk"], p["wv"]],
                                   quant, cfg.norm_eps)

    def in_proj(w):
        if prenorm is None:
            return L.linear(x, w, q=quant)
        nk, ng, nb = prenorm
        return L.layernorm_linear(x, ng, nb, w, q=quant, eps=cfg.norm_eps,
                                  rms_only=(nk == "rms"))

    q = in_proj(p["wq"]).reshape(b, s, kvh, g, hd)
    k = in_proj(p["wk"]).reshape(b, s, kvh, hd)
    v = in_proj(p["wv"]).reshape(b, s, kvh, hd)
    o = quant.datapath.attention(q, k, v, q=quant, scale=hd ** -0.5)
    return L.linear(o.reshape(b, s, cfg.n_heads * hd), p["wo"], q=quant)
