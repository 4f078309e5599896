"""Attention: GQA, RoPE, sliding window, KV-cache rings, cross-attention.

This module owns the orchestration (projections, RoPE, cache ring
arithmetic, mask semantics); the attention core dispatches through the
backend resolved from the config (``quant.datapath``): the cache-less path
to ``attention``, decode to ``attention_decode``.  The kernel backend runs
them in the kernels (whole-row, flash, one fused decode kernel over the
ring); the float and sim backends run ``_direct_attention`` (the masked
softmax on the whole score matrix) or ``_q_chunked_attention``.  Prefill
into a cache runs ``_q_chunked_attention``, plain float attention that
the reference computes outside any kernel in every mode.
Cross-attention (``kv_override``: the encoder-decoder's per-layer
encoder K/V) is cache-less and takes the backend's ``attention``.

Float products and sums run in float64 and round once to float32 (then
to the model dtype), so they do not depend on the device's summation
order.

KV caches are (b, W, kv_heads, hd) rings, written in place.  With a window
W < max_len, slot i of row b at step t holds absolute position
t - ((t - i) mod W).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.mx_types import NEG_INF, QuantConfig
from repro_torch.kernels.mxint_layernorm import f32
from repro_torch.models import layers as L
from repro_torch.models.model_api import ModelConfig

CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)


def attn_param_spec(cfg: ModelConfig, cross: bool = False):
    """The (shape, axes, init) leaves of one attention: wq, wk, wv, wo,
    and with ``cfg.qk_norm`` the per-head q/k RMSNorm scales, which a
    cross-attention (``cross``) does without."""
    d, hd = cfg.d_model, cfg.hd
    spec = {"wq": ((d, cfg.n_heads * hd), ("embed", "q_heads"), "dense"),
            "wk": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), "dense"),
            "wv": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), "dense"),
            "wo": ((cfg.n_heads * hd, d), ("q_heads", "embed"), "dense")}
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ((hd,), (None,), "ones")
        spec["k_norm"] = ((hd,), (None,), "ones")
    return spec


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                  dtype, device) -> Dict[str, torch.Tensor]:
    W = min(max_len, window) if window > 0 else max_len
    shape = (batch, W, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_scores(q, k, scale: float) -> torch.Tensor:
    """q: (b, s, kv, g, hd); k: (b, S, kv, hd) -> (b, kv, g, s, S) scores
    in q's dtype, times ``scale``."""
    s = torch.einsum("bskgd,bSkd->bkgsS", q.double(), k.double())
    return s.float().to(q.dtype) * f32(scale)


def positions_mask(positions: torch.Tensor, s: int, kv_len: int,
                   causal: bool, window: int) -> torch.Tensor:
    """(1|b, s, kv_len) bool mask from per-row positions (1|b, >=s).
    Self-attention keys carry the queries' position values; cross keys
    are indices."""
    pos2 = positions if positions.ndim == 2 else positions.reshape(1, -1)
    q_pos = pos2[:, -s:]
    if kv_len == s:
        k_pos = q_pos[:, None, :]
    else:
        k_pos = torch.arange(kv_len, device=positions.device)[None, None, :]
    mask = torch.ones((q_pos.shape[0], s, kv_len), dtype=torch.bool,
                      device=positions.device)
    if causal:
        mask &= q_pos[:, :, None] >= k_pos
    if window > 0:
        mask &= (q_pos[:, :, None] - k_pos) < window
    return mask


def _direct_attention(q, k, v, mask, quant: QuantConfig, scale: float):
    """The masked softmax of the whole score matrix through the backend's
    softmax, then P.V.  mask broadcasts against (b, kv, g, s, S)."""
    sc = torch.where(mask, _gqa_scores(q, k, scale).to(torch.float32),
                     NEG_INF)
    p = L.softmax(sc, quant, axis=-1).to(q.dtype)
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bkgsS,bSkd->bskgd", p.double(), v.double())
    return o.float().to(q.dtype)


def _q_chunked_attention(q, k, v, *, causal: bool, window: int, chunk: int,
                         scale: float, positions: torch.Tensor):
    """Float attention over blocks of queries, each a full-width softmax.

    q: (b, s, kv, g, hd); k/v: (b, S, kv, hd); positions: (1|b, >=s) query
    positions (self-attention keys carry the same values).  As in the
    reference, the scores cross between steps in the model dtype, masked
    with its most negative finite value, and the products, the exp and the
    row sum come out in float32.  They are computed in float64 and rounded
    once to float32, so the result does not depend on the device's
    summation order or exp: any two devices round to the same float32
    unless the exact value lies within 2^-29 of a rounding boundary.
    """
    b, s, kv, g, hd = q.shape
    S = k.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"prefill length {s} is not a multiple of {chunk}")
    qs = (q * scale).to(q.dtype)
    kt = k.permute(0, 2, 3, 1)                        # (b, kv, hd, S)
    vt = v.permute(0, 2, 1, 3)                        # (b, kv, S, hd)
    q_pos = positions[:, -s:].to(torch.int64)         # (1|b, s)
    k_pos = q_pos if S == s else torch.arange(S, device=q.device)[None]
    neg = torch.finfo(q.dtype).min
    outs = []
    for c0 in range(0, s, chunk):
        qb = qs[:, c0:c0 + chunk]                     # (b, c, kv, g, hd)
        qp = q_pos[:, c0:c0 + chunk]
        s_blk = torch.einsum("bckgd,bkdS->bkgcS", qb.double(),
                             kt.double()).float().to(q.dtype)
        mask = torch.ones((qp.shape[0], qp.shape[1], S), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= qp[:, :, None] >= k_pos[:, None, :]
        if window > 0:
            mask &= (qp[:, :, None] - k_pos[:, None, :]) < window
        s_blk = torch.where(mask[:, None, None], s_blk, neg)
        m = s_blk.amax(dim=-1, keepdim=True)
        p = torch.exp((s_blk - m).double()).float()
        l = p.double().sum(dim=-1, keepdim=True).float()
        pb = (p / torch.clamp(l, min=1e-30)).to(q.dtype)
        o = torch.einsum("bkgcS,bkSd->bckgd", pb.double(), vt.double())
        outs.append(o.float().to(q.dtype))
    return torch.cat(outs, dim=1)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, quant: QuantConfig,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[torch.Tensor] = None,
              window: int = 0, causal: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              use_rope: bool = True, chunk: int = 1024,
              prenorm: Optional[Tuple] = None, scope: Optional[str] = None):
    """Returns (output (b, s, d), the cache or None).

      cache None         -> cache-less (scoring, the ViT encoder)
      cache, s > 1       -> prefill: writes positions 0..s-1 of every row
      cache, s == 1      -> decode at each row's ``cache_index``
      kv_override (k, v) -> cross-attention over the given (b, S, kv, hd)
                            K/V: only wq projects, no cache is read or
                            written, and RoPE (``use_rope``) touches q only

    The cache is updated in place (the reference returns a new one).
    prenorm: optional ('ln'|'rms', gamma, beta); x then arrives
    un-normalized and the q/k/v projections ride the backend's fused
    ``layernorm_linear`` composite when it has one.
    """
    quant = quant.scoped(scope)
    b, s, _ = x.shape
    hd = cfg.hd
    kvh = cfg.n_kv_heads
    g = cfg.n_heads // kvh
    scale = hd ** -0.5
    cross = kv_override is not None
    x, prenorm = L.prenorm_linears(
        x, prenorm, [p["wq"]] if cross else [p["wq"], p["wk"], p["wv"]],
        quant, cfg.norm_eps)

    def in_proj(w):
        if prenorm is None:
            return L.linear(x, w, q=quant)
        nk, ng, nb = prenorm
        return L.layernorm_linear(x, ng, nb, w, q=quant, eps=cfg.norm_eps,
                                  rms_only=(nk == "rms"))

    q = in_proj(p["wq"]).reshape(b, s, cfg.n_heads, hd)
    if cross:
        k, v = kv_override
    else:
        k = in_proj(p["wk"]).reshape(b, s, kvh, hd)
        v = in_proj(p["wv"]).reshape(b, s, kvh, hd)
    if cfg.qk_norm and "q_norm" in p:
        q = L.rmsnorm(q, p["q_norm"], q=quant, eps=cfg.norm_eps)
        if not cross:
            k = L.rmsnorm(k, p["k_norm"], q=quant, eps=cfg.norm_eps)

    if positions is None:
        base = 0
        if cache_index is not None:
            base = torch.as_tensor(cache_index, dtype=torch.int64,
                                   device=x.device)
            if base.ndim == 1:                        # per-row (b,) index
                base = base[:, None]
        positions = base + torch.arange(s, device=x.device)[None, :]
    if use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        if not cross:
            k = L.rope(k, positions, cfg.rope_theta)
    q = q.reshape(b, s, kvh, g, hd)

    if cache is not None and not cross:
        ck, cv = cache["k"], cache["v"]
        W = ck.shape[1]
        if s == 1:
            # each row writes its own slot and masks its own ring validity,
            # so a freshly prefilled row coexists with rows deep in decode
            idx = torch.as_tensor(cache_index, dtype=torch.int64,
                                  device=x.device)
            if idx.ndim == 0:
                idx = idx.expand(b)
            slot = idx % W if window > 0 else idx
            # a write past the ring's end is dropped, as the reference's
            # scatter drops it (an idle slot keeps decoding as padding)
            inside = (slot < W)[:, None, None]
            slot = slot.clamp(max=W - 1)
            rows = torch.arange(b, device=x.device)
            ck[rows, slot] = torch.where(inside, k[:, 0].to(ck.dtype),
                                         ck[rows, slot])
            cv[rows, slot] = torch.where(inside, v[:, 0].to(cv.dtype),
                                         cv[rows, slot])
            t = idx[:, None]                                  # (b, 1)
            pos = torch.arange(W, device=x.device)[None, :]   # (1, W)
            slot_pos = t - torch.remainder(t - pos, W) if window > 0 \
                else pos.expand(b, W)
            valid = (slot_pos >= 0) & (slot_pos <= t)
            if window > 0:
                valid &= (t - slot_pos) < window
            o = quant.datapath.attention_decode(q, ck, cv, valid, q=quant,
                                                scale=scale)
        else:
            if window > 0 and s >= W:
                # only the last W positions survive, on slots pos % W
                slots = torch.remainder(
                    torch.arange(s - W, s, device=x.device), W)
                ck[:, slots] = k[:, -W:].to(ck.dtype)
                cv[:, slots] = v[:, -W:].to(cv.dtype)
            else:
                ck[:, :s] = k.to(ck.dtype)
                cv[:, :s] = v.to(cv.dtype)
            o = _q_chunked_attention(q, k, v, causal=causal, window=window,
                                     chunk=chunk, scale=scale,
                                     positions=positions)
    else:
        o = quant.datapath.attention(q, k, v, q=quant, positions=positions,
                                     causal=causal, window=window,
                                     scale=scale, chunk=chunk)
    out = L.linear(o.reshape(b, s, cfg.n_heads * hd), p["wo"], q=quant)
    return out, cache
