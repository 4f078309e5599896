"""Input and cache stand-ins for every (arch x shape) dry-run cell.

Counterpart of ``repro.launch.specs``.  Every tensor here lives on the
``meta`` device unless a caller names another: it carries a shape and a
dtype and allocates nothing.  For each input the logical sharding axes
come beside it:

  train   -- {"tokens": (B, S) int32}, plus a VLM's ``vision_embeds``
             (B, vision_tokens, vision_dim) and an encoder-decoder's
             ``frames`` (B, S, d_model) in the model dtype;
  prefill -- the same layout at the prefill batch and length;
  decode  -- {"tokens": (B, 1) int32} and the cache filled to S, which
             for an encoder-decoder also holds the cross K/V of an
             S-frame prompt (``enc_kv``).

The port keeps per-layer lists where the reference stacks leaves on a
leading "layers" axis, so a per-layer leaf's axes are its stacked
counterpart's without that entry (``ShardingRules.layers`` is None).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.attention import CACHE_AXES
from repro_torch.models.model_api import ModelConfig, ShapeConfig

# the cross K/V of an encoder-decoder decode cell, per decoder layer
CROSS_KV_AXES = ("batch", "kv_seq", "kv_heads", None)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str,
                device="meta") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the step's input batch, its logical axes)."""
    B, S = shape.global_batch, shape.seq_len
    if kind == "decode":
        return ({"tokens": torch.empty((B, 1), dtype=torch.int32,
                                       device=device)},
                {"tokens": ("batch", None)})
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device=device)}
    axes = {"tokens": ("batch", None)}
    if cfg.vision_tokens:
        specs["vision_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.vision_dim), dtype=cfg.dtype,
            device=device)
        axes["vision_embeds"] = ("batch", None, None)
    if cfg.is_encoder_decoder:
        specs["frames"] = torch.empty((B, S, cfg.d_model), dtype=cfg.dtype,
                                      device=device)
        axes["frames"] = ("batch", "seq", None)
    return specs, axes


def decode_cache_specs(model, shape: ShapeConfig, device="meta"):
    """The cache of a decode cell, filled to ``seq_len``: the model's own
    ``cache_init`` and, for an encoder-decoder, the cross K/V of every
    decoder layer from an S-frame prompt under ``enc_kv``."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    cache = model.cache_init(B, S, device=device)
    if cfg.is_encoder_decoder:
        kv_shape = (B, S, cfg.n_kv_heads, cfg.hd)
        cache = dict(cache)
        cache["enc_kv"] = [
            (torch.empty(kv_shape, dtype=cfg.dtype, device=device),
             torch.empty(kv_shape, dtype=cfg.dtype, device=device))
            for _ in range(cfg.n_layers)]
    return cache


def decode_cache_axes(model):
    """The logical axes of ``decode_cache_specs``'s tree."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        n = cfg.n_layers
        return {"self": [{"k": CACHE_AXES, "v": CACHE_AXES}
                         for _ in range(n)],
                "index": (),
                "enc_kv": [(CROSS_KV_AXES, CROSS_KV_AXES)
                           for _ in range(n)]}
    return model.cache_axes()
