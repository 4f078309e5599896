"""ViT / DeiT, the paper's own model family (§IV: DeiT Tiny/Small/Base).

Patchify is an exact reshape plus a linear (the stride-16 convolution with
channel-major features, so shared exponents align with channels); class
token and learned position embeddings; pre-LayerNorm encoder blocks with
GELU MLPs; a classification head on the CLS token; ``loss`` and
``accuracy`` over ``{"images", "labels"}`` batches.

Every operator routes through the layer primitives, so with
``QuantConfig(mode="kernel", quantize_nonlinear=True)`` a forward launches
3 + 8 * n_layers kernels: the patch linear; per block the fused LN1 into
q, k and v, the softmax, the attention out-projection, the fused LN2 into
``wi``, the GELU and the FFN ``wo``; the final LayerNorm; the head.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quantize import MXTensor
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.model_api import (ModelConfig, Param, dense_init,
                                          ones_init, zeros_init)


class ViT:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        assert cfg.image_size % cfg.patch_size == 0
        self.n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.seq = self.n_patches + 1                     # + CLS

    # -- params -------------------------------------------------------------
    def param_spec(self) -> Dict[str, Any]:
        """Nested dict of (shape, axes, init) leaves, blocks stacked on a
        leading "layers" axis; init is "dense", "small" (scale 0.02),
        "zeros" or "ones"."""
        cfg = self.cfg
        d, hd, n = cfg.d_model, cfg.hd, cfg.n_layers
        patch_dim = cfg.patch_size * cfg.patch_size * 3

        def blk(shape, axes, init):
            return ((n,) + shape, ("layers",) + axes, init)

        return {
            "patch_proj": ((patch_dim, d), ("patch", "embed"), "dense"),
            "patch_bias": ((d,), ("embed",), "zeros"),
            "cls_token": ((1, 1, d), (None, None, "embed"), "small"),
            "pos_embed": ((self.seq, d), (None, "embed"), "small"),
            "blocks": {
                "ln1_g": blk((d,), ("embed",), "ones"),
                "ln1_b": blk((d,), ("embed",), "zeros"),
                "attn": {
                    "wq": blk((d, cfg.n_heads * hd), ("embed", "q_heads"),
                              "dense"),
                    "wk": blk((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                              "dense"),
                    "wv": blk((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"),
                              "dense"),
                    "wo": blk((cfg.n_heads * hd, d), ("q_heads", "embed"),
                              "dense"),
                },
                "ln2_g": blk((d,), ("embed",), "ones"),
                "ln2_b": blk((d,), ("embed",), "zeros"),
                "ffn": {
                    "wi": blk((d, cfg.d_ff), ("embed", "mlp"), "dense"),
                    "bi": blk((cfg.d_ff,), ("mlp",), "zeros"),
                    "wo": blk((cfg.d_ff, d), ("mlp", "embed"), "dense"),
                    "bo": blk((d,), ("embed",), "zeros"),
                },
            },
            "final_ln_g": ((d,), ("embed",), "ones"),
            "final_ln_b": ((d,), ("embed",), "zeros"),
            "head": ((d, cfg.n_classes), ("embed", "classes"), "dense"),
            "head_b": ((cfg.n_classes,), ("classes",), "zeros"),
        }

    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random parameters from ``seed`` (a ``torch.Generator`` on the
        CPU, so every device gets the same values)."""
        gen = torch.Generator().manual_seed(seed)
        dtype = self.cfg.dtype

        def make(spec):
            if isinstance(spec, dict):
                return {k: make(v) for k, v in spec.items()}
            shape, axes, kind = spec
            if kind == "zeros":
                return zeros_init(shape, axes, dtype, device)
            if kind == "ones":
                return ones_init(shape, axes, dtype, device)
            return dense_init(gen, shape, axes,
                              scale=0.02 if kind == "small" else None,
                              dtype=dtype, device=device)

        return make(self.param_spec())

    # -- forward --------------------------------------------------------------
    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) -> (b, n_patches, patch_dim), channel-major features
        (c slowest): the exact reshape of the reference, not a convolution."""
        b, h, w, c = images.shape
        p = self.cfg.patch_size
        x = images.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, (h // p) * (w // p), c * p * p)

    def features(self, params, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        quant = cfg.quant
        x = self.patchify(images.to(cfg.dtype))
        x = L.linear(x, params["patch_proj"], params["patch_bias"], q=quant,
                     scope="patch")
        cls = params["cls_token"].value.to(x.dtype).expand(
            x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = x + params["pos_embed"].value.to(x.dtype)[None]

        def block(x, i):
            bp = layer_params(params["blocks"], i)
            o, _ = A.attention(bp["attn"], x, cfg, quant=quant,
                               causal=False, use_rope=False,
                               prenorm=("ln", bp["ln1_g"], bp["ln1_b"]),
                               scope=f"block/{i}/attn")
            x = x + o
            return x + L.ffn(x, bp["ffn"], "gelu", quant,
                             prenorm=("ln", bp["ln2_g"], bp["ln2_b"]),
                             eps=cfg.norm_eps, scope=f"block/{i}/ffn")

        # remat "block"/"full": each block recomputed in the backward pass
        remat = cfg.checkpoints and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            x = (checkpoint(block, x, i, use_reentrant=False) if remat
                 else block(x, i))
        return L.layernorm(x, params["final_ln_g"], params["final_ln_b"],
                           q=quant, eps=cfg.norm_eps, scope="final_ln")

    def logits(self, params, images: torch.Tensor) -> torch.Tensor:
        """(b, H, W, 3) NHWC images -> (b, n_classes) logits."""
        x = self.features(params, images)
        pooled = x[:, 0] if self.cfg.pool == "cls" else x.mean(1)
        return L.linear(pooled, params["head"], params["head_b"],
                        q=self.cfg.quant, scope="head")

    def _batch(self, params, batch):
        dev = params["head_b"].value.device
        return (torch.as_tensor(batch["images"]).to(dev),
                torch.as_tensor(batch["labels"]).to(dev))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean negative log-likelihood of batch['labels'] (b,) under the
        float32 log-softmax of the logits of batch['images'] (b, H, W, 3).
        Differentiable in the modes that train ("off", "fake", "sim")."""
        images, labels = self._batch(params, batch)
        logits = self.logits(params, images).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
        return nll.mean()

    def accuracy(self, params, batch) -> torch.Tensor:
        """Share of the batch whose logits' argmax (the first of equal
        maxima) is its label, a float32 scalar."""
        images, labels = self._batch(params, batch)
        logits = self.logits(params, images)
        return (logits.argmax(-1) == labels.long()).to(torch.float32).mean()


def layer_params(blocks, i: int):
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    v = blocks.value
    v = v.layer(i) if isinstance(v, MXTensor) else v[i]
    return Param(v, blocks.axes[1:])
