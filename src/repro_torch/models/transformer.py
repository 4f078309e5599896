"""The decoder-only LM for ``("attn",)`` stacks (Llama-3, Mixtral and kin).

Pre-norm residual blocks: RMSNorm fused into the q/k/v projections, GQA
attention with RoPE, then the FFN: RMSNorm fused into the gated FFN's
input linears, or for ``ffn_kind="moe"`` an RMSNorm and the
mixture-of-experts FFN (``models/moe.py``), whose load-balancing loss is
summed over the layers and added to ``loss``.  A Python loop runs the
layers over a per-layer parameter list (the reference scans stacked
parameters).  The KV cache carries a per-row ``index`` vector, so rows
advance independently: a new request can be prefilled into one row while
the others keep decoding.

With ``QuantConfig(mode="kernel", quantize_nonlinear=True)`` every layer
of a decode step launches the decode attention kernel; a prefill's
attention stays plain float attention as in the reference, and a ``loss``
forward longer than 512 tokens runs the flash kernel in every layer.  The
kernels each layer launches are counted in
``tests/test_torch_lm.py::test_kernel_launch_structure`` and in
``chip_smoke.py``'s ``lm_per_call``.  Recurrent blocks and the
encoder-decoder are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.mx_types import MXFormat
from repro_torch.core.quantize import pack_weight
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model_api import ModelConfig, Param


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if tuple(cfg.unit) != ("attn",):
            raise NotImplementedError(
                f"unit {cfg.unit}: the port's decoder runs ('attn',) stacks; "
                f"recurrent blocks are queued in ROADMAP.md")
        if cfg.ffn_kind not in ("swiglu", "geglu", "gelu", "moe"):
            raise NotImplementedError(f"ffn kind {cfg.ffn_kind!r}")
        self.cfg = cfg.validate()
        self.window = cfg.local_attn_window or cfg.window

    # -- params -------------------------------------------------------------
    def layer_spec(self) -> Dict[str, Any]:
        """One layer's (shape, axes, init) leaves; init is "dense",
        "ones" or "small" (normal with scale 0.02)."""
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.hd
        if cfg.ffn_kind == "moe":
            ffn = M.moe_param_spec(cfg)
        else:
            ffn = {"wi": ((d, cfg.d_ff), ("embed", "mlp"), "dense"),
                   "wo": ((cfg.d_ff, d), ("mlp", "embed"), "dense")}
            if cfg.ffn_kind != "gelu":
                ffn["wg"] = ((d, cfg.d_ff), ("embed", "mlp"), "dense")
        mix = {
            "wq": ((d, cfg.n_heads * hd), ("embed", "q_heads"), "dense"),
            "wk": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), "dense"),
            "wv": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads"), "dense"),
            "wo": ((cfg.n_heads * hd, d), ("q_heads", "embed"), "dense"),
        }
        if cfg.qk_norm:
            mix["q_norm"] = ((hd,), (None,), "ones")
            mix["k_norm"] = ((hd,), (None,), "ones")
        return {"ln1": ((d,), ("embed",), "ones"), "mix": mix,
                "ln2": ((d,), ("embed",), "ones"), "ffn": ffn}

    def param_spec(self) -> Dict[str, Any]:
        """The whole tree: embed, final_norm, unembed (unless tied) and
        ``layers``, a list of ``layer_spec`` trees."""
        cfg = self.cfg
        spec = {"embed": ((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          "small"),
                "final_norm": ((cfg.d_model,), ("embed",), "ones")}
        if not cfg.tie_embeddings:
            spec["unembed"] = ((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                               "small")
        spec["layers"] = [self.layer_spec() for _ in range(cfg.n_layers)]
        return spec

    def init(self, seed: int = 0, device="cuda",
             pack_fmt: Optional[MXFormat] = None) -> Dict[str, Any]:
        """Random parameters from ``seed``.  Each tensor is drawn from its
        own ``torch.Generator`` on ``device`` (seeded from ``seed`` and the
        tensor's rank in the tree) and, with ``pack_fmt``, packed to MXInt
        planes there before the next is drawn, with the packing rules of
        ``serving.engine.pack_params_mxint``.  So a full-size model never
        exists in float, on the device or on the host.  The values depend
        on the device's generator."""
        from repro_torch.serving.engine import contraction_axis, should_pack
        cfg = self.cfg
        device = torch.device(device)
        counter = [0]

        def make(spec, stack):
            if isinstance(spec, dict):
                return {k: make(v, stack) for k, v in spec.items()}
            if isinstance(spec, list):
                return [make(v, len(spec)) for v in spec]
            shape, axes, kind = spec
            counter[0] += 1
            if kind == "ones":
                return Param(torch.ones(shape, dtype=cfg.dtype,
                                        device=device), axes)
            gen = torch.Generator(device=device)
            gen.manual_seed(seed * 1_000_003 + counter[0])
            scale = 0.02 if kind == "small" else shape[-2] ** -0.5
            v = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device).mul_(scale).to(cfg.dtype)
            p = Param(v, axes)
            if pack_fmt is not None and should_pack(p, stack):
                p = Param(pack_weight(v.to(torch.float32), pack_fmt,
                                      axis=contraction_axis(p)), axes)
            return p

        return make(self.param_spec(), 1)

    # -- cache ----------------------------------------------------------------
    def cache_init(self, batch: int, max_len: int, device="cuda"):
        """Per-layer (batch, W, kv_heads, hd) rings and a per-row ``index``
        (batch,): row i's next write position and its live-token count."""
        cfg = self.cfg
        return {"layers": [A.init_kv_cache(cfg, batch, max_len, self.window,
                                           cfg.dtype, device)
                           for _ in range(cfg.n_layers)],
                "index": torch.zeros(batch, dtype=torch.int32,
                                     device=device)}

    def cache_axes(self):
        """The cache tree with each leaf's logical axes ("batch" marks the
        row axis a slot prefill writes)."""
        return {"layers": [{"k": A.CACHE_AXES, "v": A.CACHE_AXES}
                           for _ in range(self.cfg.n_layers)],
                "index": ("batch",)}

    # -- forward ----------------------------------------------------------------
    def _run_stack(self, params, x, *, positions, cache, cache_index,
                   with_aux=False):
        """Returns (x after the final norm, the cache, the layers' summed
        MoE load-balancing loss: a float32 scalar, 0 for a dense FFN, or
        None unless ``with_aux``)."""
        cfg = self.cfg
        quant = cfg.quant
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if with_aux else None)
        for i, lp in enumerate(params["layers"]):
            o, _ = A.attention(
                lp["mix"], x, cfg, quant=quant, positions=positions,
                cache=None if cache is None else cache["layers"][i],
                cache_index=cache_index, window=self.window,
                prenorm=("rms", lp["ln1"], None))
            x = x + o
            if cfg.ffn_kind == "moe":
                h = L.rmsnorm(x, lp["ln2"], q=quant, eps=cfg.norm_eps)
                f, a = M.moe_ffn(h, lp["ffn"], cfg, quant=quant,
                                 with_aux=with_aux)
                if with_aux:
                    aux = aux + a
            else:
                f = L.ffn(x, lp["ffn"], cfg.ffn_kind, quant,
                          prenorm=("rms", lp["ln2"], None), eps=cfg.norm_eps)
            x = x + f
        x = L.rmsnorm(x, params["final_norm"], q=quant, eps=cfg.norm_eps)
        if cache is not None:
            cache["index"] = (cache_index + x.shape[1]).to(torch.int32)
        return x, cache, aux

    def _embed(self, params, tokens):
        return L.embed_lookup(tokens.long(), params["embed"], self.cfg.quant,
                              self.cfg.dtype)

    def logits(self, params, x):
        cfg = self.cfg
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return L.unembed(x, table, cfg.quant)

    # -- entry points -----------------------------------------------------------
    def _forward(self, params, tokens, with_aux=False):
        """(logits, the MoE load-balancing loss or None unless
        ``with_aux``) of a cache-less forward."""
        x = self._embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        x, _, aux = self._run_stack(params, x, positions=positions,
                                    cache=None, cache_index=None,
                                    with_aux=with_aux)
        return self.logits(params, x), aux

    @torch.no_grad()
    def forward(self, params, tokens) -> torch.Tensor:
        """Cache-less forward: (b, s) tokens -> (b, s, vocab) logits, each
        position attending causally to the positions up to it."""
        dev = params["final_norm"].value.device
        return self._forward(params, torch.as_tensor(tokens).to(dev))[0]

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token negative log-likelihood of batch['tokens'] (b, s),
        weighted by an optional batch['loss_mask'] (b, s), plus the MoE
        load-balancing loss of every layer (0 for a dense FFN).  It carries
        a gradient to the float parameters that require one (training);
        callers that only score run it under ``torch.no_grad()``."""
        dev = params["final_norm"].value.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        logits, aux = self._forward(params, tokens, with_aux=True)
        logits = logits[:, :-1]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        mask = batch.get("loss_mask")
        mask = (torch.as_tensor(mask, dtype=torch.float32, device=dev)[:, 1:]
                if mask is not None else torch.ones_like(nll))
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0) + aux

    @torch.no_grad()
    def prefill(self, params, tokens, cache, lengths=None):
        """Writes the prompts into the cache; returns (logits (b, 1, vocab),
        cache).  ``lengths``: optional (b,) real lengths of right-padded
        prompts; row i's logits are taken at position lengths[i] - 1 and
        its ``cache['index']`` set to lengths[i], so the pad slots are
        masked by the decode validity."""
        b, s = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=dev)[None, :]
        x, cache, _ = self._run_stack(
            params, x, positions=positions, cache=cache,
            cache_index=torch.zeros(b, dtype=torch.int32, device=dev))
        if lengths is None:
            return self.logits(params, x[:, -1:]), cache
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
        cache["index"] = lengths.to(torch.int32)
        last = torch.gather(x, 1, (lengths - 1)[:, None, None].expand(
            b, 1, x.shape[-1]))
        return self.logits(params, last), cache

    @torch.no_grad()
    def decode_step(self, params, token, cache):
        """token: (b, 1).  One step; row i reads and writes its cache at its
        own ``cache['index'][i]``."""
        x = self._embed(params, token)
        x, cache, _ = self._run_stack(params, x, positions=None,
                                      cache=cache,
                                      cache_index=cache["index"])
        return self.logits(params, x), cache

