"""The decoder-only LM: dense, mixture-of-experts and recurrent stacks.

The stack is ``cfg.unit`` repeated ``cfg.n_units`` times, then
``cfg.tail``; a layer is one of four block kinds, each pre-norm residual:

- "attn": RMSNorm fused into the q/k/v projections, GQA attention with
  RoPE (sliding-window with ``local_attn_window`` or ``window``);
- "rec": RMSNorm, the RG-LRU block (``models/recurrent.py``);
- "mlstm", "slstm": RMSNorm, the xLSTM block, which carries its own
  projections and no FFN.

"attn" and "rec" layers end in the FFN unless ``ffn_kind`` is "none":
RMSNorm fused into the gated FFN's input linears, or for
``ffn_kind="moe"`` an RMSNorm and the mixture-of-experts FFN
(``models/moe.py``), whose load-balancing loss is summed over the layers
and added to ``loss``.  A Python loop runs the layers over a per-layer
parameter list, in the reference's order (the unit repeats, then the
tail), and ``cfg.layer_kinds`` gives each one's kind (the reference scans
stacked parameters).  The cache holds each layer's KV ring or recurrent
state and a per-row ``index`` vector, so rows advance independently: a
new request can be prefilled into one row while the others keep
decoding.  A right-padded slot prefill runs the recurrent layers over
the pad tokens too, as the reference does, so their state is the state
after the padded length.

With ``QuantConfig(mode="kernel", quantize_nonlinear=True)`` every attn
layer of a decode step launches the decode attention kernel; a prefill's
attention stays plain float attention as in the reference, and a ``loss``
forward longer than 512 tokens runs the flash kernel in every attn layer.
The kernels each layer launches are derived in ``models/launches.py``,
which the CPU tests and ``chip_smoke.py`` hold the launch counters to.

A VLM config (``vision_tokens``) adds the ``vision_proj`` linear: its
projected embeddings overwrite the first positions of the token
embeddings in ``loss`` and ``prefill``.  ``EncDecLM`` is the encoder-
decoder: an encoder over frame embeddings (non-causal attention, GELU
FFN), then decoder layers with self-attention over a KV cache (a scalar
``index``), cross-attention over per-layer encoder K/V, and the GELU
FFN; its norms are separate RMSNorms, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mx_types import MXFormat
from repro_torch.core.quantize import pack_weight
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.model_api import ModelConfig, Param

KINDS = ("attn", "rec", "mlstm", "slstm")
_MIXER_SPEC = {"rec": R.rglru_param_spec, "mlstm": R.mlstm_param_spec,
               "slstm": R.slstm_param_spec}


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.ffn_kind not in ("swiglu", "geglu", "gelu", "moe", "none"):
            raise NotImplementedError(f"ffn kind {cfg.ffn_kind!r}")
        unknown = (set(cfg.unit) | set(cfg.tail)) - set(KINDS)
        if unknown:
            raise NotImplementedError(f"block kinds {sorted(unknown)}: the "
                                      f"decoder runs {KINDS}")
        self.cfg = cfg.validate()
        self.kinds = cfg.layer_kinds
        self.window = cfg.local_attn_window or cfg.window

    def layer_stacks(self) -> Dict[str, list]:
        """Per layer of ``layers``, the size of the reference's stack that
        holds its parameters: ``n_units`` for a unit layer, 1 for a tail
        layer.  ``pack_params_mxint``'s size rule counts it."""
        n = self.cfg.resolved_n_units
        return {"layers": [n] * (n * len(self.cfg.unit))
                + [1] * len(self.cfg.tail)}

    # -- params -------------------------------------------------------------
    def layer_spec(self, kind: str = "attn") -> Dict[str, Any]:
        """One layer's (shape, axes, init) leaves; init is "dense",
        "ones", "zeros", "small" (normal with scale 0.02), ("normal",
        scale), ("full", value) or ("linspace", lo, hi)."""
        cfg = self.cfg
        d = cfg.d_model
        spec = {"ln1": ((d,), ("embed",), "ones")}
        if kind != "attn":
            spec["mix"] = _MIXER_SPEC[kind](cfg)
            if kind != "rec":
                return spec               # xLSTM blocks: no FFN
        else:
            spec["mix"] = A.attn_param_spec(cfg)
        if cfg.ffn_kind == "none":
            return spec
        spec["ln2"] = ((d,), ("embed",), "ones")
        spec["ffn"] = (M.moe_param_spec(cfg) if cfg.ffn_kind == "moe"
                       else ffn_param_spec(cfg, cfg.ffn_kind))
        return spec

    def param_spec(self) -> Dict[str, Any]:
        """The whole tree: embed, final_norm, unembed (unless tied) and
        ``layers``, a list of ``layer_spec`` trees in layer order."""
        cfg = self.cfg
        spec = {"embed": ((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          "small"),
                "final_norm": ((cfg.d_model,), ("embed",), "ones")}
        if not cfg.tie_embeddings:
            spec["unembed"] = ((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                               "small")
        if cfg.vision_tokens:
            # no contraction axis name: the packing rule leaves it float,
            # and kernel mode packs it at each call, as the reference does
            spec["vision_proj"] = ((cfg.vision_dim, cfg.d_model),
                                   (None, "embed"), "dense")
        spec["layers"] = [self.layer_spec(k) for k in self.kinds]
        return spec

    def init(self, seed: int = 0, device="cuda",
             pack_fmt: Optional[MXFormat] = None) -> Dict[str, Any]:
        """Random parameters from ``seed`` (``init_params``)."""
        return init_params(self.param_spec(), self.layer_stacks(),
                           self.cfg.dtype, seed, device, pack_fmt)

    # -- cache ----------------------------------------------------------------
    def _layer_cache(self, kind, batch, max_len, device):
        cfg = self.cfg
        if kind == "attn":
            return A.init_kv_cache(cfg, batch, max_len, self.window,
                                   cfg.dtype, device)
        if kind == "rec":
            return R.rglru_state_init(cfg, batch, cfg.dtype, device)
        if kind == "mlstm":
            return R.mlstm_state_init(cfg, batch, device)
        return R.slstm_state_init(cfg, batch, device)

    def cache_init(self, batch: int, max_len: int, device="cuda"):
        """Per layer a (batch, W, kv_heads, hd) K/V ring ("attn") or the
        recurrent state ("rec": conv history and h in the model dtype;
        "mlstm": [C, n], "slstm": [h, c, n, m] in float32), and a per-row
        ``index`` (batch,): row i's next write position and its
        live-token count."""
        return {"layers": [self._layer_cache(k, batch, max_len, device)
                           for k in self.kinds],
                "index": torch.zeros(batch, dtype=torch.int32,
                                     device=device)}

    def cache_axes(self):
        """The cache tree with each leaf's logical axes ("batch" marks the
        row axis a slot prefill writes)."""
        axes = {"attn": {"k": A.CACHE_AXES, "v": A.CACHE_AXES},
                "rec": R.RGLRU_STATE_AXES, "mlstm": R.MLSTM_STATE_AXES,
                "slstm": R.SLSTM_STATE_AXES}
        return {"layers": [axes[k] for k in self.kinds],
                "index": ("batch",)}

    # -- forward ----------------------------------------------------------------
    def _mixer(self, kind, lp, x, *, positions, cache, cache_index):
        """The block's pre-norm and mixer: (output, its new state or
        None)."""
        cfg = self.cfg
        quant = cfg.quant
        if kind == "attn":
            o, _ = A.attention(
                lp["mix"], x, cfg, quant=quant, positions=positions,
                cache=cache, cache_index=cache_index, window=self.window,
                prenorm=("rms", lp["ln1"], None))
            return o, None
        h = L.rmsnorm(x, lp["ln1"], q=quant, eps=cfg.norm_eps)
        decode = positions is None
        if kind == "rec":
            return R.rglru_block(lp["mix"], h, cfg, quant=quant,
                                 state=cache, decode=decode)
        if kind == "mlstm":
            return R.mlstm_block(lp["mix"], h, cfg, quant=quant,
                                 state=cache, decode=decode)
        if decode:
            return R.slstm_step(lp["mix"], h, cfg, quant, cache)
        return R.slstm_scan(lp["mix"], h, cfg, quant, cache)

    def _layer(self, i, lp, x, *, positions, cache, cache_index, with_aux):
        """Layer ``i``: (x after it, its MoE load-balancing loss or None)."""
        cfg = self.cfg
        quant = cfg.quant
        kind = self.kinds[i]
        o, state = self._mixer(
            kind, lp, x, positions=positions,
            cache=None if cache is None else cache["layers"][i],
            cache_index=cache_index)
        if state is not None and cache is not None:
            cache["layers"][i] = state
        x = x + o
        if "ffn" not in lp:
            return x, None
        a = None
        if cfg.ffn_kind == "moe":
            h = L.rmsnorm(x, lp["ln2"], q=quant, eps=cfg.norm_eps)
            f, a = M.moe_ffn(h, lp["ffn"], cfg, quant=quant,
                             with_aux=with_aux)
        else:
            f = L.ffn(x, lp["ffn"], cfg.ffn_kind, quant,
                      prenorm=("rms", lp["ln2"], None), eps=cfg.norm_eps)
        return x + f, a if with_aux else None

    def _run_stack(self, params, x, *, positions, cache, cache_index,
                   with_aux=False):
        """Returns (x after the final norm, the cache, the layers' summed
        MoE load-balancing loss: a float32 scalar, 0 for a dense FFN, or
        None unless ``with_aux``).  ``positions`` None is a decode step.
        With ``remat`` "block" or "full", a cache-less forward that records
        gradients recomputes each unit in the backward pass (the reference
        checkpoints its unit scan on the training path only)."""
        cfg = self.cfg
        quant = cfg.quant
        aux = (torch.zeros((), dtype=torch.float32, device=x.device)
               if with_aux else None)
        kw = dict(positions=positions, cache=cache, cache_index=cache_index,
                  with_aux=with_aux)

        def run(first, last, x, aux):
            for i in range(first, last):
                x, a = self._layer(i, params["layers"][i], x, **kw)
                if a is not None:
                    aux = aux + a
            return x, aux

        width = len(cfg.unit)
        n_unit_layers = width * cfg.resolved_n_units
        remat = (cfg.checkpoints and cache is None
                 and torch.is_grad_enabled())
        for first in range(0, n_unit_layers, width):
            if remat:
                x, aux = checkpoint(run, first, first + width, x, aux,
                                    use_reentrant=False)
            else:
                x, aux = run(first, first + width, x, aux)
        x, aux = run(n_unit_layers, len(self.kinds), x, aux)
        x = L.rmsnorm(x, params["final_norm"], q=quant, eps=cfg.norm_eps)
        if cache is not None:
            cache["index"] = (cache_index + x.shape[1]).to(torch.int32)
        return x, cache, aux

    def _embed(self, params, tokens, vision_embeds=None):
        """Token embeddings; with a VLM config and ``vision_embeds`` (b, n,
        vision_dim), the projected embeddings replace positions 0..n-1."""
        cfg = self.cfg
        x = L.embed_lookup(tokens.long(), params["embed"], cfg.quant,
                           cfg.dtype)
        if not cfg.vision_tokens or vision_embeds is None:
            return x
        ve = torch.as_tensor(vision_embeds).to(device=x.device,
                                               dtype=cfg.dtype)
        v = L.linear(ve, params["vision_proj"], q=cfg.quant)
        return torch.cat([v.to(x.dtype), x[:, v.shape[1]:]], dim=1)

    def logits(self, params, x):
        cfg = self.cfg
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return L.unembed(x, table, cfg.quant)

    # -- entry points -----------------------------------------------------------
    def _forward(self, params, tokens, with_aux=False, vision_embeds=None):
        """(logits, the MoE load-balancing loss or None unless
        ``with_aux``) of a cache-less forward."""
        x = self._embed(params, tokens, vision_embeds)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        x, _, aux = self._run_stack(params, x, positions=positions,
                                    cache=None, cache_index=None,
                                    with_aux=with_aux)
        return self.logits(params, x), aux

    @torch.no_grad()
    def forward(self, params, tokens, vision_embeds=None) -> torch.Tensor:
        """Cache-less forward: (b, s) tokens -> (b, s, vocab) logits, each
        position attending causally to the positions up to it."""
        dev = params["final_norm"].value.device
        return self._forward(params, torch.as_tensor(tokens).to(dev),
                             vision_embeds=vision_embeds)[0]

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token negative log-likelihood of batch['tokens'] (b, s),
        weighted by an optional batch['loss_mask'] (b, s), plus the MoE
        load-balancing loss of every layer (0 for a dense FFN); a VLM reads
        batch['vision_embeds'] when given.  It carries a gradient to the
        float parameters that require one (training); callers that only
        score run it under ``torch.no_grad()``."""
        dev = params["final_norm"].value.device
        tokens = torch.as_tensor(batch["tokens"]).to(dev)
        logits, aux = self._forward(params, tokens, with_aux=True,
                                    vision_embeds=batch.get("vision_embeds"))
        logits = logits[:, :-1]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        mask = batch.get("loss_mask")
        mask = (torch.as_tensor(mask, dtype=torch.float32, device=dev)[:, 1:]
                if mask is not None else torch.ones_like(nll))
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0) + aux

    @torch.no_grad()
    def prefill(self, params, tokens, cache, vision_embeds=None,
                lengths=None):
        """Writes the prompts into the cache; returns (logits (b, 1, vocab),
        cache).  ``vision_embeds``: a VLM's (b, n, vision_dim) prefix
        embeddings.  ``lengths``: optional (b,) real lengths of
        right-padded prompts; row i's logits are taken at position
        lengths[i] - 1 and its ``cache['index']`` set to lengths[i], so
        the pad slots are masked by the decode validity."""
        b, s = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens, vision_embeds)
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


class EncDecLM:
    """The encoder-decoder (SeamlessM4T-style) with a stubbed modality
    frontend: the encoder reads precomputed frame embeddings (b, S,
    d_model).  Parameters: ``embed``, ``enc_blocks`` (a list of
    ``n_encoder_layers`` trees: ln1, mix, ln2, ffn), ``enc_norm``,
    ``dec_blocks`` (a list of ``n_layers`` trees: ln1, self_attn, ln_x,
    cross_attn, ln2, ffn), ``final_norm`` and ``unembed``.  The cache
    holds each decoder layer's K/V ring under ``self``, a scalar
    ``index`` shared by the rows and, after ``prefill``, the per-layer
    cross K/V under ``enc_kv``.  The reference serves it through
    ``ServingEngine.generate`` only; it has no slot prefill."""

    def __init__(self, cfg: ModelConfig):
        if cfg.unit != ("attn",) or cfg.tail:
            raise NotImplementedError("the encoder-decoder runs attn layers")
        self.cfg = cfg.validate()
        self.window = cfg.local_attn_window or cfg.window

    def layer_stacks(self) -> Dict[str, list]:
        """Each block list's stack sizes for ``pack_params_mxint``: the
        reference stacks the encoder's and the decoder's blocks apart."""
        ne, nd = self.cfg.n_encoder_layers, self.cfg.n_layers
        return {"enc_blocks": [ne] * ne, "dec_blocks": [nd] * nd}

    # -- params -------------------------------------------------------------
    def enc_layer_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": ((d,), ("embed",), "ones"),
                "mix": A.attn_param_spec(cfg),
                "ln2": ((d,), ("embed",), "ones"),
                "ffn": ffn_param_spec(cfg, "gelu")}

    def dec_layer_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        return {"ln1": ((d,), ("embed",), "ones"),
                "self_attn": A.attn_param_spec(cfg),
                "ln_x": ((d,), ("embed",), "ones"),
                "cross_attn": A.attn_param_spec(cfg, cross=True),
                "ln2": ((d,), ("embed",), "ones"),
                "ffn": ffn_param_spec(cfg, "gelu")}

    def param_spec(self) -> Dict[str, Any]:
        cfg = self.cfg
        table = ((cfg.vocab, cfg.d_model), ("vocab", "embed"), "small")
        norm = ((cfg.d_model,), ("embed",), "ones")
        return {"embed": table,
                "enc_blocks": [self.enc_layer_spec()
                               for _ in range(cfg.n_encoder_layers)],
                "enc_norm": norm,
                "dec_blocks": [self.dec_layer_spec()
                               for _ in range(cfg.n_layers)],
                "final_norm": norm,
                "unembed": table}

    def init(self, seed: int = 0, device="cuda",
             pack_fmt: Optional[MXFormat] = None) -> Dict[str, Any]:
        """Random parameters from ``seed`` (``init_params``)."""
        return init_params(self.param_spec(), self.layer_stacks(),
                           self.cfg.dtype, seed, device, pack_fmt)

    # -- cache --------------------------------------------------------------
    def cache_init(self, batch: int, max_len: int, device="cuda"):
        """A (batch, W, kv_heads, hd) K/V ring per decoder layer under
        ``self`` and a scalar ``index``: every row is at the same
        position."""
        cfg = self.cfg
        return {"self": [A.init_kv_cache(cfg, batch, max_len, self.window,
                                         cfg.dtype, device)
                         for _ in range(cfg.n_layers)],
                "index": torch.zeros((), dtype=torch.int32, device=device)}

    # -- forward --------------------------------------------------------------
    def encode(self, params, frames) -> torch.Tensor:
        """(b, S, d_model) frame embeddings -> the encoder's output: per
        layer RMSNorm, non-causal self-attention with RoPE, RMSNorm and
        the GELU FFN, each residual; then ``enc_norm``."""
        cfg = self.cfg
        quant = cfg.quant
        dev = params["enc_norm"].value.device
        x = torch.as_tensor(frames).to(device=dev, dtype=cfg.dtype)
        positions = torch.arange(x.shape[1], device=dev)[None, :]
        for bp in params["enc_blocks"]:
            h = L.rmsnorm(x, bp["ln1"], q=quant, eps=cfg.norm_eps)
            o, _ = A.attention(bp["mix"], h, cfg, quant=quant,
                               positions=positions, causal=False)
            x = x + o
            h = L.rmsnorm(x, bp["ln2"], q=quant, eps=cfg.norm_eps)
            x = x + L.ffn(h, bp["ffn"], "gelu", quant)
        return L.rmsnorm(x, params["enc_norm"], q=quant, eps=cfg.norm_eps)

    def encode_kv(self, params, memory) -> list:
        """The encoder output's cross K and V of every decoder layer: a
        list of ((b, S, kv_heads, hd), (b, S, kv_heads, hd)) pairs (the
        reference stacks them on a leading layer axis)."""
        cfg = self.cfg
        shape = (*memory.shape[:2], cfg.n_kv_heads, cfg.hd)
        return [(L.linear(memory, bp["cross_attn"]["wk"],
                          q=cfg.quant).reshape(shape),
                 L.linear(memory, bp["cross_attn"]["wv"],
                          q=cfg.quant).reshape(shape))
                for bp in params["dec_blocks"]]

    def _dec_stack(self, params, x, enc_kv, *, cache, cache_index,
                   decode=False):
        """The decoder layers and the final norm; ``cache`` None is a
        cache-less forward, else a prefill from position 0 or (``decode``)
        a step at the scalar ``cache_index``."""
        cfg = self.cfg
        quant = cfg.quant
        positions = None if decode else \
            torch.arange(x.shape[1], device=x.device)[None, :]
        for i, bp in enumerate(params["dec_blocks"]):
            h = L.rmsnorm(x, bp["ln1"], q=quant, eps=cfg.norm_eps)
            o, _ = A.attention(
                bp["self_attn"], h, cfg, quant=quant, positions=positions,
                cache=None if cache is None else cache["self"][i],
                cache_index=cache_index, window=self.window)
            x = x + o
            h = L.rmsnorm(x, bp["ln_x"], q=quant, eps=cfg.norm_eps)
            o, _ = A.attention(bp["cross_attn"], h, cfg, quant=quant,
                               kv_override=enc_kv[i], causal=False,
                               use_rope=False)
            x = x + o
            h = L.rmsnorm(x, bp["ln2"], q=quant, eps=cfg.norm_eps)
            x = x + L.ffn(h, bp["ffn"], "gelu", quant)
        return L.rmsnorm(x, params["final_norm"], q=quant, eps=cfg.norm_eps)

    def _embed(self, params, tokens):
        dev = params["final_norm"].value.device
        return L.embed_lookup(torch.as_tensor(tokens).to(dev).long(),
                              params["embed"], self.cfg.quant, self.cfg.dtype)

    def logits(self, params, x):
        return L.unembed(x, params["unembed"], self.cfg.quant)

    # -- entry points -----------------------------------------------------------
    def _hidden(self, params, frames, tokens) -> torch.Tensor:
        """The decoder's output after the final norm, cache-less."""
        memory = self.encode(params, frames)
        x = self._embed(params, tokens)
        return self._dec_stack(params, x, self.encode_kv(params, memory),
                               cache=None, cache_index=None)

    @torch.no_grad()
    def forward(self, params, frames, tokens) -> torch.Tensor:
        """Cache-less forward: (b, S, d_model) frames and (b, s) tokens ->
        (b, s, vocab) logits, each token attending causally to the tokens
        up to it and to every frame."""
        return self.logits(params, self._hidden(params, frames, tokens))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token negative log-likelihood of batch['tokens'] (b, s)
        given batch['frames'] (b, S, d_model), with no mask (the
        reference's).  Differentiable, as ``DecoderLM.loss`` is."""
        x = self._hidden(params, batch["frames"], batch["tokens"])
        logits = self.logits(params, x[:, :-1])
        tokens = torch.as_tensor(batch["tokens"]).to(logits.device)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean()

    @torch.no_grad()
    def prefill(self, params, frames, tokens, cache):
        """Encodes ``frames``, writes the prompts ``tokens`` (b, s) into the
        cache; returns (logits (b, 1, vocab), the cache with ``enc_kv``
        and ``index`` s)."""
        memory = self.encode(params, frames)
        enc_kv = self.encode_kv(params, memory)
        x = self._embed(params, tokens)
        x = self._dec_stack(params, x, enc_kv, cache=cache,
                            cache_index=torch.zeros((), dtype=torch.int32,
                                                    device=x.device))
        return self.logits(params, x[:, -1:]), {
            "self": cache["self"], "enc_kv": enc_kv,
            "index": (cache["index"] + x.shape[1]).to(torch.int32)}

    @torch.no_grad()
    def decode_step(self, params, token, cache):
        """token: (b, 1).  One step at the cache's scalar ``index``."""
        x = self._embed(params, token)
        x = self._dec_stack(params, x, cache["enc_kv"], cache=cache,
                            cache_index=cache["index"], decode=True)
        return self.logits(params, x), {
            "self": cache["self"], "enc_kv": cache["enc_kv"],
            "index": (cache["index"] + 1).to(torch.int32)}


def ffn_param_spec(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    """A dense FFN's leaves: wi and wo, and wg for the gated kinds."""
    d = cfg.d_model
    ffn = {"wi": ((d, cfg.d_ff), ("embed", "mlp"), "dense"),
           "wo": ((cfg.d_ff, d), ("mlp", "embed"), "dense")}
    if kind != "gelu":
        ffn["wg"] = ((d, cfg.d_ff), ("embed", "mlp"), "dense")
    return ffn


def init_params(spec, stacks: Dict[str, list], dtype, seed: int = 0,
                device="cuda", pack_fmt: Optional[MXFormat] = None):
    """Random parameters of a ``param_spec`` tree from ``seed``.  Each
    tensor is drawn from its own ``torch.Generator`` on ``device`` (seeded
    from ``seed`` and the tensor's rank in the tree) and, with
    ``pack_fmt``, packed to MXInt planes there before the next is drawn,
    with the packing rules of ``serving.engine.pack_params_mxint``
    (``stacks``: a list's stack sizes by its key, as ``layer_stacks``
    gives them).  So a full-size model never exists in float, on the
    device or on the host.  The values depend on the device's generator."""
    from repro_torch.serving.engine import contraction_axis, should_pack
    device = torch.device(device)
    counter = [0]

    def make(spec, stack, key):
        if isinstance(spec, dict):
            return {k: make(v, stack, k) for k, v in spec.items()}
        if isinstance(spec, list):
            sizes = stacks.get(key) or [len(spec)] * len(spec)
            return [make(v, n, key) for v, n in zip(spec, sizes)]
        shape, axes, kind = spec
        counter[0] += 1
        if kind in ("ones", "zeros") or kind[0] in ("full", "linspace"):
            return Param(_constant(kind, shape, device).to(dtype), axes)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + counter[0])
        scale = {"small": 0.02, "dense": shape[-2] ** -0.5}.get(kind)
        if scale is None:
            scale = kind[1]                      # ("normal", scale)
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device).mul_(scale).to(dtype)
        p = Param(v, axes)
        if pack_fmt is not None and should_pack(p, stack):
            p = Param(pack_weight(v.to(torch.float32), pack_fmt,
                                  axis=contraction_axis(p)), axes)
        return p

    return make(spec, 1, None)


def _constant(kind, shape, device) -> torch.Tensor:
    """The float32 values of a constant init: "ones", "zeros", ("full",
    value) or ("linspace", lo, hi) over the last axis."""
    if kind == "ones":
        return torch.ones(shape, device=device)
    if kind == "zeros":
        return torch.zeros(shape, device=device)
    if kind[0] == "full":
        return torch.full(shape, float(kind[1]), device=device)
    return torch.linspace(kind[1], kind[2], shape[-1],
                          device=device).expand(shape).contiguous()
