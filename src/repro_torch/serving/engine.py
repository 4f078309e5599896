"""Serving: packed-MXInt weights, the token engine and the ViT engine.

``pack_params_mxint`` turns large matmul weights into ``MXTensor`` planes
(int8 mantissas plus int8 shared exponents), the paper's weight format,
with the reference's packing rules.  ``ServingEngine`` serves a decoder LM:
prefill, slot prefill (one request into one row of a live cache, which
the per-row ``cache['index']`` makes sound) and batched decode steps.
``ViTServingEngine`` serves a classifier in fixed-size batches.  Both run
on one device, eagerly, so there is no compile cache to watch.  Both
record the reference's ``serving/*`` telemetry; their spans are given the
engine's device, so on the card they time the device's work (CUDA events,
a sync at the span's end).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.core.mx_types import MXINT6_WEIGHT, MXFormat
from repro_torch.core.quantize import MXTensor, pack_weight
from repro_torch.models.model_api import Param, tree_map


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.

    max_len: KV-cache capacity (token engines only).
    batch: the fixed batch shape; requests are padded or packed to it.
    pack_weights / weight_fmt: pack large matmul weights to MXInt planes.
    temperature: 0 is greedy decoding; above 0 each decode step samples
      from softmax(logits / temperature) with the engine's seeded
      generator (a prompt's first token stays greedy, as in the
      reference).
    """
    max_len: int = 4096
    batch: int = 8
    pack_weights: bool = False
    weight_fmt: MXFormat = None
    temperature: float = 0.0

    def __post_init__(self):
        if self.pack_weights and self.weight_fmt is None:
            object.__setattr__(self, "weight_fmt", MXINT6_WEIGHT)


_PACK_MIN_SIZE = 1 << 14       # don't pack tiny tensors (norm scales, biases)


def contraction_axis(p: Param) -> int:
    """Blocks run along the reduction dim of the consuming matmul: axis 1
    of expert stacks, the last axis of vocab/class tables (rows are looked
    up whole; the unembedding contracts d), else the second-to-last axis
    (axis 1 of a layer-stacked (L, d_in, d_out))."""
    axes = p.axes
    if axes and axes[0] == "expert":
        return 1
    if axes and axes[0] in ("vocab", "classes"):
        return len(axes) - 1
    return max(len(axes) - 2, 0)


def should_pack(p: Param, stack: int = 1) -> bool:
    """The reference's packing rule.  ``stack``: the number of layers the
    leaf is one of when the tree keeps one leaf per layer; the size rule
    counts the whole stack, as the reference's stacked leaves do."""
    if isinstance(p.value, MXTensor):
        return False            # packed already
    shape = tuple(p.value.shape)
    axes = p.axes
    if axes and axes[contraction_axis(p)] is None:
        return False            # positional tables are added, not matmul'd
    eff = shape[1:] if axes and axes[0] == "layers" else shape
    if len(eff) < 2:
        return False            # norm scales / biases stay unpacked
    if stack * int(np.prod(shape)) < _PACK_MIN_SIZE:
        return False
    return shape[contraction_axis(p)] >= 16


def pack_params_mxint(params, fmt: MXFormat, layer_stacks=None):
    """Param tree -> Param tree with ``MXTensor`` values on large matmul
    weights, blocks along the contraction axis; everything else as is.
    The size rule counts a leaf of a list (a model's per-layer trees) as
    one of a stack, as the reference's stacked leaves are:
    ``layer_stacks[key][i]`` layers for element i of the list under
    ``key`` (the model's ``layer_stacks()``: for ``DecoderLM`` ``n_units``
    for a unit layer, 1 for a tail layer; for ``EncDecLM`` the encoder's
    and the decoder's depths), or the list's length for a list it does
    not name."""
    stacks_by_key = layer_stacks or {}

    def walk(tree, stack, key):
        if isinstance(tree, dict):
            return {k: walk(v, stack, k) for k, v in tree.items()}
        if isinstance(tree, list):
            stacks = stacks_by_key.get(key) or [len(tree)] * len(tree)
            if len(stacks) != len(tree):
                raise ValueError(f"{key}: {len(tree)} layers, "
                                 f"{len(stacks)} stack sizes")
            return [walk(v, n, key) for v, n in zip(tree, stacks)]
        if not should_pack(tree, stack):
            return tree
        return Param(pack_weight(tree.value.to(torch.float32), fmt,
                                 axis=contraction_axis(tree)), tree.axes)

    return walk(params, 1, None)


def params_to(params, device):
    """Move every leaf of a Param tree (packed planes included)."""
    return tree_map(lambda p: Param(p.value.to(device), p.axes), params)


def _device(device, engine: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{engine} runs on cuda by default and no CUDA "
                           f"device is available; pass device='cpu' to run "
                           f"the plain versions of the kernels")
    return device


def make_prefill_step(model) -> Callable:
    """Prefill a whole batch: an encoder-decoder's ``frames`` and
    ``tokens``, or a decoder's ``tokens`` with a VLM's optional
    ``vision_embeds``."""
    enc_dec = model.cfg.is_encoder_decoder

    def prefill_step(params, batch, cache):
        if enc_dec:
            return model.prefill(params, batch["frames"], batch["tokens"],
                                 cache)
        return model.prefill(params, batch["tokens"], cache,
                             batch.get("vision_embeds"))

    return prefill_step


def make_slot_prefill_step(model, max_len: int, device) -> Callable:
    """Prefill ONE request into ONE row of a live batch cache.

    Runs a batch-1 prefill of the right-padded prompt ``tokens`` (1, P)
    with real length ``length`` into a fresh cache, then copies every leaf
    into row ``slot`` of the live ``cache`` along its "batch" axis
    (``model.cache_axes()``), leaving the other rows untouched.  Returns
    (the greedy first token (1,), the cache, updated in place)."""
    axes = model.cache_axes()

    def scatter(dst, src, ax, slot):
        if isinstance(dst, dict):
            for k in dst:
                scatter(dst[k], src[k], ax[k], slot)
        elif isinstance(dst, list):
            for d_, s_, a_ in zip(dst, src, ax):
                scatter(d_, s_, a_, slot)
        else:
            bi = ax.index("batch")
            dst.select(bi, slot).copy_(src.select(bi, 0))

    @torch.no_grad()
    def slot_prefill(params, tokens, length, slot, cache):
        tmp = model.cache_init(1, max_len, device)
        logits, tmp = model.prefill(params, tokens, tmp,
                                    lengths=torch.as_tensor(
                                        [length], device=tokens.device))
        scatter(cache, tmp, axes, int(slot))
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return tok, cache

    return slot_prefill


def make_decode_step(model, temperature: float = 0.0,
                     gen: torch.Generator = None) -> Callable:
    """One decode step: greedy, or with ``temperature > 0`` sampled with
    ``gen``."""
    if temperature > 0.0 and gen is None:
        raise ValueError("sampling at temperature > 0 needs a generator")

    @torch.no_grad()
    def decode_step(params, tokens, cache):
        logits, cache = model.decode_step(params, tokens, cache)
        last = logits[:, -1].to(torch.float32)
        if temperature > 0.0:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        return nxt.to(torch.int32)[:, None], cache

    return decode_step


class ServingEngine:
    """Token generation for a decoder LM or an encoder-decoder on one
    device.

    With ``pack_weights=True`` and a model config in kernel mode, every
    linear reads packed int8 planes and every decode step scores the KV
    ring in the decode attention kernel.  ``BatchScheduler`` drives
    ``_prefill_slot`` and ``_decode``; ``generate`` serves one batch.  An
    encoder-decoder is served through ``generate`` only (it has no slot
    prefill, as in the reference).  ``seed`` seeds the generator that
    sampling (``temperature > 0``) draws from.
    """

    def __init__(self, model, params, serve_cfg: ServeConfig,
                 device="cuda", seed: int = 0):
        self.model = model
        self.cfg = serve_cfg
        self.device = _device(device, "ServingEngine")
        if serve_cfg.pack_weights:
            params = pack_params_mxint(params, serve_cfg.weight_fmt,
                                       model.layer_stacks())
        self.params = params_to(params, self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self._prefill = make_prefill_step(model)
        self._decode = make_decode_step(model, serve_cfg.temperature,
                                        self.gen)
        self._prefill_slot = None if model.cfg.is_encoder_decoder else \
            make_slot_prefill_step(model, serve_cfg.max_len, self.device)

    @torch.no_grad()
    def generate(self, batch, max_new_tokens: int = 16) -> torch.Tensor:
        """batch['tokens']: (b, s) prompts of one length (with a VLM's
        optional 'vision_embeds', an encoder-decoder's 'frames') -> (b,
        max_new_tokens) tokens: the first greedy, the rest greedy or, at
        temperature > 0, sampled."""
        batch = {k: v.to(self.device) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v), device=self.device)
                 for k, v in batch.items()}
        bsz, plen = batch["tokens"].shape[:2]
        T.histogram("serving/batch_size", T.DEFAULT_SIZE_BUCKETS).record(bsz)
        T.histogram("serving/prefill_len",
                    T.DEFAULT_SIZE_BUCKETS).record(plen)
        with T.span("serving/generate", device=self.device, batch=bsz,
                    new_tokens=max_new_tokens):
            cache = self.model.cache_init(bsz, self.cfg.max_len, self.device)
            logits, cache = self._prefill(self.params, batch, cache)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            out = [tok]
            for _ in range(max_new_tokens - 1):
                tok, cache = self._decode(self.params, tok, cache)
                out.append(tok)
            return torch.cat(out, dim=1)


class ViTServingEngine:
    """Batched image classification for ViT/DeiT models on one device.

    With ``pack_weights=True`` and a model config in kernel mode this is
    the paper's deployment: packed int8 planes in device memory and every
    linear and non-linear op in the MXInt kernels.  Every forward runs the
    fixed ``(serve_cfg.batch, H, W, 3)`` shape.
    """

    def __init__(self, model, params, serve_cfg: ServeConfig,
                 device="cuda"):
        self.model = model
        self.cfg = serve_cfg
        self.device = _device(device, "ViTServingEngine")
        if serve_cfg.pack_weights:
            params = pack_params_mxint(params, serve_cfg.weight_fmt)
        self.params = params_to(params, self.device)

    @torch.no_grad()
    def logits_batch(self, chunk) -> torch.Tensor:
        """One forward on a (cfg.batch, H, W, 3) numpy chunk; the single
        funnel of ``classify`` and ``ClassifyScheduler``."""
        x = torch.as_tensor(np.asarray(chunk, dtype=np.float32),
                            device=self.device)
        return self.model.logits(self.params, x)

    def classify(self, images):
        """(n, H, W, 3) images -> (labels (n,), logits (n, classes)).

        Served in ``cfg.batch`` chunks, the last one zero-padded (the
        padding rows are dropped from the result)."""
        images = np.asarray(images, dtype=np.float32)
        n, batch = images.shape[0], self.cfg.batch
        T.histogram("serving/batch_size", T.DEFAULT_SIZE_BUCKETS).record(batch)
        with T.span("serving/classify", device=self.device, images=n):
            chunks = []
            for i in range(0, n, batch):
                chunk = images[i:i + batch]
                pad = batch - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.zeros(
                        (pad,) + chunk.shape[1:], chunk.dtype)])
                chunks.append(self.logits_batch(chunk)[:batch - pad])
            logits = torch.cat(chunks, dim=0)
            return logits.argmax(dim=-1), logits
