"""Serving: packed-MXInt weights, the token engine and the ViT engine.

``pack_params_mxint`` turns large matmul weights into ``MXTensor`` planes
(int8 mantissas plus int8 shared exponents), the paper's weight format,
with the reference's packing rules.  ``ServingEngine`` serves a decoder LM:
prefill, slot prefill (one request into one row of a live cache, which
the per-row ``cache['index']`` makes sound) and batched decode steps.
``ViTServingEngine`` serves a classifier in fixed-size batches.  Both run
eagerly, so there is no compile cache to watch.  Both record the
reference's ``serving/*`` telemetry; their spans are given the engine's
device, so on the card they time the device's work (CUDA events, a sync
at the span's end).

``ViTServingEngine`` also serves sharded, as the reference's does under
``shard_map``: given a mesh with a "model" axis, each rank keeps its
slice of the packed planes (mantissa and exponent planes cut alike) and
every kernel-mode linear runs on its local planes and adds its
collective; a "data" axis splits the batch rows over the ranks.  Column
sharding and the data axis give the single-device logits bit for bit.
The token engines run on one device, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.core.mx_types import MXINT6_WEIGHT, MXFormat
from repro_torch.core.quantize import MXTensor, _resolve_block, pack_weight
from repro_torch.launch.mesh import axis_size, mesh_context
from repro_torch.models.model_api import Param, axes_tree, tree_map
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (STRATEGIES, shard_packed_params,
                                           tp_shard_packed_params)


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
    tp_strategy: how ``ViTServingEngine`` splits the packed planes over a
      mesh's "model" axis: "column" (output-axis slices, gathered; bit
      for bit the single-device logits) or "row" (contraction-axis
      slices, partial products summed; close, not bit for bit).
    """
    max_len: int = 4096
    batch: int = 8
    pack_weights: bool = False
    weight_fmt: MXFormat = None
    temperature: float = 0.0
    tp_strategy: str = "column"

    def __post_init__(self):
        if self.pack_weights and self.weight_fmt is None:
            object.__setattr__(self, "weight_fmt", MXINT6_WEIGHT)
        if self.tp_strategy not in STRATEGIES:
            raise ValueError(f"tp_strategy must be one of {STRATEGIES}, "
                             f"got {self.tp_strategy!r}")


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


# logical axes that tensor parallelism shards: a contraction axis among
# them is cut over the ranks by the row strategy
_TP_LOGICAL = ("q_heads", "kv_heads", "heads", "mlp", "vocab", "expert",
               "lru")


def _leaf_fmt(p: Param, fmt: MXFormat, tp_shards: int) -> MXFormat:
    """The format a leaf packs with: ``fmt``, its block clamped to the
    per-rank contraction length when that axis is a tensor-parallel one
    and ``tp_shards`` ranks split it, so that no block straddles two
    ranks and the exponent plane splits as the mantissa plane does."""
    axis = contraction_axis(p)
    k_len = p.value.shape[axis]
    if tp_shards > 1 and p.axes[axis] in _TP_LOGICAL and \
            k_len % tp_shards == 0:
        return dataclasses.replace(fmt, block_size=_resolve_block(
            k_len // tp_shards, fmt.block_size))
    return fmt


def pack_params_mxint(params, fmt: MXFormat, layer_stacks=None,
                      tp_shards: int = 1):
    """Param tree -> Param tree with ``MXTensor`` values on large matmul
    weights, blocks along the contraction axis; everything else as is.
    The size rule counts a leaf of a list (a model's per-layer trees) as
    one of a stack, as the reference's stacked leaves are:
    ``layer_stacks[key][i]`` layers for element i of the list under
    ``key`` (the model's ``layer_stacks()``: for ``DecoderLM`` ``n_units``
    for a unit layer, 1 for a tail layer; for ``EncDecLM`` the encoder's
    and the decoder's depths), or the list's length for a list it does
    not name.

    ``tp_shards``: the row strategy's rank count; a leaf whose
    contraction axis is a tensor-parallel one (``_TP_LOGICAL``: the
    attention out-projection, the FFN's down projection) gets its block
    clamped to the per-rank contraction length.  The column strategy
    packs with 1, the single-device planes byte for byte."""
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
        return Param(pack_weight(tree.value.to(torch.float32),
                                 _leaf_fmt(tree, fmt, tp_shards),
                                 axis=contraction_axis(tree)), tree.axes)

    return walk(params, 1, None)


def packed_param_axes(params):
    """The logical axes of a packed tree, leaf by leaf: a packed leaf's
    exponent plane shards with its mantissa plane, so the leaf's axes
    serve both."""
    return axes_tree(params)


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
    """Batched image classification for ViT/DeiT models.

    With ``pack_weights=True`` and a model config in kernel mode this is
    the paper's deployment: packed int8 planes in device memory and every
    linear and non-linear op in the MXInt kernels.  Every forward runs the
    fixed ``(serve_cfg.batch, H, W, 3)`` shape.

    Sharded serving: ``mesh`` (a ``DeviceMesh``, this process one of its
    ranks) with a "model" axis of size above 1 splits every packed plane
    that ``tp_shard_packed_params`` marks under ``serve_cfg.tp_strategy``;
    the rank keeps its slice, and the model's linears run on it with the
    collective of the plane's ``tp_mode`` (column: bit for bit the
    single-device logits; row: the planes packed with ``tp_shards``
    ranks, close).  A "data" axis splits each batch's rows over its
    ranks, and the logits are gathered: rows are independent everywhere
    in the datapath, so that too is bit for bit.  A data-only mesh keeps
    the planes whole.  Sharding needs ``pack_weights=True``, kernel mode
    and ``batch % dp == 0``.  Every rank calls ``classify`` (or
    ``logits_batch``) with the same images.
    """

    def __init__(self, model, params, serve_cfg: ServeConfig,
                 device="cuda", mesh=None):
        self.model = model
        self.cfg = serve_cfg
        self.device = _device(device, "ViTServingEngine")
        self.mesh = mesh
        self.tp = axis_size(mesh, "model")
        self.dp = axis_size(mesh, "data")
        if self.tp > 1 or self.dp > 1:
            params = self._sharded_params(model, params, serve_cfg)
        elif serve_cfg.pack_weights:
            params = pack_params_mxint(params, serve_cfg.weight_fmt)
        self.params = params_to(params, self.device)

    def _sharded_params(self, model, params, serve_cfg):
        """Pack, mark and keep this rank's slices of the planes."""
        if not serve_cfg.pack_weights:
            raise ValueError("sharded serving shards the packed planes; set "
                             "ServeConfig(pack_weights=True)")
        if serve_cfg.batch % self.dp:
            raise ValueError(f"data sharding needs batch % dp == 0, got "
                             f"batch={serve_cfg.batch} dp={self.dp}")
        q = model.cfg.quant
        if self.tp > 1 and q.modes() != {"kernel"}:
            raise ValueError("tensor-parallel serving runs the kernel "
                             "datapath: QuantConfig(mode='kernel')")
        strategy = serve_cfg.tp_strategy
        packed = pack_params_mxint(
            params, serve_cfg.weight_fmt,
            tp_shards=self.tp if strategy == "row" else 1)
        if self.tp == 1:
            return packed
        marked, _ = tp_shard_packed_params(packed, self.tp, "model", strategy)
        return shard_packed_params(marked, self.mesh)

    @torch.no_grad()
    def logits_batch(self, chunk) -> torch.Tensor:
        """One forward on a (cfg.batch, H, W, 3) numpy chunk; the single
        funnel of ``classify`` and ``ClassifyScheduler``.  Over a "data"
        axis this rank runs its ``batch / dp`` rows and the rows of every
        data rank are gathered in order."""
        chunk = np.asarray(chunk, dtype=np.float32)
        if self.dp > 1:
            rows = chunk.shape[0] // self.dp
            r = self.mesh.get_local_rank("data")
            chunk = chunk[r * rows:(r + 1) * rows]
        x = torch.as_tensor(chunk, device=self.device)
        if self.mesh is None:
            return self.model.logits(self.params, x)
        with mesh_context(self.mesh):
            logits = self.model.logits(self.params, x)
        if self.dp > 1:
            logits = collectives.all_gather_cat(
                logits, self.mesh.get_group("data"), dim=0)
        return logits

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


def make_engine(model, params, serve_cfg: ServeConfig, mesh=None,
                device="cuda"):
    """The engine of the model's family: ``ViTServingEngine`` for a ViT
    (sharded over ``mesh`` when given), ``ServingEngine`` otherwise (one
    device: a mesh raises)."""
    if getattr(model.cfg, "family", None) == "vit":
        return ViTServingEngine(model, params, serve_cfg, device=device,
                                mesh=mesh)
    if mesh is not None:
        raise ValueError("the token engines run on one device; sharded "
                         "serving is the ViT engine's")
    return ServingEngine(model, params, serve_cfg, device=device)
