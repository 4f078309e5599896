"""Model configs and parameter helpers.

Parameters are ``Param(value, axes)``: a tensor (or packed ``MXTensor``)
plus the tuple of logical axis names the reference gives it.  The axes
decide which weights ``pack_params_mxint`` packs and along which axis,
exactly as in the reference.  Parameter trees are nested dicts; the ViT
stacks its blocks on a leading "layers" axis, the decoder LM keeps one
tree per layer, and both loop over the layers in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.mx_types import QuantConfig


class Param(NamedTuple):
    """A parameter leaf plus its logical axes."""
    value: Any               # torch.Tensor | MXTensor
    axes: Tuple[Optional[str], ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every ``Param`` leaf of a tree of dicts and lists;
    with ``rest``, trees of the same structure, ``fn`` also takes their
    leaves at the same place."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def axes_tree(tree):
    """A Param tree -> the same tree of its leaves' logical axes."""
    return tree_map(lambda p: tuple(p.axes), tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, dict keys in sorted order
    (the reference's pytree order)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has places")
    return out


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The mixture-of-experts FFN: ``num_experts`` experts, each token
    routed to ``top_k`` of them; each expert takes at most
    ``capacity_factor`` times its even share of a batch's routed tokens;
    ``router_aux_loss`` weighs the load-balancing loss."""
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of the reference's ``ModelConfig`` that the ViT family
    and the decoder LM read.

    unit / n_units / tail: the stack is ``unit`` repeated ``n_units``
    times (default: as often as it tiles ``n_layers`` after the tail),
    then ``tail``; block kinds "attn", "rec" (RG-LRU), "mlstm" and
    "slstm".  window / local_attn_window: sliding-window size of the
    attention blocks, 0 for full attention.  ffn_kind: "swiglu", "geglu",
    "gelu", "moe" (then ``moe`` holds its ``MoEConfig``) or "none".
    lru_width / conv_width: the RG-LRU's width (default d_model) and its
    temporal convolution's taps.  is_encoder_decoder / n_encoder_layers:
    the encoder-decoder (``EncDecLM``), whose encoder of
    ``n_encoder_layers`` layers reads frame embeddings.  audio_frames
    mirrors the reference's field of that name (SeamlessM4T sets it) so
    that a config reads field for field as the reference's; neither
    package's models read it.  vision_tokens / vision_dim: a VLM's
    prefix of ``vision_tokens`` positions fed by the projector from
    ``vision_dim``-wide embeddings.  remat: "none", "block" or "full";
    "block" and "full" recompute each ViT block, and each unit of a
    decoder's cache-less forward, in the backward pass
    (``torch.utils.checkpoint``) instead of keeping their activations: a
    tool for gradient memory only, the values are the same.
    max_cache_len: the KV capacity the launch dry-run sizes caches with.
    """

    name: str = "model"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab: int = 32000
    head_dim: Optional[int] = None
    unit: Tuple[str, ...] = ("attn",)
    n_units: Optional[int] = None
    tail: Tuple[str, ...] = ()
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: int = 0
    local_attn_window: int = 0
    ffn_kind: str = "swiglu"
    moe: Optional[MoEConfig] = None
    lru_width: Optional[int] = None
    conv_width: int = 4
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    vision_tokens: int = 0
    vision_dim: int = 1024
    audio_frames: bool = False
    image_size: int = 224
    patch_size: int = 16
    n_classes: int = 1000
    pool: str = "cls"
    dtype: Any = torch.float32
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    remat: str = "none"
    max_cache_len: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_n_units(self) -> int:
        """Repeats of ``unit`` before the tail."""
        if self.n_units is not None:
            return self.n_units
        body = self.n_layers - len(self.tail)
        if body % len(self.unit):
            raise ValueError(f"unit {self.unit} does not tile the "
                             f"{body} layers before the tail {self.tail}")
        return body // len(self.unit)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """The block kind of each layer: the unit repeats, then the tail."""
        return tuple(self.unit) * self.resolved_n_units + tuple(self.tail)

    def validate(self):
        """Raise unless the fields fit together; returns the config."""
        if len(self.layer_kinds) != self.n_layers:
            raise ValueError(f"{self.resolved_n_units} x {self.unit} + "
                             f"{self.tail} is not {self.n_layers} layers")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.ffn_kind == "moe" and self.moe is None:
            raise ValueError("ffn_kind 'moe' needs a MoEConfig")
        if self.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got "
                             f"{self.remat!r}")
        return self

    @property
    def checkpoints(self) -> bool:
        """Whether the training forward recomputes its blocks or units
        (``remat`` "block" or "full")."""
        return self.remat in ("block", "full")


REMAT = ("none", "block", "full")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the input-shape cells: a sequence length, a global batch and
    the kind of step ("train", "prefill" or "decode")."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def dense_init(gen: torch.Generator, shape, axes, scale=None,
               dtype=torch.float32, device="cpu") -> Param:
    """Normal(0, scale) init, scale = fan_in^-0.5 by default."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    v = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return Param(v.to(dtype=dtype, device=device), axes)


def zeros_init(shape, axes, dtype=torch.float32, device="cpu") -> Param:
    return Param(torch.zeros(shape, dtype=dtype, device=device), axes)


def ones_init(shape, axes, dtype=torch.float32, device="cpu") -> Param:
    return Param(torch.ones(shape, dtype=dtype, device=device), axes)
