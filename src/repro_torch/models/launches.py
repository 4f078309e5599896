"""Kernel launches of one call of a model in kernel mode
(``QuantConfig(mode="kernel", quantize_nonlinear=True)``), derived from
its block kinds, by kernel (the names of ``ops.LAUNCH_COUNTERS``).

A call is a slot prefill or prefill of ``tokens`` tokens, a decode step
(``decode``) or a cache-less forward (``score``, as ``loss`` runs it).
The attention core of a forward is the whole-row softmax kernel while a
(batch, head) holds at most ``ops.PAPER_MAX_SCORES`` scores and the
flash kernel past that; a decode step's is the decode kernel; a decoder
prefill's self-attention is float and launches none.  The CPU tests and
``chip_smoke.py`` hold the launch counters to these counts.
"""
import contextlib
from typing import Dict

import torch

from repro_torch.kernels import ops


def _core(s: int, n: int) -> str:
    """The kernel of a cache-less attention of ``s`` queries over ``n``
    keys."""
    return ("flash_attention" if s * n > ops.PAPER_MAX_SCORES
            else "mxint_softmax")


def lm_launches(cfg, tokens: int, decode: bool = False,
                score: bool = False, vision: bool = False) -> Dict[str, int]:
    """A ``DecoderLM`` call, layer by layer.  attn: 3 fused norm -> q/k/v
    and the out linear, with qk-norm the per-head q and k RMSNorms, and
    the attention kernel of a step or a forward.  The FFN after an attn
    or rec layer, dense: 2 fused norm -> linears (gate, up), the SiLU or
    GELU and the out linear; MoE: the RMSNorm, the router linear, the
    gates' softmax and the experts' SiLU.  rec: the RMSNorm, 5 linears
    (y, x, the two gates, out) and the GELU.  mlstm: the RMSNorm and 8
    linears (q, k, v, the two gates, out, up, down).  slstm: the RMSNorm,
    2 linears a token and the out linear.  Then the final RMSNorm.
    ``vision``: a call with vision embeddings adds the projector's
    linear."""
    s = 1 if decode else tokens
    c = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    c["mxint_layernorm"] = 1
    c["mxint_matmul"] = 1 if vision else 0
    for kind in cfg.layer_kinds:
        if kind == "attn":
            c["mxint_ln_matmul"] += 3
            c["mxint_matmul"] += 1
            c["mxint_layernorm"] += 2 if cfg.qk_norm else 0
            if decode:
                c["flash_attention_decode"] += 1
            elif score:
                c[_core(s, s)] += 1
        elif kind == "rec":
            c["mxint_layernorm"] += 1
            c["mxint_matmul"] += 5
            c["mxint_gelu"] += 1
        else:
            c["mxint_layernorm"] += 1
            c["mxint_matmul"] += 8 if kind == "mlstm" else 2 * s + 1
        if kind in ("attn", "rec") and cfg.ffn_kind != "none":
            if cfg.ffn_kind == "moe":
                c["mxint_layernorm"] += 1
                c["mxint_matmul"] += 1
                c["mxint_softmax"] += 1
            else:
                c["mxint_ln_matmul"] += 2
                c["mxint_matmul"] += 1
            c["mxint_gelu"] += 1
    return c


def encdec_launches(cfg, frames: int, tokens: int, decode: bool = False,
                    score: bool = False) -> Dict[str, int]:
    """An ``EncDecLM`` call over ``frames`` frames.  A prefill or forward
    runs the encoder: a layer's 2 RMSNorms, q/k/v/out and the FFN's 2
    linears, the GELU and its attention kernel; then ``enc_norm`` and
    ``encode_kv``'s 2 linears a decoder layer.  A decoder layer: 3
    RMSNorms, the self-attention's 4 linears and its kernel, the cross-
    attention's q and out linears and its kernel over the frames, the
    FFN's 2 linears and GELU; then the final RMSNorm.  Its norms are
    separate RMSNorms: no ``mxint_ln_matmul``."""
    c = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    if not decode:
        c["mxint_layernorm"] += 2 * cfg.n_encoder_layers + 1
        c["mxint_matmul"] += 6 * cfg.n_encoder_layers + 2 * cfg.n_layers
        c["mxint_gelu"] += cfg.n_encoder_layers
        c[_core(frames, frames)] += cfg.n_encoder_layers
    s = 1 if decode else tokens
    c["mxint_layernorm"] += 3 * cfg.n_layers + 1
    c["mxint_matmul"] += 8 * cfg.n_layers
    c["mxint_gelu"] += cfg.n_layers
    c[_core(s, frames)] += cfg.n_layers
    if decode:
        c["flash_attention_decode"] += cfg.n_layers
    elif score:
        c[_core(s, s)] += cfg.n_layers
    return c


def _psum_plane(k: int, n: int, axes, fmt, tp: int) -> bool:
    """Whether the row strategy over ``tp`` ranks shards a (k, n) plane
    packed with ``fmt`` along its contraction axis (``_tp_decision`` on
    the block the row packing gives it)."""
    from repro_torch.core.quantize import MXTensor, _resolve_block
    from repro_torch.parallel.sharding import _tp_decision
    from repro_torch.serving.engine import _TP_LOGICAL
    clamp = axes[0] in _TP_LOGICAL and k % tp == 0
    block = _resolve_block(k, _resolve_block(k // tp, fmt.block_size)
                           if clamp else fmt.block_size)
    meta = MXTensor(torch.empty((k, n), device="meta"),
                    torch.empty((k // block, n), device="meta"), -2,
                    fmt.mant_bits, block)
    d = _tp_decision(meta, tp, "row")
    return d is not None and d[1] == "psum"


def vit_launches(cfg, strategy: str = "column", tp: int = 1,
                 weight_fmt=None) -> Dict[str, int]:
    """One ``ViT`` forward on each rank of a ``tp``-way "model" axis (1:
    a single device): the patch linear, per block the fused LN1 into q, k
    and v, the softmax, the out-projection, the fused LN2 into ``wi``, the
    GELU and ``wo``, then the final LN and the head, 3 + 8 L.  Column
    sharding launches the same kernels on the output slices.  Under the
    row strategy a fused plane that shards along its contraction axis
    cannot take the fused kernel (the LN needs the whole row): its norm
    runs first in ``mxint_layernorm`` and its linears in
    ``mxint_matmul``."""
    from repro_torch.core.mx_types import MXINT6_WEIGHT
    fmt = weight_fmt or MXINT6_WEIGHT
    L, d = cfg.n_layers, cfg.d_model
    hoist_qkv = hoist_wi = False
    if strategy == "row" and tp > 1:
        hoist_qkv = _psum_plane(d, cfg.n_heads * cfg.hd, ("embed",), fmt, tp)
        hoist_wi = _psum_plane(d, cfg.d_ff, ("embed",), fmt, tp)
    c = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    c["mxint_matmul"] = 2 + L * (2 + 3 * hoist_qkv + hoist_wi)
    c["mxint_ln_matmul"] = L * (3 * (not hoist_qkv) + (not hoist_wi))
    c["mxint_layernorm"] = 1 + L * (hoist_qkv + hoist_wi)
    c["mxint_softmax"] = L
    c["mxint_gelu"] = L
    return c


@contextlib.contextmanager
def count_calls():
    """Count the calls of each kernel op of ``ops`` inside (a dict by
    kernel name).  On the card each call is one launch; on the CPU, where
    the plain versions launch nothing, this is how the path's structure
    is read."""
    calls = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    saved = {n: getattr(ops, n) for n in calls}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for n, fn in saved.items():
        setattr(ops, n, counted(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)
