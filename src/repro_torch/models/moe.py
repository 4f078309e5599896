"""Mixture-of-experts FFN with sort-based dispatch and token dropping.

Counterpart of ``repro.models.moe`` on one device: the reference's leading
data-parallel axis D is 1 here (it is 1 off a mesh there too), so the
routing, the stable sorts, the scatter into the capacity buffer and the
inverse-permutation gather run over the whole batch.

Every token of the batch competes for capacity, the idle rows of a decode
step and the padded positions of a slot prefill's bucket included, as in
the reference: an expert keeps the first C tokens routed to it in token
order and drops the rest, C = ceil(T k / E * capacity_factor) rounded up
to a multiple of 8.

The router and the gates run through the backend (in kernel mode the
``mxint_matmul`` and ``mxint_softmax`` kernels), and so does the experts'
SiLU (``mxint_gelu``).  The expert products are plain products of the
activations with the backend's ``weight_value`` of the expert stacks (the
dequantized planes), as in the reference, which computes them outside any
kernel.  They run in float64 and round once to float32, then to the
model dtype, as the port's other float products do, so the card and the
CPU give the same bits.  Packed planes whose values the model dtype holds
exactly (mantissas no wider than its significand) are dequantized
straight to float64, one pass over the stack fewer than through the model
dtype and the same values, unless a block lies below float32's normal
range.  That matters more here than in a dense FFN: a
last-bit difference in one layer's output can move an MXInt rounding
step of the next layer's router, flip a token's expert choice and, as
the experts' slots fill in token order, change which later tokens are
dropped.  Against the reference's float32 einsum the outputs differ in
the last bit; the LM's MXInt stages absorb that (``tests/test_torch_moe.py``,
``tests/test_torch_lm.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.core.mx_types import QuantConfig
from repro_torch.core.quantize import MXTensor
from repro_torch.models import layers as L
from repro_torch.models.model_api import ModelConfig

EXPERT_AXES = ("expert", "embed", "mlp")
# significand bits of the model dtypes with float32's exponent range
_SIGNIFICAND_BITS = {torch.bfloat16: 8, torch.float32: 24}


def moe_param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The leaves of the reference's ``init_moe_params`` as (shape, axes,
    init): the router (d, E) and the expert stacks wi, wg (E, d, f) and
    wo (E, f, d), the "expert" axis first."""
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    return {"router": ((d, E), ("embed", "expert"), "dense"),
            "wi": ((E, d, f), EXPERT_AXES, "dense"),
            "wg": ((E, d, f), EXPERT_AXES, "dense"),
            "wo": ((E, f, d), ("expert", "mlp", "embed"), "dense")}


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for a batch of ``tokens`` tokens."""
    moe = cfg.moe
    c = max(1, math.ceil(tokens * moe.top_k / moe.num_experts *
                         moe.capacity_factor))
    return -(-c // 8) * 8


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first; equal values in order of their index, as ``jax.lax.top_k``
    orders them (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def aux_loss(logits: torch.Tensor, top1: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balancing loss E * sum_e f_e p_e: the float softmax
    of the f32 router logits (a training statistic the reference keeps
    outside the MXInt datapath) and each expert's share of first choices,
    in float64, rounded once to a float32 scalar."""
    E = cfg.moe.num_experts
    # repro-lint: allow[models-float-nonlinear] float-by-design aux loss
    probs = torch.softmax(logits.double(), dim=-1)
    me = probs.mean(dim=0)
    ce = _counts(top1, E).double() / top1.numel()
    return (cfg.moe.router_aux_loss * E * (me * ce).sum()).float()


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx``; unlike
    ``torch.bincount`` it does not read the device's max back to the
    host."""
    return torch.zeros(n, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def _expert_mm(h: torch.Tensor, w, pattern: str,
               quant: QuantConfig) -> torch.Tensor:
    wv = w.value
    exact = (isinstance(wv, MXTensor)
             and wv.mant_bits <= _SIGNIFICAND_BITS.get(h.dtype, 0))
    wf = quant.datapath.weight_value(
        wv, q=quant, dtype=torch.float64 if exact else h.dtype)
    return torch.einsum(pattern, h.double(), wf.double()).float().to(h.dtype)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig, *, quant: QuantConfig,
            with_aux: bool = True):
    """x: (b, s, d) -> (y (b, s, d), aux_loss: a float32 scalar, or None
    unless ``with_aux``; serving has no use for it)."""
    moe = cfg.moe
    E, k = moe.num_experts, moe.top_k
    b, s, d = x.shape
    T = b * s
    C = capacity(T, cfg)
    xs = x.reshape(T, d)
    dev = x.device

    # routing
    logits = L.linear(xs, p["router"], q=quant).to(torch.float32)
    top_logits, top_idx = top_k(logits, k)                  # (T, k)
    gates = L.softmax(top_logits, quant, axis=-1).to(x.dtype)
    aux = aux_loss(logits, top_idx[:, 0], cfg) if with_aux else None

    # dispatch: the (token, choice) pairs in expert order, token order
    # within an expert; an expert's first C pairs get its slots
    flat_e = top_idx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    inv = torch.argsort(order)                              # inverse perm
    sorted_e = flat_e[order]
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)    # E*C: drop bin
    src_tok = torch.div(order, k, rounding_mode="floor")
    buf = x.new_zeros((E * C + 1, d))
    buf[dest] = xs[src_tok]            # dropped pairs all land in the bin
    buf = buf[:E * C].reshape(E, C, d)

    # the experts
    up = _expert_mm(buf, p["wi"], "ecd,edf->ecf", quant)
    gate = L.act_fn(_expert_mm(buf, p["wg"], "ecd,edf->ecf", quant), "silu",
                    quant)
    out = _expert_mm(up * gate, p["wo"], "ecf,efd->ecd", quant)
    out = out.reshape(E * C, d)

    # combine: gather back to (token, choice) order, weigh by the gates and
    # add a token's k choices in order, in float32
    gathered = out[dest.clamp(max=E * C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weighted = gathered * gates.reshape(T * k)[order][:, None].to(
        gathered.dtype)
    tok_major = weighted[inv].reshape(T, k, d).to(torch.float32)
    y = tok_major[:, 0]
    for j in range(1, k):
        y = y + tok_major[:, j]
    return y.to(x.dtype).reshape(b, s, d), aux
