"""Greedy mantissa-bitwidth search (paper §III-A / Table V).

Counterpart of ``repro.core.search``.  The paper determines "the minimal
bitwidth of the mantissa to preserve high accuracy within a 1% loss" by
greedy search in software quantization.  This reproduces that loop
generically: given a model's apply function, a calibration batch and a
per-group quantization hook, greedily lower each group's mantissa width
while a fidelity metric stays within budget.

Without ImageNet in the repository, the default metric is top-1
*agreement* with the float model on the calibration batch (argmax match
rate), the accuracy-delta proxy: a 1% budget on agreement upper-bounds
the accuracy drop on the same distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch


@dataclasses.dataclass
class SearchResult:
    bits: Dict[str, int]
    metric: float
    trace: List[tuple]          # (group, bits_tried, metric, accepted)

    @property
    def mean_bits(self) -> float:
        return sum(self.bits.values()) / max(len(self.bits), 1)


def argmax_agreement(logits_a: torch.Tensor, logits_b: torch.Tensor) -> float:
    """Share of rows whose argmax agrees."""
    same = logits_a.argmax(-1) == logits_b.argmax(-1)
    return float(same.to(torch.float32).mean())


def cosine_fidelity(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine similarity of the flattened outputs (float32 sums, as the
    reference's)."""
    af = a.reshape(-1).to(torch.float32)
    bf = b.reshape(-1).to(torch.float32)
    num = torch.dot(af, bf)
    den = torch.linalg.vector_norm(af) * torch.linalg.vector_norm(bf) + 1e-12
    return float(num / den)


def greedy_bitwidth_search(
    apply_fn: Callable[[Dict[str, int]], torch.Tensor],
    groups: Sequence[str],
    *,
    max_bits: int = 10,
    min_bits: int = 3,
    budget: float = 0.01,
    metric: str = "agreement",
    reference: Optional[torch.Tensor] = None,
) -> SearchResult:
    """Greedily minimize per-group mantissa bits.

    ``apply_fn(bits_per_group)`` runs the quantized model and returns
    logits (or any comparable output).  Groups are visited in the given
    order (large-memory tensors first harvest the big wins first, as the
    paper does); each group's bits drop one step at a time while the
    metric stays within ``budget`` of the reference.
    """
    bits = {g: max_bits for g in groups}
    ref = reference if reference is not None else apply_fn(bits)
    if metric == "agreement":
        def score(out):
            return 1.0 - argmax_agreement(out, ref)
    elif metric == "cosine":
        def score(out):
            return 1.0 - cosine_fidelity(out, ref)
    else:
        raise ValueError(f"unknown metric {metric!r}")

    trace: List[tuple] = []
    current = score(apply_fn(bits))
    for g in groups:
        while bits[g] > min_bits:
            trial = dict(bits)
            trial[g] = bits[g] - 1
            s = score(apply_fn(trial))
            ok = s <= budget
            trace.append((g, trial[g], s, ok))
            if not ok:
                break
            bits = trial
            current = s
    return SearchResult(bits=bits, metric=current, trace=trace)
