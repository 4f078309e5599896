"""Search drivers over a SearchSpace.

Counterpart of ``repro.dse.drivers``: the same four strategies, visit
orders and numpy generators seeded as the reference seeds them, so both
packages visit the same points in the same order.

Four strategies, all returning the full list of evaluated candidates
(the evaluator memoizes, so revisits are free and the report's Pareto
extraction sees everything each driver touched):

* ``exhaustive_search`` — every point; guarded by an explicit limit so a
  fat-fingered space cannot enumerate forever.
* ``greedy_search``     — the paper's §III-A / Table V loop re-hosted
  from ``core/search.py``: start every group at its widest candidate,
  then lower one group at a time while the accuracy drop vs the widest
  point stays within budget.  Same accept rule, same visit order, same
  trace tuples as ``core.search.greedy_bitwidth_search``.
* ``random_search``     — uniform samples, seeded.
* ``evolutionary_search`` — (mu + lambda) with dominance-based
  selection: parents are drawn from the current Pareto archive and
  mutated one knob at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.dse.evaluate import EvalResult, Evaluator
from repro_torch.dse.report import DEFAULT_OBJECTIVES, pareto_front
from repro_torch.dse.space import Point, SearchSpace

EXHAUSTIVE_LIMIT = 4096


def exhaustive_search(space: SearchSpace, evaluate: Evaluator, *,
                      limit: int = EXHAUSTIVE_LIMIT) -> List[EvalResult]:
    n = space.size()
    if n > limit:
        raise ValueError(f"space has {n} points > exhaustive limit "
                         f"{limit}; use greedy/random/evolutionary")
    return [evaluate(p) for p in space.points()]


def random_search(space: SearchSpace, evaluate: Evaluator, *,
                  n: int = 32, seed: int = 0) -> List[EvalResult]:
    import numpy as np
    rng = np.random.default_rng(seed)
    return [evaluate(space.random_point(rng)) for _ in range(n)]


@dataclasses.dataclass
class GreedyResult:
    """Mirror of ``core.search.SearchResult`` keyed by scope."""

    point: Point
    bits: Dict[str, int]        # scope -> chosen width
    metric: float               # final score (1 - agreement vs widest)
    trace: List[tuple]          # (scope, bits_tried, score, accepted)
    results: List[EvalResult]   # every candidate evaluated

    @property
    def mean_bits(self) -> float:
        return sum(self.bits.values()) / max(len(self.bits), 1)


def greedy_search(space: SearchSpace, evaluate: Evaluator, *,
                  knob: str = "weight_mant_bits",
                  budget: float = 0.01,
                  order: Optional[Sequence[str]] = None) -> GreedyResult:
    """Greedily minimize per-group ``knob`` under an accuracy budget.

    Reference = the point with every swept group at its WIDEST
    candidate (everything else at baseline); a lowering step is accepted
    while ``1 - agreement(candidate_logits, reference_logits)`` stays
    ``<= budget`` — the EXACT accept rule of
    ``core.search.greedy_bitwidth_search`` (candidates compared against
    the widest point's own output, via the evaluator's logits memo).
    """
    from repro_torch.core.search import argmax_agreement

    knobs = {k.scope: sorted(k.values, reverse=True)
             for k in space.knobs() if k.name == knob}
    if not knobs:
        raise ValueError(f"no group sweeps knob {knob!r}")
    scopes = list(order) if order is not None else list(knobs)

    point = space.baseline_point()
    for s, widths in knobs.items():
        point[(s, knob)] = widths[0]
    results = [evaluate(point)]
    ref_out = evaluate.logits_for(point)

    trace: List[tuple] = []
    current = 0.0
    for s in scopes:
        widths = knobs[s]
        while True:
            i = widths.index(point[(s, knob)])
            if i + 1 >= len(widths):
                break
            trial = dict(point)
            trial[(s, knob)] = widths[i + 1]
            r = evaluate(trial)
            results.append(r)
            score = 1.0 - argmax_agreement(evaluate.logits_for(trial),
                                           ref_out)
            ok = score <= budget
            trace.append((s, widths[i + 1], score, ok))
            if not ok:
                break
            point = trial
            current = score
    bits = {s: point[(s, knob)] for s in knobs}
    return GreedyResult(point=point, bits=bits, metric=current,
                        trace=trace, results=results)


def evolutionary_search(space: SearchSpace, evaluate: Evaluator, *,
                        generations: int = 4, population: int = 8,
                        seed: int = 0,
                        objectives=DEFAULT_OBJECTIVES) -> List[EvalResult]:
    """(mu + lambda) evolution with dominance-based parent selection."""
    import numpy as np
    rng = np.random.default_rng(seed)

    seen: List[EvalResult] = [evaluate(space.baseline_point())]
    seen += [evaluate(space.random_point(rng))
             for _ in range(max(population - 1, 0))]
    for _ in range(generations):
        front = pareto_front(seen, objectives=objectives)
        parents = [seen[i] for i in front] or seen
        children = []
        for _ in range(population):
            parent = parents[int(rng.integers(len(parents)))]
            children.append(evaluate(space.mutate(parent.point, rng)))
        seen += children
    # dedupe on the canonical key, keeping first occurrence
    out, keys = [], set()
    for r in seen:
        if r.key not in keys:
            keys.add(r.key)
            out.append(r)
    return out
