"""Pareto extraction and the JSON report.

Counterpart of ``repro.dse.report``, with the reference's report schema 1
(the cost entries name ``kernel_smem_bytes`` where the reference's name
``kernel_vmem_bytes``).

Objectives are (name, sense, extractor) triples; the comparison space
is the sign-adjusted vector where HIGHER IS BETTER on every axis.
``dominates(a, b)`` is strict Pareto dominance: at least as good
everywhere, strictly better somewhere; equal vectors never dominate
each other, so exact ties all stay on the front.

Report schema::

    {"schema": 1, "driver": ..., "space": SearchSpace.describe(),
     "objectives": [names...], "n_candidates": N, "n_evaluations": N,
     "candidates": [EvalResult.as_dict() + {"pareto": bool}],
     "pareto": [indices into candidates],
     "measured_ms": {label: mean_ms} | null}
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.dse.evaluate import EvalResult

Objective = Tuple[str, int, Callable[[EvalResult], float]]

# the Fig. 1b axes: maximize agreement, minimize bits-per-element and
# the deployment kernels' HBM traffic
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    ("accuracy", +1, lambda r: r.accuracy),
    ("weight_bits", -1, lambda r: r.cost.weight_bits),
    ("kernel_hbm_bytes", -1, lambda r: float(r.cost.kernel_hbm_bytes)),
)


def objective_vector(result: EvalResult,
                     objectives: Sequence[Objective] = DEFAULT_OBJECTIVES
                     ) -> Tuple[float, ...]:
    """Sign-adjusted objective values (higher is better on every axis)."""
    return tuple(sense * fn(result) for _, sense, fn in objectives)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Strict Pareto dominance on higher-is-better vectors."""
    if len(a) != len(b):
        raise ValueError(f"objective arity mismatch: {len(a)} vs {len(b)}")
    return all(x >= y for x, y in zip(a, b)) and \
        any(x > y for x, y in zip(a, b))


def pareto_front(results: Sequence[EvalResult],
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES
                 ) -> List[int]:
    """Indices of the non-dominated results (stable order)."""
    vecs = [objective_vector(r, objectives) for r in results]
    return [i for i, v in enumerate(vecs)
            if not any(dominates(w, v) for j, w in enumerate(vecs)
                       if j != i)]


def build_report(space, results: Sequence[EvalResult], *, driver: str,
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
                 n_evaluations: Optional[int] = None,
                 measured_ms: Optional[dict] = None) -> dict:
    # dedupe on the canonical point key (drivers may revisit; the
    # evaluator already served those from cache)
    uniq: List[EvalResult] = []
    seen = set()
    for r in results:
        if r.key not in seen:
            seen.add(r.key)
            uniq.append(r)
    front = set(pareto_front(uniq, objectives))
    candidates = []
    for i, r in enumerate(uniq):
        row = r.as_dict()
        row["pareto"] = i in front
        candidates.append(row)
    return {
        "schema": 1,
        "driver": driver,
        "space": space.describe(),
        "objectives": [name for name, _, _ in objectives],
        "n_candidates": len(uniq),
        "n_evaluations": (len(uniq) if n_evaluations is None
                          else n_evaluations),
        "candidates": candidates,
        "pareto": sorted(front),
        "measured_ms": measured_ms,
    }


def write_report(path, report: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1, sort_keys=True) + "\n")
    return path
