"""Deliberately violating fixtures: the static checks' self-tests.

Counterpart of ``repro.analysis.fixtures``.  Each fixture returns what its
rule reports on a known-bad input; ``tests/test_torch_analysis.py``
asserts that every fixture fires its rule (``FIXTURE_RULES``) and
``python -m repro_torch.analysis --fixture NAME`` exits 1 on each: a rule
that cannot flag its own counterexample guarantees nothing.

The launch fixtures go through the real recorder: ``_launch_2d``
(``kernels/launch_fixture.py``, the counterpart of the reference's
``_capture_2d``) fabricates a launch of the no-op fixture kernel whose
record the wrappers' own ``record_launches`` collects; on a CUDA device
the runtime then takes or refuses it.

Reference fixtures without a counterpart here:

- ``misaligned-tile``: the TPU's (8, 128) tile alignment has no CUDA
  equivalent; what a CUDA route needs is the alignment of its vector
  accesses (``unaligned-vector-operand``).
- ``wrong-scratch-dtype``: Pallas declares scratch buffers with a dtype;
  a CUDA kernel carves raw shared memory, whose size the contracts check.
- ``missing-dim-semantics``, ``race-parallel-accumulator``,
  ``reversed-init-flush``, ``unaliased-inplace-output``: a CUDA launch
  declares no ``dimension_semantics`` and no accumulator crosses CTAs
  (K is never split); the race between CTAs is an output tile two of
  them write (``overlapping-output-tile``), and the gap one that none
  writes (``uncovered-output-tile``).
- ``interpret-literal-in-src``: the port has no interpret mode; its
  counterpart is a kernel falling back to its plain version
  (``kernel-fallback``).

The bad source texts below split the tokens that the JAX package's line
scans (``tools/check_dispatch.py``) would otherwise find in this file.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.analysis import dispatch, grid_coverage
from repro_torch.analysis import launch_contracts as LC
from repro_torch.analysis.registry import ERROR, Violation
from repro_torch.analysis.source_rules import check_source
from repro_torch.analysis.trace_check import (KERNEL_NL_DENY, TraceRules,
                                              check_fn)
from repro_torch.kernels.launch_fixture import _launch_2d

SHAPE, BLOCK = (64, 256), (16, 64)     # a 4 x 4 grid of tiles

# the launches one past each of the card's limits, which its runtime
# must refuse (chip_smoke.py launches them): (shape, block, kwargs)
REFUSED_ON_CARD = {
    "smem-over-budget": (SHAPE, BLOCK,
                         {"smem": LC.SMEM_PER_BLOCK_OPTIN + 1}),
    "too-many-threads": (SHAPE, BLOCK,
                         {"threads": LC.MAX_THREADS_PER_BLOCK + 1}),
    "grid-y-over-limit": ((16, LC.MAX_GRID[1] + 1), (16, 1), {}),
}


def _refused(name) -> List[Violation]:
    shape, block, kw = REFUSED_ON_CARD[name]
    return LC.check_records(_launch_2d(shape, block, device="cpu",
                                                **kw))


def smem_over_budget() -> List[Violation]:
    """One byte past the shared memory a CTA may opt in to."""
    return _refused("smem-over-budget")


def too_many_threads() -> List[Violation]:
    """1025 threads a CTA."""
    return _refused("too-many-threads")


def grid_y_over_limit() -> List[Violation]:
    """65,536 CTAs along y, one a 1-column tile."""
    return _refused("grid-y-over-limit")


def unaligned_vector_operand() -> List[Violation]:
    """An output read in float4 that starts 4 bytes past 16."""
    return LC.check_records(_launch_2d(SHAPE, BLOCK, device="cpu",
                                       vector_bytes=16, offset=4))


def uncovered_output_tile() -> List[Violation]:
    """A grid of one row of CTAs over four rows of tiles: three quarters
    of the output are never written."""
    return grid_coverage.check_records(_launch_2d(
        SHAPE, BLOCK, device="cpu", grid=(1, 4)))


def overlapping_output_tile() -> List[Violation]:
    """Every row of CTAs writes the first row of tiles: a race."""
    return grid_coverage.check_records(_launch_2d(
        SHAPE, BLOCK, device="cpu", out_tile=lambda x, y: (0, y)))


def out_of_domain_record() -> List[Violation]:
    """A GEMM-core launch at 17-bit act mantissas (which only the generic
    route takes: the core's act tile holds int16) built from the core's
    geometry without the wrapper's ``matmul_route``: it reaches a
    record."""
    from repro_torch.kernels import mxint_matmul as mm
    from repro_torch.kernels.launch_record import emit

    def unchecked():
        geom = mm.gemm_geometry(64, 768, 3072, LC.H100_SMS, wide=True)
        emit(mm.gemm_launch("mxint_matmul", geom, 64, 768, 3072, 16, 17, ()))
    return LC.check_domain("fixture", "mxint_matmul", unchecked)


def float_softmax_in_kernel_trace() -> List[Violation]:
    """A hand-rolled float softmax traced under kernel-mode rules: a rank-2
    exp, the max-exp-sum chain, and no softmax kernel call."""
    x = torch.zeros(8, 16)

    def softmax():
        e = (x - x.amax(dim=-1, keepdim=True)).exp()
        return e / e.sum(dim=-1, keepdim=True)

    rules = TraceRules(deny_outside_kernels=KERNEL_NL_DENY,
                       forbid_softmax_chain=True,
                       kernel_calls={"mxint_softmax": 1})
    return check_fn(softmax, rules, "fixture:float-softmax", device="cpu")


def f64_leak() -> List[Violation]:
    """A float64 round trip outside every allowed extent."""
    x = torch.zeros(4, 4)
    return check_fn(lambda: (x.double() * 2.0).float(), TraceRules(),
                    "fixture:f64-leak", device="cpu")


def raw_neg_inf_literal() -> List[Violation]:
    return check_source("MASK_VALUE = -2.0e" "38\n",
                        "src/repro_torch/models/bad_sentinel.py")


def exp_in_models() -> List[Violation]:
    return check_source("import torch\n"
                        "def f(x):\n"
                        "    return torch.exp(x)\n",
                        "src/repro_torch/models/bad_exp.py")


def adhoc_timing_in_src() -> List[Violation]:
    return check_source("import time\n"
                        "def f(fn):\n"
                        "    t0 = time.perf_counter()\n"
                        "    fn()\n"
                        "    return time.perf_counter() - t0\n",
                        "src/repro_torch/serving/bad_timing.py")


def kernel_fallback() -> List[Violation]:
    """A wrapper that swallows a failed launch and runs its plain
    version."""
    return check_source("def op(x):\n"
                        "    try:\n"
                        "        return launch(x)\n"
                        "    except RuntimeError:\n"
                        "        return softmax_rows(x)\n",
                        "src/repro_torch/kernels/bad_fallback.py")


def jax_import() -> List[Violation]:
    return check_source("import jax.numpy as jnp\n",
                        "src/repro_torch/models/bad_import.py")


def mode_branch_outside_seam() -> List[Violation]:
    """A models/ helper branching on the mode string and walking the
    override pairs by hand, both of which belong to the seam."""
    bad = ("def pick_backend(q, scope):\n"
           "    for pattern, ov in getattr(q, 'over" "rides'):\n"
           "        if q.mo" "de == 'kernel':\n"
           "            return ov\n")
    return dispatch.check_text(bad, "src/repro_torch/models/bad_scoping.py")


def cost_model_regression() -> List[Violation]:
    """The table against a baseline whose bytes are 10% smaller: every row
    regresses past the 2% threshold."""
    from repro_torch.analysis.cost_model import (build_table,
                                                 compare_to_baseline)
    rows = build_table()
    deflated = {"rows": {r["label"]: {"hbm_bytes": int(r["hbm_bytes"] * 0.9)}
                         for r in rows}}
    return compare_to_baseline(rows, deflated)


FIXTURES: Dict[str, Callable[[], List[Violation]]] = {
    "smem-over-budget": smem_over_budget,
    "too-many-threads": too_many_threads,
    "grid-y-over-limit": grid_y_over_limit,
    "unaligned-vector-operand": unaligned_vector_operand,
    "uncovered-output-tile": uncovered_output_tile,
    "overlapping-output-tile": overlapping_output_tile,
    "out-of-domain-record": out_of_domain_record,
    "float-softmax-kernel-trace": float_softmax_in_kernel_trace,
    "f64-leak": f64_leak,
    "raw-neg-inf-literal": raw_neg_inf_literal,
    "exp-in-models": exp_in_models,
    "adhoc-timing-in-src": adhoc_timing_in_src,
    "kernel-fallback": kernel_fallback,
    "jax-import": jax_import,
    "mode-branch-outside-seam": mode_branch_outside_seam,
    "cost-model-regression": cost_model_regression,
}

# the rule each fixture must trip
FIXTURE_RULES: Dict[str, str] = {
    "smem-over-budget": "launch-contracts",
    "too-many-threads": "launch-contracts",
    "grid-y-over-limit": "launch-contracts",
    "unaligned-vector-operand": "launch-contracts",
    "uncovered-output-tile": "grid-coverage",
    "overlapping-output-tile": "grid-coverage",
    "out-of-domain-record": "launch-contracts",
    "float-softmax-kernel-trace": "trace-invariants",
    "f64-leak": "trace-invariants",
    "raw-neg-inf-literal": "neg-inf-literal",
    "exp-in-models": "models-float-nonlinear",
    "adhoc-timing-in-src": "no-adhoc-timing",
    "kernel-fallback": "no-kernel-fallback",
    "jax-import": "port-imports",
    "mode-branch-outside-seam": "dispatch-seam",
    "cost-model-regression": "cost-model",
}


def run_fixture(name: str) -> List[Violation]:
    """The error-severity findings of fixture ``name``."""
    return [v for v in FIXTURES[name]() if v.severity == ERROR]
