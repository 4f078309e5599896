"""repro_torch.analysis: the port's static checks and its Hopper cost
table.  Counterpart of ``repro.analysis``.

Importing the package registers every rule:

* ``source-rules`` (``source_rules``): AST rules over the port (one
  NEG_INF sentinel, no bare float nonlinears in models/, no ad-hoc
  timing, no kernel fallback, no jax or repro import);
* ``dispatch-seam`` (``dispatch``) and ``docs-links`` (``docs_links``):
  the counterparts of ``tools/check_dispatch.py`` and
  ``tools/check_docs.py``;
* ``launch-contracts`` (``launch_contracts``): every launch record of the
  sweep fits the H100, out-of-domain formats raise first;
* ``grid-coverage`` (``grid_coverage``): every output element written by
  exactly one CTA;
* ``trace-invariants`` (``trace_check``): what runs outside the kernels
  in kernel mode, and the kernel calls of each target;
* ``cost-model`` (``cost_model``): the cost table's bytes against a
  committed baseline, its shared memory against the launch records.

``fixtures`` holds a violating input for each rule.  Run them with
``python -m repro_torch.analysis`` (``--device cpu`` here; the default
is the card) or ``run_rules``.
"""
from repro_torch.analysis.registry import (ERROR, WARN, Rule, Violation,
                                           get_rule, register_rule,
                                           require_device, rules, run_rules)
from repro_torch.analysis import (cost_model, dispatch, docs_links,
                                  grid_coverage, launch_contracts,
                                  source_rules, trace_check)

cost_model._register()

__all__ = [
    "ERROR", "WARN", "Rule", "Violation", "get_rule", "register_rule",
    "require_device", "rules", "run_rules", "cost_model", "dispatch", "docs_links",
    "grid_coverage", "launch_contracts", "source_rules", "trace_check",
]
