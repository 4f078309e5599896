"""repro_torch.dse: per-layer design-space exploration.

Counterpart of ``repro.dse``: search per-layer-group MXInt configurations
(mantissa widths, block sizes, backend choice, LUT widths) and emit
accuracy-proxy against hardware-cost Pareto fronts (the paper's Fig. 1b
curve and the Table V greedy search as two drivers over one space), with
the Hopper cost table as the static cost.

    space    SearchSpace / GroupSpace: the declarative knob grammar
    evaluate Evaluator: cached accuracy proxy + static cost scoring
    drivers  exhaustive / greedy / random / evolutionary
    report   Pareto extraction + the JSON report

Runnable: ``python -m repro_torch.dse`` (on the card; ``--device cpu``
runs the kernels' plain versions).
"""
from repro_torch.dse.drivers import (GreedyResult, evolutionary_search,
                                     exhaustive_search, greedy_search,
                                     random_search)
from repro_torch.dse.evaluate import (CandidateCost, EvalResult, Evaluator,
                                      measure_kernels, weight_groups)
from repro_torch.dse.report import (DEFAULT_OBJECTIVES, build_report,
                                    dominates, objective_vector,
                                    pareto_front, write_report)
from repro_torch.dse.space import GroupSpace, Knob, SearchSpace, point_key

__all__ = [
    "SearchSpace", "GroupSpace", "Knob", "point_key",
    "Evaluator", "EvalResult", "CandidateCost", "measure_kernels",
    "weight_groups",
    "exhaustive_search", "greedy_search", "random_search",
    "evolutionary_search", "GreedyResult",
    "dominates", "pareto_front", "objective_vector", "DEFAULT_OBJECTIVES",
    "build_report", "write_report",
]
