"""Rule registry for the port's static checks.

A copy of ``repro.analysis.registry`` (the port imports nothing of the
JAX package): every pass registers named ``Rule`` objects, and the runner
(``python -m repro_torch.analysis``) and the tests
(``tests/test_torch_analysis.py``) iterate the registry rather than a
hard-coded list of passes.

Severity: ``error`` violations fail the run; ``warn`` violations are
printed but do not change the exit code.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ERROR = "error"
WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding.  ``where`` is ``path:line`` for the source rules and a
    target or launch label for the others."""

    rule: str
    where: str
    message: str
    severity: str = ERROR

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered pass.  ``run(root, device)`` gets the repository root
    and the device the dynamic passes run on ("cuda", the default, or
    "cpu", where the kernels' plain versions run) and returns its
    violations (empty: clean).  Rules have no side effects and run in any
    order."""

    name: str
    description: str
    run: Callable[..., List[Violation]]


_RULES: Dict[str, Rule] = {}


def register_rule(name: str, description: str):
    """Decorator: register ``fn(root, device="cuda") -> list[Violation]``
    under ``name``."""

    def deco(fn):
        if name in _RULES:
            raise ValueError(f"duplicate analysis rule {name!r}")
        _RULES[name] = Rule(name=name, description=description, run=fn)
        return fn

    return deco


def rules() -> Tuple[Rule, ...]:
    return tuple(_RULES.values())


def get_rule(name: str) -> Rule:
    return _RULES[name]


def require_device(device: str) -> None:
    """Refuse a device the dynamic passes cannot run on: ``cuda`` needs a
    card (the passes never fall back to the CPU), ``cpu`` runs the
    kernels' plain versions."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda': no CUDA device (pass "
                               "device 'cpu' to run the plain versions)")


def run_rules(root: Path, only: Optional[List[str]] = None,
              skip: Tuple[str, ...] = (),
              device: str = "cuda") -> List[Violation]:
    """Run the selected rules over ``root`` on ``device`` (the card by
    default; raises without one) and pool their violations."""
    require_device(device)
    out: List[Violation] = []
    for rule in rules():
        if only is not None and rule.name not in only:
            continue
        if rule.name in skip:
            continue
        out.extend(rule.run(Path(root), device=device))
    return out
