"""The dispatch seam of the port: only ``repro_torch/datapath/`` and
``repro_torch/core/mx_types.py`` read a config's execution mode or its
per-layer overrides.  Counterpart of ``tools/check_dispatch.py``, as a
registered rule.

Everything else asks the seam: ``q.datapath`` for the backend,
``q.scoped(scope)`` for a layer group's config, ``q.modes()`` for the
modes a config can resolve to, ``q.has_overrides`` for whether it has
any.  The rule walks the AST of ``src/repro_torch/`` and flags any
attribute read named ``mode`` or ``overrides`` (``q`` then a dot then the
name; whatever the object, since nothing outside the seam has a reason to
read either) and any ``getattr(x, "mode")`` / ``getattr(x, "overrides")``,
the spelling the JAX package's line scan does not see.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List

from repro_torch.analysis.registry import Violation, register_rule

SEAM = ("src/repro_torch/datapath/", "src/repro_torch/core/mx_types.py")
SEAM_ATTRS = frozenset({"mode", "overrides"})


def check_text(text: str, relpath: str) -> List[Violation]:
    """The seam reads in one file's source (``relpath`` repository-
    relative)."""
    if any(relpath.startswith(s) for s in SEAM):
        return []
    out = []
    for node in ast.walk(ast.parse(text)):
        name = None
        if isinstance(node, ast.Attribute) and node.attr in SEAM_ATTRS:
            name = node.attr
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id in ("getattr", "hasattr")
              and len(node.args) >= 2
              and isinstance(node.args[1], ast.Constant)
              and node.args[1].value in SEAM_ATTRS):
            name = node.args[1].value
        if name is not None:
            what = "execution mode" if name == "mode" else \
                "per-layer overrides"
            out.append(Violation(
                "dispatch-seam", f"{relpath}:{node.lineno}",
                f"reads the {what} ({name!r}) outside the seam: ask "
                f"q.datapath, q.scoped(scope) or q.modes() instead"))
    return out


def check(root: Path) -> List[Violation]:
    out: List[Violation] = []
    for py in sorted((root / "src" / "repro_torch").rglob("*.py")):
        if "__pycache__" in py.parts:
            continue
        out.extend(check_text(py.read_text(),
                              py.relative_to(root).as_posix()))
    return out


@register_rule(
    "dispatch-seam",
    "no read of the execution mode or the overrides outside "
    "repro_torch/datapath/ and repro_torch/core/mx_types.py")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    return check(Path(root))
