"""Docs links of the port: every ``PERF.md`` and ``ROADMAP`` section that
``src/repro_torch/`` and ``chip_smoke.py`` cite exists, and the README
keeps the port's CPU test command.  Counterpart of ``tools/check_docs.py``,
as a registered rule.

A citation is "PERF.md" or "ROADMAP" (".md" optional) followed by a
section sign and a number; it resolves where the document has a heading
"## <number>." (any depth of at least two).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List

from repro_torch.analysis.registry import Violation, register_rule

CITE = re.compile(r"\b(PERF\.md|ROADMAP(?:\.md)?)\s+§(\d+)")
HEADING = re.compile(r"^##+\s+(\d+)\.", re.M)
PORT_TESTS = "python -m pytest tests/test_torch_*.py"


def _sections(path: Path) -> set:
    return set(HEADING.findall(path.read_text())) if path.exists() else set()


def check(root: Path) -> List[Violation]:
    docs = {"PERF.md": _sections(root / "PERF.md"),
            "ROADMAP": _sections(root / "ROADMAP.md")}
    files = [p for p in sorted((root / "src" / "repro_torch").rglob("*.py"))
             if "__pycache__" not in p.parts]
    files.append(root / "chip_smoke.py")
    out: List[Violation] = [
        Violation("docs-links", name, f"{name} is missing")
        for name in ("PERF.md", "ROADMAP.md") if not (root / name).exists()]
    for py in files:
        if not py.exists():
            continue
        rel = py.relative_to(root).as_posix()
        for i, line in enumerate(py.read_text().splitlines(), 1):
            for doc, sec in CITE.findall(line):
                key = "PERF.md" if doc.startswith("PERF") else "ROADMAP"
                if sec not in docs[key]:
                    out.append(Violation(
                        "docs-links", f"{rel}:{i}",
                        f"cites {doc} §{sec}, which has no section "
                        f"'{sec}.'"))
    readme = root / "README.md"
    if not readme.exists() or PORT_TESTS not in readme.read_text():
        out.append(Violation("docs-links", "README.md",
                             f"the README lost the port's CPU test command "
                             f"({PORT_TESTS!r})"))
    return out


@register_rule(
    "docs-links",
    "PERF.md and ROADMAP section citations in the port resolve; the README "
    "keeps the port's CPU test command")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    return check(Path(root))
