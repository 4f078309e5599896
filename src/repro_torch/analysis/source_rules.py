"""AST source rules over the port: the repository's own lint, which the
generic linters cannot know.  Counterpart of ``repro.analysis.
source_rules``.

Each rule can be waived for one line with::

    # repro-lint: allow[rule-name] <reason>

on that line or the line above it (the reference's syntax; the reason is
required by review, not by this tool).  ``port-imports`` cannot be waived
(``UNWAIVABLE``): no line of the port may import jax or the JAX package.

Files: ``src/repro_torch/``, ``chip_smoke.py`` and ``tests/test_torch_*.py``;
each rule scopes itself within them.

``neg-inf-literal``
    The masking sentinel has one definition,
    ``repro_torch.core.mx_types.NEG_INF`` (the Eq. 2-3 score quantization
    reads masked lanes bit for bit); any other float literal of its
    magnitude forks it.

``models-float-nonlinear``
    ``repro_torch/models/`` routes exp, softmax, GELU, SiLU, sigmoid and
    erf through the datapath seam (``L.softmax``, ``q.datapath.act``), so
    every backend keeps its numerics.  The float-by-design sites are
    listed in ``FLOAT_NONLINEAR_ALLOWED`` with their reasons; other
    single sites carry a suppression comment with theirs.

``no-adhoc-timing``
    A clock read in ``src/repro_torch/`` outside ``telemetry/`` bypasses
    the one metrics registry: durations go through ``telemetry.span``.
    The smoke script ``chip_smoke.py`` and the tests time freely, as the
    reference exempts its tools and tests.

``no-kernel-fallback``
    The port's counterpart of the reference's ``interpret-literal``: a
    ``try``/``except`` in ``repro_torch/kernels/`` whose handler runs a
    plain version (``*_rows``, ``attend_rows``, ``matmul_blocks``) or
    ends without raising.  On the card a quiet fallback is how a kernel
    stops being the thing under test.

``port-imports``
    Nothing under ``src/repro_torch/`` and no line of ``chip_smoke.py``
    imports ``jax`` or the JAX package ``repro``; only the parity tests
    import both.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.registry import Violation, register_rule
from repro_torch.core.mx_types import NEG_INF

SUPPRESS_TOKEN = "repro-lint: allow["

PORT = "src/repro_torch/"
NEG_INF_HOME = "src/repro_torch/core/mx_types.py"
MODELS_PREFIX = "src/repro_torch/models/"
TIMING_HOME_PREFIX = "src/repro_torch/telemetry/"
KERNELS_PREFIX = "src/repro_torch/kernels/"
DRIVER = "chip_smoke.py"

FLOAT_NONLINEAR_CALLS = frozenset({
    "torch.exp", "torch.softmax", "torch.sigmoid", "torch.erf",
    "torch.special.erf", "torch.special.expit",
    "F.softmax", "F.gelu", "F.silu", "F.sigmoid",
    "torch.nn.functional.softmax", "torch.nn.functional.gelu",
    "torch.nn.functional.silu", "torch.nn.functional.sigmoid"})
# ``x.exp()`` (Tensor.exp) is a float exp too, unless x names one of these
NON_TENSOR_EXP = frozenset({"math", "np", "numpy", "cmath"})

# (path suffix, enclosing function or None for the whole file, reason)
FLOAT_NONLINEAR_ALLOWED: Tuple[Tuple[str, Optional[str], str], ...] = (
    ("repro_torch/models/attention.py", "_q_chunked_attention",
     "the float backends' own online-softmax body, the counterpart of the "
     "reference's allowed _q_chunked_attention: the seam dispatches to it"),
    ("repro_torch/models/recurrent.py", None,
     "the recurrent families' float gate and decay algebra is their "
     "architectures' definition; their quantized seam is the datapath's "
     "linears, as in the reference"),
)

ADHOC_TIMING_CALLS = frozenset({
    "time.time", "time.perf_counter", "time.monotonic", "time.time_ns",
    "time.perf_counter_ns", "time.monotonic_ns", "perf_counter",
    "monotonic"})

# the plain versions a kernel wrapper must never fall back to
PLAIN_VERSIONS = frozenset({"attend_rows", "matmul_blocks"})

FOREIGN_IMPORTS = frozenset({"jax", "jaxlib", "repro"})

# the rules a suppression comment does not waive
UNWAIVABLE = frozenset({"port-imports"})


def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    token = f"{SUPPRESS_TOKEN}{rule}]"
    return any(1 <= ln <= len(lines) and token in lines[ln - 1]
               for ln in (lineno, lineno - 1))


def _dotted(node: ast.AST) -> Optional[str]:
    """The dotted name of a call target ('torch.exp'), if it is one."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_plain_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _dotted(node.func) or ""
    last = name.rsplit(".", 1)[-1]
    return last in PLAIN_VERSIONS or last.endswith("_rows")


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str, lines: Sequence[str],
                 suppressed: Optional[list]):
        self.relpath = relpath
        self.lines = lines
        self.violations: List[Violation] = []
        self.suppressed = suppressed
        self._funcs: List[str] = []
        self.in_port = relpath.startswith(PORT)

    def _flag(self, rule: str, node: ast.AST, message: str):
        v = Violation(rule, f"{self.relpath}:{node.lineno}", message)
        if rule not in UNWAIVABLE and \
                _suppressed(self.lines, node.lineno, rule):
            if self.suppressed is not None:
                self.suppressed.append(v)
        else:
            self.violations.append(v)

    def _allowed_float_site(self) -> bool:
        return any(self.relpath.endswith(suffix) and
                   (func is None or func in self._funcs)
                   for suffix, func, _ in FLOAT_NONLINEAR_ALLOWED)

    def visit_FunctionDef(self, node):
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Constant(self, node):
        if (isinstance(node.value, float)
                and abs(node.value) == abs(NEG_INF)
                and self.relpath != NEG_INF_HOME):
            self._flag("neg-inf-literal", node,
                       "raw masking-sentinel literal; import NEG_INF from "
                       "repro_torch.core.mx_types (one sentinel)")
        self.generic_visit(node)

    def visit_Call(self, node):
        name = _dotted(node.func)
        if self.relpath.startswith(MODELS_PREFIX) and \
                not self._allowed_float_site():
            tensor_exp = (isinstance(node.func, ast.Attribute)
                          and node.func.attr == "exp"
                          and (name or "").split(".")[0]
                          not in NON_TENSOR_EXP | {"torch"})
            if name in FLOAT_NONLINEAR_CALLS or tensor_exp:
                self._flag("models-float-nonlinear", node,
                           f"bare {name or 'Tensor.exp'} in models/ "
                           f"bypasses the datapath seam; route it through "
                           f"L.* / q.datapath")
        if (name in ADHOC_TIMING_CALLS and self.in_port
                and not self.relpath.startswith(TIMING_HOME_PREFIX)):
            self._flag("no-adhoc-timing", node,
                       f"ad-hoc {name}() in src/repro_torch/; durations "
                       f"go through telemetry.span")
        self.generic_visit(node)

    def visit_Try(self, node):
        if self.relpath.startswith(KERNELS_PREFIX):
            for h in node.handlers:
                calls = [n for b in h.body for n in ast.walk(b)
                         if _is_plain_call(n)]
                raises = any(isinstance(n, ast.Raise)
                             for b in h.body for n in ast.walk(b))
                if calls:
                    self._flag("no-kernel-fallback", h,
                               f"the handler runs the plain version "
                               f"{_dotted(calls[0].func)}: a kernel that "
                               f"fails must raise, not fall back")
                elif not raises:
                    self._flag("no-kernel-fallback", h,
                               "the handler ends without raising: a kernel "
                               "that fails must raise, not fall back")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    def _imports(self, node, modules):
        if not (self.in_port or self.relpath == DRIVER):
            return
        bad = sorted({m.split(".")[0] for m in modules} & FOREIGN_IMPORTS)
        if bad:
            self._flag("port-imports", node,
                       f"imports {', '.join(bad)}: the port runs without "
                       f"jax and the JAX package")

    def visit_Import(self, node):
        self._imports(node, [a.name for a in node.names])

    def visit_ImportFrom(self, node):
        if node.level == 0:
            self._imports(node, [node.module or ""])


def check_source(text: str, relpath: str,
                 suppressed: Optional[list] = None) -> List[Violation]:
    """The AST rules over one file's source; ``relpath`` is the
    repository-relative posix path the rules scope by.  Findings waived
    by a suppression comment go to ``suppressed`` when given."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Violation("source-rules", f"{relpath}:{e.lineno or 0}",
                          f"unparseable: {e.msg}")]
    v = _Visitor(relpath, text.splitlines(), suppressed)
    v.visit(tree)
    return v.violations


def scanned_files(root: Path) -> List[Path]:
    """The files the source rules read."""
    files = [p for p in sorted((root / "src" / "repro_torch").rglob("*.py"))
             if "__pycache__" not in p.parts]
    files += sorted((root / "tests").glob("test_torch_*.py"))
    if (root / DRIVER).exists():
        files.append(root / DRIVER)
    return files


def check_tree(root: Path, only: Optional[str] = None,
               suppressed: Optional[list] = None) -> List[Violation]:
    """Every file's findings (of rule ``only`` when given)."""
    out: List[Violation] = []
    for path in scanned_files(root):
        rel = path.relative_to(root).as_posix()
        out.extend(v for v in check_source(path.read_text(), rel, suppressed)
                   if only is None or v.rule == only)
    return out


@register_rule(
    "source-rules",
    "AST rules over the port: one NEG_INF sentinel, no bare float "
    "nonlinears in models/, no ad-hoc timing outside telemetry/, no "
    "kernel fallback, no jax or repro import")
def run(root: Path, device: str = "cuda") -> List[Violation]:
    return check_tree(Path(root))
