"""The port's static checks (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

The reference runs with the port tests' two scoped fixes for the
installed jax (the ``TPUCompilerParams`` alias and an exact ``exp2``).
Every comparison here is exact: rule names, kernel-call counts by kernel,
shapes, element counts.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import repro_torch.analysis as AN  # noqa: E402
from repro_torch.analysis import dispatch, docs_links  # noqa: E402
from repro_torch.analysis import grid_coverage as GC  # noqa: E402
from repro_torch.analysis import launch_contracts as LC  # noqa: E402
from repro_torch.analysis import source_rules as SR  # noqa: E402
from repro_torch.analysis import trace_check as TC  # noqa: E402
from repro_torch.analysis.__main__ import main as lint_main  # noqa: E402
from repro_torch.analysis.fixtures import (FIXTURE_RULES,  # noqa: E402
                                           FIXTURES, run_fixture)
from repro_torch.core.mx_types import (QuantConfig,  # noqa: E402
                                       QuantOverride)
from repro_torch.kernels import launch_fixture as LF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.launch_record import record_launches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the reference's Pallas kernel functions -> the port's kernel names
REF_KERNELS = {"_mxint_matmul_kernel": "mxint_matmul",
               "_mxint_ln_matmul_kernel": "mxint_ln_matmul",
               "_mxint_softmax_kernel": "mxint_softmax",
               "_mxint_gelu_kernel": "mxint_gelu",
               "_mxint_layernorm_kernel": "mxint_layernorm",
               "_flash_kernel": "flash_attention",
               "_decode_kernel": "flash_attention_decode"}


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """Run the reference on this jax: alias the renamed Pallas compiler
    params and make ``jnp.exp2`` exact on integer-valued inputs."""
    orig = jnp.exp2

    def exact_exp2(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return orig(x)
        fl = jnp.floor(x)
        exact = jnp.ldexp(jnp.ones_like(x),
                          jnp.clip(fl, -300, 300).astype(jnp.int32))
        return jnp.where(x == fl, exact, orig(x))

    mp = pytest.MonkeyPatch()
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
               raising=False)
    mp.setattr(jnp, "exp2", exact_exp2)
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


def _errors(vs):
    return [str(v) for v in vs if v.severity == AN.ERROR]


# ---------------------------------------------------------------------------
# the registry on the tree, and the runner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rule", [r.name for r in AN.rules()])
def test_rule_clean_on_tree(rule):
    assert _errors(AN.get_rule(rule).run(ROOT, device="cpu")) == []


def test_registry_holds_every_pass():
    assert {r.name for r in AN.rules()} == {
        "source-rules", "dispatch-seam", "docs-links", "launch-contracts",
        "grid-coverage", "trace-invariants", "cost-model"}
    with pytest.raises(ValueError):
        AN.register_rule("launch-contracts", "dup")(lambda root: [])


def test_cli_exits_zero_on_tree():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    assert "clean (7 rules, device cpu)" in r.stdout


def test_cli_fixture_exits_one_in_a_process():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--fixture", "smem-over-budget"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert r.returncode == 1 and "[launch-contracts]" in r.stderr, r.stderr


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint_main(["--only", "docs-links"])


def test_cli_list_and_json(capsys):
    assert lint_main(["--list"]) == 0
    listed = capsys.readouterr().out
    assert all(r.name in listed for r in AN.rules())
    assert lint_main(["--only", "cost-model", "--device", "cpu",
                      "--json"]) == 0
    import json
    payload = json.loads(capsys.readouterr().out)
    assert payload["errors"] == 0
    assert {r["label"] for r in payload["cost_model"]} >= {
        "matmul-deit", "flash-deit", "deit-base-ffn-wo"}


# ---------------------------------------------------------------------------
# the fixtures fire
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_fires(name):
    vs = run_fixture(name)
    assert vs, f"fixture {name!r} reported nothing: a dead rule"
    assert any(v.rule == FIXTURE_RULES[name] for v in vs), \
        (name, [v.rule for v in vs])


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cli_fixture_exits_one(name, capsys):
    assert lint_main(["--fixture", name]) == 1
    assert f"[{FIXTURE_RULES[name]}]" in capsys.readouterr().err


def test_launch_fixture_records_and_writes_nothing_on_the_cpu():
    before = ops.launch_counts()
    out = torch.full((32, 64), 7.0)
    rec = LF.launch_config((32, 64), (16, 64), threads=128, smem=1024)
    with record_launches() as recs:
        assert LF.launch_fixture(out, rec) is None
    assert recs == [rec] and bool((out == 7.0).all())
    assert ops.launch_counts() == before
    assert rec.grid == (2, 1, 1) and LC.check_record(rec) == []
    assert GC.check_coverage(rec) == []


def test_wrappers_record_only_launches():
    """On the CPU the plain versions run and no launch is recorded."""
    x = torch.randn(8, 64)
    with record_launches() as recs:
        ops.mxint_softmax_op(x)
        ops.mxint_gelu_op(x)
    assert recs == []


# ---------------------------------------------------------------------------
# source rules against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ref,port", [
    ("raw_neg_inf_literal", "raw-neg-inf-literal"),
    ("exp_in_models", "exp-in-models"),
    ("adhoc_timing_in_src", "adhoc-timing-in-src"),
    ("override_branch_outside_seam", "mode-branch-outside-seam"),
])
def test_source_fixtures_give_the_reference_rule_names(ref, port):
    from repro.analysis import fixtures as jfix
    want = {v.rule for v in getattr(jfix, ref)()}
    assert want and {v.rule for v in run_fixture(port)} == want


def test_the_same_texts_under_both_packages():
    """Each rule on the same source, in each package's spelling."""
    from repro.analysis import source_rules as JSR
    for jtext, ptext, sub in (
            ("import jax.numpy as jnp\nY = jnp.exp(1.0)\n",
             "import torch\nY = torch.exp(1.0)\n", "models/m.py"),
            ("import jax\ndef f(x):\n    return jax.nn.softmax(x)\n",
             "import torch\ndef f(x):\n    return torch.softmax(x, -1)\n",
             "models/m.py"),
            ("import jax\ndef f(x):\n    return jax.nn.silu(x)\n",
             "import torch.nn.functional as F\ndef f(x):\n"
             "    return F.silu(x)\n", "models/m.py"),
            ("import jax.numpy as jnp\ndef f(x):\n    return jnp.exp(x)\n",
             "import torch\ndef f(x):\n    return torch.exp(x)\n",
             "datapath/b.py"),
            ("NEG = -2.0e" "38\n", "NEG = -2.0e" "38\n", "kernels/k.py"),
            ("import time\nT = time.monotonic()\n",
             "import time\nT = time.monotonic()\n", "serving/s.py")):
        want = [v.rule for v in JSR.check_source(jtext, f"src/repro/{sub}")]
        got = [v.rule for v in SR.check_source(
            ptext, f"src/repro_torch/{sub}")]
        assert got == want, (sub, got, want)
    ok = "    # repro-lint: allow[models-float-nonlinear] a reason\n"
    text = "import torch\ndef f(x):\n" + ok + "    return torch.exp(x)\n"
    assert SR.check_source(text, "src/repro_torch/models/m.py") == []
    wrong = text.replace("models-float-nonlinear", "neg-inf-literal")
    assert SR.check_source(wrong, "src/repro_torch/models/m.py")


def test_trees_clean_with_the_same_suppressed_sites():
    """Each tree is clean under its own rules, and the float-nonlinear
    rule is waived at the same sites module by module: the MoE aux loss
    and the RoPE frequency ladder."""
    from repro.analysis import source_rules as JSR
    assert _errors(JSR.run(ROOT)) == []
    suppressed = []
    assert SR.check_tree(ROOT, suppressed=suppressed) == []
    port = sorted(Path(v.where.split(":")[0]).name for v in suppressed
                  if v.rule == "models-float-nonlinear")
    token = "repro-lint: allow[models-float-nonlinear]"
    ref = sorted(p.name for p in (ROOT / "src" / "repro" / "models").glob(
        "*.py") for line in p.read_text().splitlines() if token in line)
    assert port == ref == ["layers.py", "moe.py"]


def test_port_imports_rule_sees_each_spelling():
    for text in ("import jax\n", "import jax.numpy as jnp\n",
                 "from repro.core import luts\n", "import repro\n"):
        assert [v.rule for v in SR.check_source(
            text, "src/repro_torch/x.py")] == ["port-imports"]
    assert SR.check_source("from repro_torch import ops\n",
                           "src/repro_torch/x.py") == []
    assert SR.check_source("import jax\n", "tests/test_torch_x.py") == []


def test_port_imports_cannot_be_waived():
    """A suppression comment waives the other rules but not the port's
    imports."""
    waiver = "# repro-lint: allow[{}] reason\n"
    for text in ("import jax\n", "from repro.core import luts\n"):
        suppressed = []
        got = SR.check_source(waiver.format("port-imports") + text,
                              "src/repro_torch/x.py", suppressed)
        assert [v.rule for v in got] == ["port-imports"] and not suppressed
    suppressed = []
    assert SR.check_source(
        waiver.format("models-float-nonlinear") + "y = torch.exp(x)\n",
        "src/repro_torch/models/x.py", suppressed) == []
    assert [v.rule for v in suppressed] == ["models-float-nonlinear"]


def test_kernel_fallback_rule():
    swallow = ("def op(x):\n    try:\n        return go(x)\n"
               "    except RuntimeError:\n        return None\n")
    assert SR.check_source(swallow, "src/repro_torch/kernels/k.py")
    reraise = swallow.replace("return None", "raise")
    assert SR.check_source(reraise, "src/repro_torch/kernels/k.py") == []
    assert SR.check_source(swallow, "src/repro_torch/serving/s.py") == []


def test_docs_rule_resolves_citations(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "PERF.md").write_text("# P\n## 1. Purpose\n")
    (tmp_path / "ROADMAP.md").write_text("# R\n### 3. Faults\n")
    (tmp_path / "README.md").write_text(docs_links.PORT_TESTS + "\n")
    src = tmp_path / "src" / "repro_torch" / "m.py"
    src.write_text("# PERF.md §1 and ROADMAP §3\n")
    assert docs_links.check(tmp_path) == []
    src.write_text("# PERF.md §9\n")
    assert [v.where for v in docs_links.check(tmp_path)] == [
        "src/repro_torch/m.py:1"]
    (tmp_path / "README.md").write_text("nothing\n")
    assert len(docs_links.check(tmp_path)) == 2


def test_docs_rule_names_a_missing_document(tmp_path):
    """Without PERF.md every citation of it fails, and the rule says first
    that the document itself is missing."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "ROADMAP.md").write_text("# R\n## 3. Faults\n")
    (tmp_path / "README.md").write_text(docs_links.PORT_TESTS + "\n")
    (tmp_path / "src" / "repro_torch" / "m.py").write_text(
        "# PERF.md §4 and ROADMAP §3\n")
    got = [(v.where, v.message) for v in docs_links.check(tmp_path)]
    assert got[0] == ("PERF.md", "PERF.md is missing")
    assert [w for w, _ in got[1:]] == ["src/repro_torch/m.py:1"]


# ---------------------------------------------------------------------------
# the repair: the mode reads go through the seam
# ---------------------------------------------------------------------------
# the two reads of the parent tree (train/step.py, serving/engine.py),
# which the JAX package's line scan does not see
_OLD_TRAIN = ('def _modes(q) -> set:\n'
              '    return {getattr(q, "mode")} | {getattr(ov, "mode") or '
              'getattr(q, "mode")\n'
              '                                   for _, ov in getattr(q, '
              '"overrides")}\n')
_OLD_ENGINE = ('def f(self, q):\n'
               '    if self.tp > 1 and {getattr(q, "mode")} | {\n'
               '            getattr(ov, "mode") for _, ov in getattr(q, '
               '"overrides")\n'
               '            if getattr(ov, "mode")} != {"kernel"}:\n'
               '        raise ValueError("kernel")\n')


def test_dispatch_rule_sees_the_reads_the_repair_removed():
    assert len(dispatch.check_text(_OLD_TRAIN, "src/repro_torch/train/"
                                               "step.py")) == 4
    assert len(dispatch.check_text(_OLD_ENGINE, "src/repro_torch/serving/"
                                                "engine.py")) == 4
    assert dispatch.check_text(_OLD_TRAIN, "src/repro_torch/core/"
                                           "mx_types.py") == []
    assert dispatch.check(ROOT) == []


def test_modes_answers_what_the_call_sites_asked():
    q = QuantConfig(mode="kernel")
    assert q.modes() == {"kernel"}
    mixed = QuantConfig(mode="kernel", overrides=(
        ("block/*/ffn", QuantOverride(mode="sim")),
        ("head", QuantOverride(act_fmt=q.act_fmt))))
    assert mixed.modes() == {"kernel", "sim"}
    off = QuantConfig(mode="off", overrides=(
        ("block/0/*", QuantOverride(mode="kernel")),))
    assert off.modes() == {"off", "kernel"}


def test_refusals_unchanged():
    from repro_torch.configs import deit
    from repro_torch.models.vit import ViT
    from repro_torch.train.step import check_trainable
    for q in (QuantConfig(mode="kernel"),
              QuantConfig(mode="off", overrides=(
                  ("block/0/*", QuantOverride(mode="kernel")),))):
        with pytest.raises(ValueError, match="inference only"):
            check_trainable(ViT(dataclasses.replace(deit.DEIT_MICRO,
                                                    quant=q)))
    check_trainable(ViT(dataclasses.replace(
        deit.DEIT_MICRO, quant=QuantConfig(mode="sim"))))


# ---------------------------------------------------------------------------
# the trace check against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_pallas_calls():
    """label -> the reference target's pallas_call equations by kernel."""
    from repro.analysis import trace_lint as TL
    counts = {}

    def capture(fn, args, rules, label):
        jaxpr = jax.make_jaxpr(fn)(*args)
        c = {}
        for eqn in TL.iter_eqns(jaxpr.jaxpr):
            if eqn.primitive.name == "pallas_call":
                fn_name = eqn.params["jaxpr"].debug_info.func_src_info \
                    .split()[0]
                c[REF_KERNELS[fn_name]] = c.get(REF_KERNELS[fn_name], 0) + 1
        counts[label] = c
        return []

    mp = pytest.MonkeyPatch()
    mp.setattr(TL, "lint_fn", capture)
    try:
        for target in TL.TARGETS:
            target()
    finally:
        mp.undo()
    return counts


@pytest.fixture(scope="module")
def port_calls():
    return TC.target_calls("cpu")


def test_trace_targets_are_the_references(reference_pallas_calls,
                                          port_calls):
    assert set(port_calls) == set(reference_pallas_calls)


@pytest.mark.parametrize("label", [
    "deit-micro-forward[kernel]", "decode-step[kernel]",
    "slot-prefill+decode-step[kernel]"] + [
    f"{op}[{m}]" for op in ("softmax", "gelu", "layernorm")
    for m in ("off", "fake", "sim", "packed", "kernel")])
def test_kernel_calls_equal_reference_pallas_calls(
        label, reference_pallas_calls, port_calls):
    assert port_calls[label] == reference_pallas_calls[label]


def test_reference_budgets(reference_pallas_calls):
    total = {k: sum(v.values()) for k, v in reference_pallas_calls.items()}
    assert total["deit-micro-forward[kernel]"] == 11
    assert total["decode-step[kernel]"] == 5
    assert total["slot-prefill+decode-step[kernel]"] == 17


def test_trace_check_sees_a_float_path():
    """The kernel-mode rules flag a float softmax, a float64 product and
    a lost kernel call on a real backend op, and pass the kernel's own."""
    q = QuantConfig(mode="kernel", quantize_nonlinear=True)
    sim = QuantConfig(mode="sim", quantize_nonlinear=True)
    x = torch.randn(16, 32)
    rules = TC.TraceRules(deny_outside_kernels=TC.KERNEL_NL_DENY,
                          forbid_softmax_chain=True,
                          kernel_calls={"mxint_softmax": 1})
    assert TC.check_fn(lambda: q.datapath.softmax(x, q=q), rules, "k",
                       "cpu") == []
    got = TC.check_fn(lambda: torch.softmax(x, -1), rules, "f", "cpu")
    assert any("'_softmax'" in v.message for v in got)
    assert any("kernel calls" in v.message for v in got)
    got = TC.check_fn(lambda: sim.datapath.softmax(x, q=sim), rules, "s",
                      "cpu")
    assert any("kernel calls" in v.message for v in got)
    # the kernel's softmax followed by a float64 product of its output
    got = TC.check_fn(
        lambda: (q.datapath.softmax(x, q=q).double() @ x.double().T).float(),
        rules, "d", "cpu")
    assert [v.message for v in got if "float64 leak" in v.message] and \
        not [v for v in got if "float64" not in v.message]


def test_slot_target_holds_float64_to_its_extents(monkeypatch):
    """The slot prefill's float64 products are inside
    ``_q_chunked_attention``'s extent; without that entry the slot
    target's float64 check flags them."""
    (label, fn, rules), = TC.slot_step_target("cpu")
    assert rules.forbid_f64
    with torch.no_grad():
        assert TC.check_fn(fn, rules, label, "cpu") == []
        monkeypatch.delitem(
            TC.F64_ALLOWED,
            "repro_torch.models.attention:_q_chunked_attention")
        got = TC.check_fn(fn, rules, label, "cpu")
    assert [v for v in got if "float64 leak" in v.message], got


def test_entries_default_to_the_card():
    """Every entry point of the checks runs on the card unless the caller
    asks for the CPU, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for call in (lambda: AN.run_rules(ROOT, only=["docs-links"]),
                 TC.targets, TC.target_calls,
                 lambda: TC.run(ROOT),
                 lambda: TC.check_fn(lambda: None, TC.TraceRules(), "x")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# launch contracts against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_captures():
    from repro.analysis import kernel_contracts as KC
    return KC.sweep_captures(refresh=True)


def test_every_reference_capture_has_a_port_record(reference_captures):
    recs = {(r.label, r.kernel): r for r in LC.sweep_records()}
    assert len(reference_captures) == 11
    for cap in reference_captures:
        rec = recs[(cap.label, REF_KERNELS[cap.kernel])]
        # the port's logical shapes: the reference's without its padding
        ref_shapes = [u.shape for u in cap.inputs + cap.outputs]
        for op in rec.operands:
            assert any(len(s) == len(op.shape) and all(
                a <= b for a, b in zip(op.shape, s)) for s in ref_shapes) \
                or op.name in ("w_exp", "valid"), (cap.label, op)
        if cap.label.endswith("bench"):
            assert rec.operands[0].shape == cap.inputs[0].shape, cap.label


def test_every_sweep_record_meets_every_contract():
    recs = LC.sweep_records()
    assert len(recs) > 150
    assert {r.kernel for r in recs} == set(ops.SERVED_KERNELS)
    assert LC.check_records(recs) == []
    assert GC.check_records(recs) == []


@pytest.mark.parametrize("case", LC.domain_cases(), ids=lambda c: c[0])
def test_out_of_domain_format_raises_before_a_record(case):
    label, kernel, kw = case
    with record_launches() as recs:
        with pytest.raises(LC.DOMAIN_ERRORS):
            LC.record_launch(kernel, kw, label)
    assert recs == []


@pytest.mark.parametrize("case", LC.generic_cases(), ids=lambda c: c[0])
def test_widened_format_meets_every_contract(case):
    """The formats outside the fast routes before the generic routes (each
    raised in its wrapper then): each now records a launch that fits the
    H100 and covers its output once, and is in the sweep; those of
    ``CORE_SEGMENT_LABELS`` on the GEMM core's segment walk (V 3-4), the
    others on the generic routes."""
    label, kernel, kw = case
    with record_launches() as recs:
        rec = LC.record_launch(kernel, kw, label)
    assert recs == [rec]
    assert LC.check_record(rec) == [] and GC.check_coverage(rec) == []
    assert (label, kernel) in {(r.label, r.kernel)
                               for r in LC.sweep_records()}
    if label in LC.CORE_SEGMENT_LABELS:
        assert "generic" not in rec.function and (
            "V3" in rec.function or "V4" in rec.function), rec.function
        return
    route = "decode_kernel" if label == "decode-act-block-12" else "generic"
    assert route in rec.function, rec.function


@pytest.mark.parametrize("case", LC.segment_cases(), ids=lambda c: c[0])
def test_segment_walk_meets_every_contract(case):
    """The GEMM core's segment walk (int16 planes, act blocks that do not
    nest): each format records a core launch (V 3, or V 4 past 8 bits)
    that fits the H100, covers its output once by the core's tiles, and is
    in the sweep."""
    label, kernel, kw = case
    rec = LC.launch(kernel, kw, label)
    bits = kw.get("act_mant_bits", kw.get("mant_bits"))
    assert rec.function.endswith(f"V{4 if bits > 8 else 3}>"), rec.function
    assert LC.check_record(rec) == [] and GC.check_coverage(rec) == []
    np.testing.assert_array_equal(GC.dense_mask(rec),
                                  _gemm_mask(*rec.out_shape, rec))
    assert (label, kernel) in {(r.label, r.kernel)
                               for r in LC.sweep_records()}


def test_serving_sweep_covers_every_config():
    from repro_torch.configs import ARCH_IDS
    labels = {c[0].rsplit("-", 1)[0] for c in LC.serving_cases()}
    assert labels == set(ARCH_IDS) | {"deit_base"}


# ---------------------------------------------------------------------------
# coverage, element by element, against the kernels' loop order
# ---------------------------------------------------------------------------
def _gemm_mask(M, N, rec):
    # the C entries' geometry arguments: (bm, bn, n_per, ...), after the
    # LN stage's piece for the fused kernel
    g = rec.args[1:] if rec.kernel == "mxint_ln_matmul" else rec.args
    bm, bn, n_per = g[0], g[1], g[2]
    mask = np.zeros((M, N), np.int64)
    for x in range(rec.grid[0]):
        for y in range(rec.grid[1]):
            for j in range(n_per):
                t = y * n_per + j
                mask[x * bm:(x + 1) * bm, t * bn:(t + 1) * bn] += 1
    return mask


def _stride_mask(numel, width, threads, grid):
    mask = np.zeros(numel, np.int64)
    items = numel // width
    for b in range(grid):
        for t in range(threads):
            i = b * threads + t
            while i < items:
                mask[i * width:(i + 1) * width] += 1
                i += grid * threads
    return mask[None]


@pytest.mark.parametrize("M,N,K", [(17, 40, 64), (33, 200, 256),
                                   (4, 1000, 512), (100, 96, 128)])
def test_gemm_tiles_cover_the_output_once(M, N, K):
    from repro_torch.kernels import mxint_ln_matmul, mxint_matmul
    for rec in (mxint_matmul.launch_config(M, N, K, w_block=K,
                                           act_block=16, act_mant_bits=8,
                                           n_sm=8),
                mxint_ln_matmul.launch_config(M, N, K, w_block=K,
                                              act_block=16, mant_bits=8,
                                              lut_bits=5, n_sm=8)):
        want = _gemm_mask(M, N, rec)
        np.testing.assert_array_equal(GC.dense_mask(rec), want)
        assert (want == 1).all() and GC.check_coverage(rec) == []


@pytest.mark.parametrize("rows,d,block", [(37, 64, 16), (5, 48, 12),
                                          (70, 256, 4)])
def test_row_and_stride_tiles_cover_the_output_once(rows, d, block):
    from repro_torch.kernels import mxint_gelu, mxint_layernorm, \
        mxint_softmax
    ln = mxint_layernorm.launch_config(rows, d, act_block=block, lut_bits=5,
                                       n_sm=4)
    sm = mxint_softmax.launch_config(rows, d, act_block=block, r_bits=2)
    for rec, per in ((ln, ln.args[1]), (sm, 8)):
        want = np.zeros((rows, d), np.int64)
        for c in range(rec.grid[0]):             # CTA c: its rows whole
            want[c * per:(c + 1) * per] += 1
        np.testing.assert_array_equal(GC.dense_mask(rec), want)
        assert (want == 1).all()
    for n_sm in (1, 4):
        ge = mxint_gelu.launch_config(rows, d, act_block=block, lut_bits=5,
                                      domain=3.0, fn="gelu", n_sm=n_sm)
        width = 4 if ge.args[0] == 4 else block
        want = _stride_mask(rows * d, width, ge.threads, ge.grid[0])
        np.testing.assert_array_equal(GC.dense_mask(ge), want)
        assert (want == 1).all() and GC.check_coverage(ge) == []


@pytest.mark.parametrize("b,hkv,g,d", [(2, 2, 8, 128), (1, 3, 10, 64),
                                       (4, 1, 3, 256)])
def test_decode_tiles_cover_the_output_once(b, hkv, g, d):
    from repro_torch.kernels import flash_attention as F
    rec = F.decode_launch_config(b, hkv, g, 256, d, n_sm=132)
    rows, cols = rec.args
    n_split = -(-d // cols)
    row_blocks = -(-g // rows)
    want = np.zeros((b * hkv * g, d), np.int64)
    for blk in range(rec.grid[0]):               # the kernel's decoding
        sl, rest = blk % n_split, blk // n_split
        r0, prob = (rest % row_blocks) * rows, rest // row_blocks
        r1 = min(g, r0 + rows)
        want[prob * g + r0:prob * g + r1, sl * cols:(sl + 1) * cols] += 1
    np.testing.assert_array_equal(GC.dense_mask(rec), want)
    assert (want == 1).all()


@pytest.mark.parametrize("dtype,groups,d", [(torch.bfloat16, 4, 128),
                                           (torch.bfloat16, 5, 256),
                                           (torch.float32, 3, 64)])
def test_flash_tiles_cover_the_output_once(dtype, groups, d):
    from repro_torch.kernels import flash_attention as F
    bh, sq = 2 * groups, 300
    rec = F.launch_config(bh, sq, sq, d, kv_groups=groups, dtype=dtype)
    want = np.zeros((bh * sq, d), np.int64)
    for x in range(rec.grid[0]):
        for y in range(rec.grid[1]):
            if dtype == torch.float32:           # head y, 32 positions
                want[y * sq + x * 32:y * sq + min(sq, x * 32 + 32)] += 1
                continue
            per = (64 if d > 128 else 128) // groups
            p0 = (rec.grid[1] - 1 - y) * per
            for h in range(x * groups, (x + 1) * groups):
                want[h * sq + p0:h * sq + min(sq, p0 + per)] += 1
    np.testing.assert_array_equal(GC.dense_mask(rec), want)
    assert (want == 1).all()


@pytest.mark.parametrize("case", LC.generic_cases() + LC.wide_format_cases(),
                         ids=lambda c: c[0])
def test_generic_route_tiles_cover_the_output_once(case):
    """The generic routes' loop orders, element by element: the GEMM's CTA
    (x, y) writes rows [x bm, (x + 1) bm) by columns [128 y, 128 y + 128);
    the row kernels' CTA c rows [8 c, 8 c + 8) (GELU: the scalar route's
    grid-stride walk); the flash kernel's CTA (x, head y) positions
    [w x, w x + w) of head y, the decode kernel's CTA x rows [w x, w x +
    w) of (B, Hkv, G).  The formats the GEMM core now takes by segment
    (``CORE_SEGMENT_LABELS``) are held to the core's tiles."""
    label, kernel, kw = case
    rec = LC.launch(kernel, kw, label)
    rows, cols = rec.out_shape
    if label in LC.CORE_SEGMENT_LABELS:
        want = _gemm_mask(rows, cols, rec)
    elif kernel == "mxint_gelu":
        want = _stride_mask(rows * cols, kw["act_block"], rec.threads,
                            rec.grid[0])
    else:
        want = np.zeros((rows, cols), np.int64)
        per = rec.args[0] if kernel.startswith(("mxint_matmul",
                                                "mxint_ln", "flash")) else 8
        span = rows // rec.grid[1] if kernel == "flash_attention" else rows
        for x in range(rec.grid[0]):
            for y in range(rec.grid[1]):
                if kernel.startswith(("mxint_matmul", "mxint_ln_matmul")):
                    want[x * per:(x + 1) * per, y * 128:(y + 1) * 128] += 1
                else:
                    r0 = y * span + x * per
                    want[r0:min(y * span + span, r0 + per)] += 1
    np.testing.assert_array_equal(GC.dense_mask(rec), want)
    assert (want == 1).all()


# ---------------------------------------------------------------------------
# the cost table against its baseline and the launch records
# ---------------------------------------------------------------------------
def test_cost_table_matches_its_baseline_and_the_records():
    from repro_torch.analysis import cost_model as CM
    rows = CM.build_table()
    assert CM.cross_check(rows) == []
    import json
    base = json.loads(CM.BASELINE.read_text())
    assert set(base["rows"]) == {r["label"] for r in rows}
    assert CM.compare_to_baseline(rows, base) == []
    for row in rows:
        assert CM.row_launch(row).kernel == row["kernel"]


def test_recorders_nest():
    """An inner recorder (the domain checks inside a recorded run) leaves
    the outer one active, and both see the inner launches."""
    rec = LF.launch_config((16, 16), (16, 16))
    with record_launches() as outer:
        with record_launches() as inner:
            LF.launch_fixture(torch.empty(16, 16), rec)
        with record_launches():
            pass
        LF.launch_fixture(torch.empty(16, 16), rec)
    assert inner == [rec] and outer == [rec, rec]
