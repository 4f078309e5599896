"""The port's design-space exploration against the reference's.

``repro_torch.data.pipeline``, ``core.search`` and ``dse`` held against
``repro.data.pipeline``, ``repro.core.search`` and ``repro.dse`` on
DeiT-Micro in "sim" mode: the same seeded images, the same weights (the
reference's, converted), the same spaces.  Exact: batches, point keys and
their order, ``to_config``, the static cost fields (``weight_bits``,
``act_bits``, ``weight_bytes``, ``lut_entries``), accuracy (argmax
agreement), the greedy driver's point and trace, the Pareto front on
(accuracy, weight_bits).  Fidelity (cosine of the logits against the
float model) within ``FIDELITY_TOL``: the two packages' sim logits agree
bit for bit at DeiT-Micro (``tests/test_torch_backends.py``), but their
float references sum the float linears in another order (the port in
float64, rounded once), so the cosine may move in its last bits, and
where a dot passes 2^24 (12-bit acts) by one act-grid step.  Both
evaluators are built with ``kernel_rows=()``, so the reference's TPU cost
capture never runs; the Hopper cost table is tested on its own.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import deit as jdeit  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.mx_types import MXFormat as JMXFormat  # noqa: E402
from repro.core.mx_types import QuantConfig as JQuantConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro import dse as jdse  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.model_api import unwrap  # noqa: E402
from repro.telemetry import metrics as jmetrics  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import dse  # noqa: E402
from repro_torch.analysis import cost_model  # noqa: E402
from repro_torch.configs import deit  # noqa: E402
from repro_torch.core import luts, search  # noqa: E402
from repro_torch.core.mx_types import (MXFormat, QuantConfig,  # noqa: E402
                                       QuantOverride)
from repro_torch.core.quantize import (MXTensor, pack_weight,  # noqa: E402
                                       packed_bytes)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.dse import drivers, report  # noqa: E402
from repro_torch.dse.evaluate import Evaluator  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.telemetry import export, metrics, probes  # noqa: E402

# Measured |fidelity gap| at these seeds: at most 2.4e-7 at every point
# but one, (act 12 bits, block 16): 4.3e-5.  The source is the MXInt
# softmax's Eq. 19 row sum of 2^z in float32: the port adds it in the
# CUDA kernel's fixed lane order (``_ordered_sum``), the reference in
# ``jnp.sum``'s.  At 8-bit acts both orders gave the same sums here; the
# 12-bit aligned mantissas spread the terms' exponents 16x wider, a few
# rows' sums differ in the last bit, and the Eq. 20 divide moves a
# probability by one step of the 12-bit grid (the parity contract's "one
# moved step").  With ``jnp.sum`` put into the port's softmax the two
# agree bit for bit at 8 and 12 bits.  Accuracy stays equal.
FIDELITY_TOL = 5e-4
N_LAYERS = 1


@pytest.fixture(scope="module", autouse=True)
def jax_reference():
    """The reference on this jax: the renamed Pallas compiler params
    aliased, ``jnp.exp2`` exact on integer inputs; torch's transcendentals
    warmed on one element (the CPU build may compute them inexactly on a
    first multi-threaded call)."""
    orig = jnp.exp2

    def exact_exp2(x):
        x = jnp.asarray(x)
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return orig(x)
        fl = jnp.floor(x)
        exact = jnp.ldexp(jnp.ones_like(x),
                          jnp.clip(fl, -300, 300).astype(jnp.int32))
        return jnp.where(x == fl, exact, orig(x))

    for fn in (torch.exp, torch.sin, torch.cos, torch.log, torch.erf):
        fn(torch.ones(1, dtype=torch.float64))
        fn(torch.ones(1))
    mp = pytest.MonkeyPatch()
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
               raising=False)
    mp.setattr(jnp, "exp2", exact_exp2)
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # as in test_torch_lm.py
    yield
    torch.set_num_threads(threads)
    mp.undo()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_classes=10, batch=4, image_size=32, seed=0),
    dict(n_classes=1000, batch=3, image_size=16, seed=7, noise=0.1,
         outlier_channels=True, class_sep=0.3),
    dict(n_classes=10, batch=8, image_size=32, seed=1, shard_index=1,
         num_shards=2),
])
def test_batches_equal_bit_for_bit(kw):
    got = pipeline.SyntheticImageData(device="cpu", **kw)
    want = jpipe.SyntheticImageData(**kw)
    for _ in range(2):
        g, w = got.next_batch(), want.next_batch()
        np.testing.assert_array_equal(g["images"].numpy(),
                                      np.asarray(w["images"]))
        np.testing.assert_array_equal(g["labels"].numpy(),
                                      np.asarray(w["labels"]))
    assert got.state.to_dict() == want.state.to_dict()
    np.testing.assert_array_equal(got.batch_at(0)["images"].numpy(),
                                  np.asarray(want.batch_at(0)["images"]))
    assert pipeline.DataState.from_dict(want.state.to_dict()) == got.state
    assert got.next_batch()["images"].device.type == "cpu"


# ---------------------------------------------------------------------------
# spaces
# ---------------------------------------------------------------------------
def _spaces(mode="sim", kind="per_group"):
    """(port space, reference space) with the same base and groups."""
    def build(QC, Fmt, GS, SS):
        base = QC(mode=mode, quantize_nonlinear=True,
                  weight_fmt=Fmt(8, 256), act_fmt=Fmt(8, 16))
        if kind == "per_group":
            groups = (GS(scope="block/*/attn", weight_mant_bits=(8, 4, 3)),
                      GS(scope="block/*/ffn", weight_mant_bits=(8, 3)))
        elif kind == "act":
            groups = (GS(scope="*", act_mant_bits=(8, 12),
                         act_block_size=(16, 32)),)
        else:
            groups = (GS(scope="block/0/*", weight_mant_bits=(8, 6),
                         mode=("sim", "fake"), ln_lut_bits=(5, 4)),
                      GS(scope="head", weight_block_size=(256, 32),
                         gelu_lut_bits=(5, 3), softmax_r_bits=(2, 3)))
        return SS(base=base, groups=groups)

    return (build(QuantConfig, MXFormat, dse.GroupSpace, dse.SearchSpace),
            build(JQuantConfig, JMXFormat, jdse.GroupSpace, jdse.SearchSpace))


def _cfg_fields(q):
    """A QuantConfig as plain data, overrides and all."""
    out = dict(q.describe())
    out["overrides"] = [(p, {f: getattr(ov, f) for f in (
        "mode", "quantize_nonlinear")} | {
        f: None if getattr(ov, f) is None else dataclasses.asdict(
            getattr(ov, f)) for f in ("weight_fmt", "act_fmt", "nonlinear")})
        for p, ov in getattr(q, "overrides")]
    return out


@pytest.mark.parametrize("kind", ["per_group", "act", "mixed_knobs"])
def test_points_keys_and_configs_equal(kind):
    sp, sj = _spaces(kind=kind)
    assert sp.size() == sj.size()
    assert sp.describe() == sj.describe()
    pp, pj = list(sp.points()), list(sj.points())
    assert [dse.point_key(p) for p in pp] == [jdse.point_key(p) for p in pj]
    for p in pp:
        assert _cfg_fields(sp.to_config(p)) == _cfg_fields(sj.to_config(p))
    assert sp.baseline_point() == sj.baseline_point()
    assert sp.to_config(sp.baseline_point()) is sp.base
    rp, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(5):
        a, b = sp.random_point(rp), sj.random_point(rj)
        assert a == b
        assert sp.mutate(a, rp) == sj.mutate(b, rj)


def test_space_validation_matches_reference():
    for make in (lambda m: m.GroupSpace(scope="x", weight_mant_bits=(8, 8)),
                 lambda m: m.GroupSpace(scope="", weight_mant_bits=(8,))):
        with pytest.raises(ValueError):
            make(dse)
        with pytest.raises(ValueError):
            make(jdse)
    with pytest.raises(ValueError, match="override-free"):
        sp, _ = _spaces()
        dse.SearchSpace(base=sp.to_config(list(sp.points())[-1]),
                        groups=sp.groups)


# ---------------------------------------------------------------------------
# evaluators and drivers on DeiT-Micro, sim
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def micro():
    """(port model config, port params, reference config, reference
    params, calibration images as numpy): the reference's weights,
    converted; 8 images of the seeded synthetic stream."""
    jcfg = dataclasses.replace(jdeit.DEIT_MICRO, n_layers=N_LAYERS)
    jp = build_model(jcfg).init(jax.random.key(0))
    arrays = jax.tree_util.tree_map(np.asarray, unwrap(jp))
    cfg = dataclasses.replace(deit.DEIT_MICRO, n_layers=N_LAYERS)
    params = convert.vit_params(ViT(cfg), arrays, device="cpu")
    imgs = pipeline.SyntheticImageData(n_classes=10, batch=8, image_size=32,
                                       seed=0, device="cpu")
    images = imgs.next_batch()["images"].numpy()
    return cfg, params, jcfg, jp, images


class _JitEvaluator(jdse.Evaluator):
    """The reference's evaluator with its forward jitted, as the other
    parity tests run the reference's models (eagerly, each candidate
    retraces the model's pieces: about 3.5 s a candidate here)."""

    def _logits(self, q):
        model = build_model(dataclasses.replace(self.cfg, quant=q))
        return jax.jit(model.logits)(self.params, self.images)


def _evaluators(micro, kind):
    cfg, params, jcfg, jp, images = micro
    sp, sj = _spaces(kind=kind)
    ev = Evaluator(sp, cfg, params, images, kernel_rows=(),
                   registry=metrics.Registry(), device="cpu")
    jev = _JitEvaluator(sj, jcfg, jp, jnp.asarray(images), kernel_rows=(),
                        registry=jmetrics.Registry())
    return sp, sj, ev, jev


def _same_result(r, jr):
    assert r.key == jr.key
    for f in ("weight_bits", "act_bits", "weight_bytes", "lut_entries"):
        assert getattr(r.cost, f) == getattr(jr.cost, f), f
    assert r.accuracy == jr.accuracy
    assert abs(r.fidelity - jr.fidelity) <= FIDELITY_TOL


@pytest.mark.parametrize("kind", ["per_group", "act"])
def test_dse_parity(micro, kind):
    """Exhaustive over the space (6 and 4 points), then the greedy driver
    on the same evaluators (served from their caches where it revisits),
    then the Pareto fronts."""
    sp, sj, ev, jev = _evaluators(micro, kind)
    got = drivers.exhaustive_search(sp, ev)
    want = jdse.exhaustive_search(sj, jev)
    for r, jr in zip(got, want, strict=True):
        _same_result(r, jr)
    obj = report.DEFAULT_OBJECTIVES[:2]           # accuracy, weight_bits
    assert report.pareto_front(got, obj) == \
        jdse.pareto_front(want, jdse.DEFAULT_OBJECTIVES[:2])
    assert jdse.report.DEFAULT_OBJECTIVES[:2][1][0] == "weight_bits"
    if kind == "per_group":
        g = drivers.greedy_search(sp, ev, budget=0.01)
        jg = jdse.greedy_search(sj, jev, budget=0.01)
        assert g.point == jg.point and g.bits == jg.bits
        assert [t[:2] + t[3:] for t in g.trace] == \
            [t[:2] + t[3:] for t in jg.trace]
        assert g.metric == jg.metric
        assert ev.n_evaluated == jev.n_evaluated
    rep = report.build_report(sp, got, driver="exhaustive",
                              n_evaluations=ev.n_evaluated)
    jrep = jdse.build_report(sj, want, driver="exhaustive",
                             n_evaluations=jev.n_evaluated)
    blob = json.loads(json.dumps(rep))
    assert blob["schema"] == jrep["schema"] == 1
    assert set(blob) == set(jrep)
    assert blob["pareto"] == jrep["pareto"]
    assert set(blob["candidates"][0]["cost"]) == \
        set(jrep["candidates"][0]["cost"]) - {"kernel_vmem_bytes"} | \
        {"kernel_smem_bytes"}


def test_evaluator_counters_and_weight_groups(micro):
    cfg, params, jcfg, jp, images = micro
    sp, sj, ev, jev = _evaluators(micro, "per_group")
    assert dse.weight_groups(cfg, params) == jdse.weight_groups(jcfg, jp)
    p = sp.baseline_point()
    assert ev(p) is ev(p)
    assert ev.registry.counter("dse/evaluations").value == 1
    assert ev.registry.counter("dse/cache_hits").value == 1
    ev.logits_for(p)
    assert ev.registry.counter("dse/evaluations").value == 1
    assert ev.registry.histogram("span/dse/eval/ms").count == 1


def test_kernel_candidates_pack_once_per_evaluation(micro, monkeypatch):
    """A kernel-mode candidate's weights are packed once, each group in
    its scoped format, before the forward: the kernel backend then packs
    nothing per call, and the logits are those of the per-call packing,
    bit for bit.  A sim-mode group keeps its float weights."""
    cfg, params, _, _, images = micro
    from repro_torch.core.mx_types import QuantOverride
    from repro_torch.datapath import hopper_kernel
    q = QuantConfig(mode="kernel", quantize_nonlinear=True,
                    weight_fmt=MXFormat(8, 256),
                    overrides=(("block/*/attn",
                                QuantOverride(weight_fmt=MXFormat(4, 256))),
                               ("block/0/ffn", QuantOverride(mode="sim"))))
    sp, _ = _spaces(mode="kernel")
    ev = Evaluator(sp, cfg, params, images, kernel_rows=(),
                   registry=metrics.Registry(), device="cpu")
    packed = ev._params_for(q)
    wq = packed["blocks"]["attn"]["wq"].value
    assert isinstance(wq[0], MXTensor) and wq[0].mant_bits == 4
    wi = packed["blocks"]["ffn"]["wi"].value
    assert isinstance(wi[0], torch.Tensor)            # block/0/ffn: sim
    for leaf in (packed["patch_proj"].value, packed["head"].value):
        assert isinstance(leaf, MXTensor) and leaf.mant_bits == 8
    want = ViT(dataclasses.replace(cfg, quant=q)).logits(
        params, torch.from_numpy(images))
    calls = []
    orig = hopper_kernel.pack_weight
    monkeypatch.setattr(hopper_kernel, "pack_weight",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = ev._logits(q)
    assert calls == []
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# core.search, sizes
# ---------------------------------------------------------------------------
def _toy(bits_to_logits_pkg):
    """A deterministic apply function: logits whose argmax flips as a
    group's bits drop (the 'attn' group tolerates down to 5 bits, 'ffn'
    to 7)."""
    base = np.random.default_rng(0).normal(size=(64, 10)).astype(np.float32)

    def apply(bits):
        noise = np.zeros_like(base)
        noise[:, 0] += 0.2 * max(0, 5 - bits["attn"])
        noise[:, 1] += 0.3 * max(0, 7 - bits["ffn"])
        return bits_to_logits_pkg(base + noise)
    return apply


@pytest.mark.parametrize("metric,budget", [("agreement", 0.01),
                                           ("agreement", 0.1),
                                           ("cosine", 1e-3)])
def test_greedy_bitwidth_search_equal(metric, budget):
    got = search.greedy_bitwidth_search(
        _toy(torch.from_numpy), ["attn", "ffn"], budget=budget,
        metric=metric)
    want = jsearch.greedy_bitwidth_search(
        _toy(jnp.asarray), ["attn", "ffn"], budget=budget, metric=metric)
    assert got.bits == want.bits and got.mean_bits == want.mean_bits
    assert [t[:2] + t[3:] for t in got.trace] == \
        [t[:2] + t[3:] for t in want.trace]
    np.testing.assert_allclose([t[2] for t in got.trace],
                               [t[2] for t in want.trace], atol=1e-6)
    with pytest.raises(ValueError):
        search.greedy_bitwidth_search(_toy(torch.from_numpy),
                                      ["attn", "ffn"], metric="bogus")


def test_search_proxies_equal():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(32, 10)).astype(np.float32) for _ in range(2))
    assert search.argmax_agreement(torch.from_numpy(a), torch.from_numpy(b)) \
        == jsearch.argmax_agreement(jnp.asarray(a), jnp.asarray(b))
    assert abs(search.cosine_fidelity(torch.from_numpy(a),
                                      torch.from_numpy(b))
               - jsearch.cosine_fidelity(jnp.asarray(a), jnp.asarray(b))) \
        <= 1e-6


def test_size_helpers_equal():
    from repro.core import luts as jluts
    from repro.core.quantize import pack_weight as jpack
    from repro.core.quantize import packed_bytes as jpacked
    w = np.random.default_rng(2).normal(size=(256, 48)).astype(np.float32)
    for fmt, jfmt in ((MXFormat(4, 32), JMXFormat(4, 32)),
                      (MXFormat(6, 256), JMXFormat(6, 256))):
        p, jp = pack_weight(torch.from_numpy(w), fmt), jpack(w, jfmt)
        assert p.nbytes_packed() == jp.nbytes_packed()
        tree = {"a": p, "b": [torch.zeros(3, 5)]}
        jtree = {"a": jp, "b": [jnp.zeros((3, 5))]}
        assert packed_bytes(tree) == jpacked(jtree)
        assert fmt.density_vs() == jfmt.density_vs()
        assert fmt.density_vs(16.0) == jfmt.density_vs(16.0)
    for e, vb in ((32, 16), (8, 8), (64, 12)):
        assert luts.table_bytes(e, vb) == jluts.table_bytes(e, vb)


# ---------------------------------------------------------------------------
# the Hopper cost table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("label,bound_ms,by", [
    ("deit-base-ffn-wo", 0.0214, "operations"),
    ("deit-base-ln2-wi", 0.0225, "operations"),
    ("deit-base-softmax", 0.0178, "bytes"),
    ("deit-base-gelu", 0.0231, "bytes"),
    ("deit-base-final-ln", 0.0058, "bytes"),
])
def test_cost_rows_reproduce_the_kernel_table_bounds(label, bound_ms, by):
    """PERF.md's kernel table (DeiT-Base, batch 16) at 4 digits."""
    row = cost_model.query([label])[label]
    assert round(row["bound_ms"], 4) == bound_ms and row["bound_by"] == by
    assert row["flops"] == row["int8_ops"] + row["bf16_ops"] + row["f32_ops"]
    assert row["hbm_bytes"] == sum(o["bytes_traffic"]
                                   for o in row["operands"])
    assert 0 < row["smem_bytes"] <= 232448


def test_cost_table_labels_and_forward():
    rows = cost_model.query()
    assert set(probes.PROBES) | set(cost_model.DEIT_BASE_LABELS) | \
        set(cost_model.WIDENED_LABELS) == set(rows)
    # DeiT-Base's 3 + 8 x 12 launches a forward
    assert sum(rows[k]["calls"] for k in cost_model.DEIT_BASE_LABELS) == 99
    with pytest.raises(KeyError, match="unknown cost-model labels"):
        cost_model.query(["nope"])
    # the act format moves the ordered sum and the int8 products
    a = cost_model.matmul_row("x", 64, 256, 128, w_block=256)
    b = cost_model.matmul_row("x", 64, 256, 128, w_block=256, act_block=32,
                              act_mant_bits=12)
    assert b["f32_ops"] * 2 == a["f32_ops"]
    assert b["int8_ops"] == 2 * a["int8_ops"]
    # the DSE scales the mantissa plane, and only it, by weight_bits / 8
    row = rows["deit-base-ffn-wo"]
    full = dse.evaluate._scaled_bytes(row, 1.0)
    assert full == row["hbm_bytes"]
    assert full - dse.evaluate._scaled_bytes(row, 0.5) == 3072 * 768 // 2
    # a forward: every row times its calls, each call site at its scope's
    # act format and weight bits
    q = QuantConfig(mode="kernel", weight_fmt=MXFormat(8, 256))
    bits = q.weight_fmt.bits_per_element
    flops, hbm, smem = dse.evaluate.kernel_cost(cost_model.DEIT_BASE_LABELS,
                                                q, bits)
    labels = cost_model.DEIT_BASE_LABELS
    assert flops == sum(rows[k]["calls"] * rows[k]["flops"] for k in labels)
    assert hbm == sum(rows[k]["calls"] * dse.evaluate._scaled_bytes(
        rows[k], bits / 8) for k in labels)
    assert smem == sum(rows[k]["smem_bytes"] for k in labels)
    wide = cost_model.query(labels, act_block=32, act_mant_bits=12)
    ffn = ("deit-base-ln2-wi", "deit-base-ffn-wo")
    q_ffn = QuantConfig(mode="kernel", weight_fmt=MXFormat(8, 256),
                        overrides=(("block/*/ffn", QuantOverride(
                            act_fmt=MXFormat(12, 32))),))
    got = dse.evaluate.kernel_cost(labels, q_ffn, bits)[0]
    assert got == flops + 12 * sum(wide[k]["flops"] - rows[k]["flops"]
                                   for k in ffn)
    assert got != flops


def test_predicted_vs_measured_joins_the_four_probes_on_the_cpu():
    reg = metrics.Registry()
    probes.run_probes(tuple(probes.PROBES), repeats=1, registry=reg,
                      device="cpu")
    got = export.predicted_vs_measured(reg.snapshot())
    assert [k["label"] for k in got["kernels"]] == sorted(probes.PROBES)
    assert got["unmatched"] == []
    for k in got["kernels"]:
        row = cost_model.query([k["label"]])[k["label"]]
        assert k["predicted_ms"] == round(row["bound_ms"], 6)
        assert k["bottleneck"] == {"bytes": "memory",
                                   "operations": "compute"}[row["bound_by"]]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_runs_on_the_cpu_and_refuses_a_missing_card(tmp_path,
                                                        monkeypatch):
    from repro_torch.dse.__main__ import main
    out = tmp_path / "r.json"
    rep = main(["--arch", "deit_micro", "--layers", "1", "--batch", "4",
                "--weight-bits", "8,4", "--device", "cpu", "--out",
                str(out)])
    assert rep["n_candidates"] == 2 and json.loads(out.read_text()) == \
        json.loads(json.dumps(rep))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "deit_micro", "--layers", "1", "--out",
              str(tmp_path / "x.json")])
