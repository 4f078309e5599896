"""The port's telemetry (``repro_torch.telemetry``) against the reference's
(``repro.telemetry``), and the serving stack's records on the CPU.

The same seeded record sequence goes into a reference ``Registry`` and the
port's: snapshots, Prometheus text, JSON payloads and join reports must be
identical.  The reference's unit cases run against the port's registry;
its jit-safety case becomes the refusal of a CUDA tensor (a stand-in whose
``device.type`` is "cuda": no card needed).  The scheduler cases follow
the seeded streams of ``tests/test_scheduler_properties.py`` on the SMOKE
Llama-3 in kernel mode: on the CPU the kernels' plain versions run, so
every ``kernel/launches/*`` counter stays 0.
"""
import ast
import dataclasses
import json
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import export as jexport  # noqa: E402
from repro.telemetry.metrics import Registry as JRegistry  # noqa: E402
from repro_torch import telemetry as T  # noqa: E402
from repro_torch.configs import deit, llama3_8b  # noqa: E402
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.vit import ViT  # noqa: E402
from repro_torch.serving.engine import (ServeConfig,  # noqa: E402
                                        ServingEngine, ViTServingEngine)
from repro_torch.serving.scheduler import (BatchScheduler,  # noqa: E402
                                           ClassifyRequest,
                                           ClassifyScheduler, Request)
from repro_torch.telemetry import export, probes  # noqa: E402
from repro_torch.telemetry.export import (json_snapshot,  # noqa: E402
                                          predicted_vs_measured,
                                          prometheus_text)
from repro_torch.telemetry.metrics import Registry  # noqa: E402
from repro_torch.telemetry.tracing import (current_span, span,  # noqa: E402
                                           span_stats)

KERNEL = QuantConfig(mode="kernel", quantize_nonlinear=True)
TELEMETRY = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "telemetry"
KERNELS = ("mxint_matmul", "mxint_ln_matmul", "mxint_softmax", "mxint_gelu",
           "mxint_layernorm", "flash_attention", "flash_attention_decode")


@pytest.fixture
def reg():
    return Registry()


class CudaStandIn:
    """Duck-types a CUDA tensor: reading it would sync the device."""
    device = types.SimpleNamespace(type="cuda")

    def __float__(self):
        raise AssertionError("read a CUDA value")


# ---------------------------------------------------------------------------
# the same records in both packages
# ---------------------------------------------------------------------------
def _record(reg, seed):
    """A seeded sequence of counter, gauge and histogram records, with
    names the Prometheus writer must rewrite and kernel spans to join."""
    rng = np.random.default_rng(seed)
    names = ("req/total", "q depth", "a/b-c.d", "scheduler/submitted")
    for _ in range(200):
        op, name = rng.integers(5), names[rng.integers(len(names))]
        if op == 0:
            reg.counter(name).inc(int(rng.integers(0, 5)))
        elif op == 1:
            reg.gauge(name).set(float(rng.normal() * 10))
        elif op == 2:
            reg.gauge(name).add(int(rng.integers(-3, 4)))
        elif op == 3:
            reg.histogram("lat " + name, (1.0, 10.0, 100.0)).record(
                float(rng.exponential(20.0)))
        else:
            reg.histogram("size/" + name, T.DEFAULT_SIZE_BUCKETS).record(
                int(rng.integers(1, 5000)))
    for label in ("matmul-deit", "flash-deit", "mystery"):
        h = reg.histogram(f"span/kernel:{label}/ms", T.DEFAULT_MS_BUCKETS)
        for _ in range(int(rng.integers(1, 4))):
            h.record(float(rng.uniform(0.01, 3.0)))
    reg.histogram("span/kernel:idle/ms", T.DEFAULT_MS_BUCKETS)


ROWS = [{"label": "matmul-deit", "kernel": "mxint_matmul",
         "flops": 2 * 394 * 192 * 192,
         "hbm_bytes": 394 * 192 * 4 + 192 * 192 + 6 * 192 + 394 * 192 * 4,
         "intensity": 7.9},
        {"label": "flash-deit", "kernel": "flash_attention",
         "flops": 4 * 6 * 197 * 197 * 64, "hbm_bytes": 4 * 6 * 197 * 64 * 4,
         "intensity": 24.6}]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_records_same_exports_as_reference(seed, tmp_path):
    ref, port = JRegistry(), Registry()
    _record(ref, seed)
    _record(port, seed)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert prometheus_text(snap) == jexport.prometheus_text(ref.snapshot())
    extra = {"tag": f"seed{seed}"}
    assert json_snapshot(snap, path=tmp_path / "port.json", extra=extra) == \
        jexport.json_snapshot(ref.snapshot(), path=tmp_path / "ref.json",
                              extra=extra)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    peaks = dict(flops_per_s=1e12, hbm_bytes_per_s=1e11, name="hand-made")
    got = predicted_vs_measured(snap, ROWS,
                                peaks=export.RooflinePeaks(**peaks))
    want = jexport.predicted_vs_measured(
        ref.snapshot(), ROWS, peaks=jexport.RooflinePeaks(**peaks))
    assert got == want
    assert got["unmatched"] == ["mystery"]
    assert [k["label"] for k in got["kernels"]] == ["flash-deit",
                                                    "matmul-deit"]


def test_default_peaks_are_the_h100s():
    p = export.DEFAULT_PEAKS
    assert (p.flops_per_s, p.hbm_bytes_per_s, p.name) == \
        (989e12, 3.35e12, "NVIDIA H100 80GB HBM3")
    assert (export.INT8_OPS_PER_S, export.F32_OPS_PER_S) == (1979e12, 67e12)
    assert dataclasses.asdict(p).keys() == \
        dataclasses.asdict(jexport.DEFAULT_PEAKS).keys()


def test_load_cost_rows_takes_a_path_only(tmp_path):
    """A path reads a report as the reference does; without one the port
    now has its own rows, the Hopper cost table (``tests/test_torch_dse.py``
    holds its contents), and the join runs on it."""
    rows = export.load_cost_rows()
    assert {"matmul-deit", "flash-deit", "matmul-bench",
            "ln-matmul-bench"} <= set(rows)
    assert predicted_vs_measured(Registry().snapshot())["kernels"] == []
    path = tmp_path / "cost.json"
    path.write_text(json.dumps({"cost_model": {"rows": ROWS[:1],
                                               "fusion_rows": ROWS[1:]}}))
    assert export.load_cost_rows(path) == jexport.load_cost_rows(path)
    assert sorted(export.load_cost_rows(path)) == ["flash-deit",
                                                   "matmul-deit"]


def _imports(path):
    """Top-level names of the modules a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_telemetry_imports_neither_jax_nor_the_reference():
    """Importing the port's telemetry loads neither jax, ``repro`` nor
    torch, and the registry (``metrics.py``) imports no torch anywhere
    (``tests/test_torch_core.py`` holds every port module's imports to no
    jax and no ``repro``)."""
    assert "torch" not in _imports(TELEMETRY / "metrics.py")
    code = ("import sys; import repro_torch.telemetry, "
            "repro_torch.telemetry.export; "
            "print(sorted(m for m in ('jax', 'repro', 'torch') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(TELEMETRY.parents[1])})
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the reference's unit cases, against the port's registry
# ---------------------------------------------------------------------------
def _span_with_attr(reg, v):
    with span("bad", registry=reg, n=v):
        pass


class TestMetrics:
    def test_counter_get_or_create_and_inc(self, reg):
        c = reg.counter("a/b")
        c.inc()
        c.inc(3)
        assert reg.counter("a/b").value == 4

    def test_counter_rejects_negative(self, reg):
        with pytest.raises(ValueError):
            reg.counter("c").inc(-1)

    def test_gauge_set_add(self, reg):
        g = reg.gauge("g")
        g.set(2.5)
        g.add(0.5)
        assert g.value == 3.0

    @pytest.mark.parametrize("values,counts", [
        ((0.5, 5.0, 50.0, 500.0), [1, 1, 1, 1]),    # one per bucket + inf
        ((1.0,), [1, 0, 0, 0]),                     # le: v <= bound
    ])
    def test_histogram_bucketing(self, reg, values, counts):
        h = reg.histogram("h", (1.0, 10.0, 100.0))
        for v in values:
            h.record(v)
        snap = h.snapshot()
        assert snap["counts"] == counts
        assert snap["count"] == len(values)
        assert snap["min"] == min(values) and snap["max"] == max(values)
        assert snap["mean"] == pytest.approx(sum(values) / len(values))

    def test_histogram_conflicting_buckets_raise(self, reg):
        reg.histogram("h", (1.0, 2.0))
        reg.histogram("h")                          # None = keep existing
        with pytest.raises(ValueError):
            reg.histogram("h", (1.0, 3.0))

    def test_histogram_bad_buckets_raise(self, reg):
        with pytest.raises(ValueError):
            reg.histogram("h", (2.0, 1.0))
        # empty buckets through the registry mean "use the defaults"
        assert reg.histogram("h2", ()).buckets == T.DEFAULT_MS_BUCKETS

    def test_snapshot_shape_and_isolation(self, reg):
        reg.counter("c").inc()
        reg.gauge("g").set(1)
        reg.histogram("h", (1.0,)).record(0.5)
        snap = reg.snapshot()
        assert set(snap) == {"counters", "gauges", "histograms"}
        snap["counters"]["c"] = 999                 # mutating a copy
        assert reg.counter("c").value == 1

    def test_reset_prefix_removes(self, reg):
        reg.counter("x/a").inc()
        reg.counter("x/b").inc()
        reg.counter("y/a").inc()
        reg.reset("x/")
        assert list(reg.snapshot()["counters"]) == ["y/a"]
        # handle after reset is detached; re-fetch starts at zero
        assert reg.counter("x/a").value == 0

    def test_counters_with_prefix_drops_zero(self, reg):
        reg.counter("f/head_dim").inc()
        reg.counter("f/other")                      # created, never inc'd
        assert reg.counters_with_prefix("f/") == {"head_dim": 1}

    @pytest.mark.parametrize("record", [
        lambda reg, v: reg.counter("bad").inc(v),
        lambda reg, v: reg.gauge("bad").set(v),
        lambda reg, v: reg.gauge("bad").add(v),
        lambda reg, v: reg.histogram("bad").record(v),
        lambda reg, v: _span_with_attr(reg, v),
    ], ids=["counter", "gauge_set", "gauge_add", "histogram", "span_attr"])
    def test_cuda_tensor_refused(self, reg, record):
        """The port's jit-safety contract: ``float()`` on a CUDA tensor
        would sync the device without a word, so it raises instead and
        nothing is recorded."""
        with pytest.raises(TypeError, match="CUDA tensor"):
            record(reg, CudaStandIn())
        snap = reg.snapshot()
        assert snap["counters"].get("bad", 0) == 0
        assert snap["gauges"].get("bad", 0.0) == 0.0
        assert snap["histograms"].get("bad", {"count": 0})["count"] == 0
        assert snap["histograms"].get("span/bad/n", {"count": 0})[
            "count"] == 0

    def test_host_tensor_scalars_record(self, reg):
        reg.counter("c").inc(torch.tensor(3))
        reg.histogram("h", (1.0,)).record(torch.tensor(0.5))
        assert reg.counter("c").value == 3
        assert reg.histogram("h").sum == 0.5

    def test_thread_safety_exact_totals(self, reg):
        n_threads, per_thread = 8, 2000

        def work():
            for i in range(per_thread):
                reg.counter("thr").inc()
                reg.histogram("thr_ms", (1.0, 10.0)).record(i % 20)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert reg.counter("thr").value == n_threads * per_thread
        h = reg.histogram("thr_ms").snapshot()
        assert h["count"] == n_threads * per_thread
        assert sum(h["counts"]) == h["count"]


class TestSpans:
    def test_span_records_ms_and_attrs(self, reg):
        with span("op", registry=reg, items=7) as sp:
            pass
        assert sp.elapsed_s is not None and sp.elapsed_ms >= 0
        snap = reg.snapshot()["histograms"]
        assert snap["span/op/ms"]["count"] == 1
        assert snap["span/op/items"]["count"] == 1
        assert snap["span/op/items"]["sum"] == 7.0

    def test_span_nesting_and_current(self, reg):
        assert current_span() is None
        with span("outer", registry=reg) as so:
            assert current_span() is so
            with span("inner", registry=reg) as si:
                assert current_span() is si
            assert current_span() is so
        assert current_span() is None

    def test_span_records_on_exception(self, reg):
        with pytest.raises(RuntimeError):
            with span("boom", registry=reg):
                raise RuntimeError("x")
        assert reg.histogram("span/boom/ms").count == 1

    def test_span_stats(self, reg):
        for _ in range(3):
            with span("s", registry=reg):
                pass
        n, mean_ms = span_stats("s", registry=reg)
        assert n == 3 and mean_ms >= 0

    def test_device_span_times_cuda_events(self, reg, monkeypatch):
        """A span given a CUDA device records an event pair on the
        device's current stream, synchronizes the end event at exit and
        records the events' time, not the host clock's."""
        calls = []

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing

            def record(self, stream=None):
                calls.append(("record", stream))

            def synchronize(self):
                calls.append(("synchronize",))

            def elapsed_time(self, end):
                return 12.5

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: f"stream of {device}")
        with span("dev", registry=reg, device="cuda:0", rows=4) as sp:
            assert calls == [("record", "stream of cuda:0")]
        assert calls[1:] == [("record", "stream of cuda:0"),
                             ("synchronize",)]
        assert sp.elapsed_ms == 12.5
        assert reg.histogram("span/dev/ms").sum == 12.5
        assert reg.histogram("span/dev/rows").sum == 4.0

    @pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
    def test_host_span_syncs_nothing(self, reg, monkeypatch, device):
        def no_event(*a, **k):
            raise AssertionError("a host span touched a CUDA event")

        monkeypatch.setattr(torch.cuda, "Event", no_event)
        with span("host", registry=reg, device=device) as sp:
            pass
        assert sp.elapsed_s >= 0

    def test_span_shows_in_a_profiler_trace(self, reg):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("telemetry/traced", registry=reg):
                torch.ones(8).sum()
        assert "telemetry/traced" in {e.key for e in prof.key_averages()}


class TestDefaultRegistry:
    def test_module_level_api(self):
        T.reset("tmod/")
        T.counter("tmod/c").inc()
        T.gauge("tmod/g").set(1)
        T.histogram("tmod/h").record(2.0)
        snap = T.snapshot()
        assert snap["counters"]["tmod/c"] == 1
        assert snap["histograms"]["tmod/h"]["buckets"] == list(
            T.DEFAULT_MS_BUCKETS)
        T.reset("tmod/")
        assert "tmod/c" not in T.snapshot()["counters"]
        assert T.walltime() > 1.6e9            # epoch seconds


def test_probes_on_the_cpu_join_by_label(reg):
    """The four reference labels run the port's ops (here their plain
    versions: the times mean nothing) and join against rows of the same
    labels."""
    assert set(probes.PROBES) == {"matmul-deit", "flash-deit",
                                  "matmul-bench", "ln-matmul-bench"}
    out = probes.run_probes(tuple(probes.PROBES), repeats=1, registry=reg,
                            device="cpu")
    assert set(out) == set(probes.PROBES) and min(out.values()) > 0
    rows = [dict(r, label=label) for r, label in
            zip(ROWS * 2, sorted(probes.PROBES))]
    rep = predicted_vs_measured(reg.snapshot(), rows)
    assert rep["unmatched"] == []
    assert [k["label"] for k in rep["kernels"]] == sorted(probes.PROBES)
    assert all(k["samples"] == 1 for k in rep["kernels"])


# ---------------------------------------------------------------------------
# the serving stack's records
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_engine():
    """The SMOKE Llama-3 in kernel mode, MXInt8 planes, on the CPU."""
    model = DecoderLM(dataclasses.replace(llama3_8b.SMOKE, quant=KERNEL))
    params = model.init(0, device="cpu", pack_fmt=MXINT8_WEIGHT)
    return ServingEngine(model, params, ServeConfig(max_len=64, batch=3),
                         device="cpu")


def _conserved():
    snap = T.snapshot()
    assert snap["counters"]["scheduler/submitted"] == \
        snap["counters"].get("scheduler/completed", 0) + \
        snap["gauges"]["scheduler/in_flight"], snap
    return snap


def _no_launches(snap, samples):
    """Every kernel counter exported at 0 and one 0 sample a step: the
    CPU's plain versions launch nothing."""
    assert {k: v for k, v in snap["counters"].items()
            if k.startswith("kernel/launches/")} == {
        f"kernel/launches/{n}": 0 for n in KERNELS}
    h = snap["histograms"]["scheduler/kernel_launches"]
    assert (h["count"], h["sum"]) == (samples, 0.0)


@pytest.mark.parametrize("spec,batch,seed", [
    ([(3, 5), (12, 2), (1, 6), (7, 4), (5, 1), (9, 6), (2, 3)], 3, 0),
    ([(4, 3)] * 9, 3, 1),                       # a burst 3x the batch
    ([(2, 1), (6, 1), (1, 1), (8, 1)], 2, 2),   # done straight from prefill
], ids=["ragged_stream", "burst_larger_than_batch", "single_token"])
def test_batch_scheduler_telemetry_conserved(lm_engine, spec, batch, seed):
    """submitted == completed + in_flight at every step boundary, through
    a late submit mid-stream; after the drain every request completed, and
    the decode tokens the requests hold (all but each one's first, which
    its slot prefill gives) are ``scheduler/tokens_generated``."""
    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(1, 512, n).astype(np.int32),
                    max_new_tokens=m) for i, (n, m) in enumerate(spec)]
    T.reset()
    sched = BatchScheduler(lm_engine, batch_size=batch)
    late = reqs.pop()
    for r in reqs:
        sched.submit(r)
        _conserved()
    for i in range(4096):
        live = sched.step()
        _conserved()
        if i == 1:
            sched.submit(late)
            _conserved()
        if live == 0 and not sched.queue:
            break
    done = sched.run()
    snap = _conserved()
    assert sorted(r.uid for r in done) == list(range(len(spec)))
    assert [len(r.generated) for r in sorted(done, key=lambda r: r.uid)] == \
        [m for _, m in spec]
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    assert c["scheduler/submitted"] == c["scheduler/completed"] == \
        c["scheduler/admissions"] == len(spec)
    assert (g["scheduler/in_flight"], g["scheduler/queue_depth"],
            g["scheduler/slots_active"]) == (0, 0, 0)
    assert h["scheduler/request_latency_ms"]["count"] == len(spec)
    assert h["span/scheduler/slot_prefill/ms"]["count"] == len(spec)
    assert h["serving/prefill_len"]["count"] == len(spec)
    decode_tokens = sum(len(r.generated) - 1 for r in done)
    assert c.get("scheduler/tokens_generated", 0) == decode_tokens
    n_decode = h.get("span/scheduler/decode_step/ms", {"count": 0})["count"]
    if decode_tokens:
        assert h["span/scheduler/decode_step/live"]["sum"] == decode_tokens
        assert g["scheduler/tokens_per_s"] > 0
    else:
        assert n_decode == 0
    _no_launches(snap, len(spec) + n_decode)


def test_classify_scheduler_telemetry_conserved():
    """The same for images: the invariant at every step, every image
    classified and counted, one launch sample and span a step."""
    model = ViT(dataclasses.replace(deit.DEIT_MICRO, n_layers=2,
                                    quant=KERNEL))
    engine = ViTServingEngine(model, model.init(0, device="cpu"),
                              ServeConfig(batch=4, pack_weights=True),
                              device="cpu")
    rng = np.random.default_rng(5)
    sizes = [3, 0, 5, 1, 6]
    T.reset()
    sched = ClassifyScheduler(engine)
    for uid, n in enumerate(sizes):
        sched.submit(ClassifyRequest(uid, rng.normal(
            size=(n, 32, 32, 3)).astype(np.float32)))
        _conserved()
    steps = []
    while True:
        n = sched.step()
        _conserved()
        if not n:
            break
        steps.append(n)
    snap = _conserved()
    assert [r.uid for r in sched.finished] == list(range(len(sizes)))
    assert steps == [4, 4, 4, 3]
    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    assert c["scheduler/images_classified"] == sum(sizes)
    assert c["scheduler/completed"] == len(sizes)
    assert h["scheduler/request_latency_ms"]["count"] == len(sizes)
    assert h["span/scheduler/classify_step/images"]["sum"] == sum(sizes)
    assert g["scheduler/slots_active"] == steps[-1]
    assert g["scheduler/images_per_s"] > 0
    _no_launches(snap, len(steps))
    T.reset()
    labels, logits = engine.classify(np.zeros((5, 32, 32, 3), np.float32))
    assert labels.shape == (5,) and logits.shape == (5, 10)
    h = T.snapshot()["histograms"]
    assert h["serving/batch_size"]["sum"] == 4.0
    assert h["span/serving/classify/images"]["sum"] == 5.0
    assert h["span/serving/classify/ms"]["count"] == 1


def test_generate_records_serving_metrics(lm_engine):
    T.reset()
    prompt = np.random.default_rng(6).integers(1, 512, (2, 9)).astype(
        np.int32)
    out = lm_engine.generate({"tokens": prompt}, max_new_tokens=3)
    assert out.shape == (2, 3)
    h = T.snapshot()["histograms"]
    assert (h["serving/batch_size"]["sum"], h["serving/prefill_len"]["sum"],
            h["span/serving/generate/batch"]["sum"],
            h["span/serving/generate/new_tokens"]["sum"],
            h["span/serving/generate/ms"]["count"]) == (2, 9, 2, 3, 1)
