"""The port's example drivers (``repro_torch.examples``), each run once in
a subprocess on the CPU at its smallest flags, each checked by its own
report (the JSON line it prints last):

* ``quickstart``: the format, the outlier test, the three datapaths and
  a fully MXInt DeiT forward near the float one;
* ``serve_deit_mxint``: every batch the kernel-mode engine ran equal bit
  for bit to "sim", on one process and over two gloo ranks (``--tp 2``);
* ``serve_llm_mxint --kernel``: every request's tokens, in the
  vocabulary;
* ``train_lm_fault_tolerant``: the resumed run equal to the straight one.

Each driver refuses to run without a card unless given ``--device cpu``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(name, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=str(ROOT))
    return proc


def _report(proc):
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_quickstart():
    rep = _report(_run("quickstart", "--device", "cpu"))
    assert rep["ok"] and rep["device"] == "cpu"
    assert rep["reconstruction_max_err"] < 0.1
    assert abs(rep["outlier_small_value"] - 0.01) < 1e-3
    assert rep["logit_cosine"] > 0.9


@pytest.mark.parametrize("tp", [1, 2])
def test_serve_deit_mxint_kernel_equals_sim(tp, tmp_path):
    metrics = tmp_path / "metrics.json"
    rep = _report(_run("serve_deit_mxint", "--requests", "8", "--batch", "4",
                       "--train-steps", "2", "--tp", str(tp),
                       "--metrics-json", str(metrics), "--device", "cpu"))
    assert rep["ok"] and rep["tp"] == tp
    assert rep["images"] == 8 and rep["batches"] >= 2
    assert rep["kernel_equals_sim"] == rep["batches"]
    assert rep["ranks_equal"]
    snap = json.loads(metrics.read_text())
    assert snap["run"]["batches"] == rep["batches"]


def test_serve_llm_mxint_kernel():
    rep = _report(_run("serve_llm_mxint", "--requests", "2", "--new-tokens",
                       "2", "--kernel", "--device", "cpu"))
    assert rep["ok"] and rep["kernel"] and rep["requests"] == 2
    assert rep["tokens"] == 4
    assert all(len(t) == 2 for t in rep["generated"].values())
    # the plain versions on the CPU launch nothing
    assert not any(rep["launches"].values())


def test_train_lm_fault_tolerant_resumes_exactly(tmp_path):
    rep = _report(_run("train_lm_fault_tolerant", "--steps", "4", "--batch",
                       "2", "--seq", "16", "--dir", str(tmp_path / "run"),
                       "--device", "cpu"))
    assert rep["ok"] and rep["resumed_from"] == 2
    assert rep["resumed_equals_straight"]
    assert rep["final_loss"] == rep["straight_final_loss"]


def test_drivers_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run("serve_llm_mxint", "--requests", "1", "--new-tokens", "1")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
