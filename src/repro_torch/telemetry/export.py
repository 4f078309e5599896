"""Snapshot exporters and the predicted-vs-measured roofline join.

Counterpart of ``repro.telemetry.export``: given the same snapshot, the
JSON payload, the Prometheus text and the join report are the same as the
reference's.  Three surfaces over one :meth:`Registry.snapshot`:

* :func:`json_snapshot`: the machine-readable dump (``chip_smoke.py``
  writes it into ``build/chip_smoke.json``);
* :func:`prometheus_text`: Prometheus text exposition (counters, gauges,
  cumulative-bucket histograms) for scrape endpoints;
* :func:`predicted_vs_measured`: joins measured kernel spans
  (``span/kernel:<label>/ms``, recorded by ``repro_torch.telemetry.probes``)
  against rows of a static cost table by label, and reports the achieved
  fraction of the roofline per kernel.

Without a path :func:`load_cost_rows` returns the port's Hopper cost
table (``repro_torch.analysis.cost_model``), whose rows split their
operations by unit (int8 and bf16 tensor cores, float32); the join then
predicts a row's time as ``cost_model.bound`` does.  The peaks are the
H100's and are the one definition of them in the port: the cost table
and ``chip_smoke.py`` compute their bounds from these.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.telemetry import metrics

KERNEL_SPAN_PREFIX = "span/kernel:"


@dataclasses.dataclass(frozen=True)
class RooflinePeaks:
    """Peak rates the predicted times are derived from.

    Defaults: one NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power
    limit, NVIDIA's published dense peaks: 989 TFLOP/s bf16 on the tensor
    cores and 3.35 TB/s of HBM.  A card set below 700 W runs slower under
    load.  On the CPU the probes run the kernels' plain versions, and the
    achieved fractions mean nothing there.
    """
    flops_per_s: float = 989e12
    hbm_bytes_per_s: float = 3.35e12
    name: str = "NVIDIA H100 80GB HBM3"


DEFAULT_PEAKS = RooflinePeaks()
# the card's other published dense peaks: int8 tensor cores, float32
# outside the tensor cores
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# NVIDIA H100 SXM data sheet: "FP64 Tensor Core 67 teraFLOPS" (the
# float64 products run there), and "NVLink 900 GB/s", which counts both
# directions: one way carries half of it
F64_TENSOR_OPS_PER_S = 67e12
NVLINK_BYTES_PER_S = 900e9 / 2


def json_snapshot(snapshot: Optional[dict] = None,
                  path: Union[str, Path, None] = None,
                  extra: Optional[dict] = None,
                  registry=None) -> dict:
    """Snapshot (default registry unless given) as a json-ready dict;
    ``extra`` keys are merged top-level; ``path`` also writes the file."""
    if snapshot is None:
        snapshot = (registry or metrics.default_registry()).snapshot()
    payload = dict(snapshot)
    if extra:
        payload.update(extra)
    if path is not None:
        Path(path).write_text(json.dumps(payload, indent=1,
                                         sort_keys=True) + "\n")
    return payload


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name).strip("_")


def _fmt(v: float) -> str:
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(snapshot: Optional[dict] = None, registry=None) -> str:
    """Prometheus 0.0.4 text format.  Histograms use cumulative bucket
    counts with ``le`` labels plus ``_sum``/``_count`` series."""
    if snapshot is None:
        snapshot = (registry or metrics.default_registry()).snapshot()
    out: List[str] = []
    for name, value in snapshot.get("counters", {}).items():
        p = _prom_name(name) + "_total"
        out += [f"# TYPE {p} counter", f"{p} {value}"]
    for name, value in snapshot.get("gauges", {}).items():
        p = _prom_name(name)
        out += [f"# TYPE {p} gauge", f"{p} {_fmt(value)}"]
    for name, h in snapshot.get("histograms", {}).items():
        p = _prom_name(name)
        out.append(f"# TYPE {p} histogram")
        cum = 0
        for bound, count in zip(h["buckets"], h["counts"]):
            cum += count
            out.append(f'{p}_bucket{{le="{_fmt(bound)}"}} {cum}')
        cum += h["counts"][-1]
        out.append(f'{p}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{p}_sum {_fmt(h['sum'])}")
        out.append(f"{p}_count {h['count']}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# predicted vs measured
# ---------------------------------------------------------------------------
def load_cost_rows(path: Union[str, Path, None] = None
                   ) -> Dict[str, dict]:
    """Static cost-table rows keyed by label: without a path the port's
    Hopper cost table (``repro_torch.analysis.cost_model.query()``), else
    the sweep and fusion rows of a JSON report at ``path`` (a report with
    a ``cost_model`` key, or the bare payload)."""
    if path is None:
        from repro_torch.analysis.cost_model import query
        return query()
    payload = json.loads(Path(path).read_text())
    payload = payload.get("cost_model", payload)
    rows = list(payload.get("rows", []))
    rows += payload.get("fusion_rows", [])
    return {r["label"]: r for r in rows}


def predicted_vs_measured(snapshot: Optional[dict] = None,
                          rows: Union[Dict[str, dict],
                                      Sequence[dict], None] = None,
                          peaks: RooflinePeaks = DEFAULT_PEAKS,
                          cost_report: Union[str, Path, None] = None,
                          registry=None) -> dict:
    """Join measured ``span/kernel:<label>/ms`` histograms against the
    static cost-model rows of the same label.

    Per joined kernel: measured mean wall-clock, the analytic roofline
    time ``max(flops/peak_flops, hbm_bytes/peak_bw)`` (for a row that
    splits its operations by unit, as the Hopper table's do, the compute
    term is the sum of int8, bf16 and f32 operations over their own
    peaks), which term binds,
    and the achieved fraction ``predicted/measured`` (1.0 == running at
    the roofline; the CPU's plain versions sit far below it).
    Measured spans with no table row land in ``unmatched`` — a probe
    label drifting from the sweep is a finding, not a silent drop.
    """
    if snapshot is None:
        snapshot = (registry or metrics.default_registry()).snapshot()
    if rows is None:
        rows = load_cost_rows(cost_report)
    elif not isinstance(rows, dict):
        rows = {r["label"]: r for r in rows}

    joined: List[dict] = []
    unmatched: List[str] = []
    for name, h in snapshot.get("histograms", {}).items():
        if not (name.startswith(KERNEL_SPAN_PREFIX)
                and name.endswith("/ms")):
            continue
        label = name[len(KERNEL_SPAN_PREFIX):-len("/ms")]
        if not h["count"]:
            continue
        row = rows.get(label)
        if row is None:
            unmatched.append(label)
            continue
        measured_ms = h["mean"]
        flops = int(row.get("flops", 0))
        hbm = int(row.get("hbm_bytes", 0))
        if "int8_ops" in row:
            compute_s = (row["int8_ops"] / INT8_OPS_PER_S
                         + row["bf16_ops"] / peaks.flops_per_s
                         + row["f32_ops"] / F32_OPS_PER_S)
        else:
            compute_s = flops / peaks.flops_per_s
        memory_s = hbm / peaks.hbm_bytes_per_s
        predicted_s = max(compute_s, memory_s)
        measured_s = measured_ms / 1e3
        joined.append({
            "label": label,
            "kernel": row.get("kernel"),
            "samples": h["count"],
            "measured_ms": round(measured_ms, 6),
            "predicted_ms": round(predicted_s * 1e3, 6),
            "bottleneck": "compute" if compute_s >= memory_s else "memory",
            "flops": flops,
            "hbm_bytes": hbm,
            "intensity": row.get("intensity"),
            "achieved_fraction":
                round(predicted_s / measured_s, 9) if measured_s else None,
            "achieved_gflop_per_s":
                round(flops / measured_s / 1e9, 3) if measured_s else None,
            "achieved_gb_per_s":
                round(hbm / measured_s / 1e9, 3) if measured_s else None,
        })
    joined.sort(key=lambda r: r["label"])
    return {
        "peaks": dataclasses.asdict(peaks),
        "kernels": joined,
        "unmatched": sorted(unmatched),
    }
