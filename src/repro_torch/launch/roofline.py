"""The launch dry run's layout, collective rules and roofline on the H100.

Counterpart of ``repro.launch.hlo_analysis`` (and, run as ``python -m
repro_torch.launch.roofline``, of ``benchmarks/roofline.py`` and
``repro.launch.reanalyze``).  The reference reads its per-device FLOPs,
bytes and collectives from XLA's partitioned program.  The port has no
partitioned program, so the three inputs of a cell's roofline come from
three places:

* **memory from the layout**: every leaf of the params, the optimizer
  state, the cache and the batch gets the reference's ``PartitionSpec``
  (``parallel.sharding.logical_to_pspec``); its per-device bytes are its
  bytes with each dimension divided by the product of the mesh sizes
  its spec puts there (rounded up: a ragged shard is padded).  Exact;
* **FLOPs and bytes from one run** of the step on ``meta`` at the global
  shape (``launch.step_cost``), split evenly over the devices: an ideal
  split, which no partitioned program checks;
* **collectives from rules** over the same layout and the run's product
  events.  Each collective counts its per-device tensor bytes once, as
  the reference's parser does.  Activations count in the model's dtype.

The rules:

1. A product whose weight leaf has its contraction dimension (the axis
   ``serving.engine.contraction_axis`` names: the packing blocks' axis)
   sharded over mesh axes all-reduces its per-device output over them:
   once per call, and once more for the backward of a train step.  Its
   per-device output is the call's output over the batch shards (the
   batch input's first dimension) and the leaf's other sharded
   dimensions.
2. A lookup in a table whose vocab dimension is sharded all-reduces its
   per-device output (rows x d_model, over the batch shards), once a
   call.
3. A train step all-reduces every parameter leaf's gradient over the
   batch axes its own spec does not use, at the leaf's per-device bytes.
   Under ``grad_compression`` with a "pod" axis, the "pod" reduction
   carries what ``compressed_psum`` sends instead: one int8 mantissa an
   element and one int8 exponent a block of 32 (``MXINT8_OCP``), and the
   other batch axes reduce at the leaf's bytes.
4. A MoE layer whose expert stacks are sharded over their "expert" axis
   all-to-alls its capacity buffer (experts x capacity x d_model, the
   operand of the ``wi`` stack's product) twice a call, dispatch and
   combine, at its per-device bytes under the (expert, cap, embed)
   spec; a train step does both again in the backward.
5. A decode step whose cache shards the K/V ring's positions
   (``kv_seq``) all-reduces each attention layer's partials once: the
   per-device output (rows x heads x head_dim) and the softmax's running
   max and sum (two float32 a row and head).

The compute term sums each dtype's per-device FLOPs over that dtype's
peak on the card: the port's non-kernel products run in float64, whose
tensor-core peak is a fifteenth of bf16's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.telemetry import export

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")
OCP_BLOCK = 32                   # MXINT8_OCP's block: one exponent byte


@dataclasses.dataclass(frozen=True)
class Peaks:
    """The card's rates: FLOP/s by dtype, HBM and one link's bytes/s.

    Defaults: NVIDIA H100 SXM (80GB HBM3, 700 W), from NVIDIA's data
    sheet through ``telemetry.export``: bf16/f16 989e12 and int8 1979e12
    on the tensor cores; float32 67e12 outside them (the port runs its
    float32 products with TF32 off); float64 67e12 on the tensor cores;
    HBM 3.35e12 B/s; NVLink 450e9 B/s one way (the sheet's 900 GB/s
    counts both directions).  One link rate ignores that a 256-rank mesh
    spans 32 nodes of eight cards, as the reference's ``ICI_BW`` ignores
    its torus."""
    bf16: float = export.DEFAULT_PEAKS.flops_per_s
    f16: float = export.DEFAULT_PEAKS.flops_per_s
    int8: float = export.INT8_OPS_PER_S
    f32: float = export.F32_OPS_PER_S
    f64: float = export.F64_TENSOR_OPS_PER_S
    hbm: float = export.DEFAULT_PEAKS.hbm_bytes_per_s
    link: float = export.NVLINK_BYTES_PER_S

    def flops_per_s(self, dtype: str) -> float:
        """A dtype's peak; an integer or other dtype takes float32's."""
        return getattr(self, dtype, None) or self.f32

    @classmethod
    def parse(cls, text: str) -> "Peaks":
        """"bf16=989e12,hbm=3.35e12" -> the defaults with those set."""
        kw = {}
        for item in filter(None, (t.strip() for t in text.split(","))):
            k, _, v = item.partition("=")
            kw[k.strip()] = float(v)
        return cls(**kw)


H100 = Peaks()


# ---------------------------------------------------------------------------
# the reference's model FLOPs (copied from repro.launch.hlo_analysis)
# ---------------------------------------------------------------------------
def model_flops_estimate(cfg, shape, n_devices: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) per device, D = tokens processed.

    Training multiplies by 1 (the 6 already counts fwd+bwd: 2 fwd + 4 bwd);
    decode counts one token per sequence.
    """
    n_params, n_active = param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / n_devices
    tokens = shape.global_batch            # one step
    return 2.0 * n_active * tokens / n_devices


def param_counts(cfg) -> Tuple[float, float]:
    """(total, active) parameter counts from the config."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.hd
    counts = {"attn": d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2),
              "rec": 0.0, "mlstm": 0.0, "slstm": 0.0}
    w = cfg.lru_width or d
    counts["rec"] = 3 * d * w + 2 * w * w + cfg.conv_width * w
    counts["mlstm"] = 4 * d * (cfg.n_heads * hd) + 2 * d * cfg.n_heads + \
        3 * d * d
    counts["slstm"] = 8 * d * d + d * d
    if cfg.ffn_kind in ("swiglu", "geglu"):
        ffn_total = ffn_active = 3 * d * ff
    elif cfg.ffn_kind == "gelu":
        ffn_total = ffn_active = 2 * d * ff
    elif cfg.ffn_kind == "moe":
        ffn_total = cfg.moe.num_experts * 3 * d * ff + d * cfg.moe.num_experts
        ffn_active = cfg.moe.top_k * 3 * d * ff + d * cfg.moe.num_experts
    else:
        ffn_total = ffn_active = 0.0

    layers = list(cfg.unit) * cfg.resolved_n_units + list(cfg.tail)
    total = active = 0.0
    for kind in layers:
        total += counts[kind]
        active += counts[kind]
        if kind in ("attn", "rec"):
            total += ffn_total
            active += ffn_active
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    total += emb
    active += emb
    if cfg.is_encoder_decoder:
        enc = cfg.n_encoder_layers * (counts["attn"] + 2 * d * ff)
        cross = cfg.n_layers * counts["attn"]
        total += enc + cross
        active += enc + cross
    return total, active


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def shard_factor(entry, mesh: Dict[str, int]) -> int:
    """The number of shards a pspec entry cuts its dimension into."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh[n] for n in names)


def shard_bytes(shape, itemsize: int, pspec, mesh: Dict[str, int]) -> int:
    """One device's bytes of a tensor laid out by ``pspec``: each
    dimension divided by its shards, rounded up."""
    n = itemsize
    for i, d in enumerate(shape):
        f = shard_factor(pspec[i] if i < len(pspec) else None, mesh)
        n *= -(-d // f)
    return n


@dataclasses.dataclass
class Leaf:
    path: str
    group: str                   # params | opt_state | cache | batch
    shape: Tuple[int, ...]
    itemsize: int
    dtype: str
    axes: Tuple[Optional[str], ...]
    pspec: tuple
    bytes: int                   # the whole leaf, every plane
    device_bytes: int            # one device's share, every plane
    contraction: Optional[int] = None


@dataclasses.dataclass
class Layout:
    """Every leaf of a cell over one mesh, and what the rules read."""
    mesh: Dict[str, int]
    rules: Any
    kind: str
    leaves: List[Leaf]
    batch_factor: int = 1        # shards of the batch input's rows
    act_itemsize: int = 2        # the model dtype's bytes
    grad_compression: bool = False

    def by_path(self) -> Dict[str, Leaf]:
        return {l.path: l for l in self.leaves}

    def resident_bytes(self) -> Dict[str, int]:
        out = {g: 0 for g in ("params", "opt_state", "cache", "batch")}
        for l in self.leaves:
            out[l.group] += l.device_bytes
        out["total"] = sum(out.values())
        return out


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def build_layout(groups: Dict[str, Tuple[Any, Any]], mesh: Dict[str, int],
                 rules, kind: str, act_itemsize: int,
                 grad_compression: bool = False) -> Layout:
    """``groups``: name -> (a tree of tensors, Params and packed planes;
    its axes tree, or None where the leaves are Params).  A packed leaf's
    exponent plane takes its mantissa plane's spec."""
    import torch
    from repro_torch.core.quantize import MXTensor
    from repro_torch.models.model_api import Param
    from repro_torch.launch.step_cost import dtype_name
    from repro_torch.parallel.sharding import logical_to_pspec
    from repro_torch.serving.engine import contraction_axis
    names = tuple(mesh)
    leaves: List[Leaf] = []

    def add(path, group, value, axes, contraction=None):
        planes = ([value.mantissa, value.exponent]
                  if isinstance(value, MXTensor) else [value])
        shape = tuple(planes[0].shape)
        pspec = logical_to_pspec(tuple(axes), rules, names, shape=shape,
                                 mesh_shape=mesh)
        leaves.append(Leaf(
            path, group, shape, planes[0].element_size(),
            dtype_name(planes[0].dtype), tuple(axes),
            pspec, sum(p.numel() * p.element_size() for p in planes),
            sum(shard_bytes(p.shape, p.element_size(), pspec, mesh)
                for p in planes), contraction))

    def walk(value, axes, path, group):
        if isinstance(value, Param):
            add(path, group, value.value, value.axes,
                contraction_axis(value) if group == "params" else None)
        elif isinstance(value, (MXTensor, torch.Tensor)):
            if not _is_axes(axes):
                raise ValueError(f"{path}: no axes for a leaf")
            add(path, group, value, axes)
        elif isinstance(value, dict):
            for k, v in value.items():
                walk(v, None if axes is None else axes[k],
                     f"{path}/{k}" if path else str(k), group)
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                walk(v, None if axes is None else axes[i], f"{path}/{i}",
                     group)
        elif value is not None:
            raise TypeError(f"{path}: not a tree leaf: {type(value)}")

    for group, (tree, axes) in groups.items():
        walk(tree, axes, "", group)
    tokens = next((l for l in leaves if l.group == "batch"
                   and l.path == "tokens"), None)
    batch_factor = shard_factor(tokens.pspec[0], mesh) if tokens else 1
    return Layout(mesh, rules, kind, leaves, batch_factor, act_itemsize,
                  grad_compression)


# ---------------------------------------------------------------------------
# the collective rules
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _batch_axes(layout: Layout) -> Tuple[str, ...]:
    b = layout.rules.batch
    b = (b,) if isinstance(b, str) else tuple(b or ())
    return tuple(a for a in b if a in layout.mesh)


def collective_terms(counts: Dict[str, Any], layout: Layout,
                     cfg=None) -> List[Dict[str, Any]]:
    """The cell's collectives under rules 1-5 (module docstring): one
    entry per rule and kind with its per-device bytes and its count."""
    from repro_torch.parallel.sharding import logical_to_pspec
    mesh, train = layout.mesh, layout.kind == "train"
    leaves = layout.by_path()
    out: Dict[Tuple[int, str], Dict[str, Any]] = {}

    def add(rule, kind, nbytes, n=1, over=()):
        e = out.setdefault((rule, kind), {"rule": rule, "kind": kind,
                                          "bytes": 0, "count": 0,
                                          "over": sorted(set(over))})
        e["bytes"] += nbytes * n
        e["count"] += n
        e["over"] = sorted(set(e["over"]) | set(over))

    passes = 2 if train else 1
    for ev in counts.get("events", ()):
        leaf = leaves.get(ev["leaf"])
        if leaf is None:
            continue
        out_numel = math.prod(ev["out_shape"]) if ev["out_shape"] else 0
        if ev["op"] in ("mm", "addmm", "bmm", "baddbmm"):
            c = leaf.contraction
            if c is not None and leaf.pspec[c] is not None:
                other = math.prod(shard_factor(p, mesh)
                                  for i, p in enumerate(leaf.pspec)
                                  if i != c)
                nbytes = out_numel * layout.act_itemsize // (
                    layout.batch_factor * other)
                add(1, "all-reduce", nbytes, passes,
                    _entry_axes(leaf.pspec[c]))
            if (leaf.axes[:1] == ("expert",) and leaf.path.endswith("/wi")
                    and leaf.pspec[0] is not None):
                act = ev["shapes"][1 - ev["operand"]]
                E, d = leaf.shape[0], leaf.shape[1]
                cap = math.prod(act) // (E * d)
                spec = logical_to_pspec(("expert", "cap", "embed"),
                                        layout.rules, tuple(mesh),
                                        shape=(E, cap, d), mesh_shape=mesh)
                nbytes = shard_bytes((E, cap, d), layout.act_itemsize,
                                     spec, mesh)
                add(4, "all-to-all", nbytes, 2 * passes,
                    _entry_axes(spec[0]))
        elif leaf.axes[:1] == ("vocab",) and leaf.pspec[0] is not None:
            nbytes = out_numel * layout.act_itemsize // layout.batch_factor
            add(2, "all-reduce", nbytes, 1, _entry_axes(leaf.pspec[0]))
    if train:
        batch_axes = _batch_axes(layout)
        for leaf in layout.leaves:
            if leaf.group != "params":
                continue
            used = {a for p in leaf.pspec for a in _entry_axes(p)}
            axes = [a for a in batch_axes if a not in used]
            if layout.grad_compression and "pod" in axes:
                axes.remove("pod")
                numel = leaf.device_bytes // leaf.itemsize
                add(3, "all-reduce", numel + -(-numel // OCP_BLOCK), 1,
                    ("pod",))
            if axes:
                add(3, "all-reduce", leaf.device_bytes, 1, axes)
    if layout.kind == "decode" and cfg is not None:
        for leaf in layout.leaves:
            if (leaf.group == "cache" and leaf.path.endswith("/k")
                    and len(leaf.pspec) > 1 and leaf.pspec[1] is not None):
                rows = -(-leaf.shape[0] // shard_factor(leaf.pspec[0], mesh))
                heads = -(-cfg.n_heads // shard_factor(leaf.pspec[2], mesh))
                nbytes = rows * heads * (cfg.hd * layout.act_itemsize + 8)
                add(5, "all-reduce", nbytes, 1, _entry_axes(leaf.pspec[1]))
    return [out[k] for k in sorted(out)]


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Roofline:
    """The reference's fields.  ``device_flops``, ``device_bytes`` and
    ``flops_by_dtype`` are the ideal split of the global counts;
    ``per_device_hbm_bytes`` is the resident bytes (exact) plus the ideal
    transient bytes."""
    device_flops: float
    device_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_flops_ratio: Optional[float] = None
    per_device_hbm_bytes: Optional[float] = None
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


def terms(flops_by_dtype: Dict[str, float], device_bytes: float,
          collective_bytes: float, peaks: Peaks = H100) -> Dict[str, float]:
    """The three roofline terms, in seconds, from per-device counts."""
    return {"compute": sum(n / peaks.flops_per_s(dt)
                           for dt, n in flops_by_dtype.items()),
            "memory": device_bytes / peaks.hbm,
            "collective": collective_bytes / peaks.link}


def roofline_from_counts(counts: Dict[str, Any], layout: Layout,
                         n_devices: int, peaks: Peaks = H100, *,
                         model_flops: Optional[float] = None,
                         collectives: Optional[list] = None,
                         cfg=None) -> Roofline:
    """One cell's roofline: ``counts`` (``StepCost.counts()``, global)
    split over ``n_devices``, the collectives of ``layout`` (or the given
    ``collectives``), and ``peaks``."""
    if collectives is None:
        collectives = collective_terms(counts, layout, cfg)
    by_dtype = {dt: n / n_devices
                for dt, n in counts["flops_by_dtype"].items()}
    flops = sum(by_dtype.values())
    nbytes = counts["bytes"] / n_devices
    coll = sum(c["bytes"] for c in collectives)
    coll_counts = {k: 0 for k in COLLECTIVE_KINDS}
    for c in collectives:
        coll_counts[c["kind"]] += c["count"]
    t = terms(by_dtype, nbytes, coll, peaks)
    hbm = (layout.resident_bytes()["total"]
           + counts["transient_peak_bytes"] / n_devices)
    return Roofline(
        device_flops=flops, device_bytes=nbytes, collective_bytes=coll,
        collective_counts=coll_counts, compute_s=t["compute"],
        memory_s=t["memory"], collective_s=t["collective"],
        bottleneck=max(t, key=t.get), model_flops=model_flops,
        useful_flops_ratio=(model_flops / flops
                            if model_flops and flops > 0 else None),
        per_device_hbm_bytes=hbm, flops_by_dtype=by_dtype)


def reanalyze(rec: Dict[str, Any], peaks: Peaks) -> Dict[str, float]:
    """A saved record's three terms and binding term under other peaks,
    from its raw per-device counts: no rerun."""
    r = rec["roofline"]
    t = terms(r["flops_by_dtype"], r["device_bytes"], r["collective_bytes"],
              peaks)
    return {"compute_s": t["compute"], "memory_s": t["memory"],
            "collective_s": t["collective"],
            "bottleneck": max(t, key=t.get)}


# ---------------------------------------------------------------------------
# the table (python -m repro_torch.launch.roofline)
# ---------------------------------------------------------------------------
def static_rows() -> List[tuple]:
    """The Hopper cost table's kernel rows (``analysis.cost_model``)."""
    from repro_torch.analysis import cost_model
    rows = []
    for r in cost_model.table():
        rows.append((f"roofline/static/{r['label']}", 0.0,
                     f"flops={r['flops']} hbm_bytes={r['hbm_bytes']} "
                     f"intensity={r['intensity']:.1f} "
                     f"smem_bytes={r['smem_bytes']} "
                     f"bound_ms={r['bound_ms']} ({r['bound_by']})"))
    return rows


def load_cells(directory: Path, tag: str = "", mesh_filter: str = ""):
    cells = {}
    suffix = f".{tag}.json" if tag else ".json"
    for f in sorted(Path(directory).glob("*.json")):
        if f.name.startswith("summary") or not f.name.endswith(suffix):
            continue
        rec = json.loads(f.read_text())
        if tag == "" and rec.get("tag"):
            continue
        if mesh_filter and rec.get("mesh") != mesh_filter:
            continue
        cells[(rec["arch"], rec["shape"], rec["mesh"],
               rec.get("variant", "-"))] = rec
    return cells


def fmt_row(rec, peaks: Optional[Peaks] = None) -> str:
    if rec.get("skipped"):
        return "SKIP (" + rec["reason"][:60] + "...)"
    if not rec.get("ok"):
        return "FAIL"
    r = dict(rec["roofline"])
    if peaks is not None:
        r.update(reanalyze(rec, peaks))
    m = rec["memory"]
    dt = " ".join(f"{k}={v:.3g}" for k, v in r["flops_by_dtype"].items())
    return " ".join([
        f"compute={r['compute_s'] * 1e3:.3f}ms",
        f"memory={r['memory_s'] * 1e3:.3f}ms",
        f"collective={r['collective_s'] * 1e3:.3f}ms",
        f"bound={r['bottleneck']}",
        f"useful_flops={100 * r['useful_flops_ratio']:.1f}%"
        if r.get("useful_flops_ratio") else "useful_flops=n/a",
        f"resident={m['resident_bytes'] / 2**30:.2f}GiB",
        f"transient_ideal={m['transient_bytes_ideal'] / 2**30:.2f}GiB",
        f"flops[{dt}]", f"seconds={rec.get('seconds')}"])


def run(directory: Path = OUT_DIR, tag: str = "",
        peaks: Optional[Peaks] = None) -> List[tuple]:
    rows = static_rows()
    cells = load_cells(directory, tag)
    if not cells:
        rows.append(("roofline/dryrun_missing", 0.0,
                     "run `python -m repro_torch.launch.dryrun` for the "
                     "dry-run half of the table"))
        return rows
    census: Dict[str, int] = {}
    for (arch, shape, mesh, variant), rec in sorted(cells.items()):
        rows.append((f"roofline/{arch}/{shape}/{mesh}/{variant}",
                     rec.get("seconds") or 0.0, fmt_row(rec, peaks)))
        if mesh == "single_16x16" and variant in ("bf16", "-") and \
                rec.get("ok") and not rec.get("skipped"):
            b = (reanalyze(rec, peaks) if peaks else rec["roofline"])[
                "bottleneck"]
            census[b] = census.get(b, 0) + 1
    rows.append(("roofline/bottleneck_census_single_bf16", 0.0,
                 " ".join(f"{k}={v}" for k, v in sorted(census.items()))))
    return rows


def markdown(directory: Path = OUT_DIR, tag: str = "",
             peaks: Optional[Peaks] = None) -> List[str]:
    """The sweep as one table, a row per cell: per mesh the per-device
    GiB (resident + ideal transient) and the three terms in ms with the
    binding one, each "x/y" for the bf16/mxint variants where they
    differ; the global FLOPs by dtype, the useful share and each record's
    seconds (mesh by mesh, variant by variant)."""
    cells = load_cells(directory, tag)
    meshes = sorted({m for (_, _, m, _) in cells})

    def join(vals, fmt):
        out = [fmt(v) for v in vals]
        return out[0] if len(set(out)) == 1 else "/".join(out)

    head = ["cell", "ok"] + [
        f"{m}: GiB resident + transient; compute / memory / collective ms;"
        f" bound" for m in meshes] + ["global FLOPs by dtype", "useful",
                                       "s"]
    lines = ["| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    skipped = []
    for arch, shape in sorted({(a, s) for (a, s, _, _) in cells}):
        recs = {(m, v): r for (a, s, m, v), r in cells.items()
                if (a, s) == (arch, shape)}
        if all(r.get("skipped") for r in recs.values()):
            skipped.append(f"{arch} {shape}")
            continue
        variants = sorted({v for (_, v) in recs}, key=["bf16",
                                                        "mxint"].index)
        ok = all(r.get("ok") for r in recs.values())
        row = [f"{arch} {shape} ({'/'.join(variants)})",
               "ok" if ok else "FAIL"]
        if not ok:
            lines.append("| " + " | ".join(row) + " |")
            continue
        for m in meshes:
            rs = [recs[(m, v)] for v in variants]
            ts = [dict(r["roofline"], **(reanalyze(r, peaks) if peaks
                                         else {})) for r in rs]
            mem = [r["memory"] for r in rs]

            def gib(key):
                return join(mem, lambda x: f"{x[key] / 2**30:.2f}")

            def ms(key):
                return join(ts, lambda t: f"{t[key] * 1e3:.3g}")

            row.append(f"{gib('resident_bytes')} + "
                       f"{gib('transient_bytes_ideal')}; "
                       f"{ms('compute_s')} / {ms('memory_s')} / "
                       f"{ms('collective_s')}; "
                       f"{join(ts, lambda t: t['bottleneck'])}")
        first = recs[(meshes[0], variants[0])]
        flops = ", ".join(f"{k} {v:.3g}" for k, v in
                          first["counts"]["flops_by_dtype"].items())
        useful = first["roofline"].get("useful_flops_ratio")
        secs = "; ".join("/".join(f"{recs[(m, v)]['seconds']:.1f}"
                                  for v in variants) for m in meshes)
        row += [flops, f"{100 * useful:.1f}%" if useful else "n/a", secs]
        lines.append("| " + " | ".join(row) + " |")
    if skipped:
        lines += ["", "Skipped (the registry's reason): " +
                  "; ".join(skipped) + "."]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=str(OUT_DIR),
                    help="the dry run's records")
    ap.add_argument("--tag", default="", help="read records of this tag")
    ap.add_argument("--peaks", default="",
                    help="recompute the terms under other rates, e.g. "
                         "'bf16=989e12,f64=67e12,hbm=3.35e12,link=450e9'")
    ap.add_argument("--markdown", action="store_true",
                    help="print the sweep as one markdown table")
    args = ap.parse_args(argv)
    peaks = Peaks.parse(args.peaks) if args.peaks else None
    if args.markdown:
        print("\n".join(markdown(Path(args.dir), args.tag, peaks)))
        return 0
    for r in run(Path(args.dir), args.tag, peaks):
        print(",".join(map(str, r)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
