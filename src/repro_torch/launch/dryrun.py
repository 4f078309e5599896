"""The launch dry run: every (arch x shape x mesh) cell's per-device memory,
FLOPs by dtype, collectives and roofline on the H100, with no card.

Counterpart of ``repro.launch.dryrun``.  Run it as a program::

    python -m repro_torch.launch.dryrun [--arch llama3_8b] [--shape
        decode_32k] [--mesh single|multi|both|tiny_single|tiny_multi]
        [--variant bf16|mxint|auto] [--grad-compression]
        [--microbatches N] [--rules fsdp=data,kv_seq=data] [--out DIR]
        [--tag TAG]

Per cell it:

1. builds the step's inputs on the ``meta`` device (``launch.specs``,
   ``train.state.abstract_train_state``): nothing is allocated.  Serve
   cells run twice, with bf16 weights and with packed MXInt6 planes
   (``pack_params_mxint(..., tp_shards=)`` the "model" axis's size);
   both go through the config's default ``QuantConfig``, whose mode is
   "off", so no kernel is on this path;
2. lays every leaf (params, optimizer state, cache, batch) out over the
   mesh by the reference's rules (``launch.roofline.build_layout``).  A
   decode batch smaller than the batch axes switches to ``batch=None,
   kv_seq="data"``, as the reference does.  The per-device resident
   bytes are exact;
3. runs the step once on ``meta`` at the global shape under
   ``launch.step_cost.StepCost``.  Its FLOPs, bytes and transient bytes
   over the device count are the ``*_ideal`` numbers of the record: they
   assume an even split, which the port has no partitioned program to
   check (at one device they are exact).  ``memory.peak_device_bytes`` is
   the resident bytes plus the ideal transient bytes;
4. derives the collectives from the layout under the rules of
   ``launch.roofline`` and writes the record, with the three roofline
   terms over the H100's peaks, as JSON under ``experiments/dryrun/``.

A cell that raises is recorded with ``ok: false`` and its traceback, and
the run goes on; the program exits 1 if any cell failed.  The per-cell
time is the ``dryrun/cell`` telemetry span.  Nothing here starts a
process group, except that ``--grad-compression`` on a mesh with a "pod"
axis runs the compressed step over a ``fake`` process group of the pods
in this process; so call ``run_cell`` with it only from its own process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import threading
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from repro_torch import telemetry as T
from repro_torch.configs import (ARCH_IDS, full_config, shape_supported,
                                 skip_reason)
from repro_torch.core.mx_types import MXINT6_WEIGHT
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.launch import mesh as M
from repro_torch.launch.step_cost import StepCost, tag_tree
from repro_torch.models import build_model
from repro_torch.models.model_api import (ALL_SHAPES, ModelConfig,
                                          ShapeConfig, shape_by_name)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.serving.engine import (make_decode_step, make_prefill_step,
                                        pack_params_mxint)
from repro_torch.train.state import abstract_train_state, make_train_state
from repro_torch.train.step import make_train_step

OUT_DIR = R.OUT_DIR
MESH_CHOICES = {"single": ["single_16x16"], "multi": ["multi_2x16x16"],
                "both": ["single_16x16", "multi_2x16x16"],
                "tiny_single": ["tiny_2x2"], "tiny_multi": ["tiny_2x2x2"]}


@dataclasses.dataclass
class Cell:
    """One cell's step, its arguments and their layout groups."""
    cfg: ModelConfig
    shape: ShapeConfig
    rules: ShardingRules
    step: Any
    args: tuple
    groups: Dict[str, tuple]
    tags: Any
    n_split: int                  # the devices the step's work splits over


def _random_batch(cfg, shape, kind, device, seed):
    """The batch of ``batch_specs`` with random tokens and embeddings."""
    specs, axes = S.batch_specs(cfg, shape, kind, device="meta")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for k, t in specs.items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                   dtype=torch.int32, device=device)
        else:
            out[k] = torch.randn(t.shape, generator=gen, device=device,
                                 dtype=torch.float32).to(t.dtype)
    return out, axes


_POD_MESH = {}


def _pod_mesh(n_pods: int):
    """A ("pod",) mesh over a ``fake`` process group of ``n_pods`` ranks in
    this process (rank 0): the compressed step's pod group, whose
    collectives move nothing."""
    if n_pods not in _POD_MESH:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if not dist.is_initialized():
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n_pods)
        _POD_MESH[n_pods] = init_device_mesh("cpu", (n_pods,),
                                             mesh_dim_names=("pod",))
    return _POD_MESH[n_pods]


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Dict[str, int],
               rules: ShardingRules = ShardingRules(),
               variant: str = "bf16", grad_compression: bool = False,
               microbatches: int = 1, device="meta", seed: int = 0) -> Cell:
    """The cell's step and arguments on ``device``: ``meta`` for the dry
    run, a card for checking it (random weights from ``seed``, zero
    caches, random tokens)."""
    device = torch.device(device)
    meta = device.type == "meta"
    model = build_model(cfg)
    n_dev = math.prod(mesh.values())
    n_split = n_dev
    if shape.kind == "decode" and shape.global_batch < (
            mesh.get("pod", 1) * mesh.get("data", 1)):
        # the reference's switch: no batch parallelism at batch 1, the
        # cache's positions shard over "data" instead
        rules = dataclasses.replace(rules, batch=None, kv_seq="data")
    if shape.kind == "train":
        pods = mesh.get("pod", 1)
        compress = grad_compression and pods > 1
        if meta:
            state = abstract_train_state(model, grad_compression=compress,
                                         n_pods=pods)
        else:
            state = make_train_state(model, seed, device,
                                     grad_compression=compress, n_pods=pods)
        if meta:
            batch, b_axes = S.batch_specs(cfg, shape, "train", device)
        else:
            batch, b_axes = _random_batch(cfg, shape, "train", device, seed)
        pod_mesh = None
        if compress:
            pod_mesh = _pod_mesh(pods)
            n_split = n_dev // pods       # the step runs one pod's share
        step = make_train_step(
            model, lr_fn=lambda s: torch.tensor(1e-4, device=device),
            opt_cfg=AdamWConfig(), microbatches=microbatches,
            grad_compression=compress, mesh=pod_mesh)
        opt = {"mu": state.opt.mu, "nu": state.opt.nu,
               "opt_step": state.opt.step, "step": state.step,
               "err_fb": state.err_fb}
        opt_axes = {"mu": None, "nu": None, "opt_step": (), "step": (),
                    "err_fb": None}
        groups = {"params": (state.params, None),
                  "opt_state": (opt, opt_axes), "batch": (batch, b_axes)}
        return Cell(cfg, shape, rules, step, (state, batch), groups,
                    tag_tree(state.params), n_split)
    if meta:
        from repro_torch.train.state import _spec_params
        params = _spec_params(model.param_spec(), cfg.dtype)
    else:
        params = model.init(seed, device=device)
    if variant == "mxint":
        params = pack_params_mxint(params, MXINT6_WEIGHT,
                                   model.layer_stacks(),
                                   tp_shards=mesh.get("model", 1))
    elif variant != "bf16":
        raise ValueError(f"variant must be bf16 or mxint, got {variant!r}")
    cache = S.decode_cache_specs(model, shape, device)
    c_axes = S.decode_cache_axes(model)
    kind = shape.kind
    if meta:
        batch, b_axes = S.batch_specs(cfg, shape, kind, device)
    else:
        batch, b_axes = _random_batch(cfg, shape, kind, device, seed)
    groups = {"params": (params, None), "cache": (cache, c_axes),
              "batch": (batch, b_axes)}
    if kind == "prefill":
        args = (params, batch, cache)
        step = make_prefill_step(model)
    else:
        args = (params, batch["tokens"], cache)
        step = make_decode_step(model)
    return Cell(cfg, shape, rules, step, args, groups, tag_tree(params),
                n_split)


def cell_layout(cell: Cell, mesh: Dict[str, int],
                grad_compression: bool = False) -> R.Layout:
    return R.build_layout(
        cell.groups, mesh, cell.rules, cell.shape.kind,
        torch.empty((), dtype=cell.cfg.dtype).element_size(),
        grad_compression=grad_compression and mesh.get("pod", 1) > 1)


# the C stack of the thread a step is counted in: a recurrence over
# thousands of tokens (xLSTM's sLSTM loop) leaves a chain of autograd
# nodes and tensors that Python objects hold, and freeing it recurses
# once a link (a default 8 MiB stack overflows at 4096 tokens)
COUNT_STACK_BYTES = 1 << 30


def count_step(cell: Cell) -> Dict[str, Any]:
    """One run of the cell's step under ``StepCost``: its global counts.
    It runs in a thread of its own with a ``COUNT_STACK_BYTES`` stack,
    where the step's graph is freed too."""
    result: Dict[str, Any] = {}

    def run():
        try:
            with StepCost(cell.tags) as cost:
                out = cell.step(*cell.args)
            del out
            result["counts"] = cost.counts()
        except BaseException as e:              # raised in the caller
            result["error"] = e

    old = threading.stack_size(COUNT_STACK_BYTES)
    try:
        t = threading.Thread(target=run, name="dryrun-step")
        t.start()
        t.join()
    finally:
        threading.stack_size(old)
    if "error" in result:
        raise result["error"]
    return result["counts"]


_COUNTS: Dict[tuple, Dict[str, Any]] = {}


def run_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
             mesh_shape: Dict[str, int],
             rules: ShardingRules = ShardingRules(), variant: str = "bf16",
             grad_compression: bool = False, microbatches: int = 1):
    """One cell's record fields and its seconds.  ``arch`` and ``shape``
    are registry names or configs.  A step already counted in this
    process (the same config, shape, variant and options: the mesh
    changes only the layout) is not run again."""
    cfg = full_config(arch) if isinstance(arch, str) else arch
    shape = shape_by_name(shape) if isinstance(shape, str) else shape
    mesh = dict(mesh_shape)
    with T.span("dryrun/cell", devices=len(mesh)) as sp:
        cell = build_cell(cfg, shape, mesh, rules, variant,
                          grad_compression, microbatches)
        compress = grad_compression and mesh.get("pod", 1) > 1
        key = (cfg, shape, variant, mesh.get("model", 1),
               mesh["pod"] if compress else 0, microbatches)
        if key not in _COUNTS:
            _COUNTS[key] = count_step(cell)
        counts = _COUNTS[key]
        layout = cell_layout(cell, mesh, grad_compression)
        n_dev = math.prod(mesh.values())
        colls = R.collective_terms(counts, layout, cfg)
        roof = R.roofline_from_counts(
            counts, layout, cell.n_split, R.H100, collectives=colls,
            model_flops=R.model_flops_estimate(cfg, shape, n_dev))
    resident = layout.resident_bytes()
    transient = counts["transient_peak_bytes"] / cell.n_split
    extra = {
        "n_devices": n_dev,
        "mesh_shape": mesh,
        "rules": {"batch": cell.rules.batch, "kv_seq": cell.rules.kv_seq},
        "resident_bytes": resident,
        "split": {"devices": cell.n_split,
                  "flops_ideal": counts["flops"] / cell.n_split,
                  "bytes_ideal": counts["bytes"] / cell.n_split,
                  "transient_bytes_ideal": transient},
        "memory": {"resident_bytes": resident["total"],
                   "transient_bytes_ideal": transient,
                   "peak_device_bytes": resident["total"] + transient},
        "roofline": roof.as_dict(),
        "collectives": colls,
        "counts": {k: v for k, v in counts.items() if k != "events"},
    }
    return extra, sp.elapsed_s


def _result(ok, mesh_name, arch, shape, kind, variant, extra=None,
            error=None, seconds=None, tag=""):
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "kind": kind,
           "variant": variant, "ok": ok, "seconds": seconds, "tag": tag}
    if extra:
        rec.update(extra)
    if error:
        rec["error"] = error
    return rec


def parse_rules(text: str) -> ShardingRules:
    """"fsdp=data,kv_seq=data" -> the default rules with those set."""
    rules = ShardingRules()
    if not text:
        return rules
    changes = {}
    for kv in text.split(","):
        k, _, v = kv.partition("=")
        changes[k.strip()] = (None if v.strip() in ("", "None", "none")
                              else v.strip())
    return dataclasses.replace(rules, **changes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=sorted(MESH_CHOICES),
                    help="the production meshes (16x16, 2x16x16) or the "
                         "tiny ones (2x2, 2x2x2)")
    ap.add_argument("--variant", default="auto",
                    help="bf16 | mxint | auto (serve cells run both)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--rules", default="",
                    help="comma list rule=axis changes, e.g. "
                         "fsdp=data,kv_seq=data")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    rules = parse_rules(args.rules)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else [args.shape])
    results, failures = [], 0
    with T.span("dryrun/sweep") as sweep:
        for mesh_name in MESH_CHOICES[args.mesh]:
            mesh = M.mesh_shape(mesh_name)
            for arch in archs:
                for shape_name in shapes:
                    if not shape_supported(arch, shape_name):
                        results.append(_result(
                            True, mesh_name, arch, shape_name, "skip", "-",
                            extra={"skipped": True,
                                   "reason": skip_reason(arch, shape_name)},
                            tag=args.tag))
                        continue
                    kind = shape_by_name(shape_name).kind
                    variants = ([args.variant] if args.variant != "auto"
                                else ["bf16"] if kind == "train"
                                else ["bf16", "mxint"])
                    for variant in variants:
                        name = f"{arch}.{shape_name}.{mesh_name}.{variant}"
                        try:
                            extra, secs = run_cell(
                                arch, shape_name, mesh, rules, variant,
                                args.grad_compression, args.microbatches)
                            rec = _result(True, mesh_name, arch, shape_name,
                                          kind, variant, extra=extra,
                                          seconds=secs, tag=args.tag)
                            print(f"[ok]   {name}  {secs!r} s "
                                  f"bottleneck="
                                  f"{extra['roofline']['bottleneck']}",
                                  flush=True)
                        except Exception:
                            failures += 1
                            rec = _result(False, mesh_name, arch, shape_name,
                                          kind, variant, tag=args.tag,
                                          error=traceback.format_exc())
                            print(f"[FAIL] {name}", flush=True)
                            print(traceback.format_exc()[-2000:], flush=True)
                        results.append(rec)
                        fname = out_dir / (name + (f".{args.tag}" if args.tag
                                                   else "") + ".json")
                        fname.write_text(json.dumps(rec, indent=1))
    n_spans, mean_ms = T.span_stats("dryrun/cell")
    summary = {"cells": len(results), "failures": failures,
               "ok": failures == 0,
               "cell_spans": {"count": n_spans, "mean_ms": mean_ms},
               "seconds": sweep.elapsed_s}
    suffix = f".{args.tag}" if args.tag else ""
    (out_dir / f"summary.{args.mesh}.{args.arch}.{args.shape}{suffix}.json"
     ).write_text(json.dumps({"summary": summary, "results": results},
                             indent=1))
    print(json.dumps(summary))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
