"""Sharded kernel-mode serving self-check.

    python -m repro_torch.serving.sharded_check --tp 2 [--dp N]
        [--device cpu|cuda] [--layers 2] [--classes 100] [--batch 4]

Counterpart of ``repro.serving.sharded_check``.  It spawns ``tp * dp``
ranks (``parallel.spawn``: gloo over localhost; on ``--device cuda``
every rank on the card, sharing it when there is one) and prints one JSON
object:

  1. parity: DeiT-Tiny-width ``classify()`` on the sharded kernel-mode
     engine against the port's single-device kernel-mode engine (run in
     this process): bit for bit with the column strategy.  The row
     strategy packs the K-sharded planes with smaller blocks
     (``pack_params_mxint(tp_shards=)``), so it serves a slightly
     different quantized model: it is held, with argmax equal, to the
     single-device engine on those same planes (its gap is then only the
     two partial sums added), and its gap to the default planes is
     reported.  The gap to the port's own "sim" logits is reported
     beside.
  2. scheduler: a mixed stream of requests (3, 5, 1, 8, 2, 7, 4 images)
     through ``ClassifyScheduler`` on the column engine: every request
     classified, and each forward's kernels on each rank equal to
     ``models.launches.vit_launches``: on the card by the kernels' own
     launch counters, on the CPU (where nothing launches) by their
     calls.
  3. with ``--dp N`` the mesh is ("data", "model"): batch rows over the
     data ranks composed with the model shards, held bit for bit as
     above, and a data-only engine (the mesh's "data" axis) too.

The rank-side tasks are functions of this module, so the CPU tests and
``chip_smoke.py`` run them through ``parallel.spawn`` as well.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.configs import deit
from repro_torch.core.mx_types import MXINT6_WEIGHT, QuantConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (make_serving_mesh, make_test_mesh,
                                     make_tp_mesh)
from repro_torch.models.launches import count_calls, vit_launches
from repro_torch.models.model_api import Param, tree_map
from repro_torch.models.vit import ViT
from repro_torch.parallel import collectives
from repro_torch.parallel.spawn import rank_device, spawn
from repro_torch.serving.engine import (ServeConfig, ViTServingEngine,
                                        pack_params_mxint)
from repro_torch.serving.scheduler import ClassifyRequest, ClassifyScheduler

KERNEL = QuantConfig(mode="kernel", quantize_nonlinear=True)
SIM = QuantConfig(mode="sim", quantize_nonlinear=True)
STREAM = (3, 5, 1, 8, 2, 7, 4)
# the row strategy against the single-device engine on the same planes,
# as a share of the logit scale (each rank sums its K half, then the two
# halves are added).  Measured 0: DeiT-Tiny at 2 layers on 2 gloo CPU
# ranks (tests/test_torch_tp.py), DeiT-Base at 12 layers on 2 ranks
# sharing one H100 (chip_smoke.py's tp phase)
ROW_TOL = 1e-3


def deit_config(arch: str = "deit_tiny", n_layers: int = 2,
                n_classes: int = 100, quant: QuantConfig = KERNEL):
    return dataclasses.replace(deit.BY_NAME[arch], n_layers=n_layers,
                               n_classes=n_classes, quant=quant)


def images(n: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# rank-side tasks
# ---------------------------------------------------------------------------
def build_mesh(spec, device: str):
    """``spec`` = (shape, axis names, the axis to take as a 1-D submesh or
    None)."""
    shape, names, sub = spec
    dt = "cpu" if device == "cpu" else "cuda"
    if tuple(names) == ("model",):
        mesh = make_tp_mesh(shape[0], dt)
    elif tuple(names) == ("data", "model"):
        mesh = make_serving_mesh(shape[0], shape[1], dt)
    else:
        mesh = make_test_mesh(tuple(shape), tuple(names), dt)
    return mesh[sub] if sub else mesh


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_task(device, mesh, cfg, params, imgs, batch: int, strategy: str,
               stream=None, timed: int = 0):
    """One sharded engine on this rank: its logits of ``imgs``, the kernel
    calls, launches and collectives of one forward, and optionally the
    scheduler stream (request sizes; each step's kernel calls and its
    launches by the kernels' own counters) and ``timed`` timed batches
    (ms of a ``telemetry.span``: CUDA events on the card, the host clock
    on the CPU).  The counters move only where a kernel launches, so on
    the CPU the calls (``count_calls``) show the path's structure."""
    model = ViT(cfg)
    eng = ViTServingEngine(model, params, ServeConfig(
        batch=batch, pack_weights=True, weight_fmt=cfg.quant.weight_fmt,
        tp_strategy=strategy), device=device, mesh=mesh)
    out = {"strategy": strategy, "tp": eng.tp, "dp": eng.dp}
    collectives.reset_counts()
    launched = ops.launch_counts()
    with count_calls() as calls:
        _, logits = eng.classify(imgs)
    _sync(eng.device)
    launched = {k: v - launched[k] for k, v in ops.launch_counts().items()}
    out["logits"] = logits.float().cpu().numpy()
    chunks = -(-imgs.shape[0] // batch)
    out["calls_per_forward"] = {k: v // chunks for k, v in calls.items()}
    # the kernels' own counters (0 on the CPU, where nothing launches)
    out["launches_per_forward"] = {k: v // chunks
                                   for k, v in launched.items()}
    out["collectives_per_forward"] = {
        k: v // chunks for k, v in collectives.COUNTS.items()}
    if stream is not None:
        rng = np.random.default_rng(1)
        sched = ClassifyScheduler(eng)
        size = cfg.image_size
        for uid, n in enumerate(stream):
            sched.submit(ClassifyRequest(uid=uid, images=rng.normal(
                size=(n, size, size, 3)).astype(np.float32)))
        per_step, launched_per_step = [], []
        while True:
            before = ops.launch_counts()
            with count_calls() as calls:
                n = sched.step()
            _sync(eng.device)
            if not n:
                break
            per_step.append(dict(calls))
            launched_per_step.append({k: v - before[k] for k, v in
                                      ops.launch_counts().items()})
        done = sched.finished
        out["stream"] = {
            "requests": len(done), "images": int(sum(stream)),
            "all_classified": bool(len(done) == len(stream) and all(
                r.done and r.logits.shape == (stream[r.uid], cfg.n_classes)
                for r in done)),
            "calls_per_step": per_step,
            "launches_per_step": launched_per_step}
    if timed:
        chunk = imgs[:batch]
        eng.logits_batch(chunk)
        ms = []
        for _ in range(timed):
            with T.span("sharded/logits_batch", device=eng.device) as sp:
                eng.logits_batch(chunk)
            ms.append(sp.elapsed_ms)
        out["ms_per_batch"] = ms
    if eng.device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(eng.device) / 2**30
    return out


def row_linear_task(device, mesh, x, mant, exp, block: int,
                    act_block: int = 16, act_mant_bits: int = 8):
    """One linear on this rank's K rows of the planes (the row strategy's
    psum): returns the all-reduced output."""
    from repro_torch.kernels import ops
    n, r = mesh.size(0), mesh.get_local_rank("model")
    k = mant.shape[0] // n
    y = ops.mxint_linear(
        torch.as_tensor(x, device=device),
        torch.as_tensor(mant[r * k:(r + 1) * k], device=device),
        torch.as_tensor(exp[r * k // block:(r + 1) * k // block],
                        device=device),
        w_block=block, quantize_act=True, act_block=act_block,
        act_mant_bits=act_mant_bits, tp_group=mesh.get_group("model"),
        tp_mode="psum")
    return y.cpu().numpy()


def compressed_psum_task(device, mesh, grads, errs):
    """``compressed_psum`` of this rank's ``grads[r]`` and ``errs[r]``
    over the mesh's first axis."""
    from repro_torch.core.gradient_compression import compressed_psum
    r = mesh.get_local_rank(mesh.mesh_dim_names[0])
    g = [torch.as_tensor(a, device=device) for a in grads[r]]
    e = [torch.as_tensor(a, device=device) for a in errs[r]]
    red, new = compressed_psum(g, mesh.get_group(mesh.mesh_dim_names[0]), e)
    return ([t.cpu().numpy() for t in red], [t.cpu().numpy() for t in new])


def pod_step_task(device, mesh, cfg, params, batch, steps: int = 1,
                  lr: float = 1e-3, keep_params: bool = True):
    """``steps`` pod-compressed train steps (``make_train_step`` with
    ``grad_compression=True`` over the mesh's "pod" axis) of ``cfg`` from
    ``params`` on ``batch`` (the global batch; each pod takes its slice).
    Per step the loss, the grad norm, the ms (a ``telemetry.span``:
    CUDA events on the card) and whether this pod's residuals are nonzero
    after it; the peak GiB on a card; with ``keep_params`` every parameter and
    this pod's residuals, in ``tree_leaves`` order."""
    from repro_torch.models import build_model
    from repro_torch.models.model_api import tree_leaves
    from repro_torch.train.state import train_state_from_params
    from repro_torch.train.step import make_train_step
    model = build_model(cfg)
    n_pods = mesh.size(mesh.mesh_dim_names.index("pod"))
    pod = mesh.get_local_rank("pod")
    state = train_state_from_params(
        tree_map(lambda p: Param(p.value.to(device), p.axes), params),
        grad_compression=True, n_pods=n_pods)
    step = make_train_step(model, lr_fn=lambda s: lr, grad_compression=True,
                           mesh=mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics = []
    for _ in range(steps):
        with T.span("sharded/pod_step", device=device) as sp:
            state, m = step(state, batch)
        err = [e.value[pod] for e in tree_leaves(state.err_fb)]
        metrics.append({"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "ms": sp.elapsed_ms,
                        "err_nonzero": bool(any(bool((e != 0).any())
                                                for e in err))})
    out = {"metrics": metrics, "pod": pod,
           "err_nonzero": metrics[-1]["err_nonzero"]}
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    if keep_params:
        out["params"] = [p.value.detach().cpu().numpy()
                         for p in tree_leaves(state.params)]
        out["err"] = [e.cpu().numpy() for e in err]
    return out


TASKS = {"serve": serve_task, "row_linear": row_linear_task,
         "compressed_psum": compressed_psum_task, "pod_step": pod_step_task}


def run_tasks(rank: int, world: int, device: str, tasks):
    """Rank entry: ``tasks`` is a list of (task name, mesh spec, keyword
    arguments); returns each task's result.  Meshes of one spec are made
    once."""
    dev = rank_device(rank, device)
    meshes, out = {}, []
    for name, spec, kw in tasks:
        key = repr(spec)
        if key not in meshes:
            meshes[key] = build_mesh(spec, device)
        out.append(TASKS[name](dev, meshes[key], **kw))
    return out


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------
def single_device_logits(cfg, params, imgs, batch: int, device):
    model = ViT(cfg)
    eng = ViTServingEngine(model, params, ServeConfig(
        batch=batch, pack_weights=True, weight_fmt=cfg.quant.weight_fmt),
        device=device)
    return eng.classify(imgs)[1].float().cpu().numpy()


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    return {"bit_exact": bool(np.array_equal(got, want)),
            "max_abs_diff": float(np.max(np.abs(got - want))),
            "scale": float(np.max(np.abs(want))),
            "argmax_equal": bool(np.array_equal(got.argmax(-1),
                                                 want.argmax(-1)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=2, help="model-axis ranks")
    ap.add_argument("--dp", type=int, default=1, help="data-axis ranks")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--classes", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--arch", default="deit_tiny", choices=deit.BY_NAME)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    world = args.tp * args.dp
    cfg = deit_config(args.arch, args.layers, args.classes)
    params = ViT(cfg).init(0, device="cpu")
    imgs = images(args.batch, cfg.image_size, 0)
    dev = torch.device("cpu") if args.device == "cpu" else rank_device(
        0, args.device)
    want = single_device_logits(cfg, params, imgs, args.batch, dev)
    want_row = single_device_logits(
        cfg, pack_params_mxint(params, cfg.quant.weight_fmt,
                               tp_shards=args.tp), imgs, args.batch, dev)
    sim = ViT(dataclasses.replace(cfg, quant=SIM)).logits(
        params, torch.from_numpy(imgs)).detach().numpy()
    spec = ((args.dp, args.tp), ("data", "model"), None) if args.dp > 1 \
        else ((args.tp,), ("model",), None)
    common = dict(cfg=cfg, params=params, imgs=imgs, batch=args.batch)
    tasks = [("serve", spec, dict(common, strategy=s,
                                  stream=STREAM if s == "column" else None))
             for s in ("column", "row")]
    if args.dp > 1:
        tasks.append(("serve", ((args.dp, args.tp), ("data", "model"),
                                "data"), dict(common, strategy="column")))
    t0 = T.walltime()
    ranks = spawn(run_tasks, world, (tasks,), device=args.device)
    col, row = ranks[0][0], ranks[0][1]
    report = {
        "device": args.device, "ranks": world, "tp": args.tp, "dp": args.dp,
        "arch": f"{args.arch}_L{args.layers}", "seconds":
            T.walltime() - t0,
        "parity": {"column": compare(col["logits"], want),
                   "row": compare(row["logits"], want_row),
                   "row_vs_default_planes": compare(row["logits"], want)},
        "vs_sim": {"column": compare(col["logits"], sim)},
    }
    want_calls = {s: {k: v for k, v in vit_launches(
        cfg, s, args.tp, cfg.quant.weight_fmt).items() if v}
        for s in ("column", "row")}
    # on the card the kernels' own counters, on the CPU the calls
    read = "launches" if args.device == "cuda" else "calls"

    def nonzero(c):
        return {k: v for k, v in c.items() if v}

    calls = {s: [nonzero(r[i][f"{read}_per_forward"]) for r in ranks]
             for i, s in enumerate(("column", "row"))}
    stream = col["stream"]
    report[f"{read}_per_forward"] = {s: {"want": want_calls[s],
                                         "ranks": calls[s]}
                                     for s in want_calls}
    report["scheduler"] = {k: v for k, v in stream.items()
                           if k not in ("calls_per_step",
                                        "launches_per_step")}
    ok = (report["parity"]["column"]["bit_exact"]
          and report["parity"]["row"]["argmax_equal"]
          and report["parity"]["row"]["max_abs_diff"]
          <= ROW_TOL * report["parity"]["row"]["scale"]
          and stream["all_classified"]
          and all(c == want_calls[s] for s in calls for c in calls[s])
          and all(nonzero(c) == want_calls["column"]
                  for c in stream[f"{read}_per_step"]))
    if args.dp > 1:
        report["parity_dp_only"] = compare(ranks[0][2]["logits"], want)
        ok = ok and report["parity_dp_only"]["bit_exact"]
    report["ok"] = bool(ok)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
