"""Serve a DeiT classifier fully quantized in MXInt, kernel against sim.

Counterpart of the reference's ``examples/serve_deit_mxint.py``: the
paper's deployment, a ViT whose every operator (linears, LayerNorm, GELU,
softmax) runs the MXInt datapath, behind a batched service.  A micro
DeiT is trained in float for ``--train-steps`` on the synthetic 100-class
task, its weights packed once into int8 mantissa and exponent planes,
and served in kernel mode (the Hopper kernels; on the CPU their plain
versions) through ``ViTServingEngine`` and ``ClassifyScheduler``:
requests of a random 1..batch images each are packed across request
boundaries into the fixed batch.  Every batch the engine runs is held
bit for bit against the "sim" model (the bit-accurate datapath) on the
same images: the serving datapath is the validated one.

With ``--tp N`` the packed planes are split over an N-rank "model" mesh
(``parallel.spawn``: N processes over gloo, sharing the card on one),
column-wise, which is bit for bit the single device's result.

``--metrics-json PATH`` writes the telemetry snapshot of the run and, on
the card, the kernel probes joined to the Hopper cost table.  The last
line printed is a JSON report; the exit code is 1 unless every batch is
equal to sim.

    python -m repro_torch.examples.serve_deit_mxint [--requests 64]
        [--batch 16] [--tp 2] [--train-steps 300] [--metrics-json out]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import telemetry as T
from repro_torch.configs.deit import DEIT_MICRO
from repro_torch.core.mx_types import QuantConfig
from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.examples import device_arg
from repro_torch.models import build_model
from repro_torch.models.model_api import Param, tree_map
from repro_torch.serving.engine import ServeConfig, make_engine, params_to
from repro_torch.serving.scheduler import ClassifyRequest, ClassifyScheduler

# the reference's micro-DeiT task (benchmarks/common.py)
BENCH_DEIT = dataclasses.replace(DEIT_MICRO, n_classes=100)
TASK = dict(n_classes=100, image_size=32, noise=1.0, class_sep=0.25,
            outlier_channels=False)
KERNEL = QuantConfig(mode="kernel", quantize_nonlinear=True)
SIM = QuantConfig(mode="sim", quantize_nonlinear=True)


def train_float(steps: int, device, seed: int = 0):
    """The float micro DeiT after ``steps`` AdamW steps at batch 64."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import make_train_state, make_train_step
    model = build_model(BENCH_DEIT)
    state = make_train_state(model, seed, device)
    step = make_train_step(model, lr_fn=lambda s: torch.tensor(
        1e-3, device=device), opt_cfg=AdamWConfig(weight_decay=0.01))
    data = SyntheticImageData(batch=64, seed=seed, device=device, **TASK)
    loss = None
    for _ in range(steps):
        state, m = step(state, data.next_batch())
        loss = float(m["loss"])
    params = tree_map(lambda p: Param(p.value.detach(), p.axes),
                      state.params)
    return model, params, loss


class Recorder:
    """The engine, with every batch it runs kept: (images, logits)."""

    def __init__(self, engine):
        self.engine, self.cfg, self.model = engine, engine.cfg, engine.model
        self.batches = []

    def logits_batch(self, chunk):
        out = self.engine.logits_batch(chunk)
        self.batches.append((np.array(chunk), out.float().cpu()))
        return out


def make_requests(images: np.ndarray, batch: int, seed: int = 7):
    """The pool cut into requests of a random 1..batch images each."""
    rng = np.random.default_rng(seed)
    reqs, off = [], 0
    while off < images.shape[0]:
        n = int(rng.integers(1, batch + 1))
        reqs.append(ClassifyRequest(uid=len(reqs), images=images[off:off + n]))
        off += n
    return reqs


def serve(params, images, batch: int, device, mesh=None):
    """Serve ``images`` as mixed-size requests in kernel mode; returns
    (the finished requests, the recorded batches, the serve span's
    seconds)."""
    model_k = build_model(dataclasses.replace(BENCH_DEIT, quant=KERNEL))
    engine = make_engine(model_k, params, ServeConfig(
        batch=batch, pack_weights=True, weight_fmt=KERNEL.weight_fmt),
        mesh=mesh, device=device)
    rec = Recorder(engine)
    engine.logits_batch(images[:batch])              # warm: the build
    sched = ClassifyScheduler(rec)
    for r in make_requests(images, batch):
        sched.submit(r)
    with T.span("examples/serve_deit", device=device) as sp:
        done = sched.run()
    return done, rec.batches, sp.elapsed_s


def _rank_serve(rank, world, device, params, images, batch):
    """One rank of ``--tp``: the same stream over its planes' slice."""
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.parallel.spawn import rank_device
    dev = rank_device(rank, device)
    mesh = make_tp_mesh(world, device_type=dev.type)
    done, batches, secs = serve(params_to(params, dev), images, batch, dev,
                                mesh)
    return ([(r.uid, r.labels, r.logits) for r in done],
            [(c, l.numpy()) for c, l in batches], secs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=64,
                    help="total images to serve")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1,
                    help="split the packed planes over an N-rank 'model' "
                         "mesh")
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--metrics-json", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)

    print(f"training the float micro DeiT ({args.train_steps} steps, "
          f"synthetic 100-class task)...")
    model_f, params, loss = train_float(args.train_steps, dev)
    data = SyntheticImageData(batch=args.batch, seed=123, device="cpu",
                              **TASK)
    pool = [data.next_batch() for _ in range(
        -(-args.requests // args.batch))]
    images = torch.cat([b["images"] for b in pool]).numpy()
    labels = torch.cat([b["labels"] for b in pool]).numpy()

    if args.tp > 1:
        from repro_torch.parallel.spawn import spawn
        print(f"serving sharded: packed planes over a {args.tp}-rank "
              f"'model' mesh (column, bit for bit)")
        out = spawn(_rank_serve, args.tp, args=(
            params_to(params, "cpu"), images, args.batch),
            device="cpu" if dev.type == "cpu" else "cuda")
        finished, batches, secs = out[0]
        done = [ClassifyRequest(uid=u, images=np.zeros(0), labels=lb,
                                logits=lg, done=True)
                for u, lb, lg in finished]
        batches = [(c, torch.as_tensor(l)) for c, l in batches]
        ranks_equal = all(
            all(np.array_equal(a[1], b[1]) for a, b in zip(batches, o[1]))
            for o in out[1:])
    else:
        done, batches, secs = serve(params, images, args.batch, dev)
        ranks_equal = True

    model_s = build_model(dataclasses.replace(BENCH_DEIT, quant=SIM))
    equal = 0
    with torch.no_grad():
        for chunk, got in batches:
            x = torch.as_tensor(chunk, device=dev)
            want = model_s.logits(params, x).float().cpu()
            equal += bool(torch.equal(got, want))
        ref = model_f.logits(params, torch.as_tensor(images, device=dev))
    done = sorted(done, key=lambda r: r.uid)
    pred = np.concatenate([r.labels for r in done])
    n = images.shape[0]
    accuracy = float(np.mean(pred == labels))
    agree = float(np.mean(pred == ref.argmax(-1).cpu().numpy()))
    print(f"\nserved {n} images across {len(done)} mixed-size requests in "
          f"{secs:.3f} s ({n / secs:.1f} img/s, kernel mode, packed planes"
          f"{f', tp={args.tp}' if args.tp > 1 else ''}, {dev.type})")
    print(f"  accuracy (MXInt)    : {accuracy:.4f}  (train loss {loss:.4f})")
    print(f"  agreement w/float   : {agree:.4f}")
    print(f"  kernel == sim (bit) : {equal}/{len(batches)} batches")
    report = {"example": "serve_deit_mxint", "device": str(dev),
              "images": n, "requests": len(done), "batches": len(batches),
              "kernel_equals_sim": equal, "ranks_equal": ranks_equal,
              "accuracy": accuracy, "float_agreement": agree,
              "serve_s": secs, "img_per_s": n / secs, "tp": args.tp}
    if args.metrics_json:
        from repro_torch.telemetry import export, probes
        extra = {"run": report}
        if dev.type == "cuda":
            probes.run_probes(device=dev)
            extra["predicted_vs_measured"] = export.predicted_vs_measured()
        payload = export.json_snapshot(path=args.metrics_json, extra=extra)
        print(f"  metrics -> {args.metrics_json} "
              f"({len(payload.get('histograms', {}))} histograms)")
    ok = equal == len(batches) and ranks_equal and len(done) > 0
    print(json.dumps({**report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
