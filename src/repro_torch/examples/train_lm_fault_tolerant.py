"""Train an LM with the production loop: checkpoints, a crash, a resume.

Counterpart of the reference's ``examples/train_lm_fault_tolerant.py``.
Phase 1 trains an architecture's SMOKE config (``--arch``) to half of
``--steps`` with checkpoints, heartbeats and metrics, then "crashes" (the
loop is dropped).  Phase 2 builds a fresh loop, resumes from the newest
checkpoint (parameters, optimizer state, the data stream's position)
and trains to ``--steps``.  A straight run of ``--steps`` from the same
seed is the check: the resumed run must end on the same parameters, bit
for bit, and the same last loss.

The last line printed is a JSON report; the exit code is 1 unless the
resumed run equals the straight one.

    python -m repro_torch.examples.train_lm_fault_tolerant
        [--arch llama3_8b] [--steps 40] [--batch 8] [--seq 32]
        [--dir build/examples/train_lm] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.examples import device_arg
from repro_torch.models import build_model
from repro_torch.models.model_api import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.state import make_train_state
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[3]


def build(arch, root: Path, total_steps, batch, seq, device, every):
    cfg = smoke_config(arch)
    model = build_model(cfg)
    state = make_train_state(model, 0, device)
    data = SyntheticLMData(vocab=cfg.vocab, batch=batch, seq_len=seq,
                           seed=7, device=device)
    step = make_train_step(
        model, lr_fn=lambda s: cosine_schedule(
            s, peak=3e-3, warmup_steps=10, total_steps=total_steps),
        opt_cfg=AdamWConfig(weight_decay=0.01))
    lcfg = LoopConfig(total_steps=total_steps, checkpoint_every=every,
                      log_every=1, checkpoint_dir=str(root / "ckpt"),
                      metrics_path=str(root / "metrics.jsonl"),
                      heartbeat_path=str(root / "heartbeat.json"))
    return TrainLoop(train_step=step, state=state, data=data, cfg=lcfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--dir", default=str(ROOT / "build" / "examples" /
                                         "train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)
    root = Path(args.dir)
    shutil.rmtree(root, ignore_errors=True)
    half = args.steps // 2

    print(f"=== phase 1: train to step {half}, then 'crash' ===")
    loop = build(args.arch, root / "run", half, args.batch, args.seq, dev,
                 half)
    m1 = loop.run()
    print(f"   loss {m1[0]['loss']:.4f} -> {m1[-1]['loss']:.4f}; "
          f"checkpoint committed at step {loop.ckpt.latest_step()}")
    del loop

    print("=== phase 2: a fresh loop resumes from the checkpoint ===")
    loop2 = build(args.arch, root / "run", args.steps, args.batch, args.seq,
                  dev, half)
    resumed = loop2.try_resume()
    print(f"   resumed from step {resumed} (data stream index "
          f"{loop2.data.state.next_index})")
    m2 = loop2.run(start_step=resumed)
    print(f"   final loss {m2[-1]['loss']:.4f} at step {m2[-1]['step']}")

    print("=== the straight run, for the check ===")
    straight = build(args.arch, root / "straight", args.steps, args.batch,
                     args.seq, dev, args.steps)
    m3 = straight.run()
    same = all(torch.equal(a.value, b.value) for a, b in zip(
        tree_leaves(loop2.state.params), tree_leaves(straight.state.params)))
    print(f"   resumed == straight (bit): {same}; last loss "
          f"{m2[-1]['loss']!r} / {m3[-1]['loss']!r}")
    ok = (same and resumed == half and m2[-1]["loss"] == m3[-1]["loss"]
          and m2[-1]["step"] == args.steps)
    print(json.dumps({"example": "train_lm_fault_tolerant",
                      "arch": args.arch, "device": str(dev),
                      "steps": args.steps, "resumed_from": resumed,
                      "first_loss": m1[0]["loss"],
                      "final_loss": m2[-1]["loss"],
                      "straight_final_loss": m3[-1]["loss"],
                      "resumed_equals_straight": same, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
