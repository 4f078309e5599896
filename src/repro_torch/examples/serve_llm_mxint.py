"""Serve an LM on packed MXInt planes with slot-level continuous batching.

Counterpart of the reference's ``examples/serve_llm_mxint.py``: the
weights are stored as int8 mantissa planes and shared exponents (MXInt8,
blocks of 256), the KV cache and the scheduler are ``repro_torch.
serving``'s.  The model is an architecture's SMOKE config (``--arch``,
any of the registry's), random weights from a seed.  ``--kernel``
switches it to ``QuantConfig(mode="kernel")``: every linear reads the
packed planes in the Hopper kernels and every decode step scores the KV
ring in the decode attention kernel (on the CPU, their plain versions).

The last line printed is a JSON report (requests, tokens, the serve
span's seconds, the kernels' launches); the exit code is 1 unless every
request got its tokens, each in the vocabulary.

    python -m repro_torch.examples.serve_llm_mxint [--arch llama3_8b]
        [--requests 6] [--new-tokens 12] [--kernel] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch import telemetry as T
from repro_torch.configs import smoke_config
from repro_torch.core.mx_types import MXINT8_WEIGHT, QuantConfig
from repro_torch.examples import device_arg
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import BatchScheduler, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--kernel", action="store_true",
                    help="kernel mode: the Hopper kernels read the packed "
                         "planes and score the cache ring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)

    cfg = smoke_config(args.arch)
    if args.kernel:
        cfg = dataclasses.replace(
            cfg, quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    model = build_model(cfg)
    params = model.init(0, device=dev)
    print(f"arch={cfg.name}: packing weights to MXInt8 (block 256)...")
    eng = ServingEngine(model, params, ServeConfig(
        max_len=128, batch=2, pack_weights=True, weight_fmt=MXINT8_WEIGHT),
        device=dev)
    sched = BatchScheduler(eng, batch_size=2)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        sched.submit(Request(
            uid=uid, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
            max_new_tokens=args.new_tokens))
    before = ops.launch_counts()
    with T.span("examples/serve_llm", device=dev) as sp:
        done = sched.run(max_steps=500)
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    for r in sorted(done, key=lambda r: r.uid):
        print(f"  req {r.uid}: {len(r.generated)} tokens -> "
              f"{r.generated[:8]}...")
    tokens = sum(len(r.generated) for r in done)
    secs = sp.elapsed_s
    print(f"\n{len(done)} requests, {tokens} tokens in {secs:.3f} s "
          f"({tokens / secs:.1f} tok/s, {dev.type}, continuous batching)")
    ok = (len(done) == args.requests and all(
        len(r.generated) == args.new_tokens
        and all(0 <= t < cfg.vocab for t in r.generated) for r in done))
    print(json.dumps({"example": "serve_llm_mxint", "arch": args.arch,
                      "device": str(dev), "kernel": args.kernel,
                      "requests": len(done), "tokens": tokens,
                      "generated": {r.uid: list(map(int, r.generated))
                                    for r in done},
                      "serve_s": secs, "launches": launches, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
