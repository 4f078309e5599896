#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the five CUDA
   kernels from ``src/repro_torch/kernels/csrc`` and prints the build time.
2. Kernel phase: each kernel at DeiT-Base batch-16 shapes and at one ragged
   shape, against its plain PyTorch version on the same card inputs
   (tolerance: bit-identical, 0 mismatched elements), timed as a median of
   CUDA events after warmup beside the plain version and, for the two
   matmuls, one ``torch.matmul`` on the dequantized operands; one JSON
   line per kernel.
3. Slice phase: DeiT-Base at full width and depth (12 layers, d 768, 1000
   classes, random weights from a seed, packed MXInt6 planes) serves 5
   requests of 1-16 images through ``ViTServingEngine(batch=16)`` and
   ``ClassifyScheduler``; every kernel's launch count must equal
   (3 + 8 * 12) forwards' worth per batch, kernel by kernel.  One 4-image
   batch is compared with the same model on the CPU through the plain
   versions: argmax equal and logits within 1e-3 of their scale.  One
   forward is also split by kernel with CUDA events around each call.
4. Prints one JSON line of per-kernel results, then as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.

Details also go to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BATCH = 16
DEVICE = "cuda"
# published H100 SXM peaks (NVIDIA data sheet), dense
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# f32 operations per element of the row datapaths, counted from their
# stages (quantize, align, LUT, scale, requantize)
ROW_OPS = {"mxint_layernorm": 30, "mxint_softmax": 30, "mxint_gelu": 16}
REPLACES = {
    "mxint_matmul": "src/repro/kernels/mxint_matmul.py:109",
    "mxint_ln_matmul": "src/repro/kernels/mxint_ln_matmul.py:89",
    "mxint_softmax": "src/repro/kernels/mxint_softmax.py:65",
    "mxint_gelu": "src/repro/kernels/mxint_gelu.py:52",
    "mxint_layernorm": "src/repro/kernels/mxint_layernorm.py:118",
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median per-call time of ``fn`` on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, int8_ops: float = 0.0, f32_ops: float = 0.0):
    """(least time in ms, what bounds it) on the published peaks."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_ops / F32_OPS_PER_S
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def kernel_cases(torch, np):
    """name -> list of (label, kernel call, plain call, bound args,
    library call or None); the first case is the DeiT-Base one."""
    from repro_torch.core.mx_types import MXINT6_WEIGHT
    from repro_torch.core.quantize import dequantize, pack_weight
    from repro_torch.kernels import (mxint_gelu, mxint_layernorm,
                                     mxint_ln_matmul, mxint_matmul,
                                     mxint_softmax)
    rng = np.random.default_rng(SEED)
    dev = DEVICE

    def x(*shape, scale=1.0):
        a = rng.normal(size=shape).astype(np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(dev)

    def planes(K, N):
        return pack_weight(x(K, N, scale=K ** -0.5), MXINT6_WEIGHT)

    rows = BATCH * 197
    cases = {n: [] for n in REPLACES}
    for label, M, K, N in (("deit_base_b16_ffn_wo", rows, 3072, 768),
                           ("ragged", 37, 192, 1000)):
        a, w = x(M, K), planes(K, N)
        wd = dequantize(w)
        cases["mxint_matmul"].append((
            label,
            lambda a=a, w=w: mxint_matmul.mxint_matmul(
                a, w.mantissa, w.exponent, w_block=w.block_size),
            lambda a=a, w=w: mxint_matmul.matmul_blocks(
                a, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=16, act_mant_bits=8),
            bound(M * K * 4 + w.mantissa.numel() + w.exponent.numel()
                  + M * N * 4, int8_ops=2.0 * M * N * K),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    for label, M, d, N in (("deit_base_b16_ln2_wi", rows, 768, 3072),
                           ("ragged", 37, 192, 200)):
        a, w = x(M, d, scale=2.0), planes(d, N)
        g, b = 1.0 + 0.1 * x(d), 0.1 * x(d)
        wd = dequantize(w)

        def plain(a=a, g=g, b=b, w=w):
            y = mxint_layernorm.layernorm_rows(
                a, g, b, act_block=16, mant_bits=8, lut_bits=5,
                rms_only=False, quantize_out=True)
            return mxint_matmul.matmul_blocks(
                y, w.mantissa, w.exponent, w_block=w.block_size,
                act_block=16, act_mant_bits=8)
        cases["mxint_ln_matmul"].append((
            label,
            lambda a=a, g=g, b=b, w=w: mxint_ln_matmul.mxint_ln_matmul(
                a, g, b, w.mantissa, w.exponent, w_block=w.block_size),
            plain,
            bound(M * d * 4 + 2 * d * 4 + w.mantissa.numel()
                  + w.exponent.numel() + M * N * 4, int8_ops=2.0 * M * N * d,
                  f32_ops=ROW_OPS["mxint_layernorm"] * M * d),
            lambda a=a, wd=wd: torch.matmul(a, wd)))
    for label, R, n, blk in (("deit_base_b16_scores", BATCH * 12 * 197, 197,
                              1), ("ragged", 37, 64, 16)):
        a = x(R, n, scale=4.0)
        cases["mxint_softmax"].append((
            label,
            lambda a=a, blk=blk: mxint_softmax.mxint_softmax(
                a, act_block=blk, quantize_out=True),
            lambda a=a, blk=blk: mxint_softmax.softmax_rows(
                a, act_block=blk, mant_bits=8, r_bits=2, quantize_out=True),
            bound(2 * R * n * 4, f32_ops=ROW_OPS["mxint_softmax"] * R * n),
            None))
    for label, R, d in (("deit_base_b16_ffn", rows, 3072),
                        ("ragged", 37, 768)):
        a = x(R, d, scale=2.0)
        lut = mxint_layernorm.lut_tensor(mxint_gelu.gelu_table(
            "gelu", 5, 3.0)[0], dev)
        cases["mxint_gelu"].append((
            label,
            lambda a=a: mxint_gelu.mxint_gelu(a),
            lambda a=a, lut=lut: mxint_gelu.gelu_rows(
                a, lut, act_block=16, mant_bits=8, domain=3.0),
            bound(2 * R * d * 4, f32_ops=ROW_OPS["mxint_gelu"] * R * d),
            None))
    for label, R, d, qout in (("deit_base_b16_final_ln", rows, 768, True),
                              ("ragged", 37, 192, False)):
        a, g, b = x(R, d, scale=2.0), 1.0 + 0.1 * x(d), 0.1 * x(d)
        cases["mxint_layernorm"].append((
            label,
            lambda a=a, g=g, b=b, q=qout: mxint_layernorm.mxint_layernorm(
                a, g, b, quantize_out=q),
            lambda a=a, g=g, b=b, q=qout: mxint_layernorm.layernorm_rows(
                a, g, b, act_block=16, mant_bits=8, lut_bits=5,
                rms_only=False, quantize_out=q),
            bound(2 * R * d * 4 + 2 * d * 4,
                  f32_ops=ROW_OPS["mxint_layernorm"] * R * d),
            None))
    return cases


def kernel_phase(torch, np):
    results = {}
    for name, cases in kernel_cases(torch, np).items():
        res = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": REPLACES[name], "max_abs_err": 0.0, "cases": []}
        for i, (label, kern, plain, (b_ms, b_by), lib) in enumerate(cases):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            mism = int((got != want).sum())
            err = float((got - want).abs().max())
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            log(f"[kernel] {name} {label} shape={tuple(got.shape)} "
                f"mismatches={mism} max_abs_err={err!r}")
            if mism:
                raise AssertionError(f"{name} {label}: {mism} elements differ "
                                     f"from the plain version (tolerance 0)")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            case = {"label": label, "mismatches": mism, "max_abs_err": err}
            if i == 0:                       # time the DeiT-Base shape
                case["ms"] = time_ms(kern, iters=20)
                case["plain_ms"] = time_ms(plain, iters=3, warmup=1)
                case["library_ms"] = (time_ms(lib, iters=20)
                                      if lib is not None else None)
                case["bound_ms"], case["bound_by"] = b_ms, b_by
                for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms"):
                    res[k] = case[k]
                log(f"[kernel] {name} {label} ms={case['ms']!r} "
                    f"plain_ms={case['plain_ms']!r} bound_ms={b_ms!r} "
                    f"({b_by}) library_ms={case['library_ms']!r}")
            res["cases"].append(case)
        results[name] = res
        log(json.dumps({"kernel": name, "max_abs_err": res["max_abs_err"],
                        "mismatches": sum(c["mismatches"]
                                          for c in res["cases"]),
                        **{k: res[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}}))
    return results


def kernel_breakdown(torch, engine, chunk, names):
    """ms of one forward spent in each kernel op, from CUDA events recorded
    around every call (the host work between the two events is inside)."""
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in names}
    events = {n: [] for n in names}

    def timed(name, fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            events[name].append((start, end))
            return out
        return call

    try:
        for n in names:
            setattr(ops, n, timed(n, saved[n]))
        engine.logits_batch(chunk)
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(ops, n, saved[n])
    return {n: sum(s.elapsed_time(e) for s, e in ev)
            for n, ev in events.items()}


def slice_phase(torch, np):
    from repro_torch.configs.deit import DEIT_BASE
    from repro_torch.core.mx_types import QuantConfig
    from repro_torch.kernels import (mxint_gelu, mxint_layernorm,
                                     mxint_ln_matmul, mxint_matmul,
                                     mxint_softmax)
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import (ServeConfig, ViTServingEngine,
                                            params_to)
    from repro_torch.serving.scheduler import ClassifyRequest, ClassifyScheduler

    mods = {m.__name__.rsplit(".", 1)[-1]: m for m in (
        mxint_matmul, mxint_ln_matmul, mxint_softmax, mxint_gelu,
        mxint_layernorm)}
    L = DEIT_BASE.n_layers
    per_forward = {"mxint_matmul": 2 * L + 2, "mxint_ln_matmul": 4 * L,
                   "mxint_softmax": L, "mxint_gelu": L, "mxint_layernorm": 1}
    assert sum(per_forward.values()) == 3 + 8 * L

    cfg = dataclasses.replace(
        DEIT_BASE, quant=QuantConfig(mode="kernel", quantize_nonlinear=True))
    model = ViT(cfg)
    params = model.init(SEED, device=DEVICE)
    engine = ViTServingEngine(model, params,
                              ServeConfig(batch=BATCH, pack_weights=True),
                              device=DEVICE)
    rng = np.random.default_rng(SEED + 1)
    sizes = [int(s) for s in rng.integers(1, BATCH + 1, size=5)]
    images = [rng.normal(size=(n, 224, 224, 3)).astype(np.float32)
              for n in sizes]
    engine.logits_batch(np.zeros((BATCH, 224, 224, 3), np.float32))  # warm
    torch.cuda.synchronize()

    sched = ClassifyScheduler(engine)
    for uid, imgs in enumerate(images):
        sched.submit(ClassifyRequest(uid, imgs))
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    n_batches = 0
    while sched.step():
        n_batches += 1
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {n: m.launches for n, m in mods.items()}
    log(f"[slice] request sizes={sizes} batches={n_batches} "
        f"serve_s={serve_s!r} launches={launches}")
    done = sched.finished
    if [r.uid for r in done] != list(range(len(sizes))):
        raise AssertionError("requests did not all finish in order")
    for r, n in zip(done, sizes):
        if r.logits.shape != (n, 1000) or r.labels.shape != (n,) or \
                not np.isfinite(r.logits).all():
            raise AssertionError(f"request {r.uid}: bad result shapes")
    want = {n: c * n_batches for n, c in per_forward.items()}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    if sum(launches.values()) != (3 + 8 * L) * n_batches:
        raise AssertionError(f"launch total is not {3 + 8 * L} per batch")

    full = np.concatenate(images)[:BATCH]
    full = np.concatenate([full, np.zeros((BATCH - len(full),) + full.shape[1:],
                                          np.float32)])
    ms_batch = time_ms(lambda: engine.logits_batch(full), iters=5)
    n_images = sum(sizes)
    stats = {"request_sizes": sizes, "batches": n_batches,
             "images": n_images, "serve_s": serve_s,
             "serve_images_per_s": n_images / serve_s,
             "ms_per_batch": ms_batch,
             "images_per_s": BATCH / (ms_batch / 1e3), "launches": launches}
    log(f"[slice] ms_per_batch={ms_batch!r} (batch {BATCH}) "
        f"images_per_s={stats['images_per_s']!r}")
    per_kernel = kernel_breakdown(torch, engine, full, list(mods))
    stats["kernel_ms_per_batch"] = per_kernel
    stats["other_ms_per_batch"] = ms_batch - sum(per_kernel.values())
    log(f"[slice] device ms per batch by kernel {per_kernel}, other "
        f"(attention products, glue, gaps) {stats['other_ms_per_batch']!r}")

    # the same model on the CPU through the plain versions
    imgs4 = np.concatenate(images)[:4]
    _, gpu = engine.classify(imgs4)
    gpu = gpu.cpu().numpy()
    cpu_engine = ViTServingEngine(model, params_to(params, "cpu"),
                                  ServeConfig(batch=4, pack_weights=True),
                                  device="cpu")
    t0 = time.perf_counter()
    _, ref = cpu_engine.classify(imgs4)
    ref = ref.numpy()
    gap = float(np.abs(gpu - ref).max())
    scale = float(np.abs(ref).max())
    agree = bool((gpu.argmax(-1) == ref.argmax(-1)).all())
    stats.update(cpu_ref_s=time.perf_counter() - t0, cpu_gap=gap,
                 cpu_logit_scale=scale, argmax_agree=agree)
    log(f"[slice] cpu reference: max_abs_gap={gap!r} scale={scale!r} "
        f"argmax_agree={agree}")
    if not agree or gap > 1e-3 * scale:
        raise AssertionError("card and CPU logits disagree beyond 1e-3 of "
                             "their scale or in argmax")
    return stats, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] five kernels built in {time.perf_counter() - t0!r} s")

    kernels = kernel_phase(torch, np)
    stats, launches = slice_phase(torch, np)
    for name, res in kernels.items():
        res["launches"] = launches[name]
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "slice": stats}, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
