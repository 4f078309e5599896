"""Quickstart: the MXInt format, outlier isolation and the paper's three
datapaths, then a fully MXInt DeiT forward.

Counterpart of the reference's ``examples/quickstart.py``::

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs.deit import DEIT_MICRO
from repro_torch.core import nonlinear as nl
from repro_torch.core.mx_types import (MXINT6_WEIGHT, MXINT8_ACT,
                                       NonlinearConfig, QuantConfig)
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.examples import device_arg
from repro_torch.models import build_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)
    rng = np.random.default_rng(0)

    # 1. the format: int8 mantissas and a shared exponent a block
    x = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32),
                        device=dev) * 5
    t = quantize(x, MXINT8_ACT)
    x_hat = dequantize(t)
    err = float((x - x_hat).abs().max())
    print("MXInt8 (A8.5):")
    print(f"  bits/element   : {MXINT8_ACT.bits_per_element}")
    print(f"  reconstruction : max|err| = {err:.4f}")
    print(f"  weight format W{MXINT6_WEIGHT.bits_per_element:.2f} -> "
          f"{MXINT6_WEIGHT.density_vs(32):.2f}x denser than f32")

    # 2. outlier isolation: a 1000x outlier leaves the other blocks alone
    y = torch.full((1, 64), 0.01, device=dev)
    y[0, 0] = 1000.0
    yq = dequantize(quantize(y, MXINT8_ACT))
    small = float(yq[0, 20])
    print(f"\noutlier test: small values survive next to a 1000x outlier: "
          f"{small:.4f} (true 0.01)")

    # 3. the three datapaths (paper §III-B)
    cfg = NonlinearConfig()
    g, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    ln = nl.layernorm_value(x, g, b, cfg, MXINT8_ACT)
    ln_ref = torch.nn.functional.layer_norm(x, (64,), eps=1e-6)
    sm = nl.softmax_value(x, cfg, MXINT8_ACT)
    ge = nl.gelu_value(x, cfg, MXINT8_ACT)
    errs = {"layernorm": float((ln - ln_ref).abs().mean()),
            "softmax": float((sm - torch.softmax(x, -1)).abs().mean()),
            "gelu": float((ge - torch.nn.functional.gelu(x)).abs().mean())}
    print("\nMXInt datapaths vs float ops (mean |err|):")
    print(f"  LayerNorm (LUT_1/sqrt, {cfg.ln_lut_entries} entries): "
          f"{errs['layernorm']:.4f}")
    print(f"  Softmax   (LUT_pow2,   {cfg.softmax_lut_entries} entries): "
          f"{errs['softmax']:.4f}")
    print(f"  GELU      (LUT_GELU,   {cfg.gelu_lut_entries} entries): "
          f"{errs['gelu']:.4f}")

    # 4. a fully quantized ViT forward against the float one
    cfg_q = dataclasses.replace(DEIT_MICRO, quant=QuantConfig(
        mode="sim", quantize_nonlinear=True))
    model_q, model_f = build_model(cfg_q), build_model(DEIT_MICRO)
    params = model_f.init(0, device=dev)
    imgs = torch.as_tensor(rng.normal(size=(2, 32, 32, 3)).astype(
        np.float32), device=dev)
    lq, lf = model_q.logits(params, imgs), model_f.logits(params, imgs)
    cos = float(torch.nn.functional.cosine_similarity(
        lq.reshape(1, -1), lf.reshape(1, -1))[0])
    print("\nfully-MXInt DeiT forward (W6/A8.5 + LN/GELU/Softmax "
          "datapaths):")
    print(f"  logit cosine vs float model: {cos:.4f}")
    report = {"example": "quickstart", "device": str(dev),
              "reconstruction_max_err": err, "outlier_small_value": small,
              "datapath_mean_err": errs, "logit_cosine": cos}
    ok = err < 0.1 and abs(small - 0.01) < 1e-3 and cos > 0.9
    print(json.dumps({**report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
