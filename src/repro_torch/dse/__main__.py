"""Runnable Fig. 1b-style sweep: ``python -m repro_torch.dse``.

Counterpart of ``python -m repro.dse``, with the reference's flags and
defaults and one more, ``--device`` (default ``cuda``; a missing card
raises, there is no CPU fallback; ``--device cpu`` runs the kernels' plain
versions).  Sweeps weight mantissa width (and optionally a per-group
space) on a randomly-initialized DeiT against a synthetic calibration
batch and writes the Pareto JSON report.  With random weights the
accuracy proxy is agreement against the float forward of the same
weights: the datapath-fidelity signal the paper's software emulation
measures, not ImageNet accuracy (not in the repository).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def _space(args):
    from repro_torch.core.mx_types import MXFormat, QuantConfig
    from repro_torch.dse.space import GroupSpace, SearchSpace

    base = QuantConfig(mode=args.base_mode, quantize_nonlinear=True,
                       weight_fmt=MXFormat(mant_bits=8, block_size=256),
                       act_fmt=MXFormat(mant_bits=8, block_size=16))
    widths = tuple(int(b) for b in args.weight_bits.split(","))
    if args.per_group:
        groups = (GroupSpace(scope="block/*/attn",
                             weight_mant_bits=widths),
                  GroupSpace(scope="block/*/ffn",
                             weight_mant_bits=widths))
    else:
        groups = (GroupSpace(scope="*", weight_mant_bits=widths),)
    return SearchSpace(base=base, groups=groups)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description="per-layer DSE sweep: accuracy proxy vs static "
                    "hardware cost (paper Fig. 1b / Table V)")
    p.add_argument("--arch", default="deit_tiny",
                   help="configs.deit.BY_NAME entry (default deit_tiny)")
    p.add_argument("--layers", type=int, default=0,
                   help="truncate to N encoder blocks (0 = full depth)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--mode", dest="base_mode", default="sim",
                   help="base execution mode for candidates")
    p.add_argument("--weight-bits", default="3,4,6,8",
                   help="comma list of weight mantissa widths to sweep")
    p.add_argument("--per-group", action="store_true",
                   help="sweep attn and ffn groups independently")
    p.add_argument("--driver", default="exhaustive",
                   choices=("exhaustive", "greedy", "random", "evolve"))
    p.add_argument("--budget", type=float, default=0.01,
                   help="greedy accuracy-loss budget")
    p.add_argument("--samples", type=int, default=16,
                   help="random-driver sample count")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--probes", action="store_true",
                   help="also run the telemetry kernel probes (measured "
                        "time: device-true on the card)")
    p.add_argument("--out", default="dse_report.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from repro_torch.configs.deit import BY_NAME
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.dse import (Evaluator, build_report, evolutionary_search,
                                 exhaustive_search, greedy_search,
                                 measure_kernels, random_search, write_report)
    from repro_torch.models.vit import ViT
    from repro_torch.serving.engine import _device

    device = _device(args.device, "python -m repro_torch.dse")
    cfg = BY_NAME[args.arch]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = ViT(cfg).init(args.seed, device=device)
    data = SyntheticImageData(n_classes=cfg.n_classes, batch=args.batch,
                              image_size=cfg.image_size, seed=args.seed,
                              device=device)
    images = data.next_batch()["images"]

    space = _space(args)
    ev = Evaluator(space, cfg, params, images, device=device)
    if args.driver == "exhaustive":
        results = exhaustive_search(space, ev)
    elif args.driver == "random":
        results = random_search(space, ev, n=args.samples, seed=args.seed)
    elif args.driver == "evolve":
        results = evolutionary_search(space, ev, seed=args.seed)
    else:
        results = greedy_search(space, ev, budget=args.budget).results

    measured = measure_kernels(device=device) if args.probes else None
    report = build_report(space, results, driver=args.driver,
                          n_evaluations=ev.n_evaluated,
                          measured_ms=measured)
    path = write_report(args.out, report)

    print(f"# {args.arch} layers={cfg.n_layers} batch={args.batch} "
          f"driver={args.driver} space={space.size()} "
          f"evaluated={ev.n_evaluated} device={device}")
    print(f"{'pareto':>6} {'w_bits':>7} {'acc':>6} {'fid':>6} "
          f"{'hbm_bytes':>10}")
    for row in report["candidates"]:
        c = row["cost"]
        print(f"{'*' if row['pareto'] else '':>6} "
              f"{c['weight_bits']:>7.2f} {row['accuracy']:>6.3f} "
              f"{row['fidelity']:>6.3f} {c['kernel_hbm_bytes']:>10}")
    print(f"report -> {path}")
    return report


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
