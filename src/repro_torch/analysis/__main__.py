"""The port's static-analysis runner: the counterpart of
``tools/repro_lint.py``.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
    python -m repro_torch.analysis                       # on the card
    python -m repro_torch.analysis --list
    python -m repro_torch.analysis --only source-rules,dispatch-seam
    python -m repro_torch.analysis --fixture smem-over-budget  # exits 1
    python -m repro_torch.analysis --fixtures
    python -m repro_torch.analysis --json [PATH]
    python -m repro_torch.analysis --update-cost-baseline

Exits 0 exactly when no error-severity violation is found (warnings are
printed).  ``--fixture NAME`` runs one violating fixture and exits 1 when
it fires, 0 when its rule is dead.  ``--device`` (default ``cuda``) is
where the trace targets run; ``cuda`` raises without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="list the registered rules and exit")
    ap.add_argument("--only", help="comma-separated rules to run")
    ap.add_argument("--skip", default="", help="comma-separated rules to "
                                              "skip")
    ap.add_argument("--fixture", help="run one violating fixture; exits 1 "
                                      "when it fires")
    ap.add_argument("--fixtures", action="store_true",
                    help="list the fixtures and exit")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH", help="write the violations and the cost "
                                         "table as JSON to PATH or stdout")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the trace targets run (default: the card)")
    ap.add_argument("--update-cost-baseline", action="store_true",
                    help="rewrite the cost table's committed baseline")
    args = ap.parse_args(argv)

    import repro_torch.analysis as AN

    if args.update_cost_baseline:
        print(f"repro_torch.analysis: wrote "
              f"{AN.cost_model.write_baseline()}")
        return 0
    if args.list:
        for rule in AN.rules():
            print(f"{rule.name:20s} {rule.description}")
        return 0
    from repro_torch.analysis.fixtures import (FIXTURE_RULES, FIXTURES,
                                               run_fixture)
    if args.fixtures:
        for name in FIXTURES:
            print(f"{name:28s} {FIXTURE_RULES[name]}")
        return 0
    if args.fixture:
        if args.fixture not in FIXTURES:
            print(f"repro_torch.analysis: unknown fixture {args.fixture!r}",
                  file=sys.stderr)
            return 2
        found = run_fixture(args.fixture)
        for v in found:
            print(f"repro_torch.analysis: {v}", file=sys.stderr)
        if not found:
            print(f"repro_torch.analysis: fixture {args.fixture!r} did not "
                  f"fire: its rule is dead", file=sys.stderr)
            return 0
        return 1
    only = args.only.split(",") if args.only else None
    skip = tuple(s for s in args.skip.split(",") if s)
    found = AN.run_rules(ROOT, only=only, skip=skip, device=args.device)
    errors = [v for v in found if v.severity == AN.ERROR]
    if args.json is not None:
        text = json.dumps({
            "rules": [r.name for r in AN.rules()],
            "violations": [{"rule": v.rule, "where": v.where,
                            "severity": v.severity, "message": v.message}
                           for v in found],
            "errors": len(errors),
            "cost_model": AN.cost_model.build_table()}, indent=1,
            default=str)
        if args.json == "-":
            print(text)
        else:
            Path(args.json).write_text(text + "\n")
    for v in found:
        prefix = "" if v.severity == AN.ERROR else "warning "
        print(f"repro_torch.analysis: {prefix}{v}", file=sys.stderr)
    if errors:
        print(f"repro_torch.analysis: {len(errors)} violation(s)",
              file=sys.stderr)
        return 1
    if args.json is None:
        print(f"repro_torch.analysis: clean ({len(AN.rules())} rules, "
              f"device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
