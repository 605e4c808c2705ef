"""CLI: aggregate slate event/bench JSONL; SLO verdicts; round compare
(port of slate_tpu/obs/__main__.py).

    python -m slate_tpu_torch.obs events.jsonl
    python -m slate_tpu_torch.obs --json events.jsonl > summary.json
    python -m slate_tpu_torch.obs --slo budgets.json events.jsonl
    python -m slate_tpu_torch.obs --prom events.jsonl
    python -m slate_tpu_torch.obs --compare OLD.jsonl NEW.jsonl --gate 10

Accepts any mix of obs event JSONL (slate-obs-v1), span JSONL, serving
records (serve/server.py) and bench output (slate-bench-v1, and
pre-schema BENCH_r*.json wrapper files), and prints per-op
latency/device-time/MFU tables, plan usage, serving (occupancy, waste,
submit-to-result latency p50/p99, waste-adjusted throughput, sheds,
quarantines, failovers, retunes, captures) and bench tables.

Exit codes: 0 clean; 1 a gated ``--compare`` regression or a failed
``--slo`` budget; 2 usage / unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import compare as _compare
from . import metrics, slo


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m slate_tpu_torch.obs",
        description="Summarize slate_tpu_torch event/bench JSONL files, check "
                    "serving SLO budgets, or diff two bench rounds.")
    parser.add_argument("files", nargs="*",
                        help="event JSONL and/or bench JSON-lines files")
    parser.add_argument("--json", action="store_true",
                        help="print results as JSON instead of tables")
    parser.add_argument("--slo", metavar="BUDGETS.json",
                        help="evaluate serving SLO budgets over the "
                             "given event files (exit 1 on any failed "
                             "budget)")
    parser.add_argument("--prom", action="store_true",
                        help="emit the serving aggregate as "
                             "Prometheus-style text")
    parser.add_argument("--compare", nargs=2,
                        metavar=("OLD.json", "NEW.json"),
                        help="diff two bench rounds metric-by-metric "
                             "(exit 1 on a gated regression)")
    parser.add_argument("--gate", type=float,
                        default=_compare.DEFAULT_GATE_PCT,
                        help="regression gate threshold in percent for "
                             "--compare (default %(default)s)")
    parser.add_argument("--noise", type=float, default=None,
                        help="override the per-metric noise band "
                             "(percent) for --compare")
    args = parser.parse_args(argv)

    try:
        if args.compare:
            return _run_compare(args)
        if not args.files:
            parser.error("at least one input file is required "
                         "(or use --compare OLD NEW)")
        if args.slo or args.prom:
            return _run_slo(args)
        summary = metrics.summarize(args.files)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(metrics.render(summary))
    return 0


def _run_compare(args) -> int:
    old_path, new_path = args.compare
    result = _compare.compare(old_path, new_path, noise=args.noise,
                              gate=args.gate)
    if args.json:
        json.dump(result, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(_compare.render_compare(result))
    return 1 if result["regressions"] else 0


def _run_slo(args) -> int:
    records, _ = metrics.load_records(args.files)
    stats = slo.aggregate(records)
    if args.prom:
        sys.stdout.write(slo.export_prometheus(stats))
    if not args.slo:
        return 0
    try:
        budgets = slo.load_budgets(args.slo)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    verdicts = slo.evaluate(stats, budgets)
    if args.json:
        json.dump({"stats": stats, "verdicts": verdicts}, sys.stdout,
                  indent=1, sort_keys=True)
        sys.stdout.write("\n")
    elif not args.prom:
        sys.stdout.write(slo.render_verdicts(verdicts))
    return 1 if any(not v["ok"] for v in verdicts) else 0


if __name__ == "__main__":
    sys.exit(main())
