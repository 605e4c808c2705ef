"""CLI: ``python -m slate_tpu_torch.tune [--op OP ...] [--n N ...]``.

Measures every candidate plan for the requested (op, n) grid on the card
(``--device cpu`` tunes on the CPU, where every kernel runs its plain
version), prints one JSON line per candidate and one per winner, and
persists the winners to the plan cache, ``$SLATE_TORCH_TUNE_CACHE`` or
``~/.cache/slate_tpu_torch/plans.json`` (unless --dry-run).  Run once per
card kind.  Exit codes: 0 done; 2 no CUDA device and no ``--device``.

``--serve-hist SIZES.jsonl`` switches to serve-bucket ladder fitting: the
file holds one recorded request size per line (a bare integer or an
object with an ``n``/``size`` field); the tuner fits a padded-area-optimal
ladder of at most ``--hist-rungs`` rungs and persists one ``serve_bucket``
cache entry per rung, which ``tune.serve_buckets`` /
``serve.bucket.default_ladder`` then serve."""

from __future__ import annotations

import argparse
import json
import sys

from . import autotune, plans


def _read_hist(path: str) -> list[int]:
    sizes = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if isinstance(rec, dict):
                rec = rec.get("n", rec.get("size"))
            if rec is None:
                raise ValueError(f"--serve-hist: line without n/size: "
                                 f"{line!r}")
            sizes.append(int(rec))
    return sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.tune")
    ap.add_argument("--op", action="append", choices=plans.OPS,
                    help="op(s) to tune (default: all)")
    ap.add_argument("--n", action="append", type=int,
                    help="problem size(s) (default: 256 512 1024)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dry-run", action="store_true",
                    help="measure + print, do not persist")
    ap.add_argument("--device", default=None,
                    help="device to tune on (default: the current CUDA "
                         "device)")
    ap.add_argument("--serve-hist", metavar="SIZES.jsonl",
                    help="fit + persist the serve_bucket ladder from a "
                         "request-size histogram instead of tuning ops")
    ap.add_argument("--hist-rungs", type=int, default=8,
                    help="max ladder rungs for --serve-hist (default 8)")
    args = ap.parse_args(argv)

    if args.serve_hist:
        chip = plans.chip_kind(args.device)
        sizes = _read_hist(args.serve_hist)
        rungs, w_geo, w_tuned = autotune.tune_serve_buckets(
            sizes, dtype=args.dtype, max_rungs=args.hist_rungs,
            persist=not args.dry_run, device=args.device)
        for r in rungs:
            print(json.dumps({"op": plans.SERVE_BUCKET_OP, "chip": chip,
                              "dtype": args.dtype, "rung": int(r)}))
        print(json.dumps({"op": plans.SERVE_BUCKET_OP, "chip": chip,
                          "dtype": args.dtype, "sizes": len(sizes),
                          "rungs": [int(r) for r in rungs],
                          "padding_waste_geometric": round(w_geo, 4),
                          "padding_waste_tuned": round(w_tuned, 4),
                          "persisted": not args.dry_run}))
        return 0

    try:
        chip = plans.chip_kind(autotune._device(args.device))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for op in args.op or list(plans.OPS):
        for n in args.n or [256, 512, 1024]:
            def report(plan, gf, op=op, n=n):
                print(json.dumps({"op": op, "n": n, "chip": chip,
                                  "kernel": plan.kernel, "nb": plan.nb,
                                  "bw": plan.bw, "gflops": round(gf, 3)}),
                      flush=True)
            best, _ = autotune.tune_op(op, n, args.dtype, iters=args.iters,
                                       persist=not args.dry_run,
                                       device=args.device, report=report)
            print(json.dumps({"op": op, "n": n, "chip": chip,
                              "winner": best.kernel, "nb": best.nb,
                              "bw": best.bw,
                              "persisted": not args.dry_run}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
