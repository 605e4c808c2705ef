"""Perf-regression sentinel: diff two bench rounds metric-by-metric (port
of slate_tpu/obs/compare.py).

``python -m slate_tpu_torch.obs --compare OLD.json NEW.json [--gate pct]``
loads any two bench outputs — ``slate-bench-v1`` JSONL *or* the
pre-schema ``BENCH_r*.json`` wrapper files (metrics.load_records
harvests the JSON lines out of their ``tail`` transcript) — and
classifies every shared metric:

- **improved** / **regressed**: the relative change exceeds the
  metric's NOISE band in the better/worse direction,
- **flat**: within noise.

Direction is a property of the metric (GFLOP/s, speedups, problems/s,
occupancy and mfu are higher-better; waste, overhead percentages and
millisecond latencies are lower-better — :func:`direction`), and the
noise band is wider for metrics we know run noisy (serving throughput,
sweep lines) than for dense single-op GFLOP/s (:func:`noise_pct`).

The GATE is what CI enforces: exit 1 iff any metric regresses beyond
``max(gate, noise)`` percent, so a later round on the card can
mechanically answer "better or worse than the last?" instead of
hand-reading JSON.
Metrics present on only one side are reported (``only_old`` /
``only_new``) but never gate — rounds legitimately grow and lose
metrics as budgets shift.
"""

from __future__ import annotations

from . import metrics as _metrics

#: default relative noise band (percent) and CI gate (percent)
DEFAULT_NOISE_PCT = 5.0
DEFAULT_GATE_PCT = 10.0

#: substrings marking a metric whose smaller values are better
_LOWER_BETTER = ("waste", "overhead", "latency", "_ms", "compile",
                 "retrace", "shed", "quar", "slowdown")
#: metric-name substrings with wider run-to-run noise (percent); first
#: match wins, so survival (timing-sensitive shed/quarantine rates under
#: a live flush loop) and precision (the bf16-rung bench times two full
#: Server routes back to back, doubling the timing jitter surface) and
#: pool (live failover/retune drills riding the same flush loop)
#: outrank the generic serve band
_NOISY = (("survival", 20.0), ("durability", 20.0), ("precision", 20.0),
          ("pool", 20.0), ("serve", 15.0), ("sweep", 10.0),
          ("batch", 10.0), ("lookahead", 10.0))


def direction(metric: str, unit: str | None = None) -> str:
    """'higher' or 'lower' (which way is better) for one metric."""
    name = metric.lower()
    if any(tag in name for tag in _LOWER_BETTER):
        return "lower"
    if unit and unit.lower() in ("ms", "s", "pct_overhead"):
        return "lower"
    return "higher"


def noise_pct(metric: str) -> float:
    name = metric.lower()
    for tag, pct in _NOISY:
        if tag in name:
            return pct
    return DEFAULT_NOISE_PCT


def load_round(path) -> dict:
    """{metric: {value, unit}} for one bench round file; skipped and
    errored lines are excluded (they have no value to compare)."""
    records, _ = _metrics.load_records([path])
    bench = _metrics.split_records(records)[3]
    summary = _metrics.summarize_bench(bench)
    out = {}
    for name, d in summary["metrics"].items():
        v = d.get("value")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = {"value": float(v), "unit": d.get("unit")}
    return out


def compare(old_path, new_path, noise: float | None = None,
            gate: float = DEFAULT_GATE_PCT) -> dict:
    """Classify every shared metric of two rounds.

    Returns ``rows`` (one per shared metric: old/new values, delta_pct,
    class, gated flag), ``only_old`` / ``only_new`` name lists, and
    ``regressions`` — the gated failures that make the CLI exit 1."""
    old, new = load_round(old_path), load_round(new_path)
    rows, regressions = [], []
    for name in sorted(set(old) & set(new)):
        vo, vn = old[name]["value"], new[name]["value"]
        unit = new[name]["unit"] or old[name]["unit"]
        band = noise if noise is not None else noise_pct(name)
        delta_pct = ((vn - vo) / abs(vo) * 100.0) if vo else (
            0.0 if vn == vo else float("inf"))
        better = direction(name, unit)
        gain = delta_pct if better == "higher" else -delta_pct
        if gain > band:
            cls = "improved"
        elif gain < -band:
            cls = "regressed"
        else:
            cls = "flat"
        gated = cls == "regressed" and -gain > max(gate, band)
        row = {"metric": name, "unit": unit, "old": vo, "new": vn,
               "delta_pct": round(delta_pct, 2), "better": better,
               "noise_pct": band, "class": cls, "gated": gated}
        rows.append(row)
        if gated:
            regressions.append(row)
    return {
        "old": str(old_path), "new": str(new_path),
        "gate_pct": gate, "rows": rows, "regressions": regressions,
        "only_old": sorted(set(old) - set(new)),
        "only_new": sorted(set(new) - set(old)),
    }


def render_compare(result: dict) -> str:
    rows = [[r["metric"], r["old"], r["new"], f"{r['delta_pct']:+.1f}%",
             r["unit"] or "-", r["class"] + (" [GATED]" if r["gated"]
                                             else "")]
            for r in result["rows"]]
    parts = [f"compare: {result['old']} -> {result['new']} "
             f"(gate {result['gate_pct']:g}%)"]
    if rows:
        parts.append(_metrics._table(
            ["metric", "old", "new", "delta", "unit", "class"], rows))
    else:
        parts.append("no shared metrics")
    if result["only_old"]:
        parts.append("only in old: " + ", ".join(result["only_old"]))
    if result["only_new"]:
        parts.append("only in new: " + ", ".join(result["only_new"]))
    tally = {"improved": 0, "regressed": 0, "flat": 0}
    for r in result["rows"]:
        tally[r["class"]] += 1
    parts.append(f"compare: {tally['improved']} improved, "
                 f"{tally['flat']} flat, {tally['regressed']} regressed "
                 f"({len(result['regressions'])} gated)")
    return "\n".join(parts) + "\n"
