"""Metrics aggregation: event/bench JSONL -> per-op tables (port of
slate_tpu/obs/metrics.py).

Consumes the line formats the repo emits:

- ``slate-obs-v1`` driver events (obs/events.py), spans (obs/tracer.py),
  serving records (serve/server.py, serve/pool.py) and checkpoint records,
- ``slate-bench-v1`` bench lines (pre-schema ``BENCH_r*.json`` wrapper
  files too: anything with a ``metric`` key),

and aggregates them into per-op latency percentiles (p50/p99 of
``dur_ms``), device time and MFU, escalation / ABFT / certificate-failure
rates, plan usage, a serving table (bucket occupancy p50/p99, padding
waste, escalations, sheds, quarantines, failovers and retunes per row,
submit-to-result latency, CUDA-graph captures) and a bench summary.
Where the reference's serving records count ``retraces``, the port's
count ``captures``; a reference record's ``retraces`` is read as its
captures, so both packages' records summarize alike.  Pure stdlib; the
CLI front-end is obs/__main__.py.
"""

from __future__ import annotations

import json
import math

EVENT_SCHEMA = "slate-obs-v1"
BENCH_SCHEMA = "slate-bench-v1"


def load_lines(paths) -> list[dict]:
    """Parse JSONL files (or whole-file JSON arrays); non-JSON lines and
    non-dict records are skipped, not fatal — logs interleave."""
    return load_records(paths)[0]


def load_records(paths) -> tuple[list[dict], int]:
    """Like :func:`load_lines` but also counts MALFORMED lines — lines
    that look like truncated/garbled JSON records (start with ``{`` but
    fail to parse, exactly what a watchdog-killed run leaves behind).
    Ordinary interleaved log lines stay silently skipped.

    Also accepts the historical ``BENCH_r*.json`` wrapper format: a
    single pretty-printed JSON object whose ``tail`` string holds the
    run's log+JSONL mixed output — the metric lines inside ``tail`` are
    extracted as records."""
    out: list[dict] = []
    malformed = 0
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        stripped = text.lstrip()
        whole = None
        if stripped.startswith(("[", "{")):
            try:
                whole = json.loads(stripped)
            except ValueError:
                whole = None
        if isinstance(whole, list):
            for x in whole:
                if isinstance(x, dict):
                    out.append(x)
                else:
                    malformed += 1
            continue
        if isinstance(whole, dict):
            if isinstance(whole.get("tail"), str):
                # pre-schema bench-round wrapper: harvest the tail
                n, m = _parse_lines(whole["tail"], out)
                malformed += m
                if n == 0 and m == 0:
                    out.append(whole)      # no records inside: keep wrapper
            else:
                out.append(whole)          # single-record file
            continue
        malformed += _parse_lines(text, out)[1]
    return out, malformed


def _parse_lines(text: str, out: list) -> tuple[int, int]:
    """Append each parseable JSON-dict line of ``text`` to ``out``;
    returns (records appended, malformed lines).  A line counts as
    malformed only when it *starts* like a JSON record (``{``) and fails
    — plain log lines are not data and are skipped silently."""
    added = malformed = 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            if line.startswith("{"):
                malformed += 1
            continue
        if isinstance(obj, dict):
            out.append(obj)
            added += 1
        elif line.startswith(("{", "[")):
            malformed += 1
    return added, malformed


def split_records(records):
    """(events, spans, serve, bench, ckpt, unknown) from a mixed record
    list.  ``ckpt`` holds the durability layer's ``checkpoint_save`` /
    ``checkpoint_restore`` records (robust/checkpoint.py via
    obs.events.emit_checkpoint); it is appended AFTER bench so existing
    positional consumers (compare.py takes [3], slo.py takes [2]) stay
    valid."""
    events, spans, serve, bench, ckpt, unknown = [], [], [], [], [], []
    for r in records:
        schema, kind = r.get("schema"), r.get("kind")
        if schema == EVENT_SCHEMA and kind == "event":
            events.append(r)
        elif schema == EVENT_SCHEMA and kind == "span":
            spans.append(r)
        elif schema == EVENT_SCHEMA and kind in (
                "serve_batch", "serve_shed", "serve_quarantine",
                "serve_device", "serve_retune"):
            serve.append(r)
        elif schema == EVENT_SCHEMA and kind in (
                "checkpoint_save", "checkpoint_restore"):
            ckpt.append(r)
        elif schema == BENCH_SCHEMA or "metric" in r:
            bench.append(r)
        else:
            unknown.append(r)
    return events, spans, serve, bench, ckpt, unknown


def percentile(values, q: float) -> float | None:
    """Linear-interpolated percentile of a list (q in [0, 100])."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return float(vs[0])
    pos = (len(vs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return float(vs[lo] * (1.0 - frac) + vs[hi] * frac)


def summarize_events(events) -> dict:
    """Per-op aggregate: counts, latency percentiles, failure rates."""
    ops: dict[str, dict] = {}
    for e in events:
        op = e.get("op") or "?"
        s = ops.setdefault(op, {
            "count": 0, "traced": 0, "errors": 0, "escalated": 0,
            "speculated": 0, "abft_detected": 0, "abft_corrected": 0,
            "cert_fail": 0, "unhealthy": 0, "_durs": [], "_dev": [],
            "_mfu": []})
        s["count"] += 1
        if e.get("traced"):
            s["traced"] += 1
        else:
            d = e.get("dur_ms")
            if isinstance(d, (int, float)):
                s["_durs"].append(float(d))
        if isinstance(e.get("device_ms"), (int, float)):
            s["_dev"].append(float(e["device_ms"]))
        if isinstance(e.get("mfu"), (int, float)):
            s["_mfu"].append(float(e["mfu"]))
        status = e.get("status") or "ok"
        if status != "ok":
            s["errors"] += 1
        path = e.get("path") or ""
        if path.startswith("escalated"):
            s["escalated"] += 1
        elif path.startswith("speculated"):
            s["speculated"] += 1
        h = e.get("health")
        if isinstance(h, dict):
            s["abft_detected"] += int(h.get("abft_detected") or 0)
            s["abft_corrected"] += int(h.get("abft_corrected") or 0)
            if h.get("converged") is False:
                s["cert_fail"] += 1
            if h.get("ok") is False:
                s["unhealthy"] += 1
    for s in ops.values():
        durs = s.pop("_durs")
        dev, mfus = s.pop("_dev"), s.pop("_mfu")
        n = max(s["count"], 1)
        s["p50_ms"] = percentile(durs, 50)
        s["p99_ms"] = percentile(durs, 99)
        s["device_p50_ms"] = percentile(dev, 50)
        s["mfu"] = round(sum(mfus) / len(mfus), 4) if mfus else None
        s["escalation_rate"] = round(s["escalated"] / n, 4)
        s["cert_fail_rate"] = round(s["cert_fail"] / n, 4)
        s["error_rate"] = round(s["errors"] / n, 4)
    return ops


def summarize_plans(events) -> dict:
    """Plan-usage table: how often each (op, kernel, nb, source) tuned
    decision was consulted by an emitting driver call."""
    table: dict[str, int] = {}
    for e in events:
        for p in e.get("plans") or []:
            key = (f"{p.get('op')} kernel={p.get('kernel')} "
                   f"nb={p.get('nb')} source={p.get('source')}")
            table[key] = table.get(key, 0) + 1
    return dict(sorted(table.items(), key=lambda kv: -kv[1]))


def summarize_bench(bench) -> dict:
    """Bench lines -> {metric: {value, unit, chip, ...}} plus skip/error
    tallies (watchdog skip lines carry phase + elapsed_s)."""
    metrics: dict[str, dict] = {}
    skipped, errors = [], []
    for b in bench:
        name = b.get("metric") or "?"
        if b.get("skipped"):
            skipped.append({"metric": name, "reason": b.get("reason"),
                            "phase": b.get("phase"),
                            "elapsed_s": b.get("elapsed_s")})
            continue
        if b.get("error"):
            errors.append({"metric": name, "error": b.get("error")})
            continue
        metrics[name] = {k: b[k] for k in
                         ("value", "unit", "chip", "mfu", "vs_baseline",
                          "nb", "bw", "kernel", "op", "n")
                         if k in b and b[k] is not None}
    return {"metrics": metrics, "skipped": skipped, "errors": errors}


def summarize_serve(serve) -> dict:
    """Serving table: per (op, dtype) batch counts, bucket occupancy
    percentiles, padding waste, escalations per 1k problems, the
    capture/compile accounting that proves a warmed server stays warm,
    and ``wa_pps`` — padding-waste-adjusted problems/s, raw throughput
    over the batch durations divided by (1 - waste): throughput per
    unit of LIVE work, the number the ragged serving cores improve.

    Survival records ride the same stream: ``serve_shed`` records count
    into ``shed`` / ``shed_per_1k`` (per 1k offered = served + shed)
    and ``serve_quarantine`` into ``quarantined`` / ``quar_per_1k``
    (per 1k served problems).

    Device-pool records ride it too: ``dev`` counts the distinct pool
    members that served a row's batches, ``failovers`` sums the
    redispatches its batches survived (``serve_batch.failovers``, so
    nothing double-counts the pool's own ``serve_device`` records), and
    ``serve_retune`` hot-swaps land on their own ``ladder/<dtype>``
    row's ``retunes`` column."""
    table: dict[str, dict] = {}

    def row(key):
        return table.setdefault(key, {
            "batches": 0, "problems": 0, "escalated": 0, "compiles": 0,
            "captures": 0, "shed": 0, "quarantined": 0, "failovers": 0,
            "retunes": 0, "_occ": [], "_waste": [], "_dur_ms": 0.0,
            "_lat": [], "_age": [], "_mfu": [], "_devs": set()})

    for e in serve:
        kind = e.get("kind")
        if kind == "serve_device":
            continue        # pool lifecycle, not serving work
        key = f"{e.get('op') or '?'}/{e.get('dtype') or '?'}"
        s = row(key)
        if kind == "serve_shed":
            s["shed"] += 1
            continue
        if kind == "serve_quarantine":
            s["quarantined"] += 1
            continue
        if kind == "serve_retune":
            s["retunes"] += 1
            continue
        s["batches"] += 1
        s["failovers"] += int(e.get("failovers") or 0)
        if e.get("device_id") is not None:
            s["_devs"].add(int(e["device_id"]))
        s["problems"] += int(e.get("problems") or 0)
        s["escalated"] += int(e.get("escalated") or 0)
        s["compiles"] += 1 if e.get("compiled") else 0
        s["captures"] += int(e.get("captures", e.get("retraces")) or 0)
        if isinstance(e.get("occupancy"), (int, float)):
            s["_occ"].append(float(e["occupancy"]))
        if isinstance(e.get("padding_waste"), (int, float)):
            s["_waste"].append(float(e["padding_waste"]))
        if isinstance(e.get("dur_ms"), (int, float)):
            s["_dur_ms"] += float(e["dur_ms"])
        # flight-recorder fields: per-problem lists per batch
        for field, acc in (("latency_ms", "_lat"),
                           ("age_at_flush_ms", "_age")):
            vals = e.get(field)
            if isinstance(vals, list):
                s[acc].extend(float(v) for v in vals
                              if isinstance(v, (int, float)))
        if isinstance(e.get("mfu"), (int, float)):
            s["_mfu"].append(float(e["mfu"]))
    for s in table.values():
        occ, waste = s.pop("_occ"), s.pop("_waste")
        lat, age, mfus = s.pop("_lat"), s.pop("_age"), s.pop("_mfu")
        dur_s = s.pop("_dur_ms") / 1e3
        s["dev"] = len(s.pop("_devs"))
        s["occupancy_p50"] = percentile(occ, 50)
        s["occupancy_p99"] = percentile(occ, 99)
        s["padding_waste_p50"] = percentile(waste, 50)
        s["latency_p50_ms"] = percentile(lat, 50)
        s["latency_p99_ms"] = percentile(lat, 99)
        s["age_p99_ms"] = percentile(age, 99)
        s["mfu"] = round(sum(mfus) / len(mfus), 4) if mfus else None
        probs = max(s["problems"], 1)
        s["esc_per_1k"] = round(1000.0 * s["escalated"] / probs, 2)
        offered = max(s["problems"] + s["shed"], 1)
        s["shed_per_1k"] = round(1000.0 * s["shed"] / offered, 2)
        s["quar_per_1k"] = round(1000.0 * s["quarantined"] / probs, 2)
        w = s["padding_waste_p50"] or 0.0
        s["wa_pps"] = (round(s["problems"] / dur_s / max(1.0 - w, 1e-9), 2)
                       if dur_s > 0 else None)
    return dict(sorted(table.items()))


def summarize_checkpoint(ckpt) -> dict:
    """Durability table: per (op, kind) checkpoint traffic — event count,
    bytes moved, save/restore wall-clock percentiles and the verify
    outcome tally (ok vs each typed refusal reason), so a glance shows
    whether resumes are verifying cleanly and what snapshots cost."""
    table: dict[str, dict] = {}
    for e in ckpt:
        key = f"{e.get('op') or '?'}/{e.get('kind') or '?'}"
        s = table.setdefault(key, {
            "count": 0, "bytes": 0, "ok": 0, "refused": 0,
            "_wall": [], "_reasons": {}})
        s["count"] += 1
        if isinstance(e.get("bytes"), (int, float)):
            s["bytes"] += int(e["bytes"])
        if isinstance(e.get("wall_ms"), (int, float)):
            s["_wall"].append(float(e["wall_ms"]))
        verify = e.get("verify") or "?"
        if verify == "ok":
            s["ok"] += 1
        else:
            s["refused"] += 1
            s["_reasons"][verify] = s["_reasons"].get(verify, 0) + 1
    for s in table.values():
        wall = s.pop("_wall")
        reasons = s.pop("_reasons")
        s["wall_p50_ms"] = percentile(wall, 50)
        s["wall_p99_ms"] = percentile(wall, 99)
        s["refusals"] = ",".join(f"{k}={v}" for k, v in
                                 sorted(reasons.items())) or None
    return dict(sorted(table.items()))


def summarize(paths) -> dict:
    """Everything the CLI prints, as one JSON-able dict."""
    records, malformed = load_records(paths)
    events, spans, serve, bench, ckpt, unknown = split_records(records)
    return {
        "files": [str(p) for p in paths],
        "counts": {"events": len(events), "spans": len(spans),
                   "serve": len(serve), "bench": len(bench),
                   "checkpoint": len(ckpt),
                   "unknown": len(unknown), "malformed": malformed},
        "ops": summarize_events(events),
        "plans": summarize_plans(events),
        "serve": summarize_serve(serve),
        "checkpoint": summarize_checkpoint(ckpt),
        "bench": summarize_bench(bench),
    }


# ------------------------------------------------------------- rendering


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}".rstrip("0").rstrip(".") or "0"
    return str(v)


def _table(headers, rows) -> str:
    cols = [headers] + [[_fmt(c) for c in r] for r in rows]
    widths = [max(len(row[i]) for row in cols) for i in range(len(headers))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)),
             "  ".join("-" * w for w in widths)]
    for r in cols[1:]:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def render(summary: dict) -> str:
    """Human tables for one summarize() result."""
    parts = []
    c = summary["counts"]
    parts.append(f"records: {c['events']} events, {c['spans']} spans, "
                 f"{c.get('serve', 0)} serve batches, "
                 f"{c['bench']} bench lines"
                 + (f", {c['checkpoint']} checkpoint"
                    if c.get("checkpoint") else "")
                 + (f", {c['unknown']} unknown" if c["unknown"] else ""))
    if summary["ops"]:
        rows = [[op, s["count"], s["traced"], s["p50_ms"], s["p99_ms"],
                 s.get("device_p50_ms"), s.get("mfu"),
                 s["escalation_rate"], s["cert_fail_rate"],
                 f"{s['abft_corrected']}/{s['abft_detected']}",
                 s["error_rate"]]
                for op, s in sorted(summary["ops"].items())]
        parts.append("\nper-op events\n" + _table(
            ["op", "calls", "traced", "p50_ms", "p99_ms", "dev_p50_ms",
             "mfu", "esc_rate", "certfail_rate", "abft c/d", "err_rate"],
            rows))
    if summary["plans"]:
        rows = [[k, v] for k, v in summary["plans"].items()]
        parts.append("\nplan usage\n" + _table(["plan", "calls"], rows))
    if summary.get("serve"):
        rows = [[key, s["batches"], s["problems"], s["occupancy_p50"],
                 s["occupancy_p99"], s["padding_waste_p50"],
                 s.get("latency_p50_ms"), s.get("latency_p99_ms"),
                 s.get("mfu"), s.get("wa_pps"), s["esc_per_1k"],
                 s.get("shed_per_1k"), s.get("quar_per_1k"),
                 s.get("dev"), s.get("failovers"), s.get("retunes"),
                 s["captures"], s["compiles"]]
                for key, s in summary["serve"].items()]
        parts.append("\nserving\n" + _table(
            ["op/dtype", "batches", "problems", "occ_p50", "occ_p99",
             "waste_p50", "lat_p50_ms", "lat_p99_ms", "mfu", "wa_pps",
             "esc/1k", "shed/1k", "quar/1k", "dev", "failovers",
             "retunes", "captures", "compiles"],
            rows))
    if summary.get("checkpoint"):
        rows = [[key, s["count"], s["bytes"], s["wall_p50_ms"],
                 s["wall_p99_ms"], s["ok"], s["refused"],
                 s.get("refusals")]
                for key, s in summary["checkpoint"].items()]
        parts.append("\ndurability\n" + _table(
            ["op/kind", "count", "bytes", "wall_p50_ms", "wall_p99_ms",
             "ok", "refused", "refusals"], rows))
    bench = summary["bench"]
    if bench["metrics"]:
        rows = [[m, d.get("value"), d.get("unit"), d.get("mfu"),
                 d.get("chip")] for m, d in sorted(bench["metrics"].items())]
        parts.append("\nbench metrics\n" + _table(
            ["metric", "value", "unit", "mfu", "chip"], rows))
    if bench["skipped"]:
        rows = [[s["metric"], s.get("phase"), s.get("elapsed_s"),
                 s.get("reason")] for s in bench["skipped"]]
        parts.append("\nbench skipped\n" + _table(
            ["metric", "phase", "elapsed_s", "reason"], rows))
    if bench["errors"]:
        rows = [[e["metric"], e.get("error")] for e in bench["errors"]]
        parts.append("\nbench errors\n" + _table(["metric", "error"], rows))
    if c.get("malformed"):
        parts.append(f"\nmalformed={c['malformed']} truncated/garbled "
                     f"line(s) skipped")
    return "\n".join(parts) + "\n"
