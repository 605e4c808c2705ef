"""SLO verdicts over serving record streams, and the serving layer's live
latency governor (port of slate_tpu/obs/slo.py).

The serving flight recorder (serve/server.py) stamps every request at
submit and every batch at flush, so a stream of ``serve_batch`` records
carries everything a serving SLO needs: per-problem submit-to-result
latency, padding waste, escalations, waste-adjusted throughput and
(under ``obs.timing()``) device-time MFU.  This module turns such a
stream into pass/fail verdicts against DECLARED budgets.

Budgets are a JSON object mapping a target (an ``op/dtype`` key as the
serving table prints it, a bare op for any dtype, ``device:<id>`` for a
pool member, or ``"*"`` for the whole stream) to bounds per metric::

    {
      "*":             {"latency_p99_ms": 250, "esc_per_1k": 5},
      "solve/float32": {"wa_pps": 120, "padding_waste_p50": 0.35}
    }

The bound's DIRECTION is a property of the metric, not the file:
latency / waste / age / escalations / captures are maxima, throughput /
occupancy / mfu are minima (:data:`METRIC_DIRECTION`).  A budget naming
a metric the stream has no data for FAILS: an SLO that passes because
nothing was measured is how regressions ship.

CLI: ``python -m slate_tpu_torch.obs --slo budgets.json events.jsonl``
(exit 0 all pass, 1 any fail); ``--prom`` emits the aggregate as
Prometheus-style text.

Admission control (serve/admission.py) also needs the budget as a LIVE
control signal: :class:`LatencyGovernor`'s rolling p99 of delivered
requests against the declared budget tightens the queue's capacity, and
its rolling p50 estimates the wait that sheds deadline-doomed requests at
admission.
"""

from __future__ import annotations

import json
import threading
from collections import deque

from . import metrics as _metrics
from .metrics import percentile

#: metric -> "max" (bound is a ceiling) or "min" (bound is a floor); the
#: port's serving rows count CUDA-graph ``captures`` where the
#: reference's count retraces
METRIC_DIRECTION = {
    "latency_p50_ms": "max", "latency_p99_ms": "max", "age_p99_ms": "max",
    "padding_waste_p50": "max", "esc_per_1k": "max", "captures": "max",
    "compiles": "max", "shed_per_1k": "max", "quar_per_1k": "max",
    "occupancy_p50": "min", "occupancy_p99": "min", "wa_pps": "min",
    "mfu": "min", "problems": "min", "batches": "min",
}


def latency_budget_ms(budgets: dict, target: str = "*") -> float | None:
    """The ``latency_p99_ms`` bound a budgets dict declares for
    ``target`` (the live-control signal admission control consumes),
    or None when the budgets declare no latency ceiling there."""
    bound = (budgets.get(target) or {}).get("latency_p99_ms")
    return float(bound) if isinstance(bound, (int, float)) else None


class LatencyGovernor:
    """Rolling-window latency controller: the SLO budget as a LIVE
    control signal, not a post-hoc verdict.

    The server feeds every delivered request's submit->result latency
    into :meth:`observe`; admission control asks :meth:`overloaded`
    (rolling p99 over the declared ``budget_ms`` ceiling — backpressure
    tightens effective queue capacity) and :meth:`estimate_wait_ms`
    (rolling p50 — the service-time estimate that sheds deadline-doomed
    requests at admission instead of wasting a batch slot).  With no
    budget declared the governor never reports overload; with no
    observations yet it estimates zero wait — admission stays permissive
    until there is data to act on.

    Per-device tails (the device pool, serve/pool.py):
    ``observe(lat, device=i)`` additionally
    files the sample under device ``i``, so :meth:`p99_ms` /
    :meth:`overloaded` answer for one device and
    :meth:`overload_fraction` reports which share of the devices is over
    budget; backpressure then scales with that share.  Union-only
    streams (no device ids observed, as the one-device server sends)
    mean the whole world is slow: fraction 1 when over budget."""

    def __init__(self, budget_ms: float | None = None, window: int = 64):
        self.budget_ms = budget_ms
        self._window = max(int(window), 1)
        self._lock = threading.Lock()
        self._lat: deque = deque(maxlen=self._window)
        self._dev_lat: dict = {}       # device id -> deque of latencies

    def observe(self, latency_ms: float, device: int | None = None) -> None:
        """Record one delivered request's submit->result latency,
        optionally filed under the pool member that served it."""
        with self._lock:
            self._lat.append(float(latency_ms))
            if device is not None:
                dq = self._dev_lat.get(device)
                if dq is None:
                    dq = self._dev_lat[device] = deque(
                        maxlen=self._window)
                dq.append(float(latency_ms))

    def _samples(self, device: int | None) -> list:
        with self._lock:
            if device is None:
                return list(self._lat)
            return list(self._dev_lat.get(device, ()))

    def p99_ms(self, device: int | None = None) -> float | None:
        return percentile(self._samples(device), 99)

    def device_p99s(self) -> dict:
        """Rolling p99 per observed pool member (the flight recorder's
        per-device tail view)."""
        with self._lock:
            devs = {d: list(dq) for d, dq in self._dev_lat.items()}
        return {d: percentile(vals, 99)
                for d, vals in sorted(devs.items())}

    def estimate_wait_ms(self) -> float:
        """Expected admission->result wait (rolling p50; 0 cold)."""
        return percentile(self._samples(None), 50) or 0.0

    def overloaded(self, device: int | None = None) -> bool:
        """Is the rolling p99 (of one device, or the union) over the
        declared budget?  Admission capacity tightens while this holds."""
        if self.budget_ms is None:
            return False
        p99 = self.p99_ms(device)
        return p99 is not None and p99 > self.budget_ms

    def overload_fraction(self) -> float:
        """The share of the pool that is over budget, in [0, 1].

        With per-device observations: overloaded devices / observed
        devices.  Without (union-only stream): 1.0 when the union p99
        is over budget, else 0.0 — the pre-pool halving behavior.
        Admission control scales its capacity by ``1 - fraction/2``."""
        if self.budget_ms is None:
            return 0.0
        with self._lock:
            devs = list(self._dev_lat)
        if not devs:
            return 1.0 if self.overloaded() else 0.0
        over = sum(1 for d in devs if self.overloaded(d))
        return over / len(devs)


def aggregate(records) -> dict:
    """Per-``op/dtype`` serving stats plus an ``"*"`` union row, from
    any mixed record list (non-serve records are ignored).

    Batches stamped with a ``device_id`` (the device pool) additionally
    aggregate into ``device:<id>`` rows, so a budgets file can declare
    per-device latency targets — ``{"device:0": {"latency_p99_ms":
    250}}`` — and a single slow pool member fails its own row instead
    of hiding inside the union tail."""
    serve = _metrics.split_records(records)[2]
    table = _metrics.summarize_serve(serve)
    if serve:
        union = _metrics.summarize_serve(
            [{**e, "op": "*", "dtype": "all"} for e in serve])
        table["*"] = next(iter(union.values()))
    by_dev: dict = {}
    for e in serve:
        dev = e.get("device_id")
        # serve_device (pool lifecycle) records also carry device_id but
        # summarize to nothing — a member that only got quarantined must
        # not produce an empty row
        if isinstance(dev, int) and e.get("kind") == "serve_batch":
            by_dev.setdefault(dev, []).append(
                {**e, "op": "device", "dtype": str(dev)})
    for dev, evs in sorted(by_dev.items()):
        row = _metrics.summarize_serve(evs)
        if row:
            table[f"device:{dev}"] = next(iter(row.values()))
    return table


def _rows_for(stats: dict, target: str) -> list[tuple[str, dict]]:
    if target in stats:
        return [(target, stats[target])]
    # bare-op target: every dtype row of that op
    return [(k, s) for k, s in stats.items()
            if k.split("/")[0] == target]


def evaluate(stats: dict, budgets: dict) -> list[dict]:
    """Budget verdicts, one per (target row, metric bound).

    Each verdict: ``target`` (budget key), ``row`` (matched stats row),
    ``metric``, ``value`` (measured, None = no data), ``bound``,
    ``direction``, ``ok``.  Unknown metrics and targets with no
    matching data fail loudly (``value=None, ok=False``)."""
    verdicts = []
    for target in sorted(budgets):
        bounds = budgets[target]
        rows = _rows_for(stats, target)
        if not rows:
            for metric in sorted(bounds):
                verdicts.append({
                    "target": target, "row": None, "metric": metric,
                    "value": None, "bound": bounds[metric],
                    "direction": METRIC_DIRECTION.get(metric, "max"),
                    "ok": False})
            continue
        for row_key, row in rows:
            for metric in sorted(bounds):
                bound = bounds[metric]
                direction = METRIC_DIRECTION.get(metric, "max")
                value = row.get(metric)
                if not isinstance(value, (int, float)):
                    ok, value = False, None
                elif direction == "max":
                    ok = value <= bound
                else:
                    ok = value >= bound
                verdicts.append({
                    "target": target, "row": row_key, "metric": metric,
                    "value": value, "bound": bound,
                    "direction": direction, "ok": ok})
    return verdicts


def load_budgets(path) -> dict:
    with open(path, encoding="utf-8") as fh:
        budgets = json.load(fh)
    if not isinstance(budgets, dict) or not all(
            isinstance(v, dict) for v in budgets.values()):
        raise ValueError(
            f"{path}: budgets must be {{target: {{metric: bound}}}}")
    return budgets


def render_verdicts(verdicts) -> str:
    rows = [[v["target"], v["row"] or "-", v["metric"],
             v["value"] if v["value"] is not None else "no-data",
             ("<=" if v["direction"] == "max" else ">=") + _metrics._fmt(
                 v["bound"]),
             "PASS" if v["ok"] else "FAIL"]
            for v in verdicts]
    failed = sum(1 for v in verdicts if not v["ok"])
    table = _metrics._table(
        ["budget", "row", "metric", "value", "bound", "verdict"], rows)
    return (f"slo\n{table}\n\n"
            f"slo: {len(verdicts) - failed}/{len(verdicts)} budget "
            f"check(s) passed\n")


def export_prometheus(stats: dict) -> str:
    """The aggregated serving stats as Prometheus-style text — one
    ``slate_serve_<metric>{op=...,dtype=...}`` gauge per numeric stat
    (the ``"*"`` union row exports with ``op="*"``)."""
    seen_help = set()
    lines = []
    for key in sorted(stats):
        op, _, dtype = key.partition("/")
        labels = f'op="{op}",dtype="{dtype}"'
        for metric in sorted(stats[key]):
            value = stats[key][metric]
            if not isinstance(value, (int, float)) or isinstance(value,
                                                                 bool):
                continue
            name = "slate_serve_" + metric.replace("/", "_")
            if name not in seen_help:
                seen_help.add(name)
                lines.append(f"# HELP {name} serving aggregate "
                             f"{metric} (slate_tpu_torch.obs.slo)")
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{{{labels}}} {value}")
    return "\n".join(lines) + ("\n" if lines else "")
