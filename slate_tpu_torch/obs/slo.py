"""The serving layer's live latency governor (port of ``LatencyGovernor``
from slate_tpu/obs/slo.py).

Admission control (serve/admission.py) needs the SLO budget as a LIVE
control signal: the rolling p99 of delivered requests against a declared
budget tightens the queue's capacity, and the rolling p50 estimates the
wait that sheds deadline-doomed requests at admission.  The budgets file,
``evaluate`` and the Prometheus exporter of the reference's module come
with the telemetry slice (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import math
import threading
from collections import deque


def percentile(values, q: float) -> float | None:
    """Linear-interpolated percentile of a list (q in [0, 100]); the
    reference's obs/metrics.py helper."""
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

    Per-device tails (for the reference's device pool, which the port
    has not brought in yet): ``observe(lat, device=i)`` additionally
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
