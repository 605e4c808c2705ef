"""Elastic device pool: dispatch that survives losing a device (port of
slate_tpu/serve/pool.py).

A :class:`DevicePool` owns one :class:`PoolMember` per device,
round-robins flushed batches across the healthy ones, and runs the
failover ladder when a member misbehaves:

1. **detect**: a dispatch that raises, returns non-finite results for
   problems whose ``HealthInfo`` claims health (the device lied: a
   device-loss signature, distinct from a poison request whose health
   honestly reports failure), or exceeds the per-dispatch deadline
   derived from the :class:`~slate_tpu_torch.obs.slo.LatencyGovernor`'s
   rolling tail (a wedged device: the dispatch thread lingers, the pool
   moves on; tickets are first-write-wins, so a late result is dropped);
2. **fail over**: the SAME packed batch is redispatched onto the next
   healthy member.  The server keeps the packed batch untouched by an
   attempt (each attempt copies it into the bucket's static buffers) and
   every member replays the same captured graphs, so results after a
   failover are bit-identical to a no-fault run and no ticket is lost;
3. **quarantine**: ``strike_limit`` consecutive failures retire the
   member from rotation (any success resets the counter);
4. **canary and readmit**: every ``canary_interval_s`` the pool probes a
   quarantined member with a small canary solve; a clean probe readmits
   it, a failed probe (or a ``serve_canary_flake`` chaos plan)
   reschedules the next one.

With one healthy member left the pool keeps serving (``degraded()`` is
True); with none it raises :class:`SlateServeOverloadError`.  Probes run
before member selection, so a pool in total blackout readmits a
recovered device.

Chaos sites (robust/faults.py ``SERVE_SITES``): ``serve_device_fail``
(kind ``nan`` poisons the batch output so that the non-finite sentinel
must catch it; any other kind raises at dispatch), ``serve_device_slow``
(sleeps past the dispatch deadline: the wedged path),
``serve_canary_flake`` (the probe fails).  All three honor
``FaultPlan(device=i)``.

Members are ``torch.device``s; the default pool is one member on
``cuda:0``.  Two members may name the same device (the drill harness):
they share the cache's graphs and keep separate health.  Every failover,
quarantine, readmission and failed probe emits a ``serve_device`` record
(obs/events.py).  Member state is guarded by ``_lock``; dispatch and
capture never run under it.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import torch

from ..exceptions import SlateServeError, SlateServeOverloadError
from ..obs import events as _events
from ..obs import slo as _slo
from ..robust import faults as _faults

#: member lifecycle states
HEALTHY, QUARANTINED = "healthy", "quarantined"


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Failure-detection knobs.

    ``strike_limit`` consecutive dispatch failures quarantine a member;
    ``dispatch_timeout_s`` is the per-dispatch deadline (None derives it
    live from the governor: ``max(dispatch_floor_s, dispatch_factor *
    rolling p99)``, and no deadline at all while the governor has no
    latency budget, so default serving never pays a watcher thread);
    ``canary_interval_s`` paces readmission probes of quarantined
    members; ``canary_n`` is the canary solve's size."""

    strike_limit: int = 2
    dispatch_timeout_s: float | None = None
    dispatch_floor_s: float = 10.0
    dispatch_factor: float = 8.0
    canary_interval_s: float = 0.25
    canary_n: int = 8

    def __post_init__(self):
        if self.strike_limit < 1:
            raise ValueError("pool: strike_limit must be >= 1")
        if self.canary_interval_s <= 0:
            raise ValueError("pool: canary_interval_s must be > 0")


class PoolMember:
    """One device in the pool: the device plus its health bookkeeping
    (mutated only under the owning pool's lock)."""

    __slots__ = ("index", "device", "state", "strikes", "dispatches",
                 "failures", "next_probe", "quarantined_at")

    def __init__(self, index: int, device):
        self.index = index
        self.device = torch.device(device)
        self.state = HEALTHY
        self.strikes = 0
        self.dispatches = 0
        self.failures = 0
        self.next_probe = 0.0
        self.quarantined_at: float | None = None

    def describe(self) -> dict:
        return {"index": self.index, "device": str(self.device),
                "state": self.state, "strikes": self.strikes,
                "dispatches": self.dispatches, "failures": self.failures}


class _DeviceFailure(Exception):
    """Why one member's attempt was declared dead (``nonfinite`` /
    ``deadline``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _poison_tree(out):
    """The ``serve_device_fail kind='nan'`` payload: every floating tensor
    of the dispatch result becomes NaN, every other leaf (health records,
    escalation flags) keeps claiming success: the lie the non-finite
    sentinel exists to catch."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            return torch.full_like(out, math.nan)
        return out
    if isinstance(out, (tuple, list)) and not hasattr(out, "_fields"):
        return type(out)(_poison_tree(v) for v in out)
    return out


class DevicePool:
    """Round-robin dispatcher over the healthy members.

    ``devices`` defaults to ``[cuda:0]``; tests pass an explicit list
    (the same device twice gives a two-member pool on one card: the
    drill's harness).  ``governor`` is the shared latency governor the
    per-dispatch deadline derives from; ``canary`` is the probe callable
    ``(member) -> bool`` (the Server wires a canary solve through its
    cache; a standalone pool readmits on the chaos-gated default)."""

    def __init__(self, devices=None, config: PoolConfig | None = None,
                 governor: _slo.LatencyGovernor | None = None,
                 canary=None):
        devices = (list(devices) if devices is not None
                   else [torch.device("cuda", 0)])
        if not devices:
            raise ValueError("pool: need at least one device")
        self.config = config or PoolConfig()
        self.governor = governor if governor is not None \
            else _slo.LatencyGovernor()
        self._canary = canary
        self._lock = threading.Lock()
        self._members = [PoolMember(i, d) for i, d in enumerate(devices)]
        self._rr = 0
        self._failovers = 0
        self._quarantines = 0
        self._readmissions = 0

    # ------------------------------------------------------------ queries

    def size(self) -> int:
        # the member list is built once here and never resized
        return len(self._members)

    def members(self) -> list:
        """Snapshot descriptions of every member."""
        with self._lock:
            return [m.describe() for m in self._members]

    def healthy_devices(self) -> list:
        """(index, device) of every in-rotation member."""
        with self._lock:
            return [(m.index, m.device) for m in self._members
                    if m.state == HEALTHY]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for m in self._members if m.state == HEALTHY)

    def degraded(self) -> bool:
        """One survivor (or none) in a multi-member pool: serving goes on
        but the next strike is an outage."""
        return self.size() > 1 and self.healthy_count() <= 1

    def stats(self) -> dict:
        with self._lock:
            healthy = sum(1 for m in self._members if m.state == HEALTHY)
            return {"devices": len(self._members), "healthy": healthy,
                    "failovers": self._failovers,
                    "quarantines": self._quarantines,
                    "readmissions": self._readmissions}

    def set_canary(self, canary) -> None:
        """Install the readmission probe (last write wins)."""
        self._canary = canary

    # ----------------------------------------------------------- deadline

    def dispatch_timeout_s(self) -> float | None:
        """The per-dispatch deadline: the configured one, else derived
        from the governor's rolling p99 (None while no latency budget is
        declared: the dispatch runs on the caller's thread)."""
        cfg = self.config
        if cfg.dispatch_timeout_s is not None:
            return cfg.dispatch_timeout_s
        if self.governor.budget_ms is None:
            return None
        p99 = self.governor.p99_ms()
        derived = (p99 or 0.0) * cfg.dispatch_factor / 1e3
        return max(cfg.dispatch_floor_s, derived)

    # ----------------------------------------------------------- dispatch

    def dispatch(self, run, validate=None, op: str | None = None,
                 dtype: str | None = None):
        """Run one packed batch on the pool; returns ``(result,
        member_index, failovers)``.

        ``run(member)`` executes the batch on ``member.device`` and returns
        its result; ``validate(result)`` returns False when the result
        looks like device garbage.  A failure strikes the member and the
        SAME batch fails over to the next healthy one; when every member
        was tried (or all are quarantined and every probe failed)
        :class:`SlateServeOverloadError` is raised, naming the last
        failure."""
        self._probe_due()
        tried: set = set()
        failovers = 0
        last = None
        while True:
            member = self._select(tried)
            if member is None:
                raise SlateServeOverloadError(
                    f"serve: no healthy device left in the pool for "
                    f"{op}/{dtype} ({self.size()} member(s), all "
                    f"quarantined or already failed this batch; last "
                    f"failure: {last}) — retrying after a clean canary "
                    f"probe", policy="pool_exhausted")
            try:
                out = self._attempt(run, member)
                if validate is not None and not validate(out):
                    raise _DeviceFailure("nonfinite")
            except _DeviceFailure as f:
                self._strike(member, f.reason, op, dtype)
                last = f.reason
            except Exception as e:      # an exception IS the sentinel
                self._strike(member, "exception", op, dtype, e)
                last = repr(e)
            else:
                break
            tried.add(member.index)
            failovers += 1
        with self._lock:
            member.strikes = 0          # consecutive counter: success heals
            member.dispatches += 1
        return out, member.index, failovers

    def _attempt(self, run, member: PoolMember):
        """One member's try, under the per-dispatch deadline.  The chaos
        sites live inside the worker, so a ``serve_device_slow`` sleep is
        what the deadline watches, as a real hang would be."""
        timeout = self.dispatch_timeout_s()

        def work():
            slow = _faults.host_fire("serve_device_slow",
                                     device=member.index)
            if slow is not None:
                time.sleep(slow.delay_s)
            fail = _faults.host_fire("serve_device_fail",
                                     device=member.index)
            if fail is not None and fail.kind != "nan":
                raise SlateServeError(
                    f"chaos: device {member.index} lost at dispatch")
            out = run(member)
            if fail is not None:        # kind == "nan": the device lies
                out = _poison_tree(out)
            return out

        if timeout is None:
            return work()
        box: dict = {}
        done = threading.Event()

        def _worker():
            try:
                box["value"] = work()
            except BaseException as e:  # handed to the waiter below
                box["error"] = e
            done.set()

        t = threading.Thread(target=_worker, daemon=True,
                             name=f"slate-serve-dispatch-{member.index}")
        t.start()
        if not done.wait(timeout):
            # wedged: the thread may still finish, but its result is
            # dropped here and the survivor settles the tickets
            raise _DeviceFailure("deadline")
        err = box.get("error")
        if err is not None:
            raise err
        return box["value"]

    def _select(self, tried: set) -> PoolMember | None:
        """Next healthy member in rotation not yet tried for this batch."""
        with self._lock:
            n = len(self._members)
            for off in range(n):
                m = self._members[(self._rr + off) % n]
                if m.state == HEALTHY and m.index not in tried:
                    self._rr = (m.index + 1) % n
                    return m
        return None

    def _strike(self, member: PoolMember, reason: str, op, dtype,
                cause: BaseException | None = None) -> None:
        now = time.perf_counter()
        with self._lock:
            member.strikes += 1
            member.failures += 1
            self._failovers += 1
            quarantine = (member.state == HEALTHY
                          and member.strikes >= self.config.strike_limit)
            if quarantine:
                member.state = QUARANTINED
                member.quarantined_at = now
                member.next_probe = now + self.config.canary_interval_s
                self._quarantines += 1
            strikes = member.strikes
        _events.emit_serve_device({
            "event": "failover", "device_id": member.index,
            "op": op, "dtype": dtype, "reason": reason,
            "strikes": strikes,
            "cause": None if cause is None else repr(cause),
        })
        if quarantine:
            _events.emit_serve_device({
                "event": "quarantine", "device_id": member.index,
                "op": op, "dtype": dtype, "reason": reason,
                "strikes": strikes,
            })

    # ------------------------------------------------------------- canary

    def _probe_due(self) -> None:
        """Probe every quarantined member whose canary is due."""
        now = time.perf_counter()
        with self._lock:
            due = [m for m in self._members
                   if m.state == QUARANTINED and now >= m.next_probe]
        for m in due:
            self._probe(m)

    def probe(self, index: int) -> bool:
        """Force one member's canary probe now (tests and operators);
        True when the member is (back) in rotation."""
        with self._lock:
            member = self._members[index]
            if member.state == HEALTHY:
                return True
        return self._probe(member)

    def _probe(self, member: PoolMember) -> bool:
        ok = False
        flake = _faults.host_fire("serve_canary_flake",
                                  device=member.index)
        if flake is None:
            try:
                ok = True if self._canary is None \
                    else bool(self._canary(member))
            except Exception:           # a failed canary keeps it out
                ok = False
        now = time.perf_counter()
        if not ok:
            with self._lock:
                member.next_probe = now + self.config.canary_interval_s
            _events.emit_serve_device({
                "event": "probe_fail", "device_id": member.index,
                "op": None, "dtype": None,
                "reason": "flake" if flake is not None else "canary",
            })
            return False
        with self._lock:
            quarantined_ms = (
                None if member.quarantined_at is None
                else round((now - member.quarantined_at) * 1e3, 3))
            member.state = HEALTHY
            member.strikes = 0
            member.quarantined_at = None
            self._readmissions += 1
        _events.emit_serve_device({
            "event": "readmit", "device_id": member.index,
            "op": None, "dtype": None, "reason": "canary_ok",
            "quarantined_ms": quarantined_ms,
        })
        return True
