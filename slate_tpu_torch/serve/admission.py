"""Deadline-aware admission control for the serving front door (port of
slate_tpu/serve/admission.py; pure Python threading, unchanged).

The server's intake is a BOUNDED queue with a declared overflow policy,
per-request deadlines, and the SLO budget wired in as a LIVE control
signal (obs/slo.py's :class:`~slate_tpu_torch.obs.slo.LatencyGovernor`)
rather than a post-hoc verdict:

- **overflow policy** (:data:`OVERFLOW_POLICIES`): ``reject`` raises a
  typed :class:`SlateServeOverloadError` at submit; ``shed_oldest``
  admits the newcomer and shed the oldest queued request (its sticky
  error lands on the victim's ticket); ``block`` parks the submitter
  until space frees or ``block_timeout_s`` elapses.
- **deadline shedding**: a request whose deadline would expire before
  the governor's rolling service-time estimate completes is shed AT
  ADMISSION with :class:`SlateServeTimeoutError` — it never wastes a
  batch slot.  Requests that age out while queued are shed at flush.
- **SLO backpressure**: while the governor's rolling latency p99 runs
  over the declared budget, the queue's effective capacity halves —
  load sheds earlier until the tail recovers.

Every submitted request gets a :class:`Ticket` — a one-shot,
first-write-wins result slot.  First-write-wins is the no-double-answer
guarantee: if the watchdog fails a wedged flush's requests and the
flush later limps home, the late delivery is dropped, not duplicated.

Thread safety: all queue state is guarded by ``_lock`` (a Condition —
the waiters are blocked producers and a parked flush loop), all ticket
state by the ticket's own ``_lock``.  Lock order is queue -> governor;
ticket locks nest under nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from ..exceptions import (SlateServeError, SlateServeOverloadError,
                          SlateServeTimeoutError)
from ..obs import slo as _slo

#: what happens when the bounded queue is full at submit
OVERFLOW_POLICIES = ("reject", "shed_oldest", "block")


def _closed_error(reason: str) -> SlateServeTimeoutError:
    return SlateServeTimeoutError(
        f"serve: admission closed ({reason}) — the server is wedged or "
        f"shut down", reason=reason)


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Front-door knobs (docs/SERVING.md "Survival" documents each).

    ``max_queue`` bounds pending requests; ``overflow`` picks the
    full-queue policy; ``block_timeout_s`` bounds a blocked submit;
    ``default_deadline_ms`` stamps submits that bring no deadline
    (None = no deadline); ``flush_occupancy`` / ``max_batch_delay_ms``
    are the background loop's flush watermarks (batch when this many
    are pending, or when the oldest has waited this long);
    ``watchdog_timeout_s`` is how long one flush may run before the
    watchdog declares it wedged; ``slo_budget_ms`` / ``slo_window``
    parameterize the live latency governor (None = no backpressure).

    Online ladder retuning (docs/TUNING.md "Hot-swap"):
    ``retune_interval_s`` paces the background refit tick (None = off);
    ``retune_min_samples`` is how many observed sizes the DP fitter
    needs before it argues; ``retune_margin`` is the padding-waste
    improvement a fitted ladder must show before the server hot-swaps
    it (hysteresis — a marginal win is not worth recompiling)."""

    max_queue: int = 256
    overflow: str = "reject"
    block_timeout_s: float = 1.0
    default_deadline_ms: float | None = None
    flush_occupancy: int = 8
    max_batch_delay_ms: float = 5.0
    watchdog_timeout_s: float = 30.0
    slo_budget_ms: float | None = None
    slo_window: int = 64
    retune_interval_s: float | None = None
    retune_min_samples: int = 64
    retune_margin: float = 0.05

    def __post_init__(self):
        if self.overflow not in OVERFLOW_POLICIES:
            raise ValueError(f"admission: unknown overflow policy "
                             f"{self.overflow!r} (known: "
                             f"{OVERFLOW_POLICIES})")
        if self.max_queue < 1:
            raise ValueError("admission: max_queue must be >= 1")
        if self.flush_occupancy < 1:
            raise ValueError("admission: flush_occupancy must be >= 1")
        if (self.retune_interval_s is not None
                and self.retune_interval_s <= 0):
            raise ValueError("admission: retune_interval_s must be > 0")
        if self.retune_min_samples < 1:
            raise ValueError("admission: retune_min_samples must be >= 1")


class Ticket(int):
    """Handle for one admitted request: a one-shot result slot.

    Subclasses int so the synchronous contract survives — the value is
    the request's index into the next ``drain()``'s results, exactly
    what ``submit`` has always returned.  Under the background flush
    loop (or any shedding policy) indices shift, so the DURABLE
    interface is :meth:`result`, which blocks for the outcome and
    re-raises the stored typed error — the sticky-error guarantee: a
    failed flush is re-raised at the caller's result() site, never
    silently dropped.

    Settling is first-write-wins and atomic: whichever of the flush
    loop, the watchdog, or shutdown settles first wins; later writes
    are dropped (no request is ever answered twice).  ``tid`` is the
    queue-unique request id used by the accounting tests."""

    def __new__(cls, index: int, tid: int):
        t = super().__new__(cls, index)
        t.tid = tid
        t._lock = threading.Lock()
        t._done = threading.Event()
        t._value = None
        t._error = None
        return t

    def _settle(self, value, error) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self._value = value
            self._error = error
            self._done.set()           # inside the lock: check-then-set
            return True                # stays atomic vs a racing settler

    def deliver(self, result) -> bool:
        """Settle with a result; False if already settled (late write)."""
        return self._settle(result, None)

    def fail(self, error: BaseException) -> bool:
        """Settle with a sticky typed error; False if already settled."""
        return self._settle(None, error)

    def done(self) -> bool:
        return self._done.is_set()

    def error(self) -> BaseException | None:
        """The stored sticky error, without raising (None if none/unset)."""
        with self._lock:
            return self._error

    def result(self, timeout: float | None = None):
        """Block for the outcome; re-raises the stored typed error.
        Raises :class:`SlateServeTimeoutError` if ``timeout`` elapses
        first (the ticket itself stays unsettled and can be re-waited)."""
        if not self._done.wait(timeout):
            raise SlateServeTimeoutError(
                f"serve: result() timed out after {timeout}s "
                f"(request id {self.tid} still pending)",
                reason="result_timeout")
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._value


class AdmissionQueue:
    """The bounded, deadline-aware pending queue behind Server.submit.

    State (``_items`` and the admission counters) is guarded by
    ``_lock``; producers blocked by the ``block`` overflow policy and
    the parked flush loop wait on the same Condition.  The queue never
    executes anything — it admits, sheds, and hands batches to the
    flush path via :meth:`take_all`."""

    def __init__(self, config: AdmissionConfig | None = None,
                 governor: _slo.LatencyGovernor | None = None):
        self.config = config or AdmissionConfig()
        self.governor = governor if governor is not None else \
            _slo.LatencyGovernor(self.config.slo_budget_ms,
                                 self.config.slo_window)
        self._lock = threading.Condition()
        self._items: list = []
        self._next_id = 0
        self._admitted = 0
        self._shed = 0
        self._closed: str | None = None    # close reason; None = open

    # --------------------------------------------------------- admission

    def capacity(self) -> int:
        """Effective capacity right now: ``max_queue`` scaled by the
        governor's overloaded share of the device pool — ``1 - frac/2``
        (backpressure).  A union-only stream (no per-device samples)
        reports fraction 1 when over budget, so the pre-pool behavior
        — halve the world — is the single-device special case; one
        slow member out of four only trims capacity by an eighth."""
        cap = self.config.max_queue
        frac = self.governor.overload_fraction()
        if frac > 0.0:
            cap = max(1, int(cap * (1.0 - frac / 2.0)))
        return cap

    def offer(self, build, deadline: float | None, now: float):
        """Admit one request; returns ``(ticket, shed_victims)``.

        ``build(ticket)`` constructs the Request once a slot is won (it
        runs under the queue lock and must be cheap and lock-free).
        Raises :class:`SlateServeTimeoutError` for a deadline-doomed or
        closed-queue submit and :class:`SlateServeOverloadError` for an
        overflow reject/block-timeout; ``shed_victims`` are the requests
        a ``shed_oldest`` admission evicted — the caller fails their
        tickets and emits the shed events."""
        wait_s = self.governor.estimate_wait_ms() / 1e3
        if deadline is not None and now + wait_s > deadline:
            with self._lock:
                self._shed += 1
            raise SlateServeTimeoutError(
                f"serve: request deadline expires in "
                f"{(deadline - now) * 1e3:.1f}ms but the rolling service "
                f"estimate is {wait_s * 1e3:.1f}ms — shed at admission",
                reason="deadline")
        victims: list = []
        with self._lock:
            if self._closed is not None:
                raise _closed_error(self._closed)
            cap = self.capacity()
            if len(self._items) >= cap:
                policy = self.config.overflow
                if policy == "reject":
                    self._shed += 1
                    raise SlateServeOverloadError(
                        f"serve: queue full ({len(self._items)}/{cap}) — "
                        f"request rejected", policy="reject")
                if policy == "shed_oldest":
                    while len(self._items) >= cap:
                        victims.append(self._items.pop(0))
                        self._shed += 1
                else:                                   # block
                    t_giveup = now + self.config.block_timeout_s
                    while len(self._items) >= self.capacity():
                        if self._closed is not None:
                            raise _closed_error(self._closed)
                        remaining = t_giveup - time.perf_counter()
                        if remaining <= 0:
                            self._shed += 1
                            raise SlateServeOverloadError(
                                f"serve: queue still full after blocking "
                                f"{self.config.block_timeout_s}s",
                                policy="block")
                        self._lock.wait(remaining)
            ticket = Ticket(len(self._items), self._next_id)
            self._next_id += 1
            self._admitted += 1
            self._items.append(build(ticket))
            self._lock.notify_all()        # wake the parked flush loop
        return ticket, victims

    # ------------------------------------------------------------- flush

    def take_all(self, now: float | None = None):
        """Swap out every pending request; returns ``(live, expired)``.
        Requests whose deadline already passed come back separately so
        the flush path sheds them instead of batching them."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            items, self._items = self._items, []
            self._lock.notify_all()      # space freed: wake blockers
        live = [r for r in items
                if r.deadline is None or r.deadline > now]
        expired = [r for r in items
                   if not (r.deadline is None or r.deadline > now)]
        return live, expired

    def flush_due(self, now: float | None = None) -> bool:
        """Do the watermarks say a batch is due?  True when occupancy
        reaches ``flush_occupancy``, the oldest request has waited
        ``max_batch_delay_ms``, or a queued deadline has less slack
        than the governor's service estimate plus one batch delay."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if not self._items:
                return False
            if len(self._items) >= self.config.flush_occupancy:
                return True
            oldest = min(r.t_submit for r in self._items)
            if (now - oldest) * 1e3 >= self.config.max_batch_delay_ms:
                return True
            slack_s = (self.governor.estimate_wait_ms()
                       + self.config.max_batch_delay_ms) / 1e3
            return any(r.deadline is not None
                       and r.deadline - now <= slack_s
                       for r in self._items)

    def park(self, timeout_s: float) -> None:
        """Park the flush loop until work arrives (or timeout)."""
        with self._lock:
            if not self._items and self._closed is None:
                self._lock.wait(timeout_s)

    def kick(self) -> None:
        """Wake every waiter (shutdown uses this to unblock parkers)."""
        with self._lock:
            self._lock.notify_all()

    # --------------------------------------------------------- lifecycle

    def close(self, reason: str = "shutdown") -> list:
        """Refuse further admissions; returns the stranded requests
        (the caller drains or fails them — they are never dropped)."""
        with self._lock:
            if self._closed is None:
                self._closed = reason
            items, self._items = self._items, []
            self._lock.notify_all()
        return items

    def closed(self) -> str | None:
        with self._lock:
            return self._closed

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def note_shed(self, n: int = 1) -> None:
        """Account sheds decided outside offer() (age-out at flush,
        watchdog strandings)."""
        with self._lock:
            self._shed += n

    def stats(self) -> dict:
        with self._lock:
            return {"depth": len(self._items), "admitted": self._admitted,
                    "shed": self._shed,
                    "closed": self._closed is not None}


# re-exported so serve-layer callers have one import site for the
# admission surface (serve/__init__.py publishes these)
__all__ = [
    "OVERFLOW_POLICIES", "AdmissionConfig", "AdmissionQueue", "Ticket",
    "SlateServeError", "SlateServeOverloadError", "SlateServeTimeoutError",
]
