"""The serving front end: submit mixed-size solves, drain bucketed batches
(port of slate_tpu/serve/server.py).

Synchronous usage::

    from slate_tpu_torch import serve

    srv = serve.Server()                          # on CUDA by default
    t0 = srv.submit("solve", a0, b0)              # (n0, n0), (n0, k0)
    t1 = srv.submit("chol_solve", a1, b1)
    t2 = srv.submit("least_squares_solve", a2, b2)
    results = srv.drain()                         # [Result] in submit order

The background front door::

    srv = serve.Server(admission=serve.AdmissionConfig(
        max_queue=64, overflow="shed_oldest", default_deadline_ms=250,
        slo_budget_ms=250))
    srv.start()                                   # flush loop + watchdog
    t = srv.submit("solve", a, b)                 # admission-controlled
    x = t.result(timeout=1.0).x                   # sticky typed errors
    srv.shutdown()                                # drains or fails loudly

Each flush groups the pending requests by ``(op, dtype, bucket)``,
identity-pads every problem to its bucket (bucket.py) on the server's
device, rounds the batch count up to a power of two with identity filler
slots, dispatches the group through the device pool (pool.py) to the
bucket's cached callable (cache.py: on the card, CUDA graphs captured
once per bucket and replayed for every batch), and unpacks per-problem
results, ``HealthInfo`` and escalation flags.  The packed batch is kept
as it is, so that a failover copies the same bits into the survivor's
graphs.

Survival properties:

- **admission control / backpressure**: submit goes through the bounded
  :class:`~slate_tpu_torch.serve.admission.AdmissionQueue` (overflow
  policy, per-request deadlines, SLO-budget backpressure); shed requests
  carry typed errors;
- **background flush loop**: a daemon thread batches by occupancy, age
  and deadline slack while callers keep submitting; a watchdog daemon
  declares a flush wedged after ``watchdog_timeout_s`` and fails every
  pending request with :class:`SlateServeTimeoutError`, and the wedged
  server refuses new work.  Tickets are first-write-wins, so a wedged
  flush that later limps home cannot answer twice;
- **poison quarantine**: a problem that exhausts its escalation ladder
  (``escalated`` and unhealthy) is retried at most once in a fresh batch,
  then quarantined to a batch of its own;
- **sticky errors**: a failed flush stores its typed error on every
  affected ticket and on the server; the next ``drain()`` re-raises it
  first;
- **online retune**: the observed sizes refit the bucket ladder in the
  background (tune/autotune.py), the fitted rungs' graphs are captured on
  every healthy member, and the ladder is hot-swapped.

One ``slate-obs-v1`` record of kind ``serve_batch`` is emitted per
executed batch, with ``captures`` (the graphs the batch captured) where
the reference has ``retraces``; sheds, quarantines, device transitions
and retunes emit ``serve_shed``, ``serve_quarantine``, ``serve_device``
and ``serve_retune`` records (obs/events.py).  ``batch_records`` keeps
every ``serve_batch`` payload with the port's own fields beside it.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent import futures
from typing import NamedTuple

import numpy as np
import torch

from ..core.storage import as_tensor, resolve_device
from ..exceptions import SlateServeError, SlateServeTimeoutError
from ..obs import events as _events
from ..obs import flops as _flops
from ..obs import sentinel as _sentinel
from ..options import Options
from ..robust import faults as _faults
from ..robust.health import HealthInfo
from ..robust.precision import normalize_dtype, torch_dtype
from . import admission as _admission
from . import bucket as _bucket
from . import cache as _cache
from . import pool as _pool

SERVE_OPS = ("solve", "chol_solve", "least_squares_solve")


class Request(NamedTuple):
    """One pending problem: ``op`` in SERVE_OPS, dense ``a``/``b`` tensors,
    the submit stamp (perf_counter seconds), the admission ticket, the
    absolute deadline (perf_counter seconds, None = never), and how many
    batched attempts have come back poison (one earns the fresh-batch
    retry, two the quarantine)."""
    op: str
    a: torch.Tensor
    b: torch.Tensor
    t_submit: float = 0.0
    ticket: object = None
    deadline: float | None = None
    retries: int = 0


class Result(NamedTuple):
    """One served problem: the solution (a view of its batch's output, on
    the server's device), its health, and whether its safe rung produced
    it."""
    x: torch.Tensor
    health: HealthInfo
    escalated: bool


def _as_2d(x, name: str) -> torch.Tensor:
    """A numpy array or tensor as a 2-D tensor (numpy on the CPU)."""
    x = x if isinstance(x, torch.Tensor) else as_tensor(np.asarray(x), "cpu")
    if x.dim() != 2:
        raise ValueError(f"serve: {name} must be 2-D, got shape "
                         f"{tuple(x.shape)}")
    return x


def _poison(res: Result) -> bool:
    """Did this problem exhaust the escalation ladder?  The safe rung ran
    AND still reports unhealthy."""
    return bool(res.escalated) and not bool(res.health.ok)


class Server:
    """Shape-bucketed batch server over a pool of devices.

    ``opts`` apply to every request (they are part of the cache key);
    ``ladder`` overrides the bucket ladder (default: geometric);
    ``cache`` shares or isolates the store of batch callables (default:
    the process-wide one); ``admission`` configures the survival layer
    (default :class:`AdmissionConfig`: a queue of 256, no deadlines, no
    loop until :meth:`start`); ``governor`` injects a shared latency
    governor.  ``pool`` / ``devices`` configure the device pool
    (pool.py); the default is one member on ``device`` (None means CUDA,
    and raises without a GPU).  Batches are packed on the first member's
    device."""

    def __init__(self, opts: Options | None = None,
                 ladder: _bucket.BucketLadder | None = None,
                 cache: _cache.ExecutableCache | None = None,
                 admission: _admission.AdmissionConfig | None = None,
                 governor=None, device=None,
                 pool: _pool.DevicePool | None = None, devices=None):
        self.opts = dict(opts or {})
        self._ladder = ladder
        self.cache = cache if cache is not None else _cache.default_cache()
        self.admission = admission or _admission.AdmissionConfig()
        self.queue = _admission.AdmissionQueue(self.admission, governor)
        if pool is None:
            members = (list(devices) if devices is not None
                       else [resolve_device(device)])
            pool = _pool.DevicePool(members, governor=self.queue.governor)
        self.pool = pool
        self.device = torch.device(pool.members()[0]["device"])
        self.pool.set_canary(self._canary_probe)
        # flush/watchdog/lifecycle state shared by the submitting threads,
        # the flush loop, the watchdog and the retune worker
        self._lock = threading.Lock()
        self._inflight: list = []          # requests in the running flush
        self._flush_deadline: float | None = None   # watchdog deadline
        self._wedged: Exception | None = None       # sticky watchdog error
        self._flush_error: Exception | None = None  # sticky flush error
        self._quarantined = 0
        self._flusher: threading.Thread | None = None
        self._watchdog: threading.Thread | None = None
        self._stop_event = threading.Event()
        # online retune: per-dtype hot-swapped ladders, the observed
        # (op, n, kb) history the fitter reads, and the swap count
        self._ladders: dict = {}
        self._sizes: dict = {}
        self._retunes = 0
        self._retuning = False
        self._last_retune = time.perf_counter()
        # one record per executed batch, in execution order: the
        # serve_batch payload and the port's own fields
        self.batch_records: list[dict] = []

    # ------------------------------------------------------------ intake

    def ladder(self, dtype) -> _bucket.BucketLadder:
        dtype = normalize_dtype(dtype)
        with self._lock:
            swapped = self._ladders.get(dtype)
        if swapped is not None:            # online retune's hot swap wins
            return swapped
        if self._ladder is not None:
            return self._ladder
        return _bucket.default_ladder(dtype)

    def _canary_probe(self, member) -> bool:
        """The pool's readmission probe: one small well-conditioned solve
        through this member's cached callable (its graphs, on the card);
        True when the result is finite, healthy and right."""
        n = self.pool.config.canary_n
        dev = member.device
        fn, _ = self.cache.get_or_compile("solve", (n, 1), "float32", 1,
                                          self.opts, device=dev)
        a = (2.0 * torch.eye(n, device=dev))[None]
        b = torch.ones((1, n, 1), device=dev)
        x, hs, _ = fn(a, b, torch.full((1,), n, dtype=torch.int32,
                                       device=dev))
        return bool(torch.isfinite(x).all() and all(h.ok for h in hs)
                    and torch.allclose(x[0], torch.full_like(x[0], 0.5),
                                       atol=1e-4))

    def submit(self, op: str, a, b,
               deadline_ms: float | None = None) -> _admission.Ticket:
        """Queue one problem through admission control; returns its
        :class:`~slate_tpu_torch.serve.admission.Ticket` (an int: the
        index into the next ``drain()``'s results; ``ticket.result()`` is
        the durable interface).  A request that would age out is shed here
        with a typed error; a wedged server refuses new work."""
        if op not in SERVE_OPS:
            raise ValueError(f"serve: unknown op {op!r} "
                             f"(known: {SERVE_OPS})")
        a = _as_2d(a, "a")
        b = _as_2d(b, "b")
        if a.dtype != b.dtype:
            raise ValueError(f"serve: a/b dtypes differ "
                             f"({a.dtype} vs {b.dtype})")
        if op == "least_squares_solve":
            if a.shape[0] < a.shape[1]:
                raise ValueError("serve: least_squares_solve needs "
                                 f"m >= n, got {tuple(a.shape)}")
        elif a.shape[0] != a.shape[1]:
            raise ValueError(f"serve: {op} needs square A, got "
                             f"{tuple(a.shape)}")
        if b.shape[0] != a.shape[0]:
            raise ValueError(f"serve: A {tuple(a.shape)} / B "
                             f"{tuple(b.shape)} row mismatch")
        wedge = self.wedged()
        if wedge is not None:
            raise SlateServeTimeoutError(
                f"serve: server is wedged ({wedge}); restart it",
                reason="wedged")
        now = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.admission.default_deadline_ms
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        dtype = normalize_dtype(a.dtype)

        def build(ticket):
            return Request(op, a, b, now, ticket, deadline, 0)

        try:
            ticket, victims = self.queue.offer(build, deadline, now)
        except SlateServeTimeoutError as e:
            self._emit_shed(op, dtype, e.reason, 0.0)
            raise
        except SlateServeError as e:
            self._emit_shed(op, dtype,
                            f"overflow_{getattr(e, 'policy', 'reject')}",
                            0.0)
            raise
        for v in victims:
            err = _admission.SlateServeOverloadError(
                "serve: shed (oldest queued) to admit new work under "
                "overload", policy="shed_oldest")
            if v.ticket is not None:
                v.ticket.fail(err)
            self._emit_shed(v.op, normalize_dtype(v.a.dtype),
                            "overflow_shed_oldest",
                            (now - v.t_submit) * 1e3)
        return ticket

    def serve_batch(self, requests) -> list:
        """Synchronous convenience: submit every (op, a, b) and drain."""
        for op, a, b in requests:
            self.submit(op, a, b)
        return self.drain()

    def _emit_shed(self, op: str, dtype: str, reason: str,
                   age_ms: float) -> None:
        _events.emit_serve_shed({
            "op": op, "dtype": dtype, "reason": reason,
            "age_ms": round(age_ms, 3),
            "queue_depth": self.queue.depth(),
            "device_id": None,   # shed at admission: no member involved
        })

    # ------------------------------------------------- background loop

    def start(self) -> None:
        """Start the background flush loop and its watchdog (both daemon
        threads; idempotent while they are alive)."""
        with self._lock:
            if self._flusher is not None and self._flusher.is_alive():
                return
            self._stop_event.clear()
            self._flusher = threading.Thread(
                target=self._flush_loop, name="slate-serve-flush",
                daemon=True)
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="slate-serve-watchdog",
                daemon=True)
            self._flusher.start()
            self._watchdog.start()

    def running(self) -> bool:
        with self._lock:
            return (self._flusher is not None
                    and self._flusher.is_alive())

    def wedged(self) -> Exception | None:
        """The sticky watchdog error, if the server is wedged."""
        with self._lock:
            return self._wedged

    def health_info(self) -> dict:
        """Front-door health: admission stats, loop and wedge state, the
        quarantine and retune counts, the pool, the SLO tails and the
        cache's captures: what a load balancer would scrape."""
        with self._lock:
            wedged = self._wedged
            inflight = len(self._inflight)
            quarantined = self._quarantined
            retunes = self._retunes
        return {
            "queue": self.queue.stats(),
            "inflight": inflight,
            "running": self.running(),
            "wedged": None if wedged is None else str(wedged),
            "quarantined": quarantined,
            "retunes": retunes,
            "pool": self.pool.stats(),
            "degraded": self.pool.degraded(),
            "slo_p99_ms": self.queue.governor.p99_ms(),
            "slo_budget_ms": self.queue.governor.budget_ms,
            "slo_device_p99_ms": self.queue.governor.device_p99s(),
            "captures": self.cache.stats()["captures"],
        }

    def shutdown(self, drain: bool = True,
                 timeout_s: float | None = None) -> None:
        """Stop the loop and settle every pending request: drain them
        (default) or fail them with a typed shutdown error; never leave a
        ticket unsettled or a daemon thread parked.  A wedged flush thread
        cannot be stopped: its requests were already failed by the
        watchdog, and the daemon thread ends with its stall."""
        with self._lock:
            flusher, watchdog = self._flusher, self._watchdog
        self._stop_event.set()
        self.queue.kick()
        join_s = (timeout_s if timeout_s is not None
                  else self.admission.watchdog_timeout_s + 1.0)
        for t in (flusher, watchdog):
            if t is not None and t is not threading.current_thread():
                t.join(join_s)
        stranded = self.queue.close("shutdown")
        if stranded:
            if drain and self.wedged() is None:
                _, err = self._execute(stranded)
                if err is not None:
                    with self._lock:
                        self._flush_error = err
            else:
                err = SlateServeTimeoutError(
                    f"serve: shutdown with {len(stranded)} request(s) "
                    f"still pending", reason="shutdown")
                self.queue.note_shed(len(stranded))
                for r in stranded:
                    if r.ticket is not None:
                        r.ticket.fail(err)
                    self._emit_shed(
                        r.op, normalize_dtype(r.a.dtype), "shutdown",
                        (time.perf_counter() - r.t_submit) * 1e3)
        with self._lock:
            self._flusher = None
            self._watchdog = None

    def _flush_loop(self) -> None:
        poll_s = max(self.admission.max_batch_delay_ms / 2e3, 1e-3)
        while not self._stop_event.is_set():
            self._retune_tick()
            if self.queue.flush_due():
                self._flush_once()
            else:
                self.queue.park(poll_s)
                if not self.queue.flush_due():
                    self._stop_event.wait(poll_s)

    def _flush_once(self) -> None:
        live, expired = self.queue.take_all()
        self._shed_expired(expired)
        if not live:
            return
        with self._lock:
            self._inflight = live
            self._flush_deadline = (time.perf_counter()
                                    + self.admission.watchdog_timeout_s)
        err = None
        try:
            _, err = self._execute(live)
        except Exception as e:          # never kill the loop: stickify
            err = e
            for r in live:
                if r.ticket is not None:
                    r.ticket.fail(e)
        finally:
            with self._lock:
                self._inflight = []
                self._flush_deadline = None
        if err is not None:
            with self._lock:
                self._flush_error = err

    def _watchdog_loop(self) -> None:
        poll_s = min(max(self.admission.watchdog_timeout_s / 8.0, 1e-3),
                     0.25)
        while not self._stop_event.is_set():
            with self._lock:
                deadline = self._flush_deadline
            if deadline is not None and time.perf_counter() > deadline:
                self._declare_wedged()
            self._stop_event.wait(poll_s)

    def _declare_wedged(self) -> None:
        err = SlateServeTimeoutError(
            f"serve: flush exceeded watchdog_timeout_s="
            f"{self.admission.watchdog_timeout_s} (stuck capture or "
            f"device hang) — failing pending requests", reason="watchdog")
        with self._lock:
            if self._flush_deadline is None:    # the flush just completed
                return
            self._wedged = err
            inflight, self._inflight = self._inflight, []
            self._flush_deadline = None
        stranded = self.queue.close("wedged")
        self.queue.note_shed(len(inflight) + len(stranded))
        now = time.perf_counter()
        for r in inflight + stranded:
            if r.ticket is not None:
                r.ticket.fail(err)
            self._emit_shed(r.op, normalize_dtype(r.a.dtype), "watchdog",
                            (now - r.t_submit) * 1e3)

    def _shed_expired(self, expired) -> None:
        if not expired:
            return
        self.queue.note_shed(len(expired))
        now = time.perf_counter()
        for r in expired:
            err = SlateServeTimeoutError(
                "serve: request deadline expired while queued — shed at "
                "flush", reason="deadline")
            if r.ticket is not None:
                r.ticket.fail(err)
            self._emit_shed(r.op, normalize_dtype(r.a.dtype), "deadline",
                            (now - r.t_submit) * 1e3)

    # ---------------------------------------------------- online retune

    def _note_sizes(self, dtype: str, entries) -> None:
        """Record observed ``(op, n, kb)`` triples into the history the
        background retune fits against (a no-op unless
        ``retune_interval_s`` is set)."""
        if self.admission.retune_interval_s is None:
            return
        with self._lock:
            hist = self._sizes.setdefault(dtype, [])
            hist.extend(entries)
            if len(hist) > 4096:           # a window, not forever
                del hist[:len(hist) - 4096]

    def _retune_tick(self) -> None:
        """Flush-loop tick: start one background retune worker when the
        interval has elapsed.  The fit and the captures run off the flush
        loop; only the final swap takes the lock."""
        interval = self.admission.retune_interval_s
        if interval is None:
            return
        now = time.perf_counter()
        with self._lock:
            if self._retuning or now - self._last_retune < interval:
                return
            self._retuning = True
            self._last_retune = now
        threading.Thread(target=self._retune_worker,
                         name="slate-serve-retune", daemon=True).start()

    def _retune_worker(self) -> None:
        try:
            with self._lock:
                due = [d for d, h in self._sizes.items()
                       if len(h) >= self.admission.retune_min_samples]
            for dtype in due:
                try:
                    self.retune_now(dtype)
                except Exception:      # best effort: never kill serving
                    pass
        finally:
            with self._lock:
                self._retuning = False

    def retune_now(self, dtype) -> dict | None:
        """Refit the bucket ladder of ``dtype`` from the observed sizes
        and hot-swap it when the fit beats the live ladder by at least
        ``retune_margin`` padding waste.  Returns the swap's record (also
        emitted as ``serve_retune``), or None when nothing swapped (too
        few samples, or no win worth the captures).

        The fitted rungs' graphs are captured on every healthy member
        BEFORE the swap, so the first flush after it is a cache hit.  The
        swap is atomic under the server's lock, and the history resets
        after it."""
        from ..tune import autotune as _autotune
        dtype = normalize_dtype(dtype)
        cfg = self.admission
        with self._lock:
            entries = list(self._sizes.get(dtype, ()))
        if len(entries) < cfg.retune_min_samples:
            return None
        ns = [n for _, n, _ in entries]
        live = self.ladder(dtype)
        fitted = _bucket.BucketLadder(
            _autotune.serve_ladder_from_sizes(ns), "retuned")
        w_live = _autotune.ladder_waste(ns, live)
        w_fit = _autotune.ladder_waste(ns, fitted)
        if w_fit >= w_live - cfg.retune_margin:
            return None
        self._warm_rungs(fitted, dtype, entries)
        with self._lock:
            self._ladders[dtype] = fitted
            self._sizes[dtype] = []
            self._retunes += 1
        info = {"op": "ladder", "dtype": dtype,
                "old": [int(r) for r in live.rungs],
                "new": [int(r) for r in fitted.rungs],
                "waste_live": round(w_live, 4),
                "waste_fitted": round(w_fit, 4),
                "samples": len(entries)}
        _events.emit_serve_retune(info)
        return info

    def _warm_rungs(self, ladder, dtype: str, entries) -> None:
        """Best-effort capture of the fitted ladder's four hottest square
        buckets on every healthy member, at the flush occupancy's batch,
        while the old graphs keep serving; a failure is ignored (the
        flush path captures on demand)."""
        shapes = collections.Counter((op, ladder.bucket_for(n), kb)
                                     for op, n, kb in entries
                                     if op != "least_squares_solve")
        batch = _bucket.next_pow2(self.admission.flush_occupancy)
        for (op, nb, kb), _ in shapes.most_common(4):
            for _, dev in self.pool.healthy_devices():
                try:
                    self.cache.get_or_compile(op, (nb, kb), dtype, batch,
                                              self.opts, device=dev)
                except Exception:
                    return

    # ------------------------------------------------------------- drain

    def _bucket_of(self, req: Request):
        lad = self.ladder(req.a.dtype)
        if req.op == "least_squares_solve":
            return _bucket.least_squares_buckets(
                lad, req.a.shape[0], req.a.shape[1], req.b.shape[1])
        return _bucket.solve_buckets(lad, req.a.shape[0], req.b.shape[1])

    def drain(self) -> list:
        """Execute every pending request; results in submit order.  A
        sticky error from a failed background flush is raised here first
        (then cleared), even on an empty queue; a group that fails stores
        its typed error on every affected ticket, and drain raises the
        first one after every group was attempted; requests whose deadline
        passed while queued are shed with a typed error."""
        with self._lock:
            err, self._flush_error = self._flush_error, None
        if err is not None:
            raise err
        live, expired = self.queue.take_all()
        self._shed_expired(expired)
        if not live:
            return []
        results, err = self._execute(live)
        if err is not None:
            raise err
        return results

    def _execute(self, pending):
        """Run every request of one flush: group, dispatch, retry poisons
        once in a fresh batch, quarantine repeat offenders to a batch of
        their own, deliver to tickets.  Returns ``(results, first_error)``
        aligned to ``pending`` (None in a failed slot, whose ticket holds
        the error)."""
        plan = _faults.host_fire("serve_flush_delay")
        if plan is not None:
            time.sleep(plan.delay_s)
        t_flush = time.perf_counter()
        results: list = [None] * len(pending)
        first_err: Exception | None = None

        def deliver(idx: int, res: Result, device: int | None = None):
            results[idx] = res
            req = pending[idx]
            self.queue.governor.observe(
                (time.perf_counter() - req.t_submit) * 1e3, device)
            if req.ticket is not None:
                req.ticket.deliver(res)

        def run_pass(members_by_idx, queue_depth):
            """One grouped pass; returns the poison list [(idx, req)]."""
            nonlocal first_err
            reqs = dict(members_by_idx)
            groups: dict = {}
            for idx, req in members_by_idx:
                key = (req.op, normalize_dtype(req.a.dtype),
                       self._bucket_of(req))
                groups.setdefault(key, []).append((idx, req))
            keys = sorted(groups, key=repr)

            def attempt(key):
                try:
                    return key, self._run_group(*key, groups[key], t_flush,
                                                queue_depth), None
                except Exception as e:  # the group fails, not the flush
                    return key, None, e

            workers = min(len(keys), self.pool.healthy_count())
            if workers > 1:
                # distinct buckets dispatch concurrently: the pool
                # round-robins them onto different members
                with futures.ThreadPoolExecutor(
                        workers, "slate-serve-group") as ex:
                    outcomes = list(ex.map(attempt, keys))
            else:
                outcomes = [attempt(k) for k in keys]

            poisons = []
            for key, ran, exc in outcomes:
                op, dtype, shape = key
                if exc is not None:
                    err = exc if isinstance(exc, SlateServeError) else \
                        SlateServeError(
                            f"serve: batch failed for {op}/{dtype} "
                            f"bucket {shape}: {exc}")
                    err.__cause__ = exc if err is not exc else None
                    first_err = first_err or err
                    for _, req in groups[key]:
                        if req.ticket is not None:
                            req.ticket.fail(err)
                    continue
                out, device = ran
                for idx, res in out:
                    req = reqs[idx]
                    if _poison(res):
                        # withhold the result: the first strike earns the
                        # fresh-batch retry, the second the quarantine
                        poisons.append((idx, req._replace(
                            retries=req.retries + 1)))
                    else:
                        deliver(idx, res, device)
            return poisons

        poisons = run_pass(list(enumerate(pending)), len(pending))
        # the at-most-once fresh-batch retry: poisons ride together, never
        # again with the healthy requests they shared a batch with
        repeat = run_pass(poisons, len(poisons)) if poisons else []
        for idx, req in repeat:
            self._quarantine(idx, req, t_flush, deliver)
        return results, first_err

    def _quarantine(self, idx: int, req: Request, t_flush: float,
                    deliver) -> None:
        """The second strike: a batch of its own, whose result is delivered
        whatever its health says."""
        with self._lock:
            self._quarantined += 1
        op, dtype = req.op, normalize_dtype(req.a.dtype)
        shape = self._bucket_of(req)
        t0 = time.perf_counter()
        try:
            ((_, res),), device = self._run_group(
                op, dtype, shape, [(idx, req)], t_flush, 1,
                quarantine=True)
        except Exception as exc:            # the ticket carries the error
            err = exc if isinstance(exc, SlateServeError) else \
                SlateServeError(f"serve: quarantine batch failed for "
                                f"{op}/{dtype}: {exc}")
            if req.ticket is not None:
                req.ticket.fail(err)
            return
        _events.emit_serve_quarantine({
            "op": op, "dtype": dtype, "bucket": list(shape),
            "reason": "escalation_exhausted",
            "retries": max(req.retries - 1, 0),   # fresh-batch retries
            "ok": bool(res.health.ok),
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "device_id": device,
        })
        deliver(idx, res, device)

    def _run_group(self, op: str, dtype: str, shape: tuple, members,
                   t_flush: float, queue_depth: int,
                   quarantine: bool = False):
        """Pack, dispatch through the device pool, unpack one group.
        Returns ``(out, member_index)`` with ``out`` the ``(idx, Result)``
        list in member order; appends the batch's record to
        ``batch_records`` and emits it as ``serve_batch``."""
        t0 = time.perf_counter()
        n_real = len(members)
        batch = _bucket.next_pow2(n_real)
        a_pad, b_pad, sizes, real_elems = self._pack(op, dtype, shape, batch,
                                                     members)
        mb, nb, kb = a_pad.shape[1], a_pad.shape[2], b_pad.shape[2]
        self._note_sizes(dtype, [(op, req.a.shape[1], kb)
                                 for _, req in members])

        captures0 = _sentinel.total()
        # build (on the card: capture) the bucket's callable on EVERY
        # healthy member before dispatch: a cold capture must never read as
        # a dispatch-deadline miss (the watchdog guards wedged captures)
        exes: dict = {}
        warm = []
        for midx, dev in self.pool.healthy_devices():
            exes[midx], was_hit = self.cache.get_or_compile(
                op, shape, dtype, batch, self.opts, device=dev)
            warm.append(was_hit)
        hit = bool(warm) and all(warm)
        captures = _sentinel.total() - captures0

        def run(member):
            fn = exes.get(member.index)
            if fn is None:         # readmitted after the warm pass
                fn, _ = self.cache.get_or_compile(
                    op, shape, dtype, batch, self.opts,
                    device=member.device)
            dev = member.device
            # the packed batch stays as it is: each attempt copies it into
            # the member's static buffers, so a failover replays the same
            # bits on the same graphs
            t_exec = time.perf_counter()
            x, hs, esc = fn(a_pad.to(dev), b_pad.to(dev), sizes.to(dev))
            dev_ms = None
            if _events.timing_enabled():
                if x.device.type == "cuda":
                    torch.cuda.current_stream(x.device).synchronize()
                dev_ms = round((time.perf_counter() - t_exec) * 1e3, 3)
            return x, hs, esc, dev_ms

        def validate(ran) -> bool:
            # only slots whose health CLAIMS success are checked for device
            # garbage: a poison request honestly reports not-ok
            x, hs, _, _ = ran
            finite = torch.isfinite(x[:n_real].flatten(1)).all(
                dim=1).tolist()
            return all(fin or not hs[s].ok
                       for s, fin in enumerate(finite))

        (x, hs, esc, device_ms), dev_idx, failovers = \
            self.pool.dispatch(run, validate, op=op, dtype=dtype)
        out = [(idx, r) for (idx, _), r in
               zip(members, self._unpack(x, hs, esc, members))]

        t_done = time.perf_counter()
        ages = [round((t_flush - req.t_submit) * 1e3, 3)
                for _, req in members]
        latency = [round((t_done - req.t_submit) * 1e3, 3)
                   for _, req in members]
        mfu = gbps = None
        if device_ms:
            secs = device_ms * 1e-3
            # live problem flops only, against the dtype's card peak
            mfu = _flops.mfu(_flops.serve_flops(
                op, [(tuple(req.a.shape), tuple(req.b.shape))
                     for _, req in members]), secs, dtype)
            item = torch_dtype(dtype).itemsize
            gbps = _flops.achieved_gbps(
                float(batch) * (mb * nb + 2 * mb * kb) * item, secs)
        payload = {
            "op": op,
            "dtype": dtype,
            "bucket": list(shape),
            "batch": batch,
            "problems": n_real,
            "occupancy": round(n_real / batch, 4),
            "padding_waste": round(_bucket.padded_fraction(
                real_elems, batch * (mb * nb + mb * kb)), 4),
            "escalated": sum(bool(e) for e in esc[:n_real]),
            "cache": self.cache.stats(),
            "compiled": not hit,
            "captures": captures,
            "ladder": self.ladder(dtype).source,
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "device_ms": device_ms,
            "mfu": mfu,
            "achieved_gbps": gbps,
            "queue_depth": queue_depth,
            "age_at_flush_ms": ages,
            "latency_ms": latency,
            "device_id": dev_idx,
            "failovers": failovers,
        }
        _events.emit_serve_batch(payload)
        self.batch_records.append({
            **payload, "retry": max(req.retries for _, req in members),
            "quarantine": quarantine, "cache_hit": hit,
            "wall_s": time.perf_counter() - t0})
        return out, dev_idx

    def _pack(self, op: str, dtype: str, shape: tuple, batch: int, members):
        """The group's identity-augmented stacks on the server's device:
        ``(a [batch, mb, nb], b [batch, mb, kb], sizes [batch] int32,
        real_elems)``, with identity filler slots past the members."""
        if len(shape) == 3:
            mb, nb, kb = shape
        else:
            nb, kb = shape
            mb = nb
        tdt, dev = torch_dtype(dtype), self.device
        a_pad = torch.zeros((batch, mb, nb), dtype=tdt, device=dev)
        b_pad = torch.zeros((batch, mb, kb), dtype=tdt, device=dev)
        # per-problem live sizes, read by the ragged kernels on the device:
        # n for square slots, m + (nb - n) live augmented rows for least
        # squares, 0 for filler slots (batched.make_batched's contract)
        sizes = [0] * batch
        real_elems = 0
        for slot, (_, req) in enumerate(members):
            m_i, n_i = req.a.shape
            ad = req.a.to(dev)
            if op == "least_squares_solve":
                a_pad[slot] = _bucket.pad_tall(ad, mb, nb)
                sizes[slot] = m_i + (nb - n_i)
            else:
                a_pad[slot] = _bucket.pad_square(ad, nb)
                sizes[slot] = n_i
            b_pad[slot] = _bucket.pad_rows(req.b.to(dev), mb, kb)
            real_elems += m_i * n_i + m_i * req.b.shape[1]
        for slot in range(len(members), batch):      # identity filler slots
            a_pad[slot, :nb, :nb].diagonal().fill_(1)
        return (a_pad, b_pad,
                torch.tensor(sizes, dtype=torch.int32, device=dev),
                real_elems)

    def _unpack(self, x, hs, esc, members) -> list:
        """Each member's Result: its slice of x (a view of this batch's
        own output), its health and its escalation flag."""
        return [Result(x[slot, :req.a.shape[1], :req.b.shape[1]], hs[slot],
                       bool(esc[slot]))
                for slot, (_, req) in enumerate(members)]
