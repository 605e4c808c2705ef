"""The serving front end on one device: submit mixed-size solves, drain
bucketed batches (port of the synchronous part of
slate_tpu/serve/server.py)::

    from slate_tpu_torch import serve

    srv = serve.Server()                          # on CUDA by default
    t0 = srv.submit("solve", a0, b0)              # (n0, n0), (n0, k0)
    t1 = srv.submit("chol_solve", a1, b1)
    t2 = srv.submit("least_squares_solve", a2, b2)
    results = srv.drain()                         # [Result] in submit order

Each drain groups the pending requests by ``(op, dtype, bucket)``,
identity-pads every problem to its bucket (bucket.py), rounds the batch
count up to a power of two with filler slots, runs the bucket's batch
callable (cache.py, batched.py) and unpacks per-problem results,
``HealthInfo`` and escalation flags.  Admission control (admission.py)
bounds the queue with its overflow policies and deadlines.  A problem
that exhausts its escalation ladder (``escalated`` and unhealthy) is
retried at most once in a fresh batch, then quarantined to a batch of its
own, whose result is delivered with its health.

Not ported yet (ROADMAP.md queue 1, item 9): the background flush loop
with its watchdog (``start``/``shutdown`` raise), online ladder retune,
the device pool and its canary, and the obs events; in their place each
executed batch appends a plain record to ``Server.batch_records``.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core.storage import as_tensor, resolve_device
from ..exceptions import SlateServeError, not_ported
from ..options import Options
from ..robust.health import HealthInfo
from ..robust.precision import normalize_dtype, torch_dtype
from . import admission as _admission
from . import bucket as _bucket
from . import cache as _cache

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
    """Shape-bucketed batch server on one device.

    ``opts`` apply to every request (they are part of the cache key);
    ``ladder`` overrides the bucket ladder (default: geometric);
    ``cache`` shares or isolates the store of batch callables (default:
    the process-wide one); ``admission`` configures the queue (default
    :class:`AdmissionConfig`: a queue of 256, no deadlines); ``governor``
    injects a shared latency governor; ``device`` is where batches run
    (None means CUDA, and raises without a GPU)."""

    def __init__(self, opts: Options | None = None,
                 ladder: _bucket.BucketLadder | None = None,
                 cache: _cache.ExecutableCache | None = None,
                 admission: _admission.AdmissionConfig | None = None,
                 governor=None, device=None):
        self.opts = dict(opts or {})
        self.device = resolve_device(device)
        self._ladder = ladder
        self.cache = cache if cache is not None else _cache.default_cache()
        self.admission = admission or _admission.AdmissionConfig()
        self.queue = _admission.AdmissionQueue(self.admission, governor)
        self._lock = threading.Lock()
        self._quarantined = 0
        # one record per executed batch, in execution order
        self.batch_records: list[dict] = []

    # ------------------------------------------------------------ intake

    def ladder(self, dtype) -> _bucket.BucketLadder:
        if self._ladder is not None:
            return self._ladder
        return _bucket.default_ladder(normalize_dtype(dtype))

    def submit(self, op: str, a, b,
               deadline_ms: float | None = None) -> _admission.Ticket:
        """Queue one problem through admission control; returns its
        :class:`~slate_tpu_torch.serve.admission.Ticket` (an int: the
        index into the next ``drain()``'s results; ``ticket.result()`` is
        the durable interface).  A request that would age out is shed
        here with a typed error."""
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
        now = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.admission.default_deadline_ms
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3

        def build(ticket):
            return Request(op, a, b, now, ticket, deadline, 0)

        ticket, victims = self.queue.offer(build, deadline, now)
        for v in victims:
            v.ticket.fail(_admission.SlateServeOverloadError(
                "serve: shed (oldest queued) to admit new work under "
                "overload", policy="shed_oldest"))
        return ticket

    def serve_batch(self, requests) -> list:
        """Synchronous convenience: submit every (op, a, b) and drain."""
        for op, a, b in requests:
            self.submit(op, a, b)
        return self.drain()

    def start(self) -> None:
        raise not_ported("Server.start (the background flush loop and its "
                         "watchdog)", "queue 1, item 9 (serving)")

    def shutdown(self, drain: bool = True,
                 timeout_s: float | None = None) -> None:
        raise not_ported("Server.shutdown (the background flush loop and "
                         "its watchdog)", "queue 1, item 9 (serving)")

    def health_info(self) -> dict:
        """Front-door health: admission stats and the quarantine count."""
        with self._lock:
            quarantined = self._quarantined
        return {"queue": self.queue.stats(), "quarantined": quarantined,
                "slo_p99_ms": self.queue.governor.p99_ms(),
                "slo_budget_ms": self.queue.governor.budget_ms}

    # ------------------------------------------------------------- drain

    def _bucket_of(self, req: Request):
        lad = self.ladder(req.a.dtype)
        if req.op == "least_squares_solve":
            return _bucket.least_squares_buckets(
                lad, req.a.shape[0], req.a.shape[1], req.b.shape[1])
        return _bucket.solve_buckets(lad, req.a.shape[0], req.b.shape[1])

    def drain(self) -> list:
        """Execute every pending request; results in submit order.  A
        group that fails stores its typed error on every affected ticket,
        and drain raises the first one after every group was attempted;
        requests whose deadline passed while queued are shed with a typed
        error on their tickets."""
        live, expired = self.queue.take_all()
        if expired:
            self.queue.note_shed(len(expired))
            for r in expired:
                r.ticket.fail(_admission.SlateServeTimeoutError(
                    "serve: request deadline expired while queued — shed "
                    "at flush", reason="deadline"))
        if not live:
            return []
        results, err = self._execute(live)
        if err is not None:
            raise err
        return results

    def _execute(self, pending):
        """Run every request of one drain: group, execute, retry poisons
        once in a fresh batch, quarantine repeat offenders to a batch of
        their own, deliver to tickets.  Returns ``(results, first_error)``
        aligned to ``pending`` (None in a failed slot, whose ticket holds
        the error)."""
        results: list = [None] * len(pending)
        first_err: Exception | None = None

        def deliver(idx: int, res: Result) -> None:
            results[idx] = res
            req = pending[idx]
            self.queue.governor.observe(
                (time.perf_counter() - req.t_submit) * 1e3)
            if req.ticket is not None:
                req.ticket.deliver(res)

        def run_pass(members_by_idx):
            """One grouped pass; returns the poison list [(idx, req)]."""
            nonlocal first_err
            groups: dict = {}
            for idx, req in members_by_idx:
                key = (req.op, normalize_dtype(req.a.dtype),
                       self._bucket_of(req))
                groups.setdefault(key, []).append((idx, req))
            poisons = []
            for key in sorted(groups, key=repr):
                try:
                    out = self._run_group(*key, groups[key])
                except Exception as exc:    # the group fails, not the drain
                    err = exc if isinstance(exc, SlateServeError) else \
                        SlateServeError(f"serve: batch failed for "
                                        f"{key[0]}/{key[1]} bucket {key[2]}: "
                                        f"{exc}")
                    if err is not exc:
                        err.__cause__ = exc
                    first_err = first_err or err
                    for _, req in groups[key]:
                        if req.ticket is not None:
                            req.ticket.fail(err)
                    continue
                for (idx, req), res in zip(groups[key], out):
                    if _poison(res):
                        # withhold the result: the first strike earns the
                        # fresh-batch retry, the second the quarantine
                        poisons.append((idx, req._replace(
                            retries=req.retries + 1)))
                    else:
                        deliver(idx, res)
            return poisons

        poisons = run_pass(list(enumerate(pending)))
        # the at-most-once fresh-batch retry: poisons ride together, never
        # again with the healthy requests they shared a batch with
        repeat = run_pass(poisons) if poisons else []
        for idx, req in repeat:
            self._quarantine(idx, req, deliver)
        return results, first_err

    def _quarantine(self, idx: int, req: Request, deliver) -> None:
        """The second strike: a batch of its own, whose result is delivered
        whatever its health says."""
        with self._lock:
            self._quarantined += 1
        op, dtype = req.op, normalize_dtype(req.a.dtype)
        try:
            (res,) = self._run_group(op, dtype, self._bucket_of(req),
                                     [(idx, req)], quarantine=True)
        except Exception as exc:            # the ticket carries the error
            err = exc if isinstance(exc, SlateServeError) else \
                SlateServeError(f"serve: quarantine batch failed for "
                                f"{op}/{dtype}: {exc}")
            if req.ticket is not None:
                req.ticket.fail(err)
            return
        deliver(idx, res)

    def _run_group(self, op: str, dtype: str, shape: tuple, members,
                   quarantine: bool = False) -> list:
        """Pack, run and unpack one group; returns its Results in member
        order and appends the batch's record to ``batch_records``."""
        t0 = time.perf_counter()
        batch = _bucket.next_pow2(len(members))
        a_pad, b_pad, sizes, real_elems = self._pack(op, dtype, shape, batch,
                                                     members)
        fn, hit = self.cache.get_or_compile(op, shape, dtype, batch,
                                            self.opts, self.device)
        x, hs, esc = fn(a_pad, b_pad, sizes)
        out = self._unpack(x, hs, esc, members)
        mb, nb, kb = a_pad.shape[1], a_pad.shape[2], b_pad.shape[2]
        self.batch_records.append({
            "op": op, "dtype": dtype, "bucket": list(shape), "batch": batch,
            "problems": len(members), "occupancy": len(members) / batch,
            "padding_waste": _bucket.padded_fraction(
                real_elems, batch * (mb * nb + mb * kb)),
            "escalated": sum(r.escalated for r in out),
            "retry": max(req.retries for _, req in members),
            "quarantine": quarantine, "cache_hit": hit,
            "wall_s": time.perf_counter() - t0})
        return out

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
        """Each member's Result: its slice of x (a view), its health and
        its escalation flag."""
        return [Result(x[slot, :req.a.shape[1], :req.b.shape[1]], hs[slot],
                       bool(esc[slot]))
                for slot, (_, req) in enumerate(members)]
