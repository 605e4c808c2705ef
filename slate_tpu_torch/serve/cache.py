"""The serving layer's cache of batch callables (port of
slate_tpu/serve/cache.py).

The reference AOT-compiles one executable per key (op, bucket shape,
dtype, options fingerprint, batch, device), holds it for the life of the
process and donates the packed right-hand side, so that a warm server
never retraces and never re-allocates its steady-state buffers.  The
port's counterpart of that compile is a CUDA-graph capture:

- On a CUDA device, the first use of a key builds the bucket's batch
  program (serve/batched.py ``batch_program``) over static input buffers
  ``a [batch, mb, nb]``, ``b [batch, mb, kb]`` and ``sizes [batch]``
  (the packed right-hand side is the steady-state buffer, the
  counterpart of the donated ``b``) and captures each of its ragged
  device parts (the first attempts through K6, K7 or K8) as a CUDA graph,
  after one warm-up pass on a side stream (internal/graphs.py).  Every
  call, the first included, copies its batch into the static buffers,
  replays the graphs its host part asks for, and escalates eagerly, so a
  bucket's bits do not depend on whether it was cold.  A failed capture
  or replay raises :class:`SlateServeError` carrying the CUDA error: no
  eager run takes its place.  Two exceptions run eagerly by design: the
  per-problem route (each problem through the single-problem drivers,
  which read health on the host inside every driver), and any batch
  while a fault plan is armed at a device site (robust/faults.py: a
  strike's positions come from the host, and a transient strike fires
  once, not on every replay).
- On a CPU device the callable is ``make_batched``'s eager one, the plain
  versions of the kernels, as the reference's Pallas kernels run in
  interpret mode there.

Every capture is counted by the capture sentinel (obs/sentinel.py), whose
counts the server's ``serve_batch`` records carry as ``captures``.  Two
pool members on one device share an entry; calls on one entry serialize
on its lock, which covers the copy-in, the replays, the copy-out and the
host part, so a dispatch thread that outlived its deadline cannot
overwrite a batch in flight.
"""

from __future__ import annotations

import threading
import time

import torch

from ..exceptions import SlateServeError
from ..internal.graphs import Captured
from ..obs import sentinel as _sentinel
from ..options import Options, options_fingerprint
from ..robust import faults as _faults
from ..robust.health import BatchHealth
from ..robust.precision import normalize_dtype, torch_dtype
from . import batched as _batched


def _device_key(device) -> str | None:
    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _flat(fn):
    """A device part as a function returning ``(x, *BatchHealth)``."""
    def run(a, b, sizes):
        x, h = fn(a, b, sizes)
        return (x, *h)
    return run


class BucketGraphs:
    """The batch callable of one key on a CUDA device: the bucket's batch
    program with each ragged device part captured as a CUDA graph.
    ``fn(a, b, sizes) -> (x, [HealthInfo], [escalated])`` as
    ``make_batched``'s; ``route`` is the program's route and ``graphs``
    the captured parts by name."""

    def __init__(self, op: str, shape: tuple, dtype: str, batch: int,
                 opts: Options | None, device: torch.device):
        mb, nb, kb = shape if len(shape) == 3 else (shape[0], *shape)
        tdt = torch_dtype(dtype)
        # identity filler slots: what the capture runs on is a valid batch
        a = torch.zeros((batch, mb, nb), dtype=tdt, device=device)
        a[:, :nb, :nb] = torch.eye(nb, dtype=tdt, device=device)
        b = torch.zeros((batch, mb, kb), dtype=tdt, device=device)
        sizes = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.program = _batched.batch_program(op, opts, a)
        self.route = self.program.route
        self.graphs = {}
        for name, part in self.program.parts.items():
            if part.ragged:
                self.graphs[name] = Captured(_flat(part.fn), (a, b, sizes))
        self.label = f"{op} {dtype} b{batch} {'x'.join(map(str, shape))}"
        self._lock = threading.Lock()

    def __call__(self, a, b, sizes):
        eager = _faults.device_plans_active()

        def run(name):
            graph = None if eager else self.graphs.get(name)
            if graph is None:
                return self.program.parts[name].fn(a, b, sizes)
            try:
                x, *h = graph(a, b, sizes)
            except RuntimeError as exc:
                raise SlateServeError(f"serve: graph replay failed for "
                                      f"{self.label} ({name}): {exc}") \
                    from exc
            return x, BatchHealth(*h)

        # every replay is followed by its health read, which waits for it,
        # so the static buffers are free again when the lock is released
        with self._lock:
            return self.program.host(a, b, sizes, run)


class ExecutableCache:
    """In-process store of batch callables with hit/miss accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._exes: dict = {}
        self._hits = 0
        self._misses = 0
        self._compile_ms = 0.0
        self._captures = 0

    def stats(self) -> dict:
        """The reference's keys (``compile_ms``: warm-up plus capture) and
        ``captures``, the CUDA graphs captured."""
        with self._lock:
            return {"entries": len(self._exes), "hits": self._hits,
                    "misses": self._misses,
                    "compile_ms": round(self._compile_ms, 3),
                    "captures": self._captures}

    def entries(self) -> list:
        """``(key, callable)`` of every entry: key = (op, bucket shape,
        dtype, options fingerprint, batch, device); on CUDA the callable
        is a :class:`BucketGraphs`."""
        with self._lock:
            return list(self._exes.items())

    def clear(self) -> None:
        with self._lock:
            self._exes.clear()
            self._hits = 0
            self._misses = 0
            self._compile_ms = 0.0
            self._captures = 0

    def get_or_compile(self, op: str, bucket_shape: tuple, dtype,
                       batch: int, opts: Options | None = None,
                       device=None):
        """The batch callable of one bucket, built (on CUDA: captured) on
        first use; returns ``(fn, hit)``.  ``bucket_shape`` is ``(nb,
        kb)`` for square solves or ``(mb, nb, kb)`` for least squares,
        ``batch`` the bucketed problem count; ``fn(a, b, sizes)`` maps
        packed stacks on ``device`` to ``(x, [HealthInfo],
        [escalated])``.  Distinct devices are distinct keys; two pool
        members on one device share an entry."""
        dtype = normalize_dtype(dtype)
        key = (op, tuple(int(s) for s in bucket_shape), dtype,
               options_fingerprint(opts), int(batch), _device_key(device))
        # chaos site: a mid-flight eviction forces the capture path — the
        # serving layer must survive losing its warm graphs
        if _faults.host_fire("serve_cache_evict") is not None:
            self.clear()
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self._hits += 1
                return exe, True
        # capture OUTSIDE the lock (it runs the bucket twice); a racing
        # duplicate capture is wasted work, not a correctness problem.  The
        # chaos compile stall sleeps here too: the watchdog must catch a
        # wedged capture, and a stall under the lock would block every
        # other bucket
        stall = _faults.host_fire("serve_compile_stall")
        if stall is not None:
            time.sleep(stall.delay_s)
        t0 = time.perf_counter()
        exe, captures = self._compile(op, key[1], dtype, int(batch), opts,
                                      device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            winner = self._exes.setdefault(key, exe)
            self._misses += 1
            self._compile_ms += dt_ms
            self._captures += captures
        return winner, False

    @staticmethod
    def _compile(op: str, bucket_shape: tuple, dtype: str, batch: int,
                 opts: Options | None, device):
        """``(callable, graphs captured)`` for one key."""
        if device is None or torch.device(device).type != "cuda":
            return _batched.make_batched(op, opts), 0
        try:
            exe = BucketGraphs(op, bucket_shape, dtype, batch, opts,
                               torch.device(device))
        except RuntimeError as exc:
            raise SlateServeError(
                f"serve: graph capture failed for {op} {dtype} b{batch} "
                f"{bucket_shape}: {exc}") from exc
        for name in exe.graphs:
            _sentinel.record_trace(
                f"serve.{op}", f"{dtype}:b{batch}:"
                + "x".join(str(s) for s in bucket_shape) + f":{name}")
        return exe, len(exe.graphs)


_DEFAULT = ExecutableCache()


def default_cache() -> ExecutableCache:
    """The process-wide cache shared by Servers that bring none."""
    return _DEFAULT
