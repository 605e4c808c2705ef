"""The serving layer's cache of batch callables (port of
slate_tpu/serve/cache.py).

The reference AOT-compiles one executable per key (op, bucket shape,
dtype, options fingerprint, batch, device) and holds it for the life of
the process, so that a warm server never retraces.  PyTorch runs eagerly,
so there is nothing to compile: ``get_or_compile`` builds the
``make_batched`` callable under the same key and keeps the same hit/miss
accounting.  Capturing a warm bucket as a CUDA graph, with the donated
right-hand side as its steady-state buffer, is the counterpart of the
reference's compiled executable and waits for a later slice of the port
(ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import threading
import time

from ..options import Options
from ..robust.precision import normalize_dtype
from . import batched as _batched


def options_fingerprint(opts: Options | None) -> tuple:
    """Canonical, hashable digest of an options dict for cache keying.
    Order-insensitive; enum keys and values collapse to their names so
    equivalent spellings agree."""
    items = []
    for k, v in (opts or {}).items():
        kn = getattr(k, "name", str(k))
        vn = getattr(v, "name", None) or str(v)
        items.append((kn, vn))
    return tuple(sorted(items))


class ExecutableCache:
    """In-process store of batch callables with hit/miss accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._exes: dict = {}
        self._hits = 0
        self._misses = 0
        self._compile_ms = 0.0

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._exes), "hits": self._hits,
                    "misses": self._misses,
                    "compile_ms": round(self._compile_ms, 3)}

    def clear(self) -> None:
        with self._lock:
            self._exes.clear()
            self._hits = 0
            self._misses = 0
            self._compile_ms = 0.0

    def get_or_compile(self, op: str, bucket_shape: tuple, dtype,
                       batch: int, opts: Options | None = None,
                       device=None):
        """The batch callable of one bucket, built on first use; returns
        ``(fn, hit)``.  ``bucket_shape`` is ``(nb, kb)`` for square solves
        or ``(mb, nb, kb)`` for least squares, ``batch`` the bucketed
        problem count; ``fn(a, b, sizes)`` maps packed stacks on
        ``device`` to ``(x, [HealthInfo], [escalated])``."""
        key = (op, tuple(int(s) for s in bucket_shape),
               normalize_dtype(dtype), options_fingerprint(opts), int(batch),
               None if device is None else str(device))
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self._hits += 1
                return exe, True
        t0 = time.perf_counter()
        exe = _batched.make_batched(op, opts)
        dt_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            winner = self._exes.setdefault(key, exe)
            self._misses += 1
            self._compile_ms += dt_ms
        return winner, False


_DEFAULT = ExecutableCache()


def default_cache() -> ExecutableCache:
    """The process-wide cache shared by Servers that bring none."""
    return _DEFAULT
