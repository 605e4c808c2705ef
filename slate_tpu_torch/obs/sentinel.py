"""Capture sentinel: count CUDA-graph captures per key, warn on churn (port
of slate_tpu/obs/sentinel.py, which counts traces).

The reference counts every staging of a driver into a jaxpr, each of
which is followed by an XLA compile.  The port's counterpart of a compile
is a CUDA-graph capture (serve/cache.py), so this module counts captures
under the reference's API: ``record_trace(op, signature)`` counts one
capture, :func:`stats` reports per op the total, the distinct signatures
and the hottest signature's count.  A warm server never captures again;
two pathologies warn, once per op:

- the SAME signature captured more than ``SLATE_OBS_RETRACE_LIMIT``
  times (default 3): the cache is being evicted or bypassed;
- more than ``SLATE_OBS_SIGNATURE_LIMIT`` distinct signatures (default
  32) for one op: unbucketed shapes, a capture per shape.

Counters are process-global; :func:`reset` clears them (tests).
"""

from __future__ import annotations

import contextlib
import os
import threading
import warnings


class SlateRetraceWarning(UserWarning):
    """A key is being captured again and again."""


_LOCK = threading.Lock()
_TRACES: dict[str, dict[str, int]] = {}
_WARNED: set[tuple[str, str]] = set()
_TLS = threading.local()


@contextlib.contextmanager
def suppressed():
    """Ignore capture records made by this thread for the scope."""
    prev = getattr(_TLS, "suppress", False)
    _TLS.suppress = True
    try:
        yield
    finally:
        _TLS.suppress = prev


def _limit(env: str, default: int) -> int:
    try:
        return int(os.environ.get(env, "") or default)
    except ValueError:
        return default


def record_trace(op: str, signature: str) -> None:
    """Count one capture of ``op`` under ``signature``."""
    if getattr(_TLS, "suppress", False):
        return
    retrace_limit = _limit("SLATE_OBS_RETRACE_LIMIT", 3)
    sig_limit = _limit("SLATE_OBS_SIGNATURE_LIMIT", 32)
    with _LOCK:
        sigs = _TRACES.setdefault(op, {})
        sigs[signature] = count = sigs.get(signature, 0) + 1
        nsigs = len(sigs)
        warn_retrace = (count > retrace_limit
                        and (op, "retrace") not in _WARNED)
        if warn_retrace:
            _WARNED.add((op, "retrace"))
        warn_sigs = (nsigs > sig_limit and (op, "signatures") not in _WARNED)
        if warn_sigs:
            _WARNED.add((op, "signatures"))
    if warn_retrace:
        warnings.warn(
            f"{op}: captured {count}x for the same signature [{signature}] "
            f"(limit {retrace_limit}) — the graph cache is being evicted "
            "or bypassed. Raise SLATE_OBS_RETRACE_LIMIT to silence.",
            SlateRetraceWarning, stacklevel=3)
    if warn_sigs:
        warnings.warn(
            f"{op}: {nsigs} distinct capture signatures (limit {sig_limit}) "
            "— unbucketed shapes capture a graph per shape; pad/bucket "
            "inputs. Raise SLATE_OBS_SIGNATURE_LIMIT to silence.",
            SlateRetraceWarning, stacklevel=3)


def stats() -> dict:
    """Per-op capture counters: total captures (``traces``, the
    reference's key), distinct signatures, and the hottest signature's
    count."""
    with _LOCK:
        return {
            op: {
                "traces": sum(sigs.values()),
                "signatures": len(sigs),
                "max_per_signature": max(sigs.values(), default=0),
            }
            for op, sigs in _TRACES.items()
        }


def total() -> int:
    """Every capture recorded so far, over all ops."""
    return sum(s["traces"] for s in stats().values())


def reset() -> None:
    """Clear counters and re-arm the once-per-op warnings (tests)."""
    with _LOCK:
        _TRACES.clear()
        _WARNED.clear()
