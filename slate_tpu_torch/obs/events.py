"""Structured serving events: one host-side ``slate-obs-v1`` record per
executed batch, shed request, quarantine, device-pool transition and
ladder retune (port of the sink and the serving emitters of
slate_tpu/obs/events.py).

Records live in an in-process ring (``SLATE_OBS_RING`` entries, 256 by
default), in every open :func:`recording` scope, and, when a path is
configured, one JSON line each in that file.  ``SLATE_OBS_EVENTS=<path>``
in the environment enables recording to that path at import time, and
``SLATE_OBS_TIMING=1`` turns device timing on.

Recording happens on the host only: a record holds plain Python values,
never a tensor, and an emit never reads the device.  The driver-boundary
frames (``boundary_enter``/``boundary_exit``, ``note_*``) and
``emit_checkpoint`` of the reference come with the telemetry slice of the
port (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

SCHEMA = "slate-obs-v1"

_LOCK = threading.Lock()
_CFG = {"enabled": False, "path": None, "timing": False}
_RING: deque = deque(maxlen=int(os.environ.get("SLATE_OBS_RING", "256")))
_COLLECTORS: list[list] = []


def _active() -> bool:
    # a lock-free peek on the per-batch path: a stale read only delays one
    # record past a concurrent enable/disable
    return _CFG["enabled"] or bool(_COLLECTORS)


def enabled() -> bool:
    """Is event recording on (the global switch or an open collector)?"""
    return _active()


def configure(enabled: bool | None = None, path: str | None = None) -> None:
    """Flip the global recording switch and/or set the JSONL sink path
    (``path=""`` clears it; None keeps it).  Without a path events stay in
    the in-process ring (:func:`recent`)."""
    with _LOCK:
        if enabled is not None:
            _CFG["enabled"] = bool(enabled)
        if path is not None:
            _CFG["path"] = path or None


def enable(path: str | None = None) -> None:
    configure(enabled=True, path=path)


def disable() -> None:
    configure(enabled=False)


@contextlib.contextmanager
def recording(path: str | None = None):
    """Collect events for the scope; yields the (live) list of events.
    With ``path`` the events also go to that JSONL file."""
    events: list = []
    with _LOCK:
        _COLLECTORS.append(events)
        prev_path = _CFG["path"]
    if path is not None:
        configure(path=path)
    try:
        yield events
    finally:
        with _LOCK:
            _COLLECTORS.remove(events)
            _CFG["path"] = prev_path


def recent(n: int | None = None) -> list:
    """The last ``n`` events from the in-process ring."""
    with _LOCK:
        out = list(_RING)
    return out if n is None else out[-n:]


def clear() -> None:
    with _LOCK:
        _RING.clear()


# ------------------------------------------------------------------ timing
#
# Device timing is opt-in: while it is on, the server synchronizes its
# device after each batch's dispatch, so that the ``serve_batch`` record's
# ``device_ms`` measures dispatch -> results ready instead of staying None.


def timing_enabled() -> bool:
    """Is device-time measurement on (``timing()`` or
    ``SLATE_OBS_TIMING=1``)?"""
    return _CFG["timing"]


def set_timing(on: bool) -> None:
    with _LOCK:
        _CFG["timing"] = bool(on)


@contextlib.contextmanager
def timing(on: bool = True):
    """Scope device-time measurement."""
    with _LOCK:
        prev = _CFG["timing"]
    set_timing(on)
    try:
        yield
    finally:
        set_timing(prev)


# ---------------------------------------------------------------- serving


def _emit_kind(kind: str, payload: dict) -> None:
    if not _active():
        return
    _emit({"schema": SCHEMA, "kind": kind, "ts": time.time(), **payload})


def emit_serve_batch(payload: dict) -> None:
    """One record per executed serving batch (kind ``serve_batch``;
    serve/server.py is the only caller): bucket occupancy, padding waste,
    escalations, the cache's stats, whether the batch captured a graph
    (``compiled``) and how many captures it made (``captures``, the
    reference's ``retraces``), latency and the pool member that ran it."""
    _emit_kind("serve_batch", payload)


def emit_serve_shed(payload: dict) -> None:
    """One record per request shed by admission control (kind
    ``serve_shed``): op/dtype, the ``reason`` (deadline / overflow_* /
    watchdog / shutdown), the victim's age and the queue depth;
    ``device_id`` is None, shedding happens before a member is picked."""
    _emit_kind("serve_shed", payload)


def emit_serve_quarantine(payload: dict) -> None:
    """One record per request quarantined to a batch of its own after its
    fresh-batch retry (kind ``serve_quarantine``); ``device_id`` is the
    pool member that served it."""
    _emit_kind("serve_quarantine", payload)


def emit_serve_device(payload: dict) -> None:
    """One record per device-pool health transition (kind
    ``serve_device``; serve/pool.py is the only caller): ``event``
    (failover / quarantine / probe_fail / readmit), the member's
    ``device_id``, the ``reason`` (exception / nonfinite / deadline /
    canary / flake / canary_ok) and the strike count."""
    _emit_kind("serve_device", payload)


def emit_serve_retune(payload: dict) -> None:
    """One record per online ladder hot-swap (kind ``serve_retune``): the
    dtype whose ladder was refit, the old and new rungs, the live and
    fitted padding waste that justified the swap, and the sample count."""
    _emit_kind("serve_retune", payload)


def _emit(event: dict) -> None:
    with _LOCK:
        _RING.append(event)
        for c in _COLLECTORS:
            c.append(event)
        path = _CFG["path"] if _CFG["enabled"] else None
    if path:
        line = json.dumps(event)
        with _LOCK:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")


def _init_from_env() -> None:
    path = os.environ.get("SLATE_OBS_EVENTS")
    if path:
        configure(enabled=True, path=path)
    if os.environ.get("SLATE_OBS_TIMING", "").lower() in ("1", "true",
                                                          "on", "yes"):
        set_timing(True)


_init_from_env()
