"""Structured events: one host-side ``slate-obs-v1`` record per public
driver call, and per executed serving batch, shed request, quarantine,
device-pool transition, ladder retune and checkpoint (port of
slate_tpu/obs/events.py).

The ``@annotate`` wrapper (util/trace.py) opens a boundary frame, the
``health.finalize`` / ``recovery`` / ``options.resolve_*`` / ``tune``
seams note what they resolved into it, and the OUTERMOST frame emits one
event when the driver returns.  Nested driver calls (gesv's getrf, getrs
and gemm) open inner frames that are discarded; every note lands on the
outermost frame, last write wins, so the boundary's own finalize is what
the event reports.  Frames are per thread: a driver call made by the
serving loop's or the pool's threads never lands in the caller's frame.

Recording happens on the host only: a record holds plain Python values,
never a tensor, and recording never reads the device, so a driver makes
the same launches and returns the same bits with it on or off.  A
boundary opened while the current stream captures a CUDA graph (the
port's counterpart of the reference's tracing) is flagged ``"traced":
true``.  The capture sites themselves feed the capture sentinel
(obs/sentinel.py), so a boundary does not.

Records live in an in-process ring (``SLATE_OBS_RING`` entries, 256 by
default), in every open :func:`recording` scope, and, when a path is
configured, one JSON line each in that file.  ``SLATE_OBS_EVENTS=<path>``
in the environment enables recording to that path at import time, and
``SLATE_OBS_TIMING=1`` turns device timing on.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque

from . import flops as _flops
from . import tracer as _tracer

SCHEMA = "slate-obs-v1"
_MAX_PLANS_PER_EVENT = 8          # bound event size for tile-heavy drivers

_TLS = threading.local()
_LOCK = threading.Lock()
_CFG = {"enabled": False, "path": None, "timing": False}
_RING: deque = deque(maxlen=int(os.environ.get("SLATE_OBS_RING", "256")))
_COLLECTORS: list[list] = []


class _Frame:
    """One open driver boundary (host-side bookkeeping only)."""

    __slots__ = ("op", "t0", "traced", "shapes", "dtype", "notes",
                 "plans_seen", "device_ms")

    def __init__(self, op, traced, shapes, dtype):
        self.op = op
        self.t0 = time.perf_counter()
        self.traced = traced
        self.shapes = shapes
        self.dtype = dtype
        self.notes: dict = {}
        self.plans_seen: set = set()
        self.device_ms: float | None = None


def _frames() -> list:
    fs = getattr(_TLS, "frames", None)
    if fs is None:
        fs = _TLS.frames = []
    return fs


def _active() -> bool:
    # slate-lint: disable=CON001 -- designed lock-free peek on the per-call fast path: a stale read only delays one event past a concurrent enable/disable, never tears (dict read is atomic under the GIL)
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
# Device timing is opt-in: while it is on, the outermost driver boundary
# waits until its result is ready on the device before it closes, and the
# server waits after each batch's dispatch, so that an event's
# ``device_ms`` measures dispatch -> results ready instead of staying None.
# A boundary inside a CUDA-graph capture never waits (:func:`should_time`
# refuses it): a synchronization there would abort the capture.


def timing_enabled() -> bool:
    """Is device-time measurement on (``timing()`` or
    ``SLATE_OBS_TIMING=1``)?"""
    # slate-lint: disable=CON001 -- designed lock-free peek on the per-call fast path: one boundary may miss a concurrent toggle, which is benign (atomic dict read under the GIL)
    return _CFG["timing"]


def set_timing(on: bool) -> None:
    with _LOCK:
        _CFG["timing"] = bool(on)


@contextlib.contextmanager
def timing(on: bool = True):
    """Scope device-time measurement: events gain ``device_ms`` / ``mfu``
    / ``achieved_gbps`` (None outside the scope)."""
    with _LOCK:
        prev = _CFG["timing"]
    set_timing(on)
    try:
        yield
    finally:
        set_timing(prev)


def should_time(token) -> bool:
    """Should the annotate wrapper wait for this boundary's result?  Only
    the OUTERMOST frame, timing on, outside a capture: nested boundaries
    would wait twice, and a captured frame holds work that runs at
    replay."""
    # slate-lint: disable=CON001 -- designed lock-free peek on the per-call fast path: one boundary may miss a concurrent toggle, which is benign (atomic dict read under the GIL)
    if token is None or not _CFG["timing"] or token.traced:
        return False
    frames = _frames()
    return bool(frames) and frames[0] is token and not _tracer.capturing()


def note_device_ready(token) -> None:
    """Stamp the boundary's dispatch -> device-ready time (called by the
    annotate wrapper right after the wait)."""
    if token is not None:
        token.device_ms = round((time.perf_counter() - token.t0) * 1e3, 3)


# ---------------------------------------------------------------- describe


def _dtype_name(dt) -> str | None:
    if dt is None:
        return None
    return str(getattr(dt, "name", dt)).removeprefix("torch.")


def _describe(x):
    """Best-effort (shape, dtype) of one driver argument: Matrix-likes
    expose .m/.n, tensors .shape; anything else is skipped."""
    shape = getattr(x, "shape", None)
    if shape is None and hasattr(x, "m") and hasattr(x, "n"):
        shape = (getattr(x, "m"), getattr(x, "n"))
    if shape is None:
        return None
    try:
        shape = tuple(int(s) for s in shape)
    except (TypeError, ValueError):
        return None
    return shape, _dtype_name(getattr(x, "dtype", None))


def _describe_args(args):
    shapes, dtype = [], None
    for a in args:
        d = _describe(a)
        if d is None:
            continue
        shapes.append(list(d[0]))
        if dtype is None:
            dtype = d[1]
    return shapes, dtype


# ---------------------------------------------------------------- boundary


def boundary_enter(op: str, args=()):
    """Open a driver boundary frame (called by util.trace.annotate).

    Returns an opaque token for :func:`boundary_exit`, or None when
    recording is off: the disabled path does nothing beyond a depth
    bump."""
    _TLS.depth = getattr(_TLS, "depth", 0) + 1
    if not _active():
        return None
    shapes, dtype = _describe_args(args)
    frame = _Frame(op, _tracer.capturing(), shapes, dtype)
    _frames().append(frame)
    return frame


def boundary_exit(token, error: BaseException | None = None) -> None:
    """Close a boundary frame; the outermost frame emits its event."""
    depth = getattr(_TLS, "depth", 0)
    if depth > 0:
        _TLS.depth = depth - 1
    if token is None:
        return
    frames = _frames()
    try:
        i = frames.index(token)
    except ValueError:
        return                      # configure() flipped mid-call: drop
    del frames[i:]
    if i == 0:
        _emit(_build(token, error))


def _outer() -> _Frame | None:
    frames = getattr(_TLS, "frames", None)
    return frames[0] if frames else None


def _build(frame: _Frame, error) -> dict:
    notes = frame.notes
    op = frame.op[6:] if frame.op.startswith("slate.") else frame.op
    mfu = gbps = None
    if frame.device_ms:
        secs = frame.device_ms * 1e-3
        mfu = _flops.mfu(_flops.op_flops(op, frame.shapes), secs,
                         frame.dtype)
        gbps = _flops.achieved_gbps(
            _flops.op_bytes(op, frame.shapes, frame.dtype), secs)
    return {
        "schema": SCHEMA,
        "kind": "event",
        "ts": time.time(),
        "op": op,
        "shapes": frame.shapes,
        "dtype": frame.dtype,
        "traced": frame.traced,
        "dur_ms": round((time.perf_counter() - frame.t0) * 1e3, 3),
        "device_ms": frame.device_ms,
        "mfu": mfu,
        "achieved_gbps": gbps,
        "policy": notes.get("policy"),
        "speculate": notes.get("speculate"),
        "abft": notes.get("abft"),
        "path": notes.get("path", "direct"),
        "escalations": notes.get("escalations", 0),
        "health": notes.get("health"),
        "plans": notes.get("plans", []),
        "status": ("ok" if error is None
                   else f"error:{type(error).__name__}"),
    }


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


def emit_checkpoint(kind: str, payload: dict) -> None:
    """One record per checkpoint save or verified restore (kinds
    ``checkpoint_save`` / ``checkpoint_restore``): the op, the panel-step
    index ``step``, payload ``bytes``, the ``verify`` result ("ok" or the
    typed refusal reason) and ``wall_ms``, the inputs of the metrics CLI's
    durability table.  robust/checkpoint.py is its caller."""
    _emit_kind(kind, payload)


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


# ------------------------------------------------------------------- notes
#
# All note_* calls attach to the OUTERMOST open frame of this thread (the
# one that will emit) and are no-ops when none is open, so the seams call
# them unconditionally at no cost while recording is off.


def note_health(name: str, h, policy: str) -> None:
    """Called by health.finalize with the boundary's resolved policy and
    HealthInfo (plain Python values: the drivers read their health once,
    and this reads nothing from the device).  A health that holds tensors
    is recorded as None, as the reference records traced health.  Last
    write wins: the boundary's own (merged) finalize is the one the event
    reports."""
    frame = _outer()
    if frame is None:
        return
    frame.notes["policy"] = policy
    if h is None or not all(isinstance(v, (bool, int, float)) for v in h):
        frame.notes["health"] = None
        return
    site = int(h.abft_site)
    frame.notes["health"] = {
        "ok": bool(h.ok),
        "info": int(h.info),
        "nonfinite": bool(h.nonfinite),
        "min_pivot": float(h.min_pivot),
        "min_pivot_index": int(h.min_pivot_index),
        "growth": float(h.growth),
        "iters": int(h.iters),
        "converged": bool(h.converged),
        "abft_detected": int(h.abft_detected),
        "abft_corrected": int(h.abft_corrected),
        "abft_site": ([site >> 16, site & 0xffff] if site >= 0 else None),
    }


def note_resolved(knob: str, value) -> None:
    """Called by options.resolve_speculate / resolve_abft: record the
    once-per-boundary resolution ('speculate' / 'abft')."""
    frame = _outer()
    if frame is not None:
        frame.notes.setdefault(knob, bool(value))


def note_path(first: str, rungs, used: int, speculated: bool) -> None:
    """Called by the recovery boundaries: which attempt produced the
    result.  ``first`` names the primary attempt, ``rungs`` the fallback
    ladder in order, ``used`` how many rungs bounded_retry consumed."""
    frame = _outer()
    if frame is None:
        return
    rungs = list(rungs)
    if used <= 0 or used > len(rungs):
        kind = "speculated" if speculated else "direct"
        frame.notes["path"] = f"{kind}:{first}"
    else:
        frame.notes["path"] = f"escalated:{rungs[used - 1]}"
    frame.notes["escalations"] = min(max(used, 0), len(rungs))


def note_plan(op: str, n: int, dtype: str, kernel: str, nb: int,
              source: str, dist: float | None) -> None:
    """Called by tune.resolve_plan: one dispatch decision.  A driver
    resolves plans per panel, so identical decisions dedupe and the list
    is capped at _MAX_PLANS_PER_EVENT."""
    frame = _outer()
    if frame is None:
        return
    key = (op, n, dtype, kernel, nb, source)
    if key in frame.plans_seen:
        return
    frame.plans_seen.add(key)
    plans = frame.notes.setdefault("plans", [])
    if len(plans) >= _MAX_PLANS_PER_EVENT:
        return
    plans.append({"op": op, "n": int(n), "dtype": dtype, "kernel": kernel,
                  "nb": int(nb), "source": source,
                  "dist": (None if dist is None else round(float(dist), 3))})


def _init_from_env() -> None:
    path = os.environ.get("SLATE_OBS_EVENTS")
    if path:
        configure(enabled=True, path=path)
    if os.environ.get("SLATE_OBS_TIMING", "").lower() in ("1", "true",
                                                          "on", "yes"):
        set_timing(True)


_init_from_env()
