"""Tracing: every driver and phase opens a named block (port of
slate_tpu/util/trace.py).

:func:`span` names a block twice: as a ``torch.profiler.record_function``
range, so that in a ``torch.profiler`` trace the kernels a driver launches
nest under its name (``slate.posv``), and, inside ``obs.record_spans()``,
as a recorded span with its host wall time.  The profiler range is opened
only while a profiler is on: it costs a dispatcher call each time.

:func:`annotate` wraps a public driver: a span under the driver's name and
the boundary of the structured-event layer (obs/events.py), one event per
outermost call, fed by the health, recovery and tune seams.  Both layers
are host-side only: with them on or off a driver makes the same launches
and returns the same bits.

Capture a profile the standard torch way::

    with torch.profiler.profile() as prof:
        st.posv(A, B)
    prof.export_chrome_trace("posv.json")   # kernels under slate.posv
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..obs import events as _events
from ..obs import tracer as _tracer


@contextlib.contextmanager
def span(name: str):
    """Named block around a driver or phase (the reference's trace::Block).
    Records its wall time when an obs.record_spans() recorder is active on
    this thread."""
    rec = _tracer.active()
    tok = rec.enter(name) if rec is not None else None
    try:
        if torch.autograd._profiler_enabled():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if rec is not None:
            rec.exit(tok)


def _ready(out) -> None:
    """Wait for the current stream of every CUDA device ``out`` holds (a
    stream sync, not a device one, so that a capture on another thread's
    stream is not disturbed)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif hasattr(x, "storage") and hasattr(x.storage, "data"):
            visit(x.storage.data)          # a Matrix
    visit(out)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def annotate(name: str):
    """Decorator form of :func:`span` for whole drivers, and the
    structured-event boundary: one obs event per outermost call.

    Under ``obs.timing()`` the outermost boundary that is not inside a
    CUDA-graph capture waits until its result is ready on the device
    before it closes, so its event carries a dispatch-to-ready
    ``device_ms`` (and the mfu and achieved_gbps derived from it).  It
    never waits during a capture (``should_time`` refuses those frames),
    and with timing off it never waits."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tok = _events.boundary_enter(name, args)
            try:
                with span(name):
                    out = fn(*args, **kwargs)
                if _events.should_time(tok):
                    _ready(out)
                    _events.note_device_ready(tok)
            except BaseException as e:
                _events.boundary_exit(tok, error=e)
                raise
            _events.boundary_exit(tok)
            return out
        return wrapper
    return deco
