"""Recording span tracer: util.trace.span() with wall times kept (port of
slate_tpu/obs/tracer.py).

Every ``util.trace.span`` (and so every ``@annotate``d driver) opened on a
thread inside a :func:`record_spans` scope keeps its host-side enter and
exit times, exported as

- Chrome/Perfetto trace JSON (``chrome://tracing`` / ui.perfetto.dev), or
- one span a line of ``slate-obs-v1`` JSONL for ad-hoc analysis.

A span recorded while the current stream is capturing a CUDA graph (the
port's counterpart of the reference's staging of a jaxpr) measures capture
time, not execution: the span body enqueued work into a graph that runs at
each replay.  It is flagged ``"traced": true``, the reference's name.

No cost when no recorder is active: util.trace.span does one thread-local
attribute read.
"""

from __future__ import annotations

import json
import threading
import time

import torch

_TLS = threading.local()


def active():
    """The innermost active SpanRecorder on this thread, or None."""
    stack = getattr(_TLS, "recorders", None)
    return stack[-1] if stack else None


def capturing() -> bool:
    """Is this thread's current CUDA stream capturing a graph?"""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class SpanRecorder:
    """Collects completed spans as dicts (name, ts_ms, dur_ms, depth,
    traced, tid)."""

    def __init__(self):
        self.spans: list[dict] = []
        self._t0 = time.perf_counter()
        self._depth = 0

    # -- called by util.trace.span -------------------------------------
    def enter(self, name: str):
        self._depth += 1
        return (name, time.perf_counter(), self._depth, capturing())

    def exit(self, token) -> None:
        name, t0, depth, traced = token
        now = time.perf_counter()
        self._depth = depth - 1
        self.spans.append({
            "name": name,
            "ts_ms": round((t0 - self._t0) * 1e3, 3),
            "dur_ms": round((now - t0) * 1e3, 3),
            "depth": depth,
            "traced": traced,
            "tid": threading.get_ident(),
        })

    # -- exports --------------------------------------------------------
    def export_chrome_trace(self, path: str) -> None:
        """Write Chrome trace-event JSON (complete 'X' events, µs)."""
        events = [{
            "name": s["name"],
            "ph": "X",
            "ts": round(s["ts_ms"] * 1e3, 1),
            "dur": round(s["dur_ms"] * 1e3, 1),
            "pid": 0,
            "tid": s["tid"],
            "args": {"depth": s["depth"], "traced": s["traced"]},
        } for s in self.spans]
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, fh)
            fh.write("\n")

    def export_jsonl(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            for s in self.spans:
                fh.write(json.dumps({"schema": "slate-obs-v1",
                                     "kind": "span", **s}) + "\n")


class record_spans:
    """Context manager activating a SpanRecorder on this thread::

        with obs.record_spans() as rec:
            st.posv(A, B)
        rec.export_chrome_trace("slate-trace.json")

    Nests: the innermost recorder captures; outer recorders resume when
    it exits."""

    def __enter__(self) -> SpanRecorder:
        stack = getattr(_TLS, "recorders", None)
        if stack is None:
            stack = _TLS.recorders = []
        self._rec = SpanRecorder()
        stack.append(self._rec)
        return self._rec

    def __exit__(self, *exc) -> None:
        stack = _TLS.recorders
        if self._rec in stack:
            stack.remove(self._rec)
