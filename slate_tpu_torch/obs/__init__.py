"""slate_tpu_torch.obs: the observability spine (port of slate_tpu/obs).

All of it host-side, with no cost while it is off:

- structured events (:mod:`events`): one JSON record per public driver
  call (op, shapes, resolved policy/speculate/abft, path taken, health
  counters, resolved plans, wall duration) and per serving batch, shed,
  quarantine, pool transition and retune;
- a recording span tracer (:mod:`tracer`): ``util.trace.span`` wall
  times exported as Chrome/Perfetto trace JSON or JSONL;
- a capture sentinel (:mod:`sentinel`): per-key CUDA-graph capture
  counters with rate-limited warnings on churn;
- metrics aggregation (:mod:`metrics`) behind the
  ``python -m slate_tpu_torch.obs`` CLI;
- device-time truth (:mod:`flops`): one analytic flop/byte model per
  public op feeding ``device_ms``/``mfu``/``achieved_gbps`` on events
  under the opt-in :func:`timing` mode;
- serving SLOs (:mod:`slo`) over the flight-recorder fields, and a
  bench-round regression sentinel (:mod:`compare`) behind
  ``--slo`` / ``--compare``.

Turning any of it on changes nothing a driver computes: the same kernel
launches, the same bits, and with timing off no added synchronization.
"""

from . import compare, flops, slo
from .events import (SCHEMA, boundary_enter, boundary_exit, clear,
                     configure, disable, emit_checkpoint, emit_serve_batch,
                     emit_serve_device, emit_serve_quarantine,
                     emit_serve_retune, emit_serve_shed, enable, enabled,
                     note_health, note_path, note_plan, note_resolved,
                     recent, recording, set_timing, timing, timing_enabled)
from .metrics import render, summarize
from .sentinel import SlateRetraceWarning
from .sentinel import reset as reset_sentinel
from .sentinel import stats as sentinel_stats
from .tracer import SpanRecorder, record_spans

__all__ = [
    "SCHEMA", "SlateRetraceWarning", "SpanRecorder", "boundary_enter",
    "boundary_exit", "clear", "compare", "configure", "disable",
    "emit_checkpoint", "emit_serve_batch", "emit_serve_device",
    "emit_serve_quarantine", "emit_serve_retune", "emit_serve_shed",
    "enable", "enabled", "flops", "note_health", "note_path", "note_plan",
    "note_resolved", "recent", "record_spans", "recording", "render",
    "reset_sentinel", "sentinel_stats", "set_timing", "slo", "summarize",
    "timing", "timing_enabled",
]
