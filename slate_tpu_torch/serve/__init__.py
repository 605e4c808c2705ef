"""slate_tpu_torch.serve: shape-bucketed ragged-batch solver serving on one
device (port of slate_tpu/serve/).

Streams of mixed-size ``solve`` / ``chol_solve`` / ``least_squares_solve``
requests run as shape-bucketed batches, with

- a bucket ladder (geometric) and exact identity-augmentation packing
  (:mod:`bucket`),
- batched cores with per-problem escalation and per-problem
  ``HealthInfo``: the ragged route through the batched kernels K6-K8 and
  the per-problem route through the single-problem drivers, plus the
  certified bf16 rung (:mod:`batched`),
- a keyed cache of batch callables that captures each bucket's ragged
  device parts as CUDA graphs on the card and replays them for every
  batch (:mod:`cache`, the counterpart of the reference's compiled
  executables),
- deadline-aware admission control with SLO backpressure and typed
  overflow policies (:mod:`admission`),
- a ``Server`` front end with poison retry and quarantine, a background
  flush loop with its watchdog (``start``/``shutdown``), online ladder
  retune and one obs event per batch, shed, quarantine, device
  transition and retune (:mod:`server`),
- an elastic :class:`DevicePool` that round-robins batches over its
  members, fails the SAME packed batch over to a survivor when a member
  dies (no lost tickets, bit-identical results), quarantines sick
  members and readmits them after a clean canary probe (:mod:`pool`).
"""

from .admission import (OVERFLOW_POLICIES, AdmissionConfig, AdmissionQueue,
                        SlateServeError, SlateServeOverloadError,
                        SlateServeTimeoutError, Ticket)
from .batched import (CORES, SERVE_DTYPES, chol_solve_core,
                      least_squares_core, make_batched, solve_core)
from .bucket import (BucketLadder, default_ladder, geometric_ladder,
                     least_squares_buckets, next_pow2, pad_rows, pad_square,
                     pad_tall, padded_fraction, solve_buckets)
from .cache import ExecutableCache, default_cache, options_fingerprint
from .pool import DevicePool, PoolConfig, PoolMember
from .server import SERVE_OPS, Request, Result, Server

__all__ = [
    "AdmissionConfig", "AdmissionQueue", "BucketLadder", "CORES",
    "DevicePool", "ExecutableCache", "OVERFLOW_POLICIES", "PoolConfig",
    "PoolMember", "Request", "Result",
    "SERVE_DTYPES", "SERVE_OPS", "Server", "SlateServeError",
    "SlateServeOverloadError", "SlateServeTimeoutError", "Ticket",
    "chol_solve_core", "default_cache", "default_ladder", "geometric_ladder",
    "least_squares_buckets", "least_squares_core", "make_batched",
    "next_pow2", "options_fingerprint", "pad_rows", "pad_square", "pad_tall",
    "padded_fraction", "solve_buckets", "solve_core",
]
