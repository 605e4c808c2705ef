"""Tile plans: which kernel a dispatch seam takes (a minimal port of
slate_tpu/tune/plans.py).

The seams: ``potrf_tile`` (K1) and ``potrf_panel`` (K2) of the Cholesky
slice, ``getrf_panel`` (K3) and ``lu_select`` (K4) of the LU slice,
``geqrf_panel`` (K5) of the QR slice, and the serving slice's batch ops
``batch_potrf`` (K6), ``batch_getrf`` (K7) and ``batch_geqrf`` (K8),
keyed by the bucket size.  The reference keeps an autotuned plan cache
and defaults to XLA where no plan was tuned.  The port has no cache yet:
every f32 problem inside a seam's gate defaults to the hand-written CUDA
kernel (``CUDA_PLAN``), the batch ops for bf16 storage too (K6-K8 take
it), and ``plan_override`` forces the library route (``LIBRARY_PLAN``;
for ``geqrf_panel`` that is ``householder_panel_blocked``, for a batch op
the per-problem route of serve/batched.py, the counterpart of the
reference's vmapped cores) or another slab width ``bw``.  The plain
PyTorch version of a kernel is not a plan: a kernel wrapper takes it only
for tensors on the CPU.  With no cache there are no tuned serving
ladders either: :func:`serve_buckets` is always None.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

OPS = ("potrf_tile", "potrf_panel", "getrf_panel", "lu_select",
       "geqrf_panel", "batch_potrf", "batch_getrf", "batch_geqrf")
BATCH_OPS = ("batch_potrf", "batch_getrf", "batch_geqrf")
# the batch panels' width: min(BATCH_NB, bucket), which on the geometric
# ladder's rungs 32 * 2^k is always one of K6's and K7's widths
BATCH_NB = 128
KERNELS = ("cuda", "torch")


class TilePlan(NamedTuple):
    """One dispatch decision: ``kernel`` "cuda" (the hand-written kernel)
    or "torch" (PyTorch's library call), and the slab width ``bw`` of the
    kernel's column loop (the Cholesky and no-pivot LU tile factors, the
    pivot selection, and the Householder panel's column slabs), which the
    plain version and the CUDA kernel both honour.  (The reference's plan also names a tile width; the port tiles
    by the matrix's ``nb`` alone, so it has none.)"""
    kernel: str = "cuda"
    bw: int = 8


CUDA_PLAN = TilePlan()
LIBRARY_PLAN = TilePlan(kernel="torch")

_OVERRIDES: dict[str, TilePlan] = {}


def resolve_plan(op: str, n: int, dtype: str = "float32") -> TilePlan:
    """The plan for ``op`` at problem size ``n`` (a bucket edge for the
    batch ops): an override when one is active, else the hand kernel for
    float32 (and for bfloat16 on a batch op) and the library otherwise."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (known: {OPS})")
    ov = _OVERRIDES.get(op)
    if ov is not None:
        return ov
    if dtype == "float32" or (dtype == "bfloat16" and op in BATCH_OPS):
        return CUDA_PLAN
    return LIBRARY_PLAN


def serve_buckets(dtype: str = "float32") -> tuple[int, ...] | None:
    """Tuned serving bucket rungs for this card, or None when untuned: the
    port keeps no plan cache, so it is always None and the serving ladder
    is the geometric one."""
    return None


@contextlib.contextmanager
def plan_override(op: str, plan: TilePlan):
    """Force ``resolve_plan(op, ...)`` to return ``plan`` inside the block."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (known: {OPS})")
    if plan.kernel not in KERNELS or plan.bw < 1:
        raise ValueError(f"bad plan {plan!r} (kernels: {KERNELS}, bw >= 1)")
    prev = _OVERRIDES.get(op)
    _OVERRIDES[op] = plan
    try:
        yield
    finally:
        if prev is None:
            _OVERRIDES.pop(op, None)
        else:
            _OVERRIDES[op] = prev
