"""Tile plans: which kernel a dispatch seam takes (a minimal port of
slate_tpu/tune/plans.py).

The seams: ``potrf_tile`` (K1) and ``potrf_panel`` (K2) of the Cholesky
slice, ``getrf_panel`` (K3) and ``lu_select`` (K4) of the LU slice, and
``geqrf_panel`` (K5) of the QR slice.  The reference keeps an autotuned
plan cache and defaults to XLA where no plan was tuned.  The port has no
cache yet: every f32 problem inside a seam's gate defaults to the
hand-written CUDA kernel (``CUDA_PLAN``), and ``plan_override`` forces
the library route (``LIBRARY_PLAN``; for ``geqrf_panel`` that is
``householder_panel_blocked``) or another slab width ``bw``.  The plain
PyTorch version of a kernel is not a plan: a kernel wrapper takes it only
for tensors on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

OPS = ("potrf_tile", "potrf_panel", "getrf_panel", "lu_select",
       "geqrf_panel")
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
    """The plan for ``op`` at problem size ``n``: an override when one is
    active, else the hand kernel for float32 and the library otherwise."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r} (known: {OPS})")
    ov = _OVERRIDES.get(op)
    if ov is not None:
        return ov
    return CUDA_PLAN if dtype == "float32" else LIBRARY_PLAN


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
