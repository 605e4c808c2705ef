"""Tile plans: the persisted plan cache and the one resolver every dispatch
seam consults (port of slate_tpu/tune/plans.py).

The seams: ``potrf_tile`` (K1) and ``potrf_panel`` (K2) of the Cholesky
slice, ``getrf_panel`` (K3) and ``lu_select`` (K4) of the LU slice,
``geqrf_panel`` (K5) of the QR slice, and the serving slice's batch ops
``batch_potrf`` (K6), ``batch_getrf`` (K7) and ``batch_geqrf`` (K8),
keyed by the bucket size.  Each asks :func:`resolve_plan` which kernel
takes a problem of size ``n``: ``"cuda"``, the hand-written kernel, or
``"torch"``, PyTorch's library route (for ``geqrf_panel``
``householder_panel_blocked``, for a batch op the per-problem route of
serve/batched.py, the counterpart of the reference's vmapped cores).  The
plain PyTorch version of a kernel is not a plan: a kernel wrapper takes
it only for tensors on the CPU.

The answer comes from a small JSON cache of measured winners per (op, n,
dtype, chip), written by ``slate_tpu_torch.tune.autotune`` (``python -m
slate_tpu_torch.tune``): an exact size hit, else the nearest tuned size
by |log2(n / n')| in the same dtype (on a tie the first key in the file's
order, which ``save_cache`` sorts: "n=1024" before "n=256").  A miss
keeps the port's departure from the reference, whose default is its
library route (XLA): the hand kernel (``CUDA_PLAN``) for float32, and for
bfloat16 on the batch ops (K6-K8 take bf16 storage), the library
(``LIBRARY_PLAN``) otherwise.  A library default would take every hand
kernel off the main path.  ``plan_override`` forces a plan (tests, the
library yardsticks).  Each resolution is noted into the open obs event
frame with its source: ``override``, ``exact``, ``nearest`` or
``default``.

The cache is the port's own file: ``$SLATE_TORCH_TUNE_CACHE``, else
``~/.cache/slate_tpu_torch/plans.json``.  It does not share the
reference's (``$SLATE_TUNE_CACHE``, ``~/.cache/slate_tpu/plans.json``):
each package's schema accepts only its own kernel names, so either would
reject the other's entries and with them the whole file.  A bad file warns
and falls back to the defaults.

Cache schema (version 1)::

    {"version": 1,
     "chips": {"<chip-kind>": {"<op>": {"n=512,dtype=float32":
         {"kernel": "cuda", "nb": 128, "bw": 8, "gflops": 123.4}}}}}

A resolution runs for every panel (160 in a posv at n = 20480, ~470 K4
rounds in a CALU gesv), so it is one dict hit per (op, n, dtype, cache
path), memoized until :func:`reload`; the chip key is the kind of the
device current at the first miss.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import threading
import warnings
from typing import NamedTuple

from ..obs import events as _obs

SCHEMA_VERSION = 1
OPS = ("potrf_tile", "potrf_panel", "getrf_panel", "lu_select",
       "geqrf_panel", "batch_potrf", "batch_getrf", "batch_geqrf")
BATCH_OPS = ("batch_potrf", "batch_getrf", "batch_geqrf")
# Pseudo-ops, schema-accepted but kept out of OPS so the kernel sweeps
# never measure them: ``dist_lookahead`` (the distributed kernels'
# pipeline depth, read by lookahead_depth), ``serve_bucket`` (one serving
# ladder rung an entry, read by serve_buckets) and ``ooc_panel`` (the
# out-of-core drivers' streaming panel width, read by ooc_panel_width).
DIST_LOOKAHEAD_OP = "dist_lookahead"
SERVE_BUCKET_OP = "serve_bucket"
OOC_PANEL_OP = "ooc_panel"
ALL_OPS = OPS + (DIST_LOOKAHEAD_OP, SERVE_BUCKET_OP, OOC_PANEL_OP)
# "ring" names the pipelined route of the dist_lookahead pseudo-op only
KERNELS = ("cuda", "torch", "ring")


class TilePlan(NamedTuple):
    """One dispatch decision: ``kernel`` "cuda" (the hand-written kernel)
    or "torch" (PyTorch's library route); the slab width ``bw`` of the
    kernel's column loop (the Cholesky and no-pivot LU tile factors, the
    pivot selection and the Householder panel's column slabs), which the
    plain version and the CUDA kernel both honour; and ``nb``, the tile
    width the tuner measured the plan at (advisory: drivers tile by the
    matrix's ``nb``).  The reference's field order is (kernel, nb, bw);
    ``nb`` comes last here so that ``TilePlan("cuda", 16)`` names a slab
    width, as it always has in the port."""
    kernel: str = "cuda"
    bw: int = 8
    nb: int = 128


CUDA_PLAN = TilePlan()
LIBRARY_PLAN = TilePlan(kernel="torch")
# the reference's name for its no-cache plan (plans.py:82): the port's
# default, the hand kernel
XLA_PLAN = CUDA_PLAN

_LOCK = threading.Lock()
_CACHE: dict | None = None          # lazily loaded, keyed by cache_path()
_CACHE_KEY: str | None = None
_MEMO: dict = {}                    # (op, n, dtype, path) -> resolution
_OVERRIDES: dict[str, TilePlan] = {}


@functools.lru_cache(maxsize=1)
def _default_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "slate_tpu_torch", "plans.json")


def cache_path() -> str:
    """Plan-cache location: $SLATE_TORCH_TUNE_CACHE, else
    ~/.cache/slate_tpu_torch/plans.json."""
    return os.environ.get("SLATE_TORCH_TUNE_CACHE") or _default_path()


def _empty() -> dict:
    return {"version": SCHEMA_VERSION, "chips": {}}


def _normalize(dtype) -> str:
    from ..robust.precision import normalize_dtype
    return normalize_dtype(dtype)


def plan_key(n: int, dtype) -> str:
    """Cache entry key; dtype spellings normalize through
    robust/precision.normalize_dtype, so "bf16" and "bfloat16" land on the
    same entry and a misspelled dtype raises."""
    return f"n={int(n)},dtype={_normalize(dtype)}"


def _parse_key(key: str) -> tuple[int, str]:
    n_part, dt_part = key.split(",", 1)
    if not (n_part.startswith("n=") and dt_part.startswith("dtype=")):
        raise ValueError(f"plan cache: bad entry key {key!r}")
    return int(n_part[2:]), dt_part[6:]


def validate_cache(obj) -> None:
    """Raise ValueError unless ``obj`` matches the version-1 schema."""
    if not isinstance(obj, dict):
        raise ValueError("plan cache: top level must be an object")
    if obj.get("version") != SCHEMA_VERSION:
        raise ValueError(
            f"plan cache: version must be {SCHEMA_VERSION}, "
            f"got {obj.get('version')!r}")
    chips = obj.get("chips")
    if not isinstance(chips, dict):
        raise ValueError("plan cache: 'chips' must be an object")
    if set(obj) - {"version", "chips"}:
        raise ValueError("plan cache: unknown top-level keys "
                         f"{sorted(set(obj) - {'version', 'chips'})}")
    for chip, ops in chips.items():
        if not isinstance(ops, dict):
            raise ValueError(f"plan cache: chip {chip!r} must map ops")
        for op, entries in ops.items():
            if op not in ALL_OPS:
                raise ValueError(f"plan cache: unknown op {op!r} "
                                 f"(known: {ALL_OPS})")
            if not isinstance(entries, dict):
                raise ValueError(f"plan cache: {chip}/{op} must be an "
                                 "object")
            for key, ent in entries.items():
                _parse_key(key)
                if not isinstance(ent, dict):
                    raise ValueError(
                        f"plan cache: {chip}/{op}/{key} must be an object")
                if ent.get("kernel") not in KERNELS:
                    raise ValueError(
                        f"plan cache: {chip}/{op}/{key} kernel must be one "
                        f"of {KERNELS}, got {ent.get('kernel')!r}")
                for field in ("nb", "bw"):
                    v = ent.get(field)
                    if not isinstance(v, int) or v <= 0:
                        raise ValueError(
                            f"plan cache: {chip}/{op}/{key} '{field}' must "
                            f"be a positive int, got {v!r}")
                g = ent.get("gflops")
                if g is not None and not isinstance(g, (int, float)):
                    raise ValueError(
                        f"plan cache: {chip}/{op}/{key} 'gflops' must be "
                        f"a number, got {g!r}")


@functools.lru_cache(maxsize=None)
def _device_kind(index: int) -> str:
    import torch
    return torch.cuda.get_device_name(index).strip().lower().replace(
        " ", "-")


def chip_kind(device=None) -> str:
    """Cache key for a card: its name, lower case, spaces to '-' (e.g.
    'nvidia-h100-80gb-hbm3'), computed once per device; 'cpu' without a
    GPU.  ``device`` defaults to the current CUDA device."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    index = (device.index if device is not None and device.index is not None
             else torch.cuda.current_device())
    return _device_kind(index)


def load_cache(path: str | None = None) -> dict:
    """Read and validate the plan cache; a missing file is an empty
    cache."""
    path = path or cache_path()
    if not os.path.exists(path):
        return _empty()
    with open(path, encoding="utf-8") as fh:
        obj = json.load(fh)
    validate_cache(obj)
    return obj


def save_cache(obj: dict, path: str | None = None) -> str:
    """Validate and atomically persist the plan cache (keys sorted);
    returns the path."""
    validate_cache(obj)
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    reload()
    return path


def reload() -> None:
    """Drop the in-memory cache and the memoized resolutions (the next
    resolve_plan re-reads the disk)."""
    global _CACHE, _CACHE_KEY
    with _LOCK:
        _CACHE = None
        _CACHE_KEY = None
        _MEMO.clear()


def _cached(path: str) -> dict:
    global _CACHE, _CACHE_KEY
    with _LOCK:
        if _CACHE is None or _CACHE_KEY != path:
            try:
                _CACHE = load_cache(path)
            except (ValueError, OSError) as e:
                warnings.warn(f"slate_tpu_torch.tune: ignoring bad plan "
                              f"cache at {path}: {e}", stacklevel=4)
                _CACHE = _empty()
            _CACHE_KEY = path
        return _CACHE


def record_plan(op: str, n: int, dtype, plan: TilePlan,
                gflops: float | None = None, chip: str | None = None,
                path: str | None = None) -> str:
    """Persist one winning plan (the tuner and tests only: the seams
    resolve through resolve_plan)."""
    if op not in ALL_OPS:
        raise ValueError(f"unknown op {op!r} (known: {ALL_OPS})")
    obj = load_cache(path)
    ent = {"kernel": plan.kernel, "nb": int(plan.nb), "bw": int(plan.bw)}
    if gflops is not None:
        ent["gflops"] = float(gflops)
    chip = chip or chip_kind()
    obj.setdefault("chips", {}).setdefault(chip, {}).setdefault(
        op, {})[plan_key(n, dtype)] = ent
    return save_cache(obj, path)


@contextlib.contextmanager
def plan_override(op: str, plan: TilePlan):
    """Force ``resolve_plan(op, ...)`` to return ``plan`` inside the
    block."""
    if op not in ALL_OPS:
        raise ValueError(f"unknown op {op!r} (known: {ALL_OPS})")
    if plan.kernel not in KERNELS or plan.bw < 1 or plan.nb < 1:
        raise ValueError(f"bad plan {plan!r} (kernels: {KERNELS}, "
                         "bw, nb >= 1)")
    prev = _OVERRIDES.get(op)
    _OVERRIDES[op] = plan
    try:
        yield
    finally:
        if prev is None:
            _OVERRIDES.pop(op, None)
        else:
            _OVERRIDES[op] = prev


def _lookup(op: str, n: int, dtype: str, path: str | None = None):
    """Nearest tuned plan by |log2(n/n')|, same dtype only, the first key
    in the file's order on a tie.  Returns ``(TilePlan, dist)`` (dist 0.0
    is an exact size hit) or None."""
    entries = _cached(path or cache_path()).get("chips", {}).get(
        chip_kind(), {}).get(op)
    if not entries:
        return None
    best_key, best_dist = None, None
    for key in entries:
        kn, kdt = _parse_key(key)
        if kdt != dtype:
            continue
        dist = abs(math.log2(max(n, 1) / max(kn, 1)))
        if best_dist is None or dist < best_dist:
            best_key, best_dist = key, dist
    if best_key is None:
        return None
    ent = entries[best_key]
    return (TilePlan(ent["kernel"], int(ent["bw"]), int(ent["nb"])),
            best_dist)


def default_plan(op: str, dtype: str) -> TilePlan:
    """The plan of a cache miss: the hand kernel for float32 (and for
    bfloat16 on a batch op), the library otherwise."""
    if dtype == "float32" or (dtype == "bfloat16" and op in BATCH_OPS):
        return CUDA_PLAN
    return LIBRARY_PLAN


def _resolve(op: str, n: int, dtype) -> tuple:
    """(plan, source, dist, dtype name) of one resolution, memoized."""
    path = cache_path()
    key = (op, n, dtype, path)
    # slate-lint: disable=CON001 -- designed lock-free memo peek on every plan resolution: a dict get is atomic under the GIL, and a miss (or a stale miss after reload) only resolves again and stores under the lock
    hit = _MEMO.get(key)
    if hit is not None:
        return hit
    if op not in OPS and op not in (DIST_LOOKAHEAD_OP, OOC_PANEL_OP):
        raise ValueError(
            f"unknown op {op!r} "
            f"(known: {OPS + (DIST_LOOKAHEAD_OP, OOC_PANEL_OP)})")
    name = _normalize(dtype)
    found = _lookup(op, int(n), name, path)
    if found is None:
        hit = (default_plan(op, name), "default", None, name)
    else:
        plan, dist = found
        hit = (plan, "exact" if dist == 0.0 else "nearest", dist, name)
    with _LOCK:
        _MEMO[key] = hit
    return hit


def resolve_plan(op: str, n: int, dtype="float32") -> TilePlan:
    """The one plan entry point of the dispatch seams: the plan for ``op``
    at problem size ``n`` (a bucket edge for the batch ops), an override
    when one is active, else the cache's exact or nearest entry for this
    chip, else the default (:func:`default_plan`).  Each resolution is
    noted into the open obs event frame with its source and distance."""
    ov = _OVERRIDES.get(op)
    if ov is not None:
        _obs.note_plan(op, int(n), _normalize(dtype), ov.kernel, ov.nb,
                       "override", None)
        return ov
    plan, source, dist, name = _resolve(op, n, dtype)
    _obs.note_plan(op, int(n), name, plan.kernel, plan.nb, source, dist)
    return plan


def resolution(op: str, n: int, dtype="float32") -> dict:
    """How ``resolve_plan(op, n, dtype)`` resolves, as the event's plan
    record shows it (kernel, bw, nb, source, dist), without noting it."""
    ov = _OVERRIDES.get(op)
    if ov is not None:
        plan, source, dist = ov, "override", None
    else:
        plan, source, dist, _ = _resolve(op, n, dtype)
    return {"kernel": plan.kernel, "bw": plan.bw, "nb": plan.nb,
            "source": source, "dist": dist}


def lookahead_depth(n: int, dtype="float32") -> int:
    """Tuned comm/compute lookahead depth of the distributed kernels
    (parallel/summa.py and parallel/dist_chol.py): 0, the
    bulk-synchronous route, unless a
    ``dist_lookahead`` entry names the "ring" pipeline, whose ``bw`` is
    the depth, clamped to 1..2."""
    plan = resolve_plan(DIST_LOOKAHEAD_OP, n, dtype)
    if plan.kernel != "ring":
        return 0
    return max(1, min(2, int(plan.bw)))


def ooc_panel_width(n: int, dtype="float32", default: int = 256) -> int:
    """Tuned out-of-core panel width of the streaming drivers (ROADMAP.md
    queue 1, item 13): a tuned ``ooc_panel`` entry's ``nb``, else
    ``default``, clamped to n."""
    plan = resolve_plan(OOC_PANEL_OP, n, dtype)
    tuned = resolution(OOC_PANEL_OP, n, dtype)["source"] != "default"
    width = plan.nb if tuned else default
    return max(1, min(int(width), int(n)))


def serve_buckets(dtype="float32") -> tuple[int, ...] | None:
    """Tuned serving bucket ladder for this card, or None when untuned:
    each ``serve_bucket`` entry (``record_plan`` with op
    ``SERVE_BUCKET_OP``, ``n`` the rung; kernel, nb and bw ignored) is one
    rung; the tuple is sorted ascending.  serve.bucket.default_ladder
    reads it."""
    dtype = _normalize(dtype)
    entries = _cached(cache_path()).get("chips", {}).get(
        chip_kind(), {}).get(SERVE_BUCKET_OP)
    if not entries:
        return None
    rungs = sorted({n for n, dt in map(_parse_key, entries)
                    if dt == dtype})
    return tuple(rungs) or None
