"""Deterministic, seeded fault injection at named driver sites (port of
slate_tpu/robust/faults.py).

A single corrupted tile in a factorization propagates into a
finite-but-wrong solution unless detection is explicit.  This module makes
those faults reproducible on the CPU and on the card, so that the
detection and recovery paths (robust/abft.py, robust/recovery.py) are
testable.

Sites are eager gates: :func:`maybe_corrupt` returns its input untouched
unless a plan for that site is active via the :func:`inject` context
manager.  The ported drivers carry the sites ``input``, ``post_panel``,
``solve`` and ``post_rbt``; the other names are kept so that a plan valid
in the reference is valid here (their sites come with the slices that
port the spectral and distributed drivers).

Payloads: ``nan``, ``inf``, and ``bitflip`` -- a high-exponent-bit flip
(value scaled by 2^100), the silent-data-corruption payload that stays
FINITE and is only caught by pivot-growth / residual / checksum checks.

Strike positions are drawn with host numpy exactly as the reference draws
them (``np.random.default_rng(seed).choice(size, count, replace=False)``),
so the same plan strikes the same elements in both packages.

Plans are PERSISTENT by default: the corruption re-fires every time the
site is reached while the plan is active (a stuck-at fault).  Pass
``transient=True`` for single-shot semantics: the strike fires at most
once per :func:`inject` activation, at the first call of the site, so a
recovery retry sees clean data on its second attempt.  (The reference
decides this when its traced program runs, through an ordered host
callback; the port runs eagerly and decides it at the call.)

Strikes can be confined to one tile with ``FaultPlan(tile=(i, j),
nb=...)``: for 4D tile arrays ``[.., .., mb, nb]`` the strike lands inside
``x[i, j]``; for 3D stacks ``[T, mb, nb]`` inside ``x[i]``; for 2D arrays
inside the ``nb x nb`` block at block-row ``i``, block-column ``j``
(``nb`` required).  A tile index outside the array is a miss (no-op).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

SITES = ("input", "post_panel", "post_collective", "solve",
         "post_stage1", "post_chase", "post_secular", "post_backtransform",
         "post_rbt")
#: HOST-side serving-layer chaos sites (docs/SERVING.md "Survival"):
#: consumed via :func:`host_fire` by serve/server.py and serve/cache.py,
#: plain host code, never a device computation --
#:
#: ``serve_flush_delay``    the flush loop sleeps ``delay_s`` before
#:                          executing (ages the batch: deadline sheds
#:                          and watermark behavior become testable)
#: ``serve_compile_stall``  the executable cache sleeps ``delay_s``
#:                          before compiling a miss (a stuck compile:
#:                          what the serving watchdog must catch)
#: ``serve_cache_evict``    the executable cache drops every entry at
#:                          the next lookup (mid-flight eviction: the
#:                          recompile path under load)
#: ``serve_device_fail``    one pool member's dispatch fails: kind
#:                          ``nan`` poisons the batch output (the
#:                          non-finite sentinel path), any other kind
#:                          raises at dispatch (the exception sentinel
#:                          path).  ``FaultPlan(device=i)`` confines the
#:                          strike to pool member ``i``; transient plans
#:                          kill the device once, persistent plans keep
#:                          it dead until the plan deactivates (the
#:                          canary probes it back in)
#: ``serve_device_slow``    one pool member sleeps ``delay_s`` around a
#:                          dispatch — past the pool's per-dispatch
#:                          deadline this reads as a wedged device and
#:                          the batch fails over to a survivor
#: ``serve_canary_flake``   the quarantine canary probe fails (the sick
#:                          device is still sick): readmission is
#:                          refused and the next probe is rescheduled
SERVE_SITES = ("serve_flush_delay", "serve_compile_stall",
               "serve_cache_evict", "serve_device_fail",
               "serve_device_slow", "serve_canary_flake")
#: HOST-side durability chaos sites (docs/ROBUSTNESS.md "Durable jobs"):
#: consumed via :func:`host_fire` by robust/checkpoint.py and the
#: out-of-core tile map in core/storage.py —
#:
#: ``ckpt_torn_write``   the checkpoint payload write is truncated
#:                       mid-file after the manifest digest was computed
#:                       (a crash/preemption landing between write and
#:                       fsync): resume must refuse with reason "torn"
#: ``ckpt_stale_read``   the manifest writer re-reads a stale payload —
#:                       the payload write is skipped but the manifest is
#:                       republished against the old bytes: resume must
#:                       refuse with reason "stale"
#: ``ooc_copy_stall``    the tile map sleeps ``delay_s`` around a
#:                       host<->device panel copy (a congested PCIe/DMA
#:                       path): out-of-core results must stay correct,
#:                       merely late
CKPT_SITES = ("ckpt_torn_write", "ckpt_stale_read", "ooc_copy_stall")
#: every host-side site host_fire will serve
HOST_SITES = SERVE_SITES + CKPT_SITES
KINDS = ("nan", "inf", "bitflip")

# flipping exponent bit 6 of an O(1) value: finite, wildly wrong
_BITFLIP_SCALE = 2.0 ** 100


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One corruption: ``count`` elements of the first array that flows
    through ``site``, positions drawn deterministically from ``seed``."""

    site: str
    kind: str = "nan"
    seed: int = 0
    count: int = 1
    # transient faults strike once per inject() activation (single-shot
    # SDC); the default is a stuck-at fault that re-fires on every pass.
    transient: bool = False
    # confine the strike to one tile: (block-row, block-col), or None for
    # the whole array.  ``nb`` gives the block edge for 2D arrays.
    tile: tuple[int, int] | None = None
    nb: int = 0
    # host-side serving sites only: how long the chaos sleep lasts
    delay_s: float = 0.0
    # host-side device-pool sites only: confine the strike to one pool
    # member index (None = any member that reaches the site first)
    device: int | None = None

    def __post_init__(self):
        if self.site not in SITES and self.site not in HOST_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {SITES + HOST_SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"kinds: {KINDS}")
        if self.tile is not None:
            if (len(self.tile) != 2
                    or any(int(t) != t or t < 0 for t in self.tile)):
                raise ValueError(f"tile must be two non-negative block "
                                 f"indices, got {self.tile!r}")
        if self.device is not None and (int(self.device) != self.device
                                        or self.device < 0):
            raise ValueError(f"device must be a non-negative pool member "
                             f"index, got {self.device!r}")


_ACTIVE: dict[str, FaultPlan] = {}
# per-inject() activation bookkeeping for transient plans: which
# activation a site's plan belongs to, and which (activation, site) pairs
# have already struck.  The port runs eagerly, so a strike is consumed
# when the site is reached.
_EPOCH = 0
_PLAN_EPOCH: dict[str, int] = {}
_SPENT: set[tuple[int, str]] = set()


@contextlib.contextmanager
def inject(*plans: FaultPlan):
    """Activate fault plans for the dynamic extent of the block."""
    global _EPOCH
    saved = dict(_ACTIVE)
    saved_epoch = dict(_PLAN_EPOCH)
    _EPOCH += 1
    epoch = _EPOCH
    try:
        for p in plans:
            _ACTIVE[p.site] = p
            _PLAN_EPOCH[p.site] = epoch
        yield
    finally:
        _ACTIVE.clear()
        _ACTIVE.update(saved)
        _PLAN_EPOCH.clear()
        _PLAN_EPOCH.update(saved_epoch)
        _SPENT.difference_update({k for k in _SPENT if k[0] == epoch})


def active(site: str) -> FaultPlan | None:
    return _ACTIVE.get(site)


def device_plans_active() -> bool:
    """Is a plan armed at any device-side site (``SITES``)?  A strike's
    positions come from the host and a transient one fires once, so the
    paths that replay CUDA graphs run eagerly while one is armed."""
    return any(site in _ACTIVE for site in SITES)


def host_fire(site: str, device: int | None = None) -> FaultPlan | None:
    """Consume an active HOST-side chaos plan at ``site``.

    The serving and durability layers call it from plain host code (the
    flush loop, the executable cache, the checkpoint writer, the tile-map
    copy path) and act on the returned plan (sleep, evict, tear a write);
    the port's serving layer (serve/server.py, cache.py, pool.py) consumes
    the serving sites, and the durability sites wait for the slice that
    ports those layers.  Transient
    plans fire at most once per :func:`inject` activation — one stalled
    compile or one torn checkpoint, not a permanently broken disk.

    ``device`` is the calling pool member's index (serve/pool.py): a
    plan declaring ``FaultPlan(device=i)`` fires only when member ``i``
    reaches the site — a miss neither fires nor consumes, so a transient
    kill-device-1 plan cannot be eaten by member 0 passing by first."""
    if site not in HOST_SITES:
        return None
    plan = _ACTIVE.get(site)
    if plan is None:
        return None
    if plan.device is not None and plan.device != device:
        return None
    if plan.transient:
        epoch = _PLAN_EPOCH.get(site, 0)
        if (epoch, site) in _SPENT:
            return None
        _SPENT.add((epoch, site))
    return plan


def poisson_workload(seed: int, problems: int, rate_hz: float, sizes,
                     nrhs: int = 2, dtype=np.float32,
                     ops=("solve", "chol_solve", "least_squares_solve")):
    """Deterministic seeded open-loop serving workload: ``problems``
    mixed-size requests with exponential (Poisson-process) inter-arrival
    gaps at ``rate_hz``.  Same seed -> same arrival times, sizes and
    operand values, so overload/shed/quarantine behavior is reproducible
    on CPU — the chaos harness's load generator (bench_serve_survival
    and the survival tests replay it).

    Returns ``[(t_arrival_s, op, a, b)]`` sorted by arrival; matrices
    are well-conditioned (diagonally dominated / SPD-shifted), so every
    admitted request should serve healthy unless chaos intervenes."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate_hz, 1e-9),
                                         size=problems))
    out = []
    for i in range(problems):
        n = int(sizes[i % len(sizes)])
        op = ops[i % len(ops)]
        if op == "least_squares_solve":
            a = rng.standard_normal((n + 8, n)).astype(dtype)
            b = rng.standard_normal((n + 8, nrhs)).astype(dtype)
        else:
            a = rng.standard_normal((n, n)).astype(dtype)
            if op == "chol_solve":
                a = (a @ a.T / n + np.eye(n, dtype=dtype)).astype(dtype)
            else:
                a = a + np.eye(n, dtype=dtype) * 4.0
            b = rng.standard_normal((n, nrhs)).astype(dtype)
        out.append((float(arrivals[i]), op, a, b))
    return out


def _strike_flat(flat: torch.Tensor, plan: FaultPlan) -> torch.Tensor:
    """Corrupt ``plan.count`` deterministic positions of a flat tensor, in
    place (the caller passes a copy)."""
    size = flat.numel()
    k = min(plan.count, size)
    idx = torch.as_tensor(np.random.default_rng(plan.seed).choice(
        size, size=k, replace=False), device=flat.device)
    if plan.kind == "nan":
        flat[idx] = float("nan")
    elif plan.kind == "inf":
        flat[idx] = float("inf")
    else:
        # bitflip: exponent-bit flip -- finite but wildly wrong
        flat[idx] = flat[idx] * _BITFLIP_SCALE
    return flat


def _strike_block(x: torch.Tensor, plan: FaultPlan) -> torch.Tensor:
    """A struck copy of the block ``x`` (any shape)."""
    return _strike_flat(x.clone().reshape(-1), plan).reshape(x.shape)


def _inexact(x: torch.Tensor) -> bool:
    return x.is_floating_point() or x.is_complex()


def corrupt(x: torch.Tensor, plan: FaultPlan) -> torch.Tensor:
    """Apply ``plan`` to tensor ``x``: a corrupted COPY (``x`` itself is
    left as it was), deterministic flat positions from the seed, payload
    per ``plan.kind``.  With ``plan.tile`` set, the strike is confined to
    that tile (see the module docstring); an out-of-range tile is a
    miss."""
    if x.numel() == 0 or not _inexact(x):
        return x
    if plan.tile is None:
        return _strike_block(x, plan)
    ti, tj = plan.tile
    if x.dim() == 4:
        if ti >= x.shape[0] or tj >= x.shape[1]:
            return x
        out = x.clone()
        out[ti, tj] = _strike_block(x[ti, tj], plan)
        return out
    if x.dim() == 3:
        if ti >= x.shape[0]:
            return x
        out = x.clone()
        out[ti] = _strike_block(x[ti], plan)
        return out
    if x.dim() == 2:
        if plan.nb <= 0:
            raise ValueError("FaultPlan.tile on a 2D array requires nb > 0")
        r0, c0 = ti * plan.nb, tj * plan.nb
        if r0 >= x.shape[0] or c0 >= x.shape[1]:
            return x
        out = x.clone()
        sub = x[r0:r0 + plan.nb, c0:c0 + plan.nb]
        out[r0:r0 + sub.shape[0], c0:c0 + sub.shape[1]] = _strike_block(
            sub, plan)
        return out
    raise ValueError(f"FaultPlan.tile targeting needs a 2D/3D/4D array, "
                     f"got ndim={x.dim()}")


def maybe_corrupt(site: str, x: torch.Tensor) -> torch.Tensor:
    """The site hook drivers call: ``x`` itself unless a plan is active.

    A ``transient`` plan strikes at most once per :func:`inject`
    activation: the first call that reaches the site with a non-empty
    floating tensor consumes it, and later calls see ``x`` unchanged."""
    plan = _ACTIVE.get(site)
    if plan is None:
        return x
    if not plan.transient:
        return corrupt(x, plan)
    if x.numel() == 0 or not _inexact(x):
        return x
    key = (_PLAN_EPOCH.get(site, 0), site)
    if key in _SPENT:
        return x
    _SPENT.add(key)
    return corrupt(x, plan)
