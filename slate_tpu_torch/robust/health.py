"""HealthInfo and the ErrorPolicy glue (port of slate_tpu/robust/health.py).

The reference carries health as traced scalars so that it survives jit;
the port runs eagerly, so each field is a plain Python value, read from
the device once per driver call.  The fields, ``ok``, ``merge`` and
``finalize`` keep the reference's contract (health.py:26-60).  A batch of
problems (the serving path) carries a :class:`BatchHealth` of [B] device
tensors instead, read into one HealthInfo per problem in one copy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..obs import events as _obs
from ..options import ErrorPolicy, Option, Options, get_option
from ..types import eps


class HealthInfo(NamedTuple):
    """Numerical health of one factor/solve.

    nonfinite        any NaN/Inf in the result
    info             LAPACK-style code: 0 healthy, k > 0 the 1-based index
                     of the first zero/non-finite pivot
    min_pivot        smallest |pivot| seen
    min_pivot_index  0-based position of ``min_pivot`` (-1: none)
    growth           max|factor| / max|input| (1.0 when not tracked)
    iters            refinement iterations (0 for direct solves)
    converged        iterative convergence (True for direct paths)
    abft_detected    checksum mismatches found (0 without Option.Abft)
    abft_corrected   of those, how many were repaired in place
    abft_site        first detection's tile, ``ti * 65536 + tj``; -1 none
    """

    nonfinite: bool
    info: int
    min_pivot: float
    min_pivot_index: int
    growth: float
    iters: int
    converged: bool
    abft_detected: int = 0
    abft_corrected: int = 0
    abft_site: int = -1

    @property
    def ok(self) -> bool:
        """No failure flag set; an uncorrected checksum mismatch fails."""
        return (not self.nonfinite and self.info == 0 and self.converged
                and self.abft_detected == self.abft_corrected)

    def describe(self) -> str:
        """Human summary (used in exception messages)."""
        return (f"info={self.info} nonfinite={self.nonfinite} "
                f"min_pivot={self.min_pivot:.3e}@{self.min_pivot_index} "
                f"growth={self.growth:.3e} iters={self.iters} "
                f"converged={self.converged}")


def healthy() -> HealthInfo:
    return HealthInfo(nonfinite=False, info=0, min_pivot=math.inf,
                      min_pivot_index=-1, growth=1.0, iters=0,
                      converged=True)


def from_pivots(diag: torch.Tensor) -> HealthInfo:
    """Health of a factorization from its pivots (ref: health.py:99; the
    port has no caller for its ``growth`` and ``valid`` arguments).

    ``diag``: the factor's diagonal (U's for LU), any dtype.  ``info`` is
    the 1-based index of the first exactly-zero or non-finite pivot, 0 if
    none; the minimum is taken as ``torch.argmin`` takes it (a NaN wins)."""
    mag = diag.abs()
    bad = (mag == 0) | ~torch.isfinite(mag)
    mpi = torch.argmin(mag)
    any_bad, first_bad, mpi_v, minpiv, nonfinite = torch.stack([
        bad.any().double(), torch.argmax(bad.int()).double(), mpi.double(),
        mag[mpi].double(), (~torch.isfinite(mag)).any().double(),
    ]).tolist()
    return healthy()._replace(
        nonfinite=bool(nonfinite),
        info=int(first_bad) + 1 if any_bad else 0,
        min_pivot=minpiv,
        min_pivot_index=int(mpi_v))


def from_result(x: torch.Tensor, grid=None) -> HealthInfo:
    """Health of a computed result: the non-finite flag only.  On a grid
    with a process group ``x`` is a rank's local tiles, and the flag is
    reduced over the grid, so that every rank reads the same health."""
    finite = torch.isfinite(x).all()
    if grid is not None and grid.group is not None:
        from ..comm.collectives import reduce_grid
        finite = reduce_grid(finite.to(torch.int32), grid, op="min")
    return healthy()._replace(nonfinite=not bool(finite))


def merge(*hs: HealthInfo) -> HealthInfo:
    """Combine phase healths (factor + solve + ...): worst-of on every
    field; ``info`` keeps the first nonzero code; iters accumulate."""
    out = hs[0]
    for h in hs[1:]:
        out = HealthInfo(
            nonfinite=out.nonfinite or h.nonfinite,
            info=out.info if out.info != 0 else h.info,
            min_pivot=min(out.min_pivot, h.min_pivot),
            min_pivot_index=(out.min_pivot_index
                             if out.min_pivot <= h.min_pivot
                             else h.min_pivot_index),
            growth=max(out.growth, h.growth),
            iters=out.iters + h.iters,
            converged=out.converged and h.converged,
            abft_detected=out.abft_detected + h.abft_detected,
            abft_corrected=out.abft_corrected + h.abft_corrected,
            abft_site=out.abft_site if out.abft_site >= 0 else h.abft_site,
        )
    return out


class BatchHealth(NamedTuple):
    """The health of a batch of problems while it is still on the device:
    each field a [B] tensor (the reference's leading-axis HealthInfo
    pytree).  The batched readers, certificates and the serving cores
    build and merge these with the reference's arithmetic, and
    :meth:`to_list` reads them all in one copy."""

    nonfinite: torch.Tensor
    info: torch.Tensor
    min_pivot: torch.Tensor
    min_pivot_index: torch.Tensor
    growth: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    abft_detected: torch.Tensor
    abft_corrected: torch.Tensor
    abft_site: torch.Tensor

    def to_list(self) -> list[HealthInfo]:
        """One HealthInfo per problem, from one device-to-host copy."""
        rows = torch.stack([f.double() for f in self], dim=1).tolist()
        return [HealthInfo(
            nonfinite=bool(r[0]), info=int(r[1]), min_pivot=r[2],
            min_pivot_index=int(r[3]), growth=r[4], iters=int(r[5]),
            converged=bool(r[6]), abft_detected=int(r[7]),
            abft_corrected=int(r[8]), abft_site=int(r[9])) for r in rows]


def batch_healthy(bsz: int, device) -> BatchHealth:
    """A healthy record for each of ``bsz`` problems."""
    def full(v, dtype):
        return torch.full((bsz,), v, dtype=dtype, device=device)
    return BatchHealth(
        nonfinite=full(False, torch.bool), info=full(0, torch.int64),
        min_pivot=full(math.inf, torch.float64),
        min_pivot_index=full(-1, torch.int64),
        growth=full(1.0, torch.float64), iters=full(0, torch.int64),
        converged=full(True, torch.bool), abft_detected=full(0, torch.int64),
        abft_corrected=full(0, torch.int64), abft_site=full(-1, torch.int64))


def batch_from_pivots(diag: torch.Tensor) -> BatchHealth:
    """:func:`from_pivots` of each row of ``diag`` [B, n]."""
    mag = diag.abs()
    bad = (mag == 0) | ~torch.isfinite(mag)
    mpi = torch.argmin(mag, dim=1)
    return batch_healthy(mag.shape[0], mag.device)._replace(
        nonfinite=(~torch.isfinite(mag)).any(dim=1),
        info=torch.where(bad.any(dim=1), torch.argmax(bad.int(), dim=1) + 1,
                         0),
        min_pivot=mag.gather(1, mpi[:, None])[:, 0].double(),
        min_pivot_index=mpi)


def batch_from_result(x: torch.Tensor) -> BatchHealth:
    """:func:`from_result` of each problem of ``x`` [B, ...]."""
    finite = torch.isfinite(x).flatten(1).all(dim=1)
    return batch_healthy(x.shape[0], x.device)._replace(nonfinite=~finite)


def batch_merge(*hs: BatchHealth) -> BatchHealth:
    """:func:`merge` problem by problem, on the device (NaN pivots win the
    minimum, as the reference's ``jnp.minimum`` lets them)."""
    out = hs[0]
    for h in hs[1:]:
        out = BatchHealth(
            nonfinite=out.nonfinite | h.nonfinite,
            info=torch.where(out.info != 0, out.info, h.info),
            min_pivot=torch.minimum(out.min_pivot, h.min_pivot),
            min_pivot_index=torch.where(out.min_pivot <= h.min_pivot,
                                        out.min_pivot_index,
                                        h.min_pivot_index),
            growth=torch.maximum(out.growth, h.growth),
            iters=out.iters + h.iters,
            converged=out.converged & h.converged,
            abft_detected=out.abft_detected + h.abft_detected,
            abft_corrected=out.abft_corrected + h.abft_corrected,
            abft_site=torch.where(out.abft_site >= 0, out.abft_site,
                                  h.abft_site))
    return out


def batch_fold(h: BatchHealth, grid) -> BatchHealth:
    """``h`` the same on every rank of a grid with a process group: the
    non-finite flag and the worst ratio (``growth``) folded by their
    maximum, ``converged`` by its minimum, in one all-reduce over the grid
    and no host read (the fold :func:`from_result` makes of ``finite``).
    A rank whose own reading picked another ladder rung than its
    neighbours would leave them waiting in a collective.  Other grids:
    ``h`` itself."""
    if grid is None or getattr(grid, "group", None) is None:
        return h
    from ..comm.collectives import reduce_grid
    bad = torch.stack([h.nonfinite.double(), (~h.converged).double(),
                       torch.nan_to_num(h.growth.double(), nan=math.inf)])
    bad = reduce_grid(bad, grid, op="max")
    return h._replace(nonfinite=bad[0] > 0, converged=bad[1] == 0,
                      growth=bad[2])


def error_policy(opts: Options | None) -> ErrorPolicy:
    return get_option(opts, Option.ErrorPolicy)


def growth_limit(dtype: torch.dtype) -> float:
    """Pivot-growth escalation threshold: 1/sqrt(eps) of the real dtype."""
    return 1.0 / math.sqrt(eps(dtype))


def acceptable(h: HealthInfo, dtype: torch.dtype) -> bool:
    """ok AND pivot growth within the dtype's escalation threshold."""
    return h.ok and h.growth <= growth_limit(dtype)


def _poison(result):
    """NaN-fill every matrix and every floating or complex tensor or host
    array of a result (a matrix, a tensor, or tuples, lists and dicts of
    them, nested; integer leaves such as a permutation stay): the
    ErrorPolicy.Nan guarantee that a failed result is never finite."""
    from ..core.matrix import BaseMatrix
    from ..core.storage import TileStorage
    if isinstance(result, tuple):
        parts = [_poison(r) for r in result]
        # a NamedTuple (LUFactors) keeps its type; integer leaves (perm) stay
        return (type(result)(*parts) if hasattr(result, "_fields")
                else tuple(parts))
    if isinstance(result, list):
        return [_poison(r) for r in result]
    if isinstance(result, dict):
        return {k: _poison(v) for k, v in result.items()}
    if isinstance(result, BaseMatrix):
        st = result.storage
        data = torch.full_like(st.data, math.nan)
        return result._same_view(
            TileStorage(data, st.m, st.n, st.mb, st.nb, st.grid))
    if isinstance(result, torch.Tensor) and (result.is_floating_point()
                                             or result.is_complex()):
        return torch.full_like(result, math.nan)
    if isinstance(result, np.ndarray) and result.dtype.kind in "fc":
        return np.full_like(result, math.nan)    # an out-of-core host factor
    return result


def poison(tree, h: HealthInfo):
    """NaN-fill every floating or complex leaf of ``tree`` (tensors,
    matrices, host arrays, nested in tuples, lists and dicts) where the
    health is bad, and return it untouched where it is good (ref:
    health.py:181): the ErrorPolicy.Nan guarantee that a failed result is
    never finite garbage.  Integer leaves stay, as the reference's do."""
    return tree if h.ok else _poison(tree)


def finalize(name: str, result, h: HealthInfo, opts: Options | None,
             make_exc=None):
    """Resolve a driver result against Option.ErrorPolicy, the one seam
    every factor/solve driver routes its failures through.

    Raise  bad health raises ``make_exc(h)`` (typed)
    Nan    NaN-poison the result where bad; never raise
    Info   return ``(result, h)``
    """
    policy = error_policy(opts)
    # host-side note into the open obs boundary frame (no-op when none):
    # nested finalizes are overwritten by the boundary's own, so the
    # emitted event carries the recovery-merged health
    _obs.note_health(name, h, policy.name)
    if policy is ErrorPolicy.Info:
        return result, h
    if h.ok:
        return result
    if policy is ErrorPolicy.Nan:
        return poison(result, h)
    raise (make_exc(h) if make_exc is not None else _default_exc(name, h))


def finalize_flat(name: str, result: tuple, h: HealthInfo,
                  opts: Options | None, make_exc=None):
    """:func:`finalize` for tuple-shaped results ((w, Z), (s, U, V)):
    under Info the HealthInfo is appended, ``(w, Z, h)``, not nested."""
    res = finalize(name, tuple(result), h, opts, make_exc)
    if error_policy(opts) is ErrorPolicy.Info:
        r, hh = res
        return (*r, hh)
    return res


def _default_exc(name: str, h: HealthInfo):
    from ..exceptions import SlateSingularError
    return SlateSingularError(f"{name}: {h.describe()}", info=h.info)
