"""Algorithm-based fault tolerance: Huang-Abraham checksums for the blocked
BLAS-3 / LU / Cholesky paths -- detect, locate, correct (port of
slate_tpu/robust/abft.py).

The invariant: augment ``A`` with a row-checksum vector ``A e`` and a
column-checksum vector ``e^T A``.  Matrix products and blocked
factorization steps map checksums to checksums -- ``(L U) e = L (U e)``,
``e^T (A - L21 U12) = e^T A - (e^T L21) U12`` -- at O(n^2) cost per step
against the O(n^3) work they shadow.  A single corrupted element at
``(i0, j0)`` leaves a CROSS pattern in the residuals: one spiked entry in
the row residual, one in the column residual; the element is rebuilt from
a checksum's masked complement, which works for ``nan``/``inf`` payloads
too.  Every correction is re-verified: a multi-element strike that fools
the locator fails the re-check and is reported detected-but-uncorrected,
which the health layer turns into an escalation.

Pure mechanism: no options, no policies, no exceptions.  Every function
returns tensors plus :class:`AbftCounts`, and the driver boundary folds
those into ``HealthInfo``.  Nothing here reads a device value to the host,
copies a host value to the device (on the card that copy waits for the
device too) or branches in Python on data: counts are 0-d device tensors,
locations are argmaxes over masks, reads of a located element are gathers
and its correction a ``where``-gated ``index_put_``.  Thresholds are the
reference's: :func:`_threshold` over certify's ``tolerance``, scaled by
the operands' magnitudes.

Each check takes the reference's single-problem operands or the same with
one leading batch axis (where the reference vmaps: batch_potrf's in-batch
rungs); the counts then carry that axis.  :func:`sum_check` and
:func:`tile_sum_check` correct their block IN PLACE (an LU step's
trailing matrix is the largest block a rung sees, and a copy of it per
step would double the rung's traffic); the other checks return new
tensors and leave their inputs as they were.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..internal.gemm import (tile_product_col_sums,  # noqa: F401
                             tile_product_row_sums)
from .certify import tolerance

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


class AbftState(NamedTuple):
    """Checksum pair for one matrix: ``row = A e`` (length m) and
    ``col = e^T A`` (length n)."""

    row: torch.Tensor
    col: torch.Tensor


class AbftCounts(NamedTuple):
    """Detection bookkeeping for one or more checksum verifications, each
    field an integer device tensor (0-d, or [B] for a batch).

    detected   verification events that found a mismatch
    corrected  of those, repaired in place (re-verified)
    site       ``ti * 65536 + tj`` of the first located tile, -1 when
               nothing was detected
    """

    detected: torch.Tensor
    corrected: torch.Tensor
    site: torch.Tensor


def zero_counts(device=None, shape=()) -> AbftCounts:
    """No events yet: zero counters and site -1 (``shape`` (B,) for a
    batch)."""
    def full(v):
        return torch.full(shape, v, dtype=torch.int64, device=device)
    return AbftCounts(full(0), full(0), full(-1))


def site_code(ti, tj):
    """Encode a global tile coordinate (ints or integer tensors) into the
    HealthInfo site."""
    return ti * 65536 + tj


def count_event(detected, corrected, ti, tj) -> AbftCounts:
    """Counts for ONE verification event (``detected`` and ``corrected``
    bool device tensors) at tile coordinates that are ints or device
    tensors; the site is recorded only when something was detected.  No
    Python value is copied to the device: that copy would wait for the
    device, as a read does."""
    return AbftCounts(detected.to(torch.int64), corrected.to(torch.int64),
                      torch.where(detected, site_code(ti, tj), -1).to(
                          torch.int64))


def add_counts(a: AbftCounts, b: AbftCounts) -> AbftCounts:
    """Accumulate events: counters sum, the first located site wins."""
    return AbftCounts(a.detected + b.detected, a.corrected + b.corrected,
                      torch.where(a.site >= 0, a.site, b.site))


def checksums(a: torch.Tensor) -> AbftState:
    """The Huang-Abraham pair for a dense matrix."""
    return AbftState(row=a.sum(dim=-1), col=a.sum(dim=-2))


# ---------------------------------------------------------------- utils
#
# Every helper below works on a leading batch axis [B, ...]; the public
# checks add it for single problems and take it off again.


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return _REAL.get(dtype, dtype)


def _threshold(dtype, n: int, *mags) -> torch.Tensor:
    """Detection threshold [B]: certify's dtype-calibrated ``50 n eps``
    scaled by the participating magnitudes (each clamped below at 1 so a
    zero block never yields a zero threshold).  Rounding in an n-term
    checksum sits orders of magnitude below this; a 2^100 bitflip sits ~80
    orders above."""
    rdt = _real_dtype(dtype)
    t = tolerance(rdt, n)                  # a host float, rounded to rdt
    for m in mags:                         # by the first product
        t = torch.clamp(m.real.to(rdt), min=1.0) * t
    return t


def _amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each problem of ``x`` [B, ...] (0 for an empty block)."""
    if x[0].numel() == 0:
        return torch.zeros(x.shape[0], dtype=_real_dtype(x.dtype),
                           device=x.device)
    return x.abs().flatten(1).amax(dim=1)


def _finite_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over finite entries only -- the magnitude scale of a block
    that may carry an injected NaN/Inf payload."""
    a = x.abs()
    return torch.where(torch.isfinite(a), a, 0).flatten(1).amax(dim=1)


def _bad(d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Residual-exceeds-threshold mask; NaN/Inf residuals count as bad."""
    return ~(d.abs() <= t[:, None])


def _score(d: torch.Tensor) -> torch.Tensor:
    """Magnitude for argmax localization with NaN/Inf forced to the top."""
    a = d.abs()
    return torch.where(torch.isfinite(a), a, torch.inf)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _excl_sum(v: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Sum of ``v`` [B, n] excluding index ``skip`` [B] -- the masked
    complement a corrupted element is reconstructed from."""
    keep = torch.arange(v.shape[-1], device=v.device) != skip[:, None]
    return torch.where(keep, v, 0).sum(dim=-1)


def _at(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[b, i[b]] of ``v`` [B, n]: a gather."""
    return v.gather(-1, i[:, None])[:, 0]


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[b, i[b], :] of ``x`` [B, m, n]."""
    return x.gather(1, i[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


def _col(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x[b, :, j[b]] of ``x`` [B, m, n]."""
    return x.gather(2, j[:, None, None].expand(-1, x.shape[1], 1))[..., 0]


def _put(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
         v: torch.Tensor) -> None:
    """x[b, i[b], j[b]] = v[b], in place, indices on the device."""
    b = torch.arange(x.shape[0], device=x.device)
    x.index_put_((b, i, j), v.to(x.dtype))


def _nf_locate(x: torch.Tensor):
    """(any_nonfinite, i, j) [B] of the first non-finite element of each
    ``x`` [B, m, n].

    A NaN/Inf payload poisons every residual it touches (``NaN * 0 =
    NaN``), so the cross-pattern's first-bad-index locate degenerates --
    the element must be found from the factor's own non-finite mask.
    Finite payloads (bitflip) keep the zeros in the spread direction and
    are located from the residual pattern instead."""
    nf = ~torch.isfinite(x.abs()).flatten(1)
    flat = _first(nf)
    ncol = x.shape[2]
    return nf.any(dim=1), flat // ncol, flat % ncol


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m[b] @ v[b] of ``m`` [B, p, q] and ``v`` [B, q]."""
    return (m @ v[..., None])[..., 0]


def _vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v[b] @ m[b] of ``v`` [B, p] and ``m`` [B, p, q]."""
    return (v[:, None, :] @ m)[:, 0]


def _batched(x: torch.Tensor, ndim: int):
    """(x with a leading batch axis, whether the caller passed one)."""
    return (x, True) if x.dim() == ndim + 1 else (x[None], False)


def _unbatch(was_batched: bool, *ts):
    return ts if was_batched else tuple(t[0] for t in ts)


# -------------------------------------------- additive (GEMM) checksums

def sum_check(x, exp_row, exp_col, *, dtype=None, n_ctx=None,
              nb=1, row0=0, col0=0):
    """Verify a dense block against expected checksums; correct a single
    corrupted element IN PLACE.

    ``x`` [m, n] should satisfy ``x @ e == exp_row`` and ``e^T x ==
    exp_col`` up to rounding.  A single corrupted element produces exactly
    one bad row-residual entry and one bad column-residual entry (the
    cross pattern); the true value is rebuilt from the row checksum's
    masked complement and cross-checked against the column's.  Anything
    wider (two elements, two tiles) fails the single-spike / consistency
    gates and is left untouched.

    Returns ``(x, AbftCounts)`` with the site mapped to global tile
    coordinates via ``nb`` / ``row0`` / ``col0``."""
    xb, batched = _batched(x, 2)
    er = exp_row if batched else exp_row[None]
    ec = exp_col if batched else exp_col[None]
    dtype = dtype or x.dtype
    n_ctx = n_ctx or max(xb.shape[1:])
    dr = xb.sum(dim=2) - er
    dc = xb.sum(dim=1) - ec
    t = _threshold(dtype, n_ctx, _amax(er), _amax(ec))
    bad_r, bad_c = _bad(dr, t), _bad(dc, t)
    detected = bad_r.any(dim=1) | bad_c.any(dim=1)
    i0 = torch.argmax(_score(dr), dim=1)
    j0 = torch.argmax(_score(dc), dim=1)
    # reconstruct from the row complement, cross-check with the column's
    v_r = _at(er, i0) - _excl_sum(_row(xb, i0), j0)
    v_c = _at(ec, j0) - _excl_sum(_col(xb, j0), i0)
    consistent = (v_r - v_c).abs() <= t
    corrected = (detected & (bad_r.sum(dim=1) == 1)
                 & (bad_c.sum(dim=1) == 1) & consistent)
    _put(xb, i0, j0, torch.where(corrected, v_r, _at(_row(xb, i0), j0)))
    counts = count_event(detected, corrected,
                         (row0 + i0) // nb, (col0 + j0) // nb)
    if not batched:
        counts = AbftCounts(*(c[0] for c in counts))
    return x, counts


def tile_sum_check(t4, exp_r, exp_c, *, dtype=None, n_ctx=None):
    """Tile-granular :func:`sum_check` for a 4D tile array [S, T, mb, nb]
    with per-tile expected row sums ``exp_r`` [S, T, mb] and column sums
    ``exp_c`` [S, T, nb].  Locates the worst tile, corrects a single
    corrupted element inside it IN PLACE, and refuses (detected but not
    corrected) when more than one tile -- or more than one element -- is
    implicated.

    Returns ``(t4, AbftCounts-with-LOCAL-tile-site, ti, tj)``."""
    S, T, mb, nb = t4.shape
    dtype = dtype or t4.dtype
    n_ctx = n_ctx or max(S * mb, T * nb)
    dr = t4.sum(dim=3) - exp_r                            # [S, T, mb]
    dc = t4.sum(dim=2) - exp_c                            # [S, T, nb]
    t = _threshold(dtype, n_ctx, _amax(exp_r.reshape(1, -1)),
                   _amax(exp_c.reshape(1, -1)))
    bad_r = _bad(dr.reshape(1, -1), t).reshape(dr.shape)
    bad_c = _bad(dc.reshape(1, -1), t).reshape(dc.shape)
    tile_bad = bad_r.any(dim=2) | bad_c.any(dim=2)        # [S, T]
    detected = tile_bad.any()
    n_tiles_bad = tile_bad.sum()
    tile_score = _score(dr).amax(dim=2) + _score(dc).amax(dim=2)
    flat = torch.argmax(tile_score.reshape(-1))
    ti, tj = flat // T, flat % T
    sub = t4.reshape(S * T, mb, nb).index_select(0, flat[None])  # [1, mb, nb]
    sub_dr = dr.reshape(S * T, mb).index_select(0, flat[None])
    sub_dc = dc.reshape(S * T, nb).index_select(0, flat[None])
    i0 = torch.argmax(_score(sub_dr), dim=1)
    j0 = torch.argmax(_score(sub_dc), dim=1)
    v_r = (_at(exp_r.reshape(S * T, mb).index_select(0, flat[None]), i0)
           - _excl_sum(_row(sub, i0), j0))
    v_c = (_at(exp_c.reshape(S * T, nb).index_select(0, flat[None]), j0)
           - _excl_sum(_col(sub, j0), i0))
    corrected = (detected & (n_tiles_bad == 1)
                 & (_bad(sub_dr, t).sum() == 1)
                 & (_bad(sub_dc, t).sum() == 1)
                 & ((v_r - v_c).abs() <= t)[0])
    new = torch.where(corrected, v_r[0], _at(_row(sub, i0), j0)[0])
    t4.index_put_((ti[None], tj[None], i0, j0), new[None].to(t4.dtype))
    return t4, count_event(detected, corrected, ti, tj), ti, tj


# ------------------------------------------------------ LU panel check

def _lu_panel_resid(pan_row_p, pan_col, lu):
    """Checksum residuals of packed LU panels [B, M, w] against their
    PRE-factor inputs: ``dr = L (U e) - rowsum(pan)[perm]`` and ``dc =
    (e^T L) U - colsum(pan)`` -- O(M w), no product formed.  ``L`` is the
    implicit unit-lower factor, ``U`` the upper part of the first w
    rows."""
    w = lu.shape[2]
    l_strict = torch.tril(lu, -1)
    u = torch.triu(lu[:, :w])
    ru = u.sum(dim=2)                                      # U e, [B, w]
    cl = 1.0 + l_strict.sum(dim=1)                         # e^T L, [B, w]
    act_row = _matvec(l_strict, ru)
    act_row = torch.cat([act_row[:, :w] + ru, act_row[:, w:]], dim=1)
    dr = act_row - pan_row_p
    dc = _vecmat(cl, u) - pan_col
    return dr, dc, u, ru, cl


def lu_panel_check(pan, lu, perm, *, n_ctx=None):
    """Verify a just-factored packed panel ``lu`` (= L\\U, [M, w], unit L
    implicit) against its pre-factor input ``pan`` and permutation
    ``perm`` (``pan[perm] = L U``); locate + correct one corrupted factor
    element.

    Column sums are invariant under the row permutation and row sums are
    permutation-equivariant, so both checks need only the checksum vectors
    of ``pan``.  A strike in the L part (i0 > j0) spikes exactly one row
    residual and spreads along U's row j0 in the column residual; a strike
    in the U part spikes exactly one column residual and spreads along L's
    column i0 -- either way ``(first bad row, first bad column)`` is the
    element.  Reconstruction solves the element's own checksum identity
    with the corrupted entry masked out (NaN/Inf-proof), and the panel is
    re-verified before the correction is accepted.

    Returns ``(lu', detected, corrected, i0, j0)`` -- the caller maps the
    element to its global tile."""
    lub, batched = _batched(lu, 2)
    panb = pan if batched else pan[None]
    permb = perm if batched else perm[None]
    B, M, w = lub.shape
    n_ctx = n_ctx or M
    pan_row_p = panb.sum(dim=2).gather(1, permb)
    pan_col = panb.sum(dim=1)
    dr, dc, u, ru, cl = _lu_panel_resid(pan_row_p, pan_col, lub)
    t = _threshold(lub.dtype, n_ctx, _amax(panb), _finite_amax(lub))
    bad_r, bad_c = _bad(dr, t), _bad(dc, t)
    detected = bad_r.any(dim=1) | bad_c.any(dim=1)
    any_nf, nf_i, nf_j = _nf_locate(lub)
    i0 = torch.where(any_nf, nf_i, _first(bad_r))
    j0 = torch.where(any_nf, nf_j, _first(bad_c))
    is_l = i0 > j0
    rows = torch.arange(M, device=lu.device)
    cols = torch.arange(w, device=lu.device)
    # --- L-part reconstruction: column j0's checksum identity.
    # true (e^T L)[j0] = (colsum(pan)[j0] - sum_{i<j0} (e^T L)[i] U[i,j0])
    #                    / U[j0,j0]; the strike is the only unknown term.
    u_j0 = _col(u, j0)
    num = _at(pan_col, j0) - torch.where(cols < j0[:, None], cl * u_j0,
                                         0).sum(dim=1)
    den = _at(u_j0, j0)
    cl_true = num / torch.where(den == 0, 1.0, den)
    col_j0 = torch.where((rows > j0[:, None]) & (rows != i0[:, None]),
                         _col(lub, j0), 0)
    v_l = cl_true - 1.0 - col_j0.sum(dim=1)
    # --- U-part reconstruction: row i0's checksum identity.
    # true (U e)[i0] = rowsum(pan)[perm][i0] - sum_{j<i0} L[i0,j] (U e)[j]
    lu_i0 = _row(lub, i0)
    ru_true = _at(pan_row_p, i0) - torch.where(
        cols < i0[:, None], lu_i0 * ru, 0).sum(dim=1)
    row_i0 = torch.where((cols >= i0[:, None]) & (cols != j0[:, None]),
                         lu_i0, 0)
    v_u = ru_true - row_i0.sum(dim=1)
    v = torch.where(is_l, v_l, v_u)
    lu_fix = lub.clone()
    _put(lu_fix, i0, j0, v)
    dr2, dc2, *_ = _lu_panel_resid(pan_row_p, pan_col, lu_fix)
    clean2 = ~(_bad(dr2, t).any(dim=1) | _bad(dc2, t).any(dim=1))
    corrected = detected & clean2
    out = torch.where(corrected[:, None, None], lu_fix, lub)
    return _unbatch(batched, out, detected, corrected, i0, j0)


# ------------------------------------------------- Cholesky tile check

def _chol_resid(l: torch.Tensor, hh: torch.Tensor) -> torch.Tensor:
    lo = torch.tril(l)
    return torch.tril(lo @ lo.conj().mT - hh)


def chol_tile_check(hh, lkk, *, n_ctx=None):
    """Verify a just-factored diagonal tile ``lkk`` (lower triangular)
    against the Hermitian tile ``hh`` it factored; locate + correct one
    corrupted factor element.

    ``L L^H`` is Hermitian, so its row/column checksum residuals are
    conjugate mirrors and carry no cross information -- instead the full
    tile residual ``E = tril(L L^H - H)`` is formed at O(nb^3), the cost of
    the tile factorization itself.  A single strike at ``(i0, j0)``
    confines E's support to row i0 (columns >= j0) and column i0, so
    (first bad row, first bad column) of E locates it; the element is
    rebuilt from its own Cholesky defining equation and the tile
    re-verified.

    Returns ``(lkk', detected, corrected)``."""
    lb, batched = _batched(lkk, 2)
    hb = hh if batched else hh[None]
    nb = lb.shape[1]
    n_ctx = n_ctx or nb
    e1 = _chol_resid(lb, hb)
    t = _threshold(lb.dtype, n_ctx, _amax(hb))
    bad = ~(e1.abs() <= t[:, None, None])
    detected = bad.flatten(1).any(dim=1)
    any_nf, nf_i, nf_j = _nf_locate(torch.tril(lb))
    i0 = torch.where(any_nf, nf_i, _first(bad.any(dim=2)))
    j0 = torch.where(any_nf, nf_j, _first(bad.any(dim=1)))
    cols = torch.arange(nb, device=lkk.device)
    # row-i0 forward substitution with the struck element masked out:
    # H[i0,j0] = sum_{k<j0} L[i0,k] conj(L[j0,k]) + L[i0,j0] conj(L[j0,j0])
    l_i0, l_j0 = _row(lb, i0), _row(lb, j0)
    part = torch.where(cols < j0[:, None], l_i0 * l_j0.conj(), 0).sum(dim=1)
    den = _at(l_j0, j0).conj()
    h_i0 = _row(hb, i0)
    v_off = (_at(h_i0, j0) - part) / torch.where(den == 0, 1.0, den)
    # diagonal strike: L[i0,i0] = sqrt(H[i0,i0] - sum_{k<i0} |L[i0,k]|^2)
    d2 = (_at(h_i0, i0) - torch.where(cols < i0[:, None],
                                      l_i0.abs() ** 2, 0).sum(dim=1)).real
    v_diag = torch.sqrt(torch.clamp(d2, min=0)).to(lb.dtype)
    v = torch.where(i0 == j0, v_diag, v_off)
    lkk_fix = lb.clone()
    _put(lkk_fix, i0, j0, v)
    e2 = _chol_resid(lkk_fix, hb)
    clean2 = ~(~(e2.abs() <= t[:, None, None])).flatten(1).any(dim=1)
    corrected = detected & clean2
    out = torch.where(corrected[:, None, None], lkk_fix, lb)
    return _unbatch(batched, out, detected, corrected)


# -------------------------------------- triangular product (TRSM) check

def _left_product_resid(lmat, x, r_row, r_col, unit: bool):
    lo = torch.tril(lmat, -1) if unit else torch.tril(lmat)
    cl = lo.sum(dim=1) + (1.0 if unit else 0.0)            # e^T L
    xe = x.sum(dim=2)
    act_row = _matvec(lo, xe) + (xe if unit else 0.0)
    return act_row - r_row, _vecmat(cl, x) - r_col


def left_product_check(lmat, x, r_row, r_col, *, unit, n_ctx=None):
    """Verify ``L @ X == R`` through R's checksums only (``r_row = R e``,
    ``r_col = e^T R``) and correct one corrupted element of X.  L is lower
    triangular ([m, m], unit optional), so a strike at (i0, j0) spikes the
    row residual first at i0 and the column residual exactly at j0.  The
    row's own identity is solved for the true row sum, then the element --
    masked sums throughout, so NaN/Inf payloads reconstruct too.

    Returns ``(x', detected, corrected, i0, j0)``."""
    xb, batched = _batched(x, 2)
    lb = lmat if batched else lmat[None]
    rr = r_row if batched else r_row[None]
    rc = r_col if batched else r_col[None]
    m, ncol = xb.shape[1:]
    n_ctx = n_ctx or max(m, ncol)
    dr, dc = _left_product_resid(lb, xb, rr, rc, unit)
    t = _threshold(xb.dtype, n_ctx, _amax(rr), _amax(rc), _finite_amax(xb))
    bad_r, bad_c = _bad(dr, t), _bad(dc, t)
    detected = bad_r.any(dim=1) | bad_c.any(dim=1)
    any_nf, nf_i, nf_j = _nf_locate(xb)
    i0 = torch.where(any_nf, nf_i, _first(bad_r))
    j0 = torch.where(any_nf, nf_j, _first(bad_c))
    rows = torch.arange(m, device=x.device)
    xe = xb.sum(dim=2)
    l_i0 = _row(lb, i0)
    den = (torch.ones_like(xe[:, 0]) if unit else _at(l_i0, i0))
    # mask AFTER the product: xe[i0] may be NaN and 0 * NaN = NaN
    xe_true = (_at(rr, i0) - torch.where(rows < i0[:, None], l_i0 * xe,
                                         0).sum(dim=1)) / torch.where(
        den == 0, 1.0, den)
    v = xe_true - _excl_sum(_row(xb, i0), j0)
    x_fix = xb.clone()
    _put(x_fix, i0, j0, v)
    dr2, dc2 = _left_product_resid(lb, x_fix, rr, rc, unit)
    clean2 = ~(_bad(dr2, t).any(dim=1) | _bad(dc2, t).any(dim=1))
    corrected = detected & clean2
    out = torch.where(corrected[:, None, None], x_fix, xb)
    return _unbatch(batched, out, detected, corrected, i0, j0)
