"""LU drivers: getrf (partial pivot / no pivot / CALU), getrf_rbt, getrs,
gesv, gesv_nopiv, getri, getriOOP (port of the single-device path of
slate_tpu/drivers/lu.py).

The factorization result is ``LUFactors``: one matrix whose strictly lower
part is unit L and whose upper part is U (the reference's overwritten-A
convention) plus a row permutation ``perm`` with ``A[perm] = L @ U``.

getrf is a blocked right-looking LU of the dense matrix: per block column
the panel factor (internal/getrf.py: the library's pivoted LU, K3 for the
no-pivot panel, the K4 tournament and K3 for CALU), the row exchange of
the at most 2 nb rows the panel's permutation displaces, the U12 solve and
the trailing matmul.  ``Option.Abft`` adds the reference's checksum rungs
to every step, and the fault sites ``input``, ``post_panel`` and
``post_rbt`` sit where the reference's do.  ``getrf_ooc`` (host offload)
raises: it is not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.matrix import Matrix, TriangularMatrix
from ..core.storage import TileStorage
from ..exceptions import SlateSingularError, not_ported, slate_error
from ..internal import rbt
from ..internal.getrf import (panel_lu, panel_lu_nopiv, panel_lu_threshold,
                              panel_lu_tournament)
from ..internal.trsm import tri_inv_lower
from ..options import (ErrorPolicy, Option, Options, get_option,
                       resolve_abft, resolve_target)
from ..robust import abft as _abft
from ..robust import faults
from ..robust import health as _health
from ..types import Diag, Uplo
from .blas3 import trsm


class LUFactors(NamedTuple):
    """L\\U packed in one matrix + row permutation (A[perm] = L U)."""
    LU: Matrix
    perm: torch.Tensor

    def lower(self) -> TriangularMatrix:
        return TriangularMatrix._from_view(self.LU, Uplo.Lower, Diag.Unit)

    def upper(self) -> TriangularMatrix:
        return TriangularMatrix._from_view(self.LU, Uplo.Upper)


def _apply_row_perm(mat: torch.Tensor, perm: torch.Tensor,
                    bound: int) -> torch.Tensor:
    """Apply a row permutation that displaces at most ``bound`` rows to
    ``mat`` IN PLACE (the reference returns a new array), touching only
    those rows: ``top_k`` of the moved-row mask finds them without the
    host round trip of ``nonzero``.  Partial pivoting, threshold pivoting
    and the tournament placement each displace at most 2 nb rows."""
    w = perm.shape[0]
    if w == 0 or mat.shape[1] == 0:
        return mat
    moved = (perm != torch.arange(w, device=perm.device)).to(torch.float32)
    idx = torch.topk(moved, min(w, bound)).indices
    mat[idx] = mat[perm[idx]]
    return mat


def _solve_u12(l11: torch.Tensor, r12: torch.Tensor) -> torch.Tensor:
    """U12 = L11^-1 R12 as one matmul against the inverted unit L11."""
    return tri_inv_lower(l11, unit_diag=True) @ r12


def _update_trailing(a22: torch.Tensor, l21: torch.Tensor,
                     u12: torch.Tensor) -> None:
    """a22 -= l21 @ u12, in place."""
    a22.addmm_(l21, u12, alpha=-1.0)


def _panel(pan, method: str, nb: int, tau: float, mpt: int, depth: int):
    if method == "nopiv":
        return panel_lu_nopiv(pan)
    if method == "tntpiv":
        bh = pan.shape[0]
        br = max(nb, -(-bh // (mpt * nb)) * nb)
        return panel_lu_tournament(pan, block_rows=br, arity=depth)
    if tau < 1.0:
        return panel_lu_threshold(pan, tau)
    return panel_lu(pan)


def _getrf_dense_blocked(a: torch.Tensor, nb: int, method: str,
                         tau: float = 1.0, mpt: int = 4, depth: int = 2,
                         abft: bool = False):
    """Blocked right-looking LU of the dense ``a``, which it factors IN
    PLACE and returns with the global permutation (the reference builds a
    new array per step with ``.at[].set``; here each step writes into
    ``a``).  ``method``: "partial", "nopiv" or "tntpiv"; ``tau`` < 1
    switches partial pivoting to threshold pivoting (Option.PivotThreshold);
    ``mpt`` (Option.MaxPanelThreads) splits a tournament panel into ~mpt
    row blocks and ``depth`` (Option.Depth) is the reduction fan-in.

    With ``abft`` every step carries the reference's Huang-Abraham rungs
    (robust/abft.py): the packed panel against its pre-factor input (read
    before the row exchange), the U12 solve against the pre-solve row's
    checksums, and the trailing update against the expected checksum
    deltas, each locating and repairing a single corrupted element in
    place.  Returns ``(factor, perm, AbftCounts)``, the counts on ``a``'s
    device (zero without ``abft``)."""
    m, n = a.shape
    kmax = min(m, n)
    perm_g = torch.arange(m, device=a.device)
    counts = _abft.zero_counts(a.device)
    for k0 in range(0, kmax, nb):
        k1 = min(k0 + nb, kmax)
        w = k1 - k0
        kt = k0 // nb
        pan = a[k0:, k0:k1]
        lu, perm = _panel(pan, method, nb, tau, mpt, depth)
        lu = faults.maybe_corrupt("post_panel", lu)
        if abft:
            lu, det, cor, pi, _ = _abft.lu_panel_check(pan, lu, perm,
                                                       n_ctx=m)
            counts = _abft.add_counts(counts, _abft.count_event(
                det, cor, kt + pi // nb, kt))
        if method != "nopiv":
            _apply_row_perm(a[k0:], perm, 2 * w)
            perm_g[k0:] = perm_g[k0:][perm]
        a[k0:, k0:k1] = lu
        if k1 < n:
            r12 = a[k0:k1, k1:]
            u12 = _solve_u12(lu[:w, :w], r12)
            if abft:
                u12, det, cor, _, pj = _abft.left_product_check(
                    lu[:w, :w], u12, r12.sum(dim=1), r12.sum(dim=0),
                    unit=True, n_ctx=m)
                counts = _abft.add_counts(counts, _abft.count_event(
                    det, cor, kt, (k1 + pj) // nb))
            a[k0:k1, k1:] = u12
            if k1 < m:
                l21, tb = lu[w:, :w], a[k1:, k1:]
                if abft:
                    exp_row = tb.sum(dim=1) - l21 @ u12.sum(dim=1)
                    exp_col = tb.sum(dim=0) - l21.sum(dim=0) @ u12
                _update_trailing(tb, l21, u12)
                if abft:
                    _, ev = _abft.sum_check(tb, exp_row, exp_col, n_ctx=m,
                                            nb=nb, row0=k1, col0=k1)
                    counts = _abft.add_counts(counts, ev)
    return a, perm_g, counts


def getrf(A: Matrix, opts: Options | None = None) -> LUFactors:
    """LU with partial pivoting (ref: src/getrf.cc).

    Failure contract (Option.ErrorPolicy): Raise raises
    :class:`SlateSingularError` on an exactly-zero or non-finite pivot;
    Info returns ``(LUFactors, HealthInfo)``; Nan NaN-fills the factor."""
    return _getrf(A, opts, "partial")


def getrf_nopiv(A: Matrix, opts: Options | None = None) -> LUFactors:
    """LU without pivoting (ref: src/getrf_nopiv.cc)."""
    return _getrf(A, opts, "nopiv")


def getrf_tntpiv(A: Matrix, opts: Options | None = None) -> LUFactors:
    """CALU tournament-pivoting LU (ref: src/getrf_tntpiv.cc)."""
    return _getrf(A, opts, "tntpiv")


class RBTFactors:
    """Factors of the butterfly-preconditioned pivot-free LU (getrf_rbt):
    ``F`` is the NoPiv LUFactors of the transformed padded matrix
    A~ = U^T diag(A, I_pad) V, ``u``/``v`` the two depth-2 butterflies
    (internal/rbt.py level tuples) and ``n`` the logical size.  getrs
    dispatches on this type: x = V (A~^-1 (U^T [b; 0]))[:n]."""

    def __init__(self, F: LUFactors, u, v, n: int):
        self.F = F
        self.u = u
        self.v = v
        self.n = n

    def __repr__(self):
        return (f"RBTFactors(n={self.n}, padded={self.F.LU.m}, "
                f"depth={len(self.u)})")


# the reference's butterfly seed: the transform is a preconditioner, and
# the same seed draws the same butterflies in both packages
_RBT_SEED = 0x5B17


def _info(opts: Options | None) -> dict:
    o = dict(opts or {})
    o[Option.ErrorPolicy] = ErrorPolicy.Info
    return o


def getrf_rbt(A: Matrix, opts: Options | None = None):
    """Butterfly-preconditioned pivot-free LU (PRBT): A~ = U^T diag(A,
    I_pad) V with depth-2 random butterflies (internal/rbt.py), then
    :func:`getrf_nopiv` on A~.  Returns :class:`RBTFactors`; health is the
    NoPiv factor's over the transformed matrix."""
    slate_error(A.m == A.n, "getrf_rbt: square matrices (gesv path)")
    n, nb = A.m, A.nb
    resolve_target(opts, A)
    nt = rbt.padded_size(n)
    ad = faults.maybe_corrupt("input", A.to_dense())
    abar = torch.zeros((nt, nt), dtype=ad.dtype, device=ad.device)
    abar[:n, :n] = ad
    if nt > n:
        r = torch.arange(n, nt, device=ad.device)
        abar[r, r] = 1
    u = rbt.generate(nt, seed=_RBT_SEED, dtype=ad.dtype, device=ad.device)
    v = rbt.generate(nt, seed=_RBT_SEED + 1, dtype=ad.dtype,
                     device=ad.device)
    at = faults.maybe_corrupt("post_rbt", rbt.transform(abar, u, v))
    At = Matrix(TileStorage.from_dense(at, nb, nb, A.grid))
    Fi, fh = getrf_nopiv(At, _info(opts))
    return _health.finalize("getrf_rbt", RBTFactors(Fi, u, v, n), fh, opts,
                            _singular("getrf_rbt"))


def _lu_health(factor: torch.Tensor, minpiv: torch.Tensor,
               minidx: torch.Tensor, amax: torch.Tensor,
               counts: _abft.AbftCounts):
    """The LU HealthInfo: pivot record, whole-factor finiteness, the pivot
    growth max|factor| / max|A| and the checksum counts, read from the
    device at once."""
    fmax, mp, mi, am, finite, det, cor, site = torch.stack([
        factor.abs().max().double(), minpiv.double(), minidx.double(),
        amax.double(), torch.isfinite(factor).all().double(),
        *(c.double() for c in counts)]).tolist()
    bad = mp == 0 or not math.isfinite(mp)
    return _health.healthy()._replace(
        nonfinite=not finite,
        info=int(mi) + 1 if bad else 0,
        min_pivot=mp,
        min_pivot_index=int(mi),
        growth=fmax / am if am > 0 else math.inf,
        abft_detected=int(det), abft_corrected=int(cor),
        abft_site=int(site))


def _getrf(A: Matrix, opts: Options | None, method: str):
    resolve_target(opts, A)
    abft = resolve_abft(opts)  # the one Option.Abft read (driver boundary)
    tau = float(get_option(opts, Option.PivotThreshold))
    mpt = int(get_option(opts, Option.MaxPanelThreads))
    depth = int(get_option(opts, Option.Depth))
    # to_dense may share memory with the caller's tiles; factor a copy
    # (a struck copy, when the input site is armed)
    ad = faults.maybe_corrupt("input", A.to_dense())
    ad = ad.clone(memory_format=torch.contiguous_format)
    amax = ad.abs().max()
    lu, perm, counts = _getrf_dense_blocked(ad, A.nb, method, tau=tau,
                                            mpt=mpt, depth=depth, abft=abft)
    F = LUFactors(Matrix(TileStorage.from_dense(lu, A.nb, A.nb, A.grid)),
                  perm)
    udiag = torch.diagonal(lu).abs()
    h = _lu_health(lu, udiag.amin(), torch.argmin(udiag), amax, counts)
    return _health.finalize(f"getrf[{method}]", F, h, opts,
                            _singular(f"getrf[{method}]"))


def _singular(name: str):
    return lambda h: SlateSingularError(
        f"{name}: exactly-singular or non-finite factor "
        f"({h.describe()})", info=h.info)


def getrf_ooc(*args, **kwargs):
    """Out-of-core LU of a host-resident matrix (ref: drivers/lu.py:373):
    not ported, always raises NotImplementedError."""
    raise not_ported("getrf_ooc (out-of-core LU with host offload and "
                     "checkpoints)", "queue 1, item 13 (durable jobs)")


def _getrs_rbt(F: RBTFactors, B, opts: Options | None) -> Matrix:
    """getrs for RBT factors: x = V (A~^-1 (U^T [b; 0]))[:n], with no
    refinement (that belongs to the speculative gesv rung)."""
    slate_error(F.n == B.m, "getrs: dims")
    nt = F.F.LU.m
    bd = B.to_dense()
    bbar = torch.zeros((nt, bd.shape[1]), dtype=bd.dtype, device=bd.device)
    bbar[:F.n] = bd
    Yt = Matrix(TileStorage.from_dense(rbt.apply_left_t(F.u, bbar),
                                       F.F.LU.nb, B.nb, B.grid))
    Z = getrs(F.F, Yt, opts)
    xbar = rbt.apply_left(F.v, Z.to_dense())
    return Matrix(TileStorage.from_dense(xbar[:F.n], B.mb, B.nb, B.grid))


def getrs(F: LUFactors, B, opts: Options | None = None) -> Matrix:
    """Solve with LU factors: X = U^-1 L^-1 B[perm] (ref: src/getrs.cc).
    :class:`RBTFactors` take the butterfly sandwich."""
    if isinstance(F, RBTFactors):
        return _getrs_rbt(F, B, opts)
    slate_error(F.LU.m == B.m, "getrs: dims")
    resolve_target(opts, B)
    Bp = Matrix(TileStorage.from_dense(B.to_dense()[F.perm], B.mb, B.nb,
                                       B.grid))
    Y = trsm("l", 1.0, F.lower(), Bp, opts)
    return trsm("l", 1.0, F.upper(), Y, opts)


def gesv(A: Matrix, B, opts: Options | None = None):
    """Solve A X = B via LU (ref: src/gesv.cc; MethodLU dispatch).  Returns
    (LUFactors, X), or (LUFactors, X, HealthInfo) under ErrorPolicy.Info;
    with Option.UseFallbackSolver an unhealthy factor escalates the
    pivoting (NoPiv -> PartialPiv -> CALU), see robust/recovery.py."""
    from ..robust.recovery import gesv_with_recovery
    return gesv_with_recovery(A, B, opts)


def gesv_nopiv(A: Matrix, B, opts: Options | None = None):
    """ref: src/gesv_nopiv.cc: the raw NoPiv solve, no escalation."""
    from ..robust.recovery import gesv_nopiv_raw
    return gesv_nopiv_raw(A, B, opts)


def getri(F: LUFactors, opts: Options | None = None) -> Matrix:
    """Inverse from LU factors, A^-1 = U^-1 L^-1 P (ref: src/getri.cc).
    A zero or non-finite U pivot resolves per Option.ErrorPolicy: raise
    :class:`SlateSingularError` with ``info = k``, NaN-fill, or
    ``(X, HealthInfo)``."""
    n = F.LU.m
    eye = torch.eye(n, dtype=F.LU.dtype, device=F.LU.device)
    X = getrs(F, Matrix(TileStorage.from_dense(eye, F.LU.mb, F.LU.nb,
                                               F.LU.grid)), opts)
    h = _health.merge(_health.from_pivots(torch.diagonal(F.LU.to_dense())),
                      _health.from_result(X.storage.data))
    return _health.finalize("getri", X, h, opts, _singular("getri"))


def getriOOP(A: Matrix, opts: Options | None = None) -> Matrix:
    """Out-of-place inverse (ref: src/getriOOP.cc): factor, then solve
    against I.  Under ErrorPolicy.Info returns ``(X, HealthInfo)`` with
    the factor's and the inverse's health merged."""
    if _health.error_policy(opts) is ErrorPolicy.Info:
        F, fh = getrf(A, opts)
        X, ih = getri(F, opts)
        return X, _health.merge(fh, ih)
    return getri(getrf(A, opts), opts)
