"""Band drivers: pbsv/pbtrf/pbtrs, gbsv/gbtrf/gbtrs, tbsm, gbmm, hbmm
(port of slate_tpu/drivers/band.py; ref: src/pbsv.cc, pbtrf.cc, pbtrs.cc,
gbsv.cc, gbtrf.cc, gbtrs.cc, tbsm.cc, gbmm.cc, hbmm.cc).

The algorithms run on LAPACK-style packed band storage
(internal/band.py): O(n bandwidth^2) work in dense windows, none of it in
a Pallas kernel in the reference, so on the card they are library calls.
The matrix-class signatures are the reference's.  The fault sites
``input`` and ``solve`` sit where the reference's do (robust/faults.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.matrix import (BandMatrix, HermitianBandMatrix, Matrix,
                           TriangularBandMatrix)
from ..core.storage import TileStorage
from ..exceptions import (SlateNotPositiveDefiniteError, SlateSingularError,
                          slate_error)
from ..internal.band import (band_transpose, banded_trsm_lower,
                             banded_trsm_upper, dense_to_banded,
                             gbmm_banded, gbtrf_banded, gbtrs_banded,
                             hermitian_band_expand, pbtrf_banded,
                             pbtrs_banded)
from ..options import ErrorPolicy, Option, Options
from ..robust import faults
from ..robust import health as _health
from ..types import Diag, Op, Side, Uplo
from ..util.trace import annotate
from .blas3 import _conj, _side


def _block_width(nb: int, band: int) -> int:
    """Window block width: the tile size, floored so tiny bands still get
    reasonably square windows."""
    return max(min(nb, max(band, 8)), 1)


class PBFactors(NamedTuple):
    """Packed Cholesky factor of a Hermitian positive-definite band
    matrix: L lower band [kd+1, n] with A = L L^H."""
    L_band: torch.Tensor
    kd: int
    n: int
    w: int

    def solve(self, b):
        return pbtrs_banded(self.L_band, self.kd, self.n, self.w, b)


class GBFactors(NamedTuple):
    """Packed band LU: the working array (U rows 0..kl+ku, unit-L
    multipliers below) and each block's window permutation."""
    LU_band: torch.Tensor
    perms: torch.Tensor
    kl: int
    ku: int
    n: int
    w: int

    def solve(self, b):
        return gbtrs_banded(self.LU_band, self.perms, self.kl, self.ku,
                            self.n, self.w, b)


# ------------------------------------------------------------- packing

def _hermitian_band_packed(A: HermitianBandMatrix):
    """Lower packed [kd+1, n] with A.op applied: A^H = A, but A^T =
    conj(A)."""
    lp = dense_to_banded(A._expand(A._dense_store()), A.kd, 0)
    if A.op is Op.Trans:
        lp = lp.conj_physical()
    return lp, A.kd


def _general_band_packed(A: BandMatrix):
    """Packed [kl+ku+1, n] of the STORED band (A.op is applied by the
    caller through band_transpose)."""
    return dense_to_banded(A._expand(A._dense_store()), A.kl, A.ku)


def _as_dense_rhs(B):
    if isinstance(B, Matrix):
        return B.to_dense(), B
    return torch.as_tensor(B), None


def _wrap_like(x, Bm):
    if Bm is None:
        return x
    return Matrix(TileStorage.from_dense(x, Bm.mb, Bm.nb, Bm.grid))


def _with_policy(opts: Options | None, policy: ErrorPolicy) -> dict:
    o = dict(opts or {})
    o[Option.ErrorPolicy] = policy
    return o


def _raw(X):
    return X.storage.data if isinstance(X, Matrix) else X


def _finalize_band_solve(name, F, X, h, opts, make_exc):
    res = _health.finalize(name, (F, X), h, opts, make_exc)
    if _health.error_policy(opts) is ErrorPolicy.Info:
        (F, X), h = res
        return F, X, h
    return res


# ------------------------------------------------------------- pb chain

@annotate("slate.pbtrf")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def pbtrf(A: HermitianBandMatrix, opts: Options | None = None) -> PBFactors:
    """Band Cholesky A = L L^H (ref: src/pbtrf.cc).  A matrix that is not
    positive definite NaN-fills the failing block, which reads on the
    packed diagonal as ``info``."""
    slate_error(isinstance(A, HermitianBandMatrix),
                "pbtrf: need HermitianBandMatrix")
    lp, kd = _hermitian_band_packed(A)
    lp = faults.maybe_corrupt("input", lp)
    n = A.m
    w = _block_width(A.nb, kd)
    lband = pbtrf_banded(lp, kd, n, w)
    h = _health.merge(_health.from_pivots(lband[0]),
                      _health.from_result(lband))
    return _health.finalize(
        "pbtrf", PBFactors(lband, kd, n, w), h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"pbtrf: not positive definite ({hh.describe()})",
            info=hh.info))


@annotate("slate.pbtrs")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def pbtrs(F: PBFactors, B, opts: Options | None = None):
    """Solve from pbtrf factors (ref: src/pbtrs.cc)."""
    b, Bm = _as_dense_rhs(B)
    return _wrap_like(faults.maybe_corrupt("solve", F.solve(b)), Bm)


@annotate("slate.pbsv")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def pbsv(A: HermitianBandMatrix, B, opts: Options | None = None):
    """Solve A X = B, A Hermitian positive-definite band (ref:
    src/pbsv.cc).  Returns (PBFactors, X); ``(F, X, HealthInfo)`` under
    ErrorPolicy.Info."""
    F, fh = pbtrf(A, _with_policy(opts, ErrorPolicy.Info))
    X = pbtrs(F, B, opts)
    h = _health.merge(fh, _health.from_result(_raw(X)))
    return _finalize_band_solve(
        "pbsv", F, X, h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"pbsv: not positive definite ({hh.describe()})",
            info=hh.info))


# ------------------------------------------------------------- gb chain

@annotate("slate.gbtrf")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def gbtrf(A: BandMatrix, opts: Options | None = None) -> GBFactors:
    """Band LU with partial pivoting (ref: src/gbtrf.cc).  Pivoting stays
    within kl rows below the diagonal, so the factorization runs on
    (w+kl)-row windows; U's bandwidth grows to kl+ku."""
    slate_error(isinstance(A, BandMatrix), "gbtrf: need BandMatrix")
    slate_error(A.m == A.n, "gbtrf: square (gbsv path)")
    kl, ku = A.kl, A.ku
    n = A.n
    gp0 = _general_band_packed(A)
    if A.op is not Op.NoTrans:
        gp0 = band_transpose(gp0, kl, ku, n, conj=(A.op is Op.ConjTrans))
        kl, ku = ku, kl
    # the working array, kl fill rows on top
    gp = torch.zeros((2 * kl + ku + 1, n), dtype=gp0.dtype,
                     device=gp0.device)
    gp[kl:] = gp0
    gp = faults.maybe_corrupt("input", gp)
    w = _block_width(A.nb, kl + ku)
    amax = gp.abs().max()
    lu, perms = gbtrf_banded(gp, kl, ku, n, w)
    # U's diagonal lives at packed row kl+ku: an exactly-zero or
    # non-finite pivot is a singular factorization
    lmax, am = torch.stack([lu.abs().max().double(),
                            amax.double()]).tolist()
    growth = lmax / am if am > 0 else float("inf")
    h = _health.merge(
        _health.from_pivots(lu[kl + ku])._replace(growth=growth),
        _health.from_result(lu))
    return _health.finalize(
        "gbtrf", GBFactors(lu, perms, kl, ku, n, w), h, opts,
        lambda hh: SlateSingularError(
            f"gbtrf: exactly-singular or non-finite factor "
            f"({hh.describe()})", info=hh.info))


@annotate("slate.gbtrs")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def gbtrs(F: GBFactors, B, opts: Options | None = None):
    """Solve from gbtrf factors (ref: src/gbtrs.cc)."""
    b, Bm = _as_dense_rhs(B)
    return _wrap_like(faults.maybe_corrupt("solve", F.solve(b)), Bm)


@annotate("slate.gbsv")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def gbsv(A: BandMatrix, B, opts: Options | None = None):
    """Solve A X = B, A general band (ref: src/gbsv.cc).  Returns
    (GBFactors, X); ``(F, X, HealthInfo)`` under ErrorPolicy.Info."""
    F, fh = gbtrf(A, _with_policy(opts, ErrorPolicy.Info))
    X = gbtrs(F, B, opts)
    h = _health.merge(fh, _health.from_result(_raw(X)))
    return _finalize_band_solve(
        "gbsv", F, X, h, opts,
        lambda hh: SlateSingularError(
            f"gbsv: singular band matrix ({hh.describe()})", info=hh.info))


# ------------------------------------------------------------- tbsm

@annotate("slate.tbsm")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def tbsm(side, alpha, A: TriangularBandMatrix, B,
         opts: Options | None = None):
    """Triangular band solve op(A) X = alpha B (Left) or X op(A) = alpha B
    (Right) (ref: src/tbsm.cc; the pivoted variant is gbtrs's job)."""
    slate_error(isinstance(A, TriangularBandMatrix),
                "tbsm: need TriangularBandMatrix")
    b, Bm = _as_dense_rhs(B)
    if _side(side) is Side.Right:
        # X op(A) = alpha B  <=>  op(A)^T X^T = alpha B^T
        return _wrap_like(_tbsm_left(A, alpha, b.T, extra_op=Op.Trans).T,
                          Bm)
    return _wrap_like(_tbsm_left(A, alpha, b, extra_op=Op.NoTrans), Bm)


def _tbsm_left(A: TriangularBandMatrix, alpha, b, extra_op: Op):
    """Solve op(A) X = alpha b with op = A.op (and the extra transpose of
    the right-side mapping)."""
    n = A.m
    kd = A.kd
    unit = A.diag is Diag.Unit
    w = _block_width(A.nb, kd)
    # the stored triangle masked to the band (with an explicit unit
    # diagonal, which the unit-diagonal solves then ignore)
    ad = A._expand(A._dense_store())
    op = A.op
    conj_extra = False
    if extra_op is Op.Trans:
        op = {Op.NoTrans: Op.Trans, Op.Trans: Op.NoTrans,
              Op.ConjTrans: Op.NoTrans}[op]
        conj_extra = A.op is Op.ConjTrans
    b = alpha * b
    if A.uplo is Uplo.Lower:
        lp = dense_to_banded(ad, kd, 0)
        if conj_extra:
            lp = lp.conj_physical()
        if op is Op.NoTrans:
            return banded_trsm_lower(lp, kd, n, w, b, unit_diag=unit)
        if op is Op.ConjTrans:
            return banded_trsm_lower(lp, kd, n, w, b, conj_trans=True,
                                     unit_diag=unit)
        # plain transpose: conjugate around the ConjTrans solve
        return banded_trsm_lower(lp, kd, n, w, b.conj(), conj_trans=True,
                                 unit_diag=unit).conj_physical()
    up = dense_to_banded(ad, 0, kd)
    if conj_extra:
        up = up.conj_physical()
    if op is Op.NoTrans:
        return banded_trsm_upper(up, kd, n, w, b, unit_diag=unit)
    # op(U) is a lower band: transpose the packed storage
    lpt = band_transpose(up, 0, kd, n, conj=(op is Op.ConjTrans))
    return banded_trsm_lower(lpt, kd, n, w, b, unit_diag=unit)


# ------------------------------------------------------------- band multiply

@annotate("slate.gbmm")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def gbmm(alpha, A: BandMatrix, B, beta=0.0, C=None,
         opts: Options | None = None):
    """C = alpha op(A) B + beta C with A band (ref: src/gbmm.cc)."""
    slate_error(isinstance(A, BandMatrix), "gbmm: need BandMatrix")
    gp = _general_band_packed(A)
    kl, ku = A.kl, A.ku
    m, n = A.m, A.n
    if A.op is not Op.NoTrans:
        slate_error(m == n, "gbmm: op on non-square band")
        gp = band_transpose(gp, kl, ku, n, conj=(A.op is Op.ConjTrans))
        kl, ku = ku, kl
    b, Bm = _as_dense_rhs(B)
    cd = C.to_dense() if isinstance(C, Matrix) else C
    out = gbmm_banded(gp, kl, ku, m, n, b, alpha, beta, cd)
    return _wrap_like(out, Bm if Bm is not None else C)


@annotate("slate.hbmm")  # slate-lint: disable=OBS002 -- band cost needs kl/ku, not recoverable from event shapes
def hbmm(side, alpha, A: HermitianBandMatrix, B, beta=0.0, C=None,
         opts: Options | None = None):
    """C = alpha A B + beta C with A Hermitian band (ref: src/hbmm.cc).
    The right side uses A^H = A: B A = (A B^H)^H."""
    slate_error(isinstance(A, HermitianBandMatrix), "hbmm: need "
                "HermitianBandMatrix")
    lp, kd = _hermitian_band_packed(A)
    gp = hermitian_band_expand(lp, kd, A.m)
    b, Bm = _as_dense_rhs(B)
    cd = C.to_dense() if isinstance(C, Matrix) else C
    like = Bm if Bm is not None else C
    if _side(side) is Side.Left:
        out = gbmm_banded(gp, kd, kd, A.m, A.m, b, alpha, beta, cd)
        return _wrap_like(out, like)
    # B A = (conj(alpha) A B^H)^H + beta C
    t = gbmm_banded(gp, kd, kd, A.m, A.m, b.conj().T, _conj(alpha), 0.0,
                    None)
    out = t.conj_physical().T + (beta * cd if cd is not None else 0)
    return _wrap_like(out, like)
