"""Simplified API: verb-named veneer over the LAPACK-named drivers (port
of slate_tpu/api/__init__.py; ref: include/slate/simplified_api.hh).

Readable names (``multiply``, ``lu_solve``, ``chol_factor``,
``least_squares_solve``, ...) map onto the classic drivers, dispatching on
matrix structure as the C++ overload set does (general, Hermitian,
symmetric, triangular and band pick gemm/hemm/symm/gbmm/hbmm, gesv/gbsv,
posv/pbsv, ...).  Every verb returns its result and takes the drivers'
``opts``.  The batch verbs run the serving layer's batched cores
(serve/batched.py ``make_batched``) on one same-shaped stack, which
reaches K6-K8 on the card where the stack's shape passes their gates.
The spectral verbs (``eig``, ``eig_vals``, ``svd``, ``svd_vals``) call
heev and svd with their certified escalation ladders.

    import slate_tpu_torch as st
    from slate_tpu_torch import api

    C = api.multiply(1.0, A, B)              # gemm/hemm/symm/gbmm/hbmm
    X = api.lu_solve(A, B)                   # gesv
    L = api.chol_factor(H)                   # potrf
"""

from __future__ import annotations

import torch

from ..core.matrix import (BandMatrix, BaseTrapezoidMatrix,
                           HermitianBandMatrix, HermitianMatrix,
                           SymmetricMatrix, TriangularBandMatrix,
                           TriangularMatrix)
from ..drivers import auxiliary as _aux
from ..drivers import band as _band
from ..drivers import blas3 as _blas3
from ..drivers import cholesky as _chol
from ..drivers import heev as _heev
from ..drivers import hetrf as _hetrf
from ..drivers import lu as _lu
from ..drivers import qr as _qr
from ..drivers import svd as _svd
from ..exceptions import slate_error
from ..types import Side

__all__ = [
    "multiply", "triangular_multiply", "triangular_solve",
    "rank_k_update", "rank_2k_update",
    "lu_solve", "lu_solve_nopiv", "lu_factor", "lu_factor_nopiv",
    "lu_solve_using_factor", "lu_solve_using_factor_nopiv",
    "lu_inverse_using_factor", "lu_inverse_using_factor_out_of_place",
    "band_lu_solve",
    "chol_solve", "chol_factor", "chol_solve_using_factor",
    "chol_inverse_using_factor", "band_chol_solve",
    "indefinite_solve", "indefinite_factor", "indefinite_solve_using_factor",
    "least_squares_solve",
    "qr_factor", "qr_multiply_by_q", "lq_factor", "lq_multiply_by_q",
    "eig", "eig_vals", "svd", "svd_vals",
    "norm", "add", "copy", "scale",
    "batch_solve", "batch_chol_solve", "batch_least_squares_solve",
]


# ------------------------------------------------------------------ BLAS-3

def multiply(alpha, A, B, beta=0.0, C=None, opts=None):
    """C = alpha A B + beta C, dispatching on structure (ref:
    simplified_api.hh multiply overload set -> gemm/hemm/symm/gbmm/hbmm)."""
    if isinstance(A, HermitianBandMatrix):
        return _band.hbmm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, HermitianBandMatrix):
        return _band.hbmm(Side.Right, alpha, B, A, beta, C, opts)
    if isinstance(A, BandMatrix):
        return _band.gbmm(alpha, A, B, beta, C, opts)
    if isinstance(A, HermitianMatrix):
        return _blas3.hemm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, HermitianMatrix):
        return _blas3.hemm(Side.Right, alpha, B, A, beta, C, opts)
    if isinstance(A, SymmetricMatrix):
        return _blas3.symm(Side.Left, alpha, A, B, beta, C, opts)
    if isinstance(B, SymmetricMatrix):
        return _blas3.symm(Side.Right, alpha, B, A, beta, C, opts)
    return _blas3.gemm(alpha, A, B, beta, C, opts)


def triangular_multiply(alpha, A, B, opts=None):
    """B = alpha A B (A triangular) or alpha B A (B triangular)
    (ref: simplified_api.hh triangular_multiply -> trmm)."""
    if isinstance(A, TriangularMatrix):
        return _blas3.trmm(Side.Left, alpha, A, B, opts)
    slate_error(isinstance(B, TriangularMatrix),
                "triangular_multiply: one operand must be triangular")
    return _blas3.trmm(Side.Right, alpha, B, A, opts)


def triangular_solve(alpha, A, B, opts=None):
    """Solve A X = alpha B (A triangular first) or X A = alpha B
    (triangular second); band-triangular A rides tbsm
    (ref: simplified_api.hh triangular_solve -> trsm/tbsm)."""
    if isinstance(A, TriangularBandMatrix):
        return _band.tbsm(Side.Left, alpha, A, B, opts=opts)
    if isinstance(A, TriangularMatrix):
        return _blas3.trsm(Side.Left, alpha, A, B, opts)
    if isinstance(B, TriangularBandMatrix):
        return _band.tbsm(Side.Right, alpha, B, A, opts=opts)
    slate_error(isinstance(B, TriangularMatrix),
                "triangular_solve: one operand must be triangular")
    return _blas3.trsm(Side.Right, alpha, B, A, opts)


def rank_k_update(alpha, A, beta, C, opts=None):
    """C = alpha A A^{H|T} + beta C (ref: rank_k_update -> herk/syrk)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "rank_k_update: C must be Hermitian or symmetric")
    if isinstance(C, SymmetricMatrix):
        return _blas3.syrk(alpha, A, beta, C, opts)
    return _blas3.herk(alpha, A, beta, C, opts)


def rank_2k_update(alpha, A, B, beta, C, opts=None):
    """C = alpha A B^{H|T} + (conj)(alpha) B A^{H|T} + beta C
    (ref: rank_2k_update -> her2k/syr2k)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "rank_2k_update: C must be Hermitian or symmetric")
    if isinstance(C, SymmetricMatrix):
        return _blas3.syr2k(alpha, A, B, beta, C, opts)
    return _blas3.her2k(alpha, A, B, beta, C, opts)


# ------------------------------------------------------------------ LU

def lu_solve(A, B, opts=None):
    """Solve A X = B via partial-pivot LU; band A rides gbsv
    (ref: lu_solve -> gesv / gbsv).  Returns X."""
    if isinstance(A, BandMatrix):
        _, X = _band.gbsv(A, B, opts)
        return X
    _, X = _lu.gesv(A, B, opts)
    return X


band_lu_solve = lu_solve


def lu_solve_nopiv(A, B, opts=None):
    """ref: lu_solve_nopiv -> gesv_nopiv.  Returns X."""
    _, X = _lu.gesv_nopiv(A, B, opts)
    return X


def lu_factor(A, opts=None):
    """ref: lu_factor -> getrf / gbtrf (band)."""
    if isinstance(A, BandMatrix):
        return _band.gbtrf(A, opts)
    return _lu.getrf(A, opts)


def lu_factor_nopiv(A, opts=None):
    """ref: lu_factor_nopiv -> getrf_nopiv."""
    return _lu.getrf_nopiv(A, opts)


def lu_solve_using_factor(F, B, opts=None):
    """ref: lu_solve_using_factor -> getrs / gbtrs (band factors)."""
    if isinstance(F, _band.GBFactors):
        return _band.gbtrs(F, B, opts)
    return _lu.getrs(F, B, opts)


lu_solve_using_factor_nopiv = lu_solve_using_factor


def lu_inverse_using_factor(F, opts=None):
    """ref: lu_inverse_using_factor -> getri."""
    return _lu.getri(F, opts)


def lu_inverse_using_factor_out_of_place(A, opts=None):
    """ref: lu_inverse_using_factor_out_of_place -> getriOOP."""
    return _lu.getriOOP(A, opts)


# ------------------------------------------------------------------ Cholesky

def chol_solve(A, B, opts=None):
    """Solve A X = B, A positive definite; band A rides pbsv
    (ref: chol_solve -> posv / pbsv).  Returns X."""
    if isinstance(A, HermitianBandMatrix):
        _, X = _band.pbsv(A, B, opts)
        return X
    _, X = _chol.posv(A, B, opts)
    return X


band_chol_solve = chol_solve


def chol_factor(A, opts=None):
    """ref: chol_factor -> potrf / pbtrf (band)."""
    if isinstance(A, HermitianBandMatrix):
        return _band.pbtrf(A, opts)
    return _chol.potrf(A, opts)


def chol_solve_using_factor(F, B, opts=None):
    """ref: chol_solve_using_factor -> potrs / pbtrs (band factors)."""
    if isinstance(F, _band.PBFactors):
        return _band.pbtrs(F, B, opts)
    return _chol.potrs(F, B, opts)


def chol_inverse_using_factor(L, opts=None):
    """ref: chol_inverse_using_factor -> potri."""
    return _chol.potri(L, opts)


# ------------------------------------------------------------------ indefinite

def indefinite_solve(A, B, opts=None):
    """Solve A X = B, A Hermitian indefinite (ref: indefinite_solve ->
    hesv, Aasen's factorization).  Returns X."""
    _, X = _hetrf.hesv(A, B, opts)
    return X


def indefinite_factor(A, opts=None):
    """ref: indefinite_factor -> hetrf."""
    return _hetrf.hetrf(A, opts)


def indefinite_solve_using_factor(F, B, opts=None):
    """ref: indefinite_solve_using_factor -> hetrs."""
    return _hetrf.hetrs(F, B, opts)


# ------------------------------------------------------------------ QR / LS

def least_squares_solve(A, B, opts=None):
    """min ||A X - B||_2 (ref: least_squares_solve -> gels, QR vs CholQR
    by MethodGels).  Returns X."""
    return _qr.gels(A, B, opts)


def qr_factor(A, opts=None):
    """ref: qr_factor -> geqrf (CAQR on mesh)."""
    return _qr.geqrf(A, opts)


def qr_multiply_by_q(side, op, F, C, opts=None):
    """C = op(Q) C or C op(Q) (ref: qr_multiply_by_q -> unmqr)."""
    return _qr.unmqr(side, op, F, C, opts)


def lq_factor(A, opts=None):
    """ref: lq_factor -> gelqf."""
    return _qr.gelqf(A, opts)


def lq_multiply_by_q(side, op, F, C, opts=None):
    """ref: lq_multiply_by_q -> unmlq."""
    return _qr.unmlq(side, op, F, C, opts)


# ------------------------------------------------------------------ eig / SVD

def eig(A, opts=None):
    """Full Hermitian eigendecomposition (ref: simplified heev call).
    Returns (eigenvalues, eigenvector Matrix)."""
    return _heev.heev(A, opts)


def eig_vals(A, opts=None):
    """Eigenvalues only (ref: eig_vals -> heev with Job::NoVec)."""
    return _heev.heev_vals(A, opts)


def svd(A, opts=None):
    """Full SVD (ref: simplified svd call).  Returns per drivers.svd."""
    return _svd.svd(A, opts)


def svd_vals(A, opts=None):
    """Singular values only (ref: svd_vals)."""
    return _svd.svd_vals(A, opts)


# ------------------------------------------------------------------ batched
#
# Leading-axis entry points over the serving layer's batched cores: one
# stack of same-shaped dense problems in, the solutions with one
# HealthInfo and one escalation flag a problem out.  Mixed sizes go
# through serve.Server, which buckets and packs before reaching the same
# cores.


def _full_sizes(a: torch.Tensor, live: int) -> torch.Tensor:
    """Every problem of a same-shaped stack is full size: the constant
    sizes vector the batched cores take."""
    return torch.full((a.shape[0],), live, dtype=torch.int32,
                      device=a.device)


def batch_solve(a, b, opts=None):
    """Solve A_i X_i = B_i over the leading axis: ``a`` is (batch, n, n),
    ``b`` (batch, n, k).  Returns ``(x, [HealthInfo], [escalated])``:
    NoPiv fast rung, partial-pivot LU escalation per problem."""
    from ..serve import batched as _batched
    return _batched.make_batched("solve", opts)(
        a, b, _full_sizes(a, int(a.shape[1])))


def batch_chol_solve(a, b, opts=None):
    """Solve the HPD systems A_i X_i = B_i over the leading axis (``a``
    holds full symmetric matrices): Cholesky fast rung, LU escalation for
    indefinite members."""
    from ..serve import batched as _batched
    return _batched.make_batched("chol_solve", opts)(
        a, b, _full_sizes(a, int(a.shape[1])))


def batch_least_squares_solve(a, b, opts=None):
    """min ||A_i X_i - B_i|| over the leading axis, m >= n: CholQR
    semi-normal equations with per-problem Householder QR escalation.
    x has shape (batch, n, k)."""
    from ..serve import batched as _batched
    return _batched.make_batched("least_squares_solve", opts)(
        a, b, _full_sizes(a, int(a.shape[1])))


# ------------------------------------------------------------------ aux

norm = _aux.norm
add = _aux.add
copy = _aux.copy
scale = _aux.scale
