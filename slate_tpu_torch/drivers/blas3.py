"""BLAS-3 drivers (port of the single-device path of
slate_tpu/drivers/blas3.py): gemm (gemmA/gemmC), trsm, trmm, herk/syrk,
her2k/syr2k, hemm/symm (hemmA) and ``as_root_general``.

The reference computes all of them outside any Pallas kernel (XLA's
matmul), so here they are ``torch.matmul`` on the dense view: cuBLAS in
full f32 on the card (the package turns TF32 off).  On one device
``MethodGemm``/``MethodHemm`` select nothing, but they are read and
validated where the reference reads them; ``Target.mesh`` raises.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.matrix import (BaseMatrix, BaseTrapezoidMatrix, HermitianMatrix,
                           Matrix, SymmetricMatrix)
from ..core.storage import TileStorage
from ..exceptions import slate_error
from ..options import (MethodGemm, MethodHemm, Option, Options,
                       method_option, resolve_abft, resolve_target,
                       select_gemm_method)
from ..robust import abft as _abft
from ..types import Diag, Op, Side, Uplo
from ..util.trace import annotate


def as_root_general(A: BaseMatrix, mb: int | None = None,
                    nb: int | None = None,
                    grid: Grid | None = None) -> Matrix:
    """Normalise any view/op/structure to a root general Matrix with the
    given tile sizes (materialises only when needed)."""
    mb = mb or A.mb
    nb = nb or A.nb
    grid = grid or A.grid
    if (type(A) is Matrix and A.op is Op.NoTrans and A.is_root_view()
            and A.mb == mb and A.nb == nb and A.grid is grid):
        return A
    return Matrix(TileStorage.from_dense(A.to_dense(), mb, nb, grid))


def _dense_to_like(C: BaseMatrix, dense: torch.Tensor) -> Matrix:
    """A general Matrix holding ``dense`` in C's tiling."""
    return Matrix(TileStorage.from_dense(dense, C.mb, C.nb, C.grid))


def _side(side) -> Side:
    if isinstance(side, Side):
        return side
    return Side.Left if str(side).lower().startswith("l") else Side.Right


def _conj(alpha):
    """The conjugate of a Python or tensor scalar."""
    return alpha.conj() if isinstance(alpha, torch.Tensor) \
        else alpha.conjugate()


def _same_device(*mats) -> None:
    dev = mats[0].device
    slate_error(all(M.device == dev for M in mats),
                f"operands on different devices: "
                f"{[str(M.device) for M in mats]}")


# ---------------------------------------------------------------- gemm

@annotate("slate.gemm")
def gemm(alpha, A: BaseMatrix, B: BaseMatrix, beta=0.0,
         C: Matrix | None = None, opts: Options | None = None) -> Matrix:
    """C = alpha op(A) op(B) + beta C (ref: src/gemm.cc, gemmC.cc).  One
    matmul on the dense views; a literal alpha = 1 or beta = 0 skips its
    pass (0 * C is not folded: 0 * NaN is NaN), and without C the result
    is a new matrix in A's row and B's column tiling.  ``Option.Abft``
    verifies the product through its checksums (robust/abft.py) and
    repairs one corrupted element in place."""
    slate_error(A.n == B.m, "gemm: inner dims differ")
    _same_device(A, B)
    if C is None:
        dt = torch.promote_types(A.dtype, B.dtype)
        C = Matrix.zeros(A.m, B.n, A.mb, B.nb, A.grid, dt, A.device)
        beta = 0.0
    slate_error(C.m == A.m and C.n == B.n, "gemm: C dims differ")
    _same_device(A, C)
    resolve_target(opts, C)
    select_gemm_method(opts, C.nt)         # one device: the same product
    abft = resolve_abft(opts)  # the one Option.Abft read (driver boundary)
    dt = C.dtype
    Ad, Bd = A.to_dense().to(dt), B.to_dense().to(dt)
    Cd = Ad @ Bd
    if abft:
        # additive checksums of the raw product; gemm has no health
        # channel, so this is SILENT repair of a single struck element (an
        # uncorrectable multi-strike is left for the caller's certificate)
        Cd, _ = _abft.sum_check(Cd, Ad @ Bd.sum(dim=1), Ad.sum(dim=0) @ Bd,
                                n_ctx=A.n)
    if not (isinstance(alpha, (int, float)) and alpha == 1.0):
        Cd = alpha * Cd
    if not (isinstance(beta, (int, float)) and beta == 0.0):
        Cd = Cd + beta * C.to_dense()
    return C.with_dense(Cd) if type(C) is Matrix else _dense_to_like(C, Cd)


def gemmA(alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """Stationary-A gemm (ref: src/gemmA.cc); on one device, gemm."""
    return gemm(alpha, A, B, beta, C,
                {**(opts or {}), Option.MethodGemm: MethodGemm.gemmA})


def gemmC(alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """Stationary-C gemm (ref: src/gemmC.cc); on one device, gemm."""
    return gemm(alpha, A, B, beta, C,
                {**(opts or {}), Option.MethodGemm: MethodGemm.gemmC})


# ---------------------------------------------------------------- trsm/trmm

@annotate("slate.trsm")
def trsm(side, alpha, A, B, opts: Options | None = None) -> Matrix:
    """Solve op(A) X = alpha B (Left) or X op(A) = alpha B (Right), A
    triangular (ref: src/trsm.cc).  From two block rows up, block
    substitution against the batch-inverted diagonal blocks
    (internal/trsm.py), whose solve ``Option.Abft`` verifies through B's
    checksums with a silent single-element repair; below that one
    ``torch.linalg.solve_triangular``, unchecked, as in the reference."""
    sd = _side(side)
    slate_error(isinstance(A, BaseTrapezoidMatrix), "trsm: A not triangular")
    slate_error(A._m_store() == A._n_store(), "trsm: A not square")
    if sd is Side.Left:
        slate_error(A.n == B.m, "trsm: dims")
    else:
        slate_error(B.n == A.m, "trsm: dims")
    slate_error(A.device == B.device,
                f"trsm: A on {A.device}, B on {B.device}")
    resolve_target(opts, B)
    check = resolve_abft(opts)
    unit = A.diag is Diag.Unit
    ad = A._dense_store()                  # storage triangle, op separate
    bd = alpha * B.to_dense()
    lower = A.uplo is Uplo.Lower
    trans, conj = A.op is not Op.NoTrans, A.op is Op.ConjTrans
    nb = A.storage.nb
    if ad.shape[0] >= 2 * nb:
        from ..internal.trsm import trsm_left_blocked, trsm_right_blocked
        kw = dict(lower=lower, trans=trans, conj=conj, unit=unit, nb=nb,
                  check=check)
        xd = (trsm_left_blocked(ad, bd, **kw) if sd is Side.Left
              else trsm_right_blocked(ad, bd, **kw))
        return _dense_to_like(B, xd)
    a_op = ad.conj() if conj else ad
    if trans:
        a_op = a_op.T
    xd = torch.linalg.solve_triangular(
        a_op, bd, upper=(lower == trans), left=(sd is Side.Left),
        unitriangular=unit)
    return _dense_to_like(B, xd)


@annotate("slate.trmm")
def trmm(side, alpha, A, B, opts: Options | None = None) -> Matrix:
    """B = alpha op(A) B (Left) or alpha B op(A) (Right), A triangular
    (ref: src/trmm.cc): one matmul with the expanded triangle."""
    sd = _side(side)
    _same_device(A, B)
    resolve_target(opts, B)
    ad = A.to_dense()                      # expands triangle incl. unit diag
    bd = B.to_dense()
    out = alpha * (ad @ bd) if sd is Side.Left else alpha * (bd @ ad)
    return _dense_to_like(B, out)


# ---------------------------------------------------------------- rank-k

def _general_of(C) -> Matrix:
    """General matrix holding C's expanded structure."""
    return C if type(C) is Matrix else C.general()


@annotate("slate.herk")
def herk(alpha, A, beta, C, opts: Options | None = None):
    """C = alpha A A^H + beta C, C Hermitian (ref: src/herk.cc): gemm on
    the expanded C, returned as a Hermitian view of C's triangle."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "herk: C must be Hermitian/Symmetric")
    slate_error(A.m == C.m, "herk: dims")
    out = gemm(alpha, A, A.conj_transpose(), beta, _general_of(C), opts)
    return HermitianMatrix._from_view(out, C._uplo_logical())


@annotate("slate.syrk")
def syrk(alpha, A, beta, C, opts: Options | None = None):
    """C = alpha A A^T + beta C, C symmetric (ref: src/syrk.cc)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "syrk: C must be Symmetric")
    out = gemm(alpha, A, A.transpose(), beta, _general_of(C), opts)
    return SymmetricMatrix._from_view(out, C._uplo_logical())


@annotate("slate.her2k")
def her2k(alpha, A, B, beta, C, opts: Options | None = None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (ref: src/her2k.cc)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "her2k: C must be Hermitian")
    t1 = gemm(alpha, A, B.conj_transpose(), beta, _general_of(C), opts)
    out = gemm(_conj(alpha), B, A.conj_transpose(), 1.0, t1, opts)
    return HermitianMatrix._from_view(out, C._uplo_logical())


@annotate("slate.syr2k")
def syr2k(alpha, A, B, beta, C, opts: Options | None = None):
    """C = alpha A B^T + alpha B A^T + beta C (ref: src/syr2k.cc)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "syr2k: C must be Symmetric")
    t1 = gemm(alpha, A, B.transpose(), beta, _general_of(C), opts)
    out = gemm(alpha, B, A.transpose(), 1.0, t1, opts)
    return SymmetricMatrix._from_view(out, C._uplo_logical())


@annotate("slate.hemm")
def hemm(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """C = alpha A B + beta C (Left) or alpha B A + beta C (Right), A
    Hermitian (ref: src/hemm.cc).  MethodHemm is read and validated; the
    reference uses it only to pick a mesh communication pattern, so on
    one device every choice is gemm of the expanded A."""
    sd = _side(side)
    method_option(opts, Option.MethodHemm, MethodHemm)
    if sd is Side.Left:
        return gemm(alpha, A, B, beta, C, opts)
    return gemm(alpha, B, A, beta, C, opts)


def symm(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """C = alpha A B + beta C with A symmetric (ref: src/symm.cc)."""
    return hemm(side, alpha, A, B, beta, C, opts)


def hemmA(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """Stationary-A hemm (ref: src/hemmA.cc): forces gemmA on the Left
    only, as the reference does."""
    o = dict(opts or {})
    if _side(side) is Side.Left:
        o[Option.MethodGemm] = MethodGemm.gemmA
    return hemm(side, alpha, A, B, beta, C, o)
