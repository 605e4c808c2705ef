"""BLAS-3 drivers (port of slate_tpu/drivers/blas3.py): gemm
(gemmA/gemmC), trsm, trmm, herk/syrk, her2k/syr2k, hemm/symm (hemmA) and
``as_root_general``.

Each driver validates shapes and resolves the execution target
(Option.Target).  The single route computes on the dense view, outside
any Pallas kernel in the reference (XLA's matmul), so here with
``torch.matmul``: cuBLAS in full f32 on the card (the package turns TF32
off).  The mesh route, where the target is mesh and the grid carries a
process group, runs the distributed kernels over the ranks' local tiles
(parallel/): SUMMA or gemmA for gemm (MethodGemm), the substitution
pipeline for trsm (MethodTrsm picks the grid when A and B differ), the
triangle-aware pair kernels for trmm and the rank-k updates.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.matrix import (BaseMatrix, BaseTrapezoidMatrix, HermitianMatrix,
                           Matrix, SymmetricMatrix)
from ..core.storage import TileStorage
from ..exceptions import slate_error
from ..options import (MethodGemm, MethodHemm, MethodTrsm, Option,
                       Options, method_option, on_mesh, resolve_abft,
                       select_gemm_method, select_trsm_method)
from ..robust import abft as _abft
from ..types import Diag, Op, Side, Uplo
from ..util.trace import annotate


def as_root_general(A: BaseMatrix, mb: int | None = None,
                    nb: int | None = None,
                    grid: Grid | None = None) -> Matrix:
    """Normalise any view/op/structure to a root general Matrix with the
    given tile sizes on the given grid (materialises and re-tiles only
    when needed: on a grid with a group, an all-gather on every rank).
    The mesh drivers use it so that their kernels see plain block-cyclic
    tiles laid out for the output's grid."""
    mb = mb or A.mb
    nb = nb or A.nb
    grid = grid or A.grid
    if (type(A) is Matrix and A.op is Op.NoTrans and A.is_root_view()
            and A.mb == mb and A.nb == nb and A.grid is grid):
        return A
    return Matrix(TileStorage.from_dense(A.to_dense(), mb, nb, grid))


def _result_mat(C: BaseMatrix, data: torch.Tensor) -> Matrix:
    """A general Matrix over C's tiling holding local tiles ``data``."""
    st = C.storage
    return Matrix(TileStorage(data, st.m, st.n, st.mb, st.nb, st.grid))


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
    """C = alpha op(A) op(B) + beta C (ref: src/gemm.cc:66-89 dispatch,
    gemmC.cc:29-192).  Single route: one matmul on the dense views; a
    literal alpha = 1 or beta = 0 skips its pass (0 * C is not folded:
    0 * NaN is NaN), and without C the result is a new matrix in A's row
    and B's column tiling.  ``Option.Abft`` verifies the product through
    its checksums (robust/abft.py) and repairs one corrupted element in
    place.  Mesh route: every operand normalised onto C's grid, then
    stationary-C SUMMA or, under MethodGemm.gemmA (selected for a single
    block column of C), stationary-A gemmA; Abft is SUMMA's silent
    repair."""
    slate_error(A.n == B.m, "gemm: inner dims differ")
    _same_device(A, B)
    if C is None:
        dt = torch.promote_types(A.dtype, B.dtype)
        C = Matrix.zeros(A.m, B.n, A.mb, B.nb, A.grid, dt, A.device)
        beta = 0.0
    slate_error(C.m == A.m and C.n == B.n, "gemm: C dims differ")
    _same_device(A, C)
    mesh = on_mesh(opts, C)
    method = select_gemm_method(opts, C.nt)
    abft = resolve_abft(opts)  # the one Option.Abft read (driver boundary)
    dt = C.dtype
    if mesh:
        from ..parallel import summa
        from ..parallel.gemm_a import dist_gemmA_data
        # every operand on C's grid (re-tiled if it lives elsewhere: the
        # reference's one communicator for all three matrices)
        Cn = as_root_general(C, grid=C.grid)
        An = as_root_general(A, Cn.storage.mb, None, grid=C.grid)
        Bn = as_root_general(B, An.storage.nb, Cn.storage.nb, grid=C.grid)
        slate_error(An.storage.Nt == Bn.storage.Mt, "gemm: k tiling differs")
        a, b = An.storage.data.to(dt), Bn.storage.data.to(dt)
        if method is MethodGemm.gemmA:
            data = dist_gemmA_data(a, b, Cn.storage.data, alpha, beta,
                                   An.storage.Nt, Cn.grid)
        elif abft:
            # gemm has no health channel: SILENT repair of a single struck
            # accumulator tile, the counters dropped
            data = summa.summa_gemm_data(a, b, Cn.storage.data, alpha, beta,
                                         An.storage.Nt, Cn.grid,
                                         abft=True)[0]
        else:
            data = summa.summa_gemm_data(a, b, Cn.storage.data, alpha, beta,
                                         An.storage.Nt, Cn.grid)
        return _result_mat(Cn, data)
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
    """Stationary-A gemm (ref: src/gemmA.cc): on a mesh A never moves,
    skinny B is replicated and C reduce-scattered to its owners; on one
    device, gemm."""
    return gemm(alpha, A, B, beta, C,
                {**(opts or {}), Option.MethodGemm: MethodGemm.gemmA})


def gemmC(alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """Stationary-C gemm (ref: src/gemmC.cc): SUMMA on a mesh; on one
    device, gemm."""
    return gemm(alpha, A, B, beta, C,
                {**(opts or {}), Option.MethodGemm: MethodGemm.gemmC})


# ---------------------------------------------------------------- trsm/trmm

@annotate("slate.trsm")
def trsm(side, alpha, A, B, opts: Options | None = None) -> Matrix:
    """Solve op(A) X = alpha B (Left) or X op(A) = alpha B (Right), A
    triangular (ref: src/trsm.cc).  Single route: from two block rows up,
    block substitution against the batch-inverted diagonal blocks
    (internal/trsm.py), whose solve ``Option.Abft`` verifies through B's
    checksums with a silent single-element repair; below that one
    ``torch.linalg.solve_triangular``, unchecked, as in the reference.
    Mesh route: the dist_trsm substitution pipeline (parallel/
    dist_trsm.py) over A's storage triangle; MethodTrsm picks the grid
    when A and B live on different ones: trsmB (default) moves A onto B's
    grid, trsmA keeps A and moves B (ref: trsmA.cc vs trsmB.cc)."""
    sd = _side(side)
    slate_error(isinstance(A, BaseTrapezoidMatrix), "trsm: A not triangular")
    slate_error(A._m_store() == A._n_store(), "trsm: A not square")
    if sd is Side.Left:
        slate_error(A.n == B.m, "trsm: dims")
    else:
        slate_error(B.n == A.m, "trsm: dims")
    slate_error(A.device == B.device,
                f"trsm: A on {A.device}, B on {B.device}")
    mesh = on_mesh(opts, B)
    check = resolve_abft(opts)
    unit = A.diag is Diag.Unit
    lower = A.uplo is Uplo.Lower           # storage triangle
    nb = A.storage.nb
    if mesh:
        from ..parallel.dist_trsm import dist_trsm_left, dist_trsm_right
        meth = select_trsm_method(opts, B.nt)
        grid = A.grid if (meth is MethodTrsm.trsmA
                          and A.grid.group is not None) else B.grid
        An = _root_storage_triangular(A, grid=grid)
        if sd is Side.Right:
            Bn = as_root_general(B, None, nb, grid=grid)
            kern = dist_trsm_right
        else:
            Bn = as_root_general(B, nb, None, grid=grid)
            kern = dist_trsm_left
        data = kern(An.storage.data, Bn.storage.data, alpha,
                    Nt=An.storage.Nt, grid=grid, lower=lower, op_a=A.op,
                    unit_diag=unit, n=An.storage.n)
        return _result_mat(Bn, data)
    ad = A._dense_store()                  # storage triangle, op separate
    bd = alpha * B.to_dense()
    trans, conj = A.op is not Op.NoTrans, A.op is Op.ConjTrans
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


def _root_storage_triangular(A, grid=None) -> Matrix:
    """A root general Matrix holding A's STORAGE triangle on ``grid`` (op
    ignored: the callers pass A.op apart), zero-copy when A's storage
    already is one with square tiles."""
    grid = grid or A.grid
    if (A.is_root_view() and A.grid is grid
            and A.storage.mb == A.storage.nb):
        return Matrix(A.storage)
    nb = A.storage.nb
    return Matrix(TileStorage.from_dense(A._dense_store(), nb, nb, grid))


@annotate("slate.trmm")
def trmm(side, alpha, A, B, opts: Options | None = None) -> Matrix:
    """B = alpha op(A) B (Left) or alpha B op(A) (Right), A triangular
    (ref: src/trmm.cc).  Single route: one matmul with the expanded
    triangle.  Mesh route: the triangle-aware kernel over A's STORED tiles
    (parallel/dist_herk.py), half a gemm's flops; a transposed A, a view
    or an A on another grid takes gemm with the expanded triangle
    instead."""
    sd = _side(side)
    _same_device(A, B)
    mesh = on_mesh(opts, B)
    if (mesh and A.op is Op.NoTrans and A.is_root_view()
            and A.storage.mb == A.storage.nb
            # the kernel reads A.storage raw, so its layout must be B's
            # grid's; cross-grid operands take the dense route
            and A.grid is B.grid):
        from ..parallel.dist_herk import dist_trmm_data, dist_trmm_right_data
        lower = A.uplo is Uplo.Lower
        unit = A.diag is Diag.Unit
        nb = A.storage.nb
        st = A.storage
        if sd is Side.Left:
            Bn = as_root_general(B, nb, None, grid=B.grid)
            data = dist_trmm_data(st.data, Bn.storage.data, alpha, Kt=st.Nt,
                                  Mt=st.Mt, grid=B.grid, lower=lower,
                                  unit_diag=unit, n=st.n)
        else:
            Bn = as_root_general(B, None, nb, grid=B.grid)
            data = dist_trmm_right_data(st.data, Bn.storage.data, alpha,
                                        Kt=st.Mt, Nt=st.Nt, grid=B.grid,
                                        lower=lower, unit_diag=unit, n=st.n)
        return _result_mat(Bn, data)
    ad = A.to_dense()                      # expands triangle incl. unit diag
    if mesh:
        Ag = Matrix(TileStorage.from_dense(ad, A.mb, A.nb, B.grid))
        return gemm(alpha, Ag, B, 0.0, None, opts) if sd is Side.Left \
            else gemm(alpha, B, Ag, 0.0, None, opts)
    bd = B.to_dense()
    out = alpha * (ad @ bd) if sd is Side.Left else alpha * (bd @ ad)
    return _dense_to_like(B, out)


# ---------------------------------------------------------------- rank-k

def _general_of(C) -> Matrix:
    """General matrix holding C's expanded structure."""
    return C if type(C) is Matrix else C.general()


def _rank_k_mesh(alpha, A, beta, C, opts, conj: bool, B=None, alpha2=None):
    """The mesh route of herk/syrk/her2k/syr2k: the triangle-aware pair
    kernel over C's STORED tiles, half a gemm's flops and communication
    (ref: blas3.py:262, internal_herk.cc).  Returns the updated general
    storage Matrix, or None when the operands do not qualify (the caller
    takes the gemm composition)."""
    from ..parallel.dist_herk import dist_herk_data
    if not (on_mesh(opts, C) and C.op is Op.NoTrans and C.is_root_view()
            and C.storage.mb == C.storage.nb):
        return None
    nb = C.storage.nb
    An = as_root_general(A, nb, None, grid=C.grid)
    b_data = None
    if B is not None:
        Bn = as_root_general(B, nb, An.storage.nb, grid=C.grid)
        slate_error(Bn.storage.Nt == An.storage.Nt, "rank-2k: k tiling")
        b_data = Bn.storage.data.to(C.dtype)
    cs = C.storage
    data = dist_herk_data(
        An.storage.data.to(C.dtype), cs.data, alpha, beta,
        Kt=An.storage.Nt, Mt=cs.Mt, Nt=cs.Nt, grid=C.grid,
        lower=C.uplo is Uplo.Lower, conj=conj, b_data=b_data,
        alpha2=alpha2)
    return _result_mat(C, data)


@annotate("slate.herk")
def herk(alpha, A, beta, C, opts: Options | None = None):
    """C = alpha A A^H + beta C, C Hermitian (ref: src/herk.cc,
    internal_herk.cc:843).  Mesh: the triangle-aware kernel; otherwise
    gemm on the expanded C, returned as a Hermitian view of C's
    triangle."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "herk: C must be Hermitian/Symmetric")
    slate_error(A.m == C.m, "herk: dims")
    out = _rank_k_mesh(alpha, A, beta, C, opts, conj=True)
    if out is None:
        out = gemm(alpha, A, A.conj_transpose(), beta, _general_of(C), opts)
    return HermitianMatrix._from_view(out, C._uplo_logical())


@annotate("slate.syrk")
def syrk(alpha, A, beta, C, opts: Options | None = None):
    """C = alpha A A^T + beta C, C symmetric (ref: src/syrk.cc)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "syrk: C must be Symmetric")
    out = _rank_k_mesh(alpha, A, beta, C, opts, conj=False)
    if out is None:
        out = gemm(alpha, A, A.transpose(), beta, _general_of(C), opts)
    return SymmetricMatrix._from_view(out, C._uplo_logical())


@annotate("slate.her2k")
def her2k(alpha, A, B, beta, C, opts: Options | None = None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (ref: src/her2k.cc,
    internal_her2k.cc:1062); mesh: one triangle-aware pass."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "her2k: C must be Hermitian")
    out = _rank_k_mesh(alpha, A, beta, C, opts, conj=True, B=B,
                       alpha2=_conj(alpha))
    if out is None:
        t1 = gemm(alpha, A, B.conj_transpose(), beta, _general_of(C), opts)
        out = gemm(_conj(alpha), B, A.conj_transpose(), 1.0, t1, opts)
    return HermitianMatrix._from_view(out, C._uplo_logical())


@annotate("slate.syr2k")
def syr2k(alpha, A, B, beta, C, opts: Options | None = None):
    """C = alpha A B^T + alpha B A^T + beta C (ref: src/syr2k.cc)."""
    slate_error(isinstance(C, BaseTrapezoidMatrix),
                "syr2k: C must be Symmetric")
    out = _rank_k_mesh(alpha, A, beta, C, opts, conj=False, B=B,
                       alpha2=alpha)
    if out is None:
        t1 = gemm(alpha, A, B.transpose(), beta, _general_of(C), opts)
        out = gemm(alpha, B, A.transpose(), 1.0, t1, opts)
    return SymmetricMatrix._from_view(out, C._uplo_logical())


@annotate("slate.hemm")
def hemm(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """C = alpha A B + beta C (Left) or alpha B A + beta C (Right), A
    Hermitian (ref: src/hemm.cc, hemmA.cc): gemm of the expanded A.
    MethodHemm is read and validated; on the Left, hemmA (explicit, or
    Auto with a single block column of B: method.hh MethodHemm::
    select_algo) asks gemm for its stationary-A pattern (MethodGemm.gemmA),
    which only a mesh route reads; on the Right, and on one device, every
    value is the same gemm."""
    sd = _side(side)
    meth = method_option(opts, Option.MethodHemm, MethodHemm)
    if sd is Side.Left and (meth is MethodHemm.hemmA or (
            meth is MethodHemm.Auto and B.nt < 2)):
        opts = {**(opts or {}), Option.MethodGemm: MethodGemm.gemmA}
    if sd is Side.Left:
        return gemm(alpha, A, B, beta, C, opts)
    return gemm(alpha, B, A, beta, C, opts)


def symm(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """C = alpha A B + beta C with A symmetric (ref: src/symm.cc)."""
    return hemm(side, alpha, A, B, beta, C, opts)


def hemmA(side, alpha, A, B, beta=0.0, C=None, opts=None) -> Matrix:
    """Stationary-A hemm (ref: src/hemmA.cc): forces gemmA on the Left
    only, as the reference does (on the Right gemm's replicated slot would
    hold the large Hermitian A)."""
    o = dict(opts or {})
    if _side(side) is Side.Left:
        o[Option.MethodGemm] = MethodGemm.gemmA
    return hemm(side, alpha, A, B, beta, C, o)
