"""QR / LQ / least-squares drivers: geqrf, gelqf, unmqr, unmlq, qr_multiply,
cholqr, gels_cholqr, gels_qr and gels (port of the single-device path of
slate_tpu/drivers/qr.py).

geqrf is a blocked Householder QR of the dense matrix: per block column
the panel (internal/qr.py ``geqrf_panel``: K5 for f32 panels inside its
gate, else CholQR2 reconstruction or the rank-1 scan) and the larfb
trailing update, three matmuls.  cholqr and gels_cholqr compose herk,
potrf (K2 and K0 for f32) and trsm, so on a mesh they run on those
drivers' mesh routes.  On a mesh (the target mesh and a grid with a
process group) geqrf is the communication-avoiding QR of
parallel/dist_qr.py, whose factors are ``CAQRFactors``; unmqr applies
them through ``dist_unmqr_data``, a right-side apply through the left
one on Cᴴ.
"""

from __future__ import annotations

import torch

from ..core.matrix import HermitianMatrix, Matrix
from ..core.storage import TileStorage
from ..exceptions import SlateNotPositiveDefiniteError, slate_error
from ..internal.qr import apply_q_left, apply_q_right, geqrf_panel
from ..options import (ErrorPolicy, MethodCholQR, MethodGemm, Option,
                       Options, method_option, on_mesh)
from ..robust import health as _health
from ..types import Op, Side, Uplo, is_complex
from ..util.trace import annotate
from .blas3 import _dense_to_like, _side, gemm, herk, trsm
from .cholesky import potrf


class QRFactors:
    """Packed QR factors: V (unit lower, below the diagonal) and R (upper)
    in ``QR``, and the block-reflector triangles ``T`` [K, nb, nb], one a
    panel (ref: geqrf's TriangularFactors)."""

    def __init__(self, QR: Matrix, T: torch.Tensor):
        self.QR = QR
        self.T = T

    def __repr__(self):
        return f"QRFactors({self.QR.m}x{self.QR.n}, nb={self.QR.nb})"


class CAQRFactors:
    """Mesh CAQR factors (ref: qr.py:77-98): the packed local V's and the
    final R in ``QR``, every grid row's block-reflector triangles
    ``Tloc`` [p, Kt, nb, nb], and the tree factors ``Vtree`` [Kt, p*nb,
    nb] and ``Ttree`` [Kt, nb, nb], the last three the same on every
    rank."""

    def __init__(self, QR: Matrix, Tloc, Vtree, Ttree):
        self.QR = QR
        self.Tloc = Tloc
        self.Vtree = Vtree
        self.Ttree = Ttree

    def __repr__(self):
        return f"CAQRFactors({self.QR.m}x{self.QR.n}, nb={self.QR.nb})"


class LQFactors:
    """LQ factors, stored as the QR factors of A^H (A = L Q, Q = Qr^H)."""

    def __init__(self, F: QRFactors):
        self.F = F


def _geqrf_dense_blocked(a: torch.Tensor, nb: int):
    """Blocked Householder QR of the dense [m, n] ``a``, which it factors
    IN PLACE (the reference builds a new array per step): per panel the
    tuned panel factor, then the larfb trailing update Q^H A_right.
    Returns (packed, T [K, nb, nb]); a narrow last panel's T is
    zero-padded to nb x nb."""
    m, n = a.shape
    Ts = []
    for k0 in range(0, min(m, n), nb):
        k1 = min(k0 + nb, m, n)
        w = k1 - k0
        packed, T = geqrf_panel(a[k0:, k0:k1])
        a[k0:, k0:k1] = packed
        if k1 < n:
            a[k0:, k1:] = apply_q_left(packed, T, a[k0:, k1:],
                                       conj_trans=True)
        if w < nb:
            Tp = torch.zeros((nb, nb), dtype=T.dtype, device=T.device)
            Tp[:w, :w] = T
            T = Tp
        Ts.append(T)
    T_stack = (torch.stack(Ts) if Ts else
               torch.zeros((0, nb, nb), dtype=a.dtype, device=a.device))
    return a, T_stack


@annotate("slate.geqrf")
def geqrf(A: Matrix, opts: Options | None = None) -> QRFactors:
    """QR factorization A = Q R (ref: src/geqrf.cc).  Returns the packed
    factors; :func:`unmqr` applies Q, and triu(R) serves solves.  On a
    mesh: :class:`CAQRFactors` of ``dist_geqrf_data`` (ref:
    qr.py:132-141)."""
    if on_mesh(opts, A):
        from ..parallel.dist_qr import dist_geqrf_data
        from .blas3 import as_root_general
        nb = A.nb
        st = as_root_general(A, nb, nb, A.grid).storage
        data, Tloc, Vtree, Ttree = dist_geqrf_data(
            st.data, -(-min(st.m, st.n) // nb), st.Mt, st.m, st.n, A.grid)
        return CAQRFactors(Matrix(TileStorage(data, st.m, st.n, nb, nb,
                                              A.grid)), Tloc, Vtree, Ttree)
    ad = A.to_dense().clone(memory_format=torch.contiguous_format)
    packed, T = _geqrf_dense_blocked(ad, A.nb)
    return QRFactors(Matrix(TileStorage.from_dense(packed, A.mb, A.nb,
                                                   A.grid)), T)


@annotate("slate.gelqf")
def gelqf(A: Matrix, opts: Options | None = None) -> LQFactors:
    """LQ factorization A = L Q through the QR of A^H (ref: src/gelqf.cc
    computes the mirrored chain; algebraically the same)."""
    Ah = Matrix(TileStorage.from_dense(A.to_dense().conj().T, A.nb, A.mb,
                                       A.grid))
    return LQFactors(geqrf(Ah, opts))


def _parse_trans(op, dtype) -> bool:
    """An op spec as conj_trans; a plain transpose of complex data is
    refused, as LAPACK's unmqr refuses 'T' for complex."""
    if op is Op.NoTrans or str(op).lower() == "n":
        return False
    plain_t = op is Op.Trans or str(op).lower() == "t"
    slate_error(not (plain_t and is_complex(dtype)),
                "unmqr: op='t' undefined for complex; use 'c'")
    return True


def _panel_ranges(m: int, n: int, nb: int):
    r = min(m, n)
    return [(k0, min(k0 + nb, r)) for k0 in range(0, r, nb)]


@annotate("slate.unmqr")
def unmqr(side, op, F: QRFactors, C, opts: Options | None = None) -> Matrix:
    """C times Q (op 'n') or Q^H (op 'c'/'t') from the given side (ref:
    src/unmqr.cc); Q is the implicit factor of :func:`geqrf`."""
    sd = _side(side)
    conj_trans = _parse_trans(op, F.QR.dtype)
    if isinstance(F, CAQRFactors):
        return _unmqr_caqr(sd, conj_trans, F, C)
    packed = F.QR.to_dense()
    mq, nq = packed.shape
    nb = F.QR.nb
    cd = C.to_dense().clone(memory_format=torch.contiguous_format)
    ranges = _panel_ranges(mq, nq, nb)
    # Q = B_0 B_1 ... B_{K-1}: Q^H C and C Q apply the panels ascending,
    # Q C and C Q^H descending
    ascending = (sd is Side.Left) == conj_trans
    for k0, k1 in (ranges if ascending else ranges[::-1]):
        w = k1 - k0
        pk = packed[k0:, k0:k1]
        Tk = F.T[k0 // nb][:w, :w]
        if sd is Side.Left:
            cd[k0:, :] = apply_q_left(pk, Tk, cd[k0:, :], conj_trans)
        else:
            cd[:, k0:] = apply_q_right(pk, Tk, cd[:, k0:], conj_trans)
    return _dense_to_like(C, cd)


def _unmqr_caqr(sd: Side, conj_trans: bool, F: CAQRFactors, C) -> Matrix:
    """The mesh apply of CAQR's Q (ref: qr.py:203-220): from the left on
    C's local tiles, re-tiled in rows as the factor; from the right as
    C op(Q) = (op(Q)^H C^H)^H, through the left apply."""
    from ..parallel.dist_qr import dist_unmqr_data
    from .blas3 import as_root_general
    st = F.QR.storage
    if sd is Side.Right:
        Ct = Matrix(TileStorage.from_dense(C.to_dense().conj().T, st.nb,
                                           C.mb, C.grid))
        Xt = _unmqr_caqr(Side.Left, not conj_trans, F, Ct)
        return _dense_to_like(C, Xt.to_dense().conj().T)
    cs = as_root_general(C, st.nb, None, grid=F.QR.grid).storage
    data = dist_unmqr_data(st.data, cs.data, F.Tloc, F.Vtree, F.Ttree,
                           F.Tloc.shape[1], st.Mt, st.m, F.QR.grid,
                           conj_trans)
    return Matrix(TileStorage(data, cs.m, cs.n, cs.mb, cs.nb, cs.grid))


@annotate("slate.unmlq")
def unmlq(side, op, F: LQFactors, C, opts: Options | None = None) -> Matrix:
    """C times the LQ factor Q = Qr^H (ref: src/unmlq.cc): flips op on the
    underlying QR reflectors."""
    conj_trans = _parse_trans(op, F.F.QR.dtype)
    return unmqr(side, "n" if conj_trans else "c", F.F, C, opts)


def qr_multiply(F: QRFactors, opts: Options | None = None) -> Matrix:
    """The thin Q (first min(m, n) columns), Q applied to I."""
    mq = F.QR.m
    eye = torch.eye(mq, min(mq, F.QR.n), dtype=F.QR.dtype,
                    device=F.QR.device)
    E = Matrix(TileStorage.from_dense(eye, F.QR.mb, F.QR.nb, F.QR.grid))
    return unmqr(Side.Left, "n", F, E, opts)


def _gram(A: Matrix, opts: Options | None) -> HermitianMatrix:
    """G = A^H A as a lower Hermitian matrix (the CholQR paths).
    MethodCholQR picks the accumulation (ref: method.hh:114-160): HerkC
    (the default) by herk, GemmC/GemmA the full square by gemm with the
    matching MethodGemm; on one device all three are one matmul."""
    meth = method_option(opts, Option.MethodCholQR, MethodCholQR)
    if meth in (MethodCholQR.GemmC, MethodCholQR.GemmA):
        o = dict(opts or {})
        o[Option.MethodGemm] = (MethodGemm.gemmA
                                if meth is MethodCholQR.GemmA
                                else MethodGemm.gemmC)
        G = gemm(1.0, A.conj_transpose(), A, 0.0, None, o)
        return HermitianMatrix._from_view(G, Uplo.Lower)
    return herk(1.0, A.conj_transpose(), 0.0,
                HermitianMatrix._from_view(
                    Matrix.zeros(A.n, A.n, A.nb, A.nb, A.grid, A.dtype,
                                 A.device), Uplo.Lower), opts)


def _info_opts(opts: Options | None) -> dict:
    o = dict(opts or {})
    o[Option.ErrorPolicy] = ErrorPolicy.Info
    return o


def _gram_exc(name: str):
    """The CholQR family's typed failure: the Gram matrix A^H A failed
    Cholesky, so A is rank-deficient or cond(A)^2 overwhelmed the working
    precision."""
    return lambda h: SlateNotPositiveDefiniteError(
        f"{name}: Gram matrix A^H A not positive definite — A is "
        f"rank-deficient or too ill-conditioned for CholQR "
        f"({h.describe()})", info=int(h.info))


@annotate("slate.cholqr")
def cholqr(A: Matrix, opts: Options | None = None):
    """Cholesky QR: G = A^H A, R = chol(G)^H, Q = A R^-1 (ref:
    src/cholqr.cc).  Returns (Q, R), R upper triangular; a rank-deficient
    A raises :class:`SlateNotPositiveDefiniteError` (under ErrorPolicy.Info
    the return is ((Q, R), HealthInfo))."""
    slate_error(A.m >= A.n, "cholqr: need m >= n")
    G = _gram(A, opts)
    L, fh = potrf(G, _info_opts(opts))       # G = L L^H
    R = L.conj_transpose()                   # upper
    Q = trsm(Side.Right, 1.0, R, A, opts)    # Q = A R^-1
    h = _health.merge(fh, _health.from_result(Q.storage.data, Q.grid))
    return _health.finalize("cholqr", (Q, R), h, opts, _gram_exc("cholqr"))


def _gels_cholqr_attempt(A: Matrix, B, opts: Options | None, *,
                         refine: int = 0, certify: bool = False):
    """One semi-normal-equations solve R^H R x = A^H b under
    ErrorPolicy.Info; the health merges the Gram factor's with the
    solution's finiteness.  ``refine`` adds that many corrected sweeps
    (dx from A^H r through the same factor).  ``certify`` merges the
    normal-equations certificate (robust/certify.certify_lstsq) of the
    final X, with ``refine`` recorded as its iterations."""
    L, fh = potrf(_gram(A, opts), _info_opts(opts))

    def sne(Rhs):
        Z = gemm(1.0, A.conj_transpose(), Rhs, 0.0, None, opts)  # A^H rhs
        Y = trsm(Side.Left, 1.0, L, Z, opts)
        return trsm(Side.Left, 1.0, L.conj_transpose(), Y, opts)

    X = sne(B)
    h = _health.merge(fh, _health.from_result(X.storage.data, X.grid))
    for _ in range(refine):
        R = gemm(-1.0, A, X, 1.0, B, opts)            # r = B - A X
        X = X.with_dense(sne(R).to_dense() + X.to_dense())
    if certify:
        from ..robust import certify as _certify
        R = gemm(-1.0, A, X, 1.0, B, opts)
        Rn = gemm(1.0, A.conj_transpose(), R, 0.0, None, opts)
        ad = A.to_dense()
        cert = _certify.certify_lstsq(
            torch.linalg.norm(ad)[None], X.to_dense()[None],
            B.to_dense()[None], Rn.to_dense()[None],
            tol=_certify.tolerance(A.dtype, max(A.m, A.n))).to_list()[0]
        h = _health.merge(h, cert._replace(iters=refine))
    return X, h


@annotate("slate.gels_cholqr")
def gels_cholqr(A: Matrix, B, opts: Options | None = None) -> Matrix:
    """Least squares by the semi-normal equations with R from CholQR (ref:
    src/gels_cholqr.cc).  Same failure contract as :func:`cholqr`, no
    fallback: :func:`gels` is the escalating entry point."""
    slate_error(A.m >= A.n, "gels_cholqr: need m >= n")
    X, h = _gels_cholqr_attempt(A, B, opts)
    return _health.finalize("gels_cholqr", X, h, opts,
                            _gram_exc("gels_cholqr"))


@annotate("slate.gels_qr")
def gels_qr(A: Matrix, B, opts: Options | None = None) -> Matrix:
    """Least squares by Householder QR (ref: src/gels_qr.cc):
    x = R^-1 (Q^H b)[:n]."""
    m, n = A.m, A.n
    slate_error(m >= n, "gels_qr: need m >= n (use gels for m < n)")
    F = geqrf(A, opts)
    Y = unmqr(Side.Left, "c", F, B, opts)
    xd = _solve_r(F, Y.to_dense()[:n])
    return Matrix.zeros(n, B.n, A.nb, B.nb, A.grid, xd.dtype,
                        xd.device).with_dense(xd)


def _solve_r(F: QRFactors, yd: torch.Tensor) -> torch.Tensor:
    """R^-1 y with R = triu of the packed factor's leading n x n block."""
    n = F.QR.n
    rd = torch.triu(F.QR.to_dense()[:n, :n])
    return torch.linalg.solve_triangular(rd, yd, upper=True)


def _gels_qr_attempt(A: Matrix, B, opts: Options | None):
    """The Householder-QR attempt of gels' bounded retry."""
    X = gels_qr(A, B, opts)
    return X, _health.from_result(X.storage.data, X.grid)


@annotate("slate.gels")
def gels(A: Matrix, B, opts: Options | None = None) -> Matrix:
    """Linear least squares / minimum-norm solve (ref: src/gels.cc:141).

    m >= n: min ||Ax - b|| by QR or CholQR per MethodGels (auto: CholQR
    for m >= 3n), through robust/recovery.py ``gels_with_recovery``, whose
    ``Option.UseFallbackSolver`` rung retries a failed CholQR by QR.
    m < n: the minimum-norm solution through LQ, x = Q^H L^-1 b.
    Returns X, or (X, HealthInfo) under ErrorPolicy.Info."""
    m, n = A.m, A.n
    if m >= n:
        from ..robust.recovery import gels_with_recovery
        return gels_with_recovery(A, B, opts)
    F = gelqf(A, opts)
    packed = F.F.QR.to_dense()                     # QR of A^H: [n, m]
    ld = torch.triu(packed[:m, :m]).conj().T       # L = R^H, lower m x m
    yd = torch.linalg.solve_triangular(ld, B.to_dense(), upper=False)
    ypad = torch.zeros((n, yd.shape[1]), dtype=yd.dtype, device=yd.device)
    ypad[:m] = yd
    Yp = Matrix.zeros(n, yd.shape[1], A.nb, B.nb, A.grid, yd.dtype,
                      yd.device).with_dense(ypad)
    X = unmqr(Side.Left, "n", F.F, Yp, opts)       # x = Qr y
    return _health.finalize("gels", X,
                            _health.from_result(X.storage.data, X.grid),
                            opts)
