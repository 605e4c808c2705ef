"""LAPACK-style shims: numpy arrays in, numpy arrays out, one device (port
of slate_tpu/compat/lapack.py).

The analog of the reference's lapack_api tier (ref:
lapack_api/lapack_slate.hh slate_dgesv / slate_dposv / ...): each shim
takes plain numpy arrays, runs the port's drivers on the 1 x 1 grid with
the reference's tile-size heuristic (:func:`_nb`), and returns plain
numpy arrays, the path a legacy LAPACK caller migrates through first.
``device=None`` means CUDA and raises without it; ``device="cpu"`` runs
the kernels' plain versions.  Naming follows LAPACK with the precision
prefix dropped (precision comes from the input dtype)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import HermitianMatrix, Matrix
from ..core.storage import as_tensor
from ..options import Option, get_option
from ..types import Uplo


def _np(x) -> np.ndarray:
    """A result (tensor or matrix) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.resolve_conj().cpu().numpy()
    return np.asarray(x.to_numpy())


def _nb(n: int, opts=None) -> int:
    """Tile size: Option.BlockSize when given (ref: enums.hh:72), else the
    reference's size heuristic, max(8, min(256, 2^bit_length(n // 4)))."""
    bs = get_option(opts, Option.BlockSize)
    if bs:
        return int(bs)
    return max(8, min(256, 1 << max(3, (n // 4).bit_length())))


def _mat(a, nb=None, opts=None, device=None) -> Matrix:
    a = np.asarray(a)
    nb = nb or _nb(max(a.shape), opts)
    return Matrix.from_numpy(a, min(nb, a.shape[0]), min(nb, a.shape[1]),
                             device=device)


def _herm(a, uplo, opts, device, cls=HermitianMatrix):
    return cls.from_numpy(np.asarray(a), _nb(len(a), opts), uplo=_uplo(uplo),
                          device=device)


def _uplo(uplo: str) -> Uplo:
    return Uplo.Lower if uplo.upper().startswith("L") else Uplo.Upper


def gesv(a, b, opts=None, device=None):
    """Solve A X = B (LAPACK dgesv).  Returns (x, perm)."""
    from ..drivers.lu import gesv as _gesv
    F, X = _gesv(_mat(a, opts=opts, device=device),
                 _mat(b, opts=opts, device=device), opts)
    return _np(X), _np(F.perm)


def getrf(a, opts=None, device=None):
    """LU factor (LAPACK dgetrf).  Returns (lu, perm) with A[perm] = L U."""
    from ..drivers.lu import getrf as _getrf
    F = _getrf(_mat(a, opts=opts, device=device), opts)
    return _np(F.LU), _np(F.perm)


def posv(a, b, uplo: str = "L", opts=None, device=None):
    """Solve A X = B, A Hermitian positive definite (LAPACK dposv).
    Returns x."""
    from ..drivers.cholesky import posv as _posv
    _, X = _posv(_herm(a, uplo, opts, device),
                 _mat(b, opts=opts, device=device), opts)
    return _np(X)


def potrf(a, uplo: str = "L", opts=None, device=None):
    """Cholesky factor (LAPACK dpotrf).  Returns the triangular factor."""
    from ..drivers.cholesky import potrf as _potrf
    return _np(_potrf(_herm(a, uplo, opts, device), opts))


def gels(a, b, opts=None, device=None):
    """Least squares min ||A X - B|| (LAPACK dgels).  Returns x."""
    from ..drivers.qr import gels as _gels
    return _np(_gels(_mat(a, opts=opts, device=device),
                     _mat(b, opts=opts, device=device), opts))


def geqrf(a, opts=None, device=None):
    """QR factor (LAPACK dgeqrf).  Returns the packed QR factors."""
    from ..drivers.qr import geqrf as _geqrf
    return _geqrf(_mat(a, opts=opts, device=device), opts)


def heev(a, uplo: str = "L", opts=None, device=None):
    """Hermitian eigendecomposition (LAPACK dsyev/zheev).  Returns
    (eigenvalues, eigenvectors)."""
    from ..drivers.heev import heev as _heev
    lam, Z = _heev(_herm(a, uplo, opts, device), opts)
    return _np(lam), _np(Z)


def gesvd(a, opts=None, device=None):
    """SVD (LAPACK dgesvd).  Returns (u, s, vh)."""
    from ..drivers.svd import svd as _svd
    s, U, V = _svd(_mat(a, opts=opts, device=device), opts)
    return _np(U), _np(s), np.conj(_np(V)).T


def gesvd_vals(a, opts=None, device=None):
    """Singular values only."""
    from ..drivers.svd import svd_vals as _svd_vals
    return _np(_svd_vals(_mat(a, opts=opts, device=device), opts))


def gecon(a, opts=None, device=None):
    """Reciprocal 1-norm condition estimate by the Higham/Hager estimator
    (LAPACK dgecon analog)."""
    from ..drivers.auxiliary import norm as _norm
    from ..drivers.condest import gecondest
    from ..drivers.lu import getrf as _getrf
    from ..types import Norm
    A = _mat(a, opts=opts, device=device)
    return float(gecondest(_getrf(A, opts), _norm(Norm.One, A)))


# ---- BLAS-3 tier (ref: lapack_api/lapack_gemm.cc, _hemm, _herk, _her2k,
# _symm, _syrk, _syr2k, _trmm, _trsm) ----

def _apply_trans(M, trans: str):
    """op() dispatch shared by every shim taking a trans character."""
    t = trans.lower()
    if t.startswith("t"):
        return M.transpose()
    if t.startswith("c"):
        return M.conj_transpose()
    return M


def gemm(transa, transb, alpha, a, b, beta=0.0, c=None, opts=None,
         device=None):
    """C = alpha op(A) op(B) + beta C (LAPACK-style dgemm)."""
    from ..drivers.blas3 import gemm as _gemm
    C = None if c is None else _mat(c, opts=opts, device=device)
    out = _gemm(alpha, _apply_trans(_mat(a, opts=opts, device=device),
                                    transa),
                _apply_trans(_mat(b, opts=opts, device=device), transb),
                beta, C, opts)
    return _np(out)


def hemm(side, uplo, alpha, a, b, beta=0.0, c=None, opts=None,
         device=None):
    """C = alpha A B + beta C with A Hermitian (dhemm/zhemm)."""
    from ..drivers.blas3 import hemm as _hemm
    C = None if c is None else _mat(c, opts=opts, device=device)
    return _np(_hemm(side, alpha, _herm(a, uplo, opts, device),
                     _mat(b, opts=opts, device=device), beta, C, opts))


def symm(side, uplo, alpha, a, b, beta=0.0, c=None, opts=None,
         device=None):
    """C = alpha A B + beta C with A symmetric (dsymm/zsymm): a complex
    symmetric A expands as tri + tri^T, not conjugate-mirrored."""
    from ..core.matrix import SymmetricMatrix
    from ..drivers.blas3 import symm as _symm
    C = None if c is None else _mat(c, opts=opts, device=device)
    A = _herm(a, uplo, opts, device, SymmetricMatrix)
    return _np(_symm(side, alpha, A, _mat(b, opts=opts, device=device),
                     beta, C, opts))


def _rank_k(kind, uplo, alpha, a, beta, c, opts, device, b=None):
    from ..core.matrix import SymmetricMatrix
    from ..drivers import blas3
    herm = kind in ("herk", "her2k")
    n = np.asarray(a).shape[0]
    cm = (np.zeros((n, n), np.asarray(a).dtype) if c is None
          else np.asarray(c))
    C = _herm(cm, uplo, opts, device,
              HermitianMatrix if herm else SymmetricMatrix)
    A = _mat(a, opts=opts, device=device)
    if kind == "herk":
        out = blas3.herk(alpha, A, beta, C, opts)
    elif kind == "syrk":
        out = blas3.syrk(alpha, A, beta, C, opts)
    elif kind == "her2k":
        out = blas3.her2k(alpha, A, _mat(b, opts=opts, device=device), beta,
                          C, opts)
    else:
        out = blas3.syr2k(alpha, A, _mat(b, opts=opts, device=device), beta,
                          C, opts)
    return _np(out.general())


def herk(uplo, alpha, a, beta=0.0, c=None, opts=None, device=None):
    """C = alpha A A^H + beta C, C Hermitian (zherk).  Returns the full
    (Hermitian-completed) array."""
    return _rank_k("herk", uplo, alpha, a, beta, c, opts, device)


def syrk(uplo, alpha, a, beta=0.0, c=None, opts=None, device=None):
    """C = alpha A A^T + beta C, C symmetric (dsyrk)."""
    return _rank_k("syrk", uplo, alpha, a, beta, c, opts, device)


def her2k(uplo, alpha, a, b, beta=0.0, c=None, opts=None, device=None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C (zher2k)."""
    return _rank_k("her2k", uplo, alpha, a, beta, c, opts, device, b=b)


def syr2k(uplo, alpha, a, b, beta=0.0, c=None, opts=None, device=None):
    """C = alpha A B^T + alpha B A^T + beta C (dsyr2k)."""
    return _rank_k("syr2k", uplo, alpha, a, beta, c, opts, device, b=b)


def _tri_mat(a, uplo, diag, opts, device):
    from ..core.matrix import TriangularMatrix
    from ..types import Diag
    return TriangularMatrix._from_view(
        _mat(a, opts=opts, device=device), _uplo(uplo),
        Diag.Unit if diag.upper().startswith("U") else Diag.NonUnit)


def trmm(side, uplo, transa, diag, alpha, a, b, opts=None, device=None):
    """B = alpha op(A) B or alpha B op(A), A triangular (dtrmm)."""
    from ..drivers.blas3 import trmm as _trmm
    T = _apply_trans(_tri_mat(a, uplo, diag, opts, device), transa)
    return _np(_trmm(side, alpha, T, _mat(b, opts=opts, device=device),
                     opts))


def trsm(side, uplo, transa, diag, alpha, a, b, opts=None, device=None):
    """Solve op(A) X = alpha B or X op(A) = alpha B (dtrsm)."""
    from ..drivers.blas3 import trsm as _trsm
    T = _apply_trans(_tri_mat(a, uplo, diag, opts, device), transa)
    return _np(_trsm(side, alpha, T, _mat(b, opts=opts, device=device),
                     opts))


# ---- norms (ref: lapack_api/lapack_lange.cc, _lanhe, _lansy, _lantr) ----

def _norm_kind(norm):
    """LAPACK norm character -> Norm, shared by the lan* shims."""
    from ..types import Norm
    return {"m": Norm.Max, "1": Norm.One, "o": Norm.One, "i": Norm.Inf,
            "f": Norm.Fro, "e": Norm.Fro}[str(norm).lower()]


def lange(norm, a, opts=None, device=None):
    """General matrix norm: 'm'|'1'|'i'|'f' (dlange)."""
    from ..drivers.auxiliary import norm as _norm
    return float(_norm(_norm_kind(norm), _mat(a, opts=opts, device=device)))


def lanhe(norm, uplo, a, opts=None, device=None):
    """Hermitian matrix norm (zlanhe)."""
    from ..drivers.auxiliary import norm as _norm
    return float(_norm(_norm_kind(norm), _herm(a, uplo, opts, device)))


def lansy(norm, uplo, a, opts=None, device=None):
    """Symmetric matrix norm (dlansy)."""
    from ..core.matrix import SymmetricMatrix
    from ..drivers.auxiliary import norm as _norm
    return float(_norm(_norm_kind(norm),
                       _herm(a, uplo, opts, device, SymmetricMatrix)))


def lantr(norm, uplo, diag, a, opts=None, device=None):
    """Triangular matrix norm (dlantr)."""
    from ..drivers.auxiliary import norm as _norm
    return float(_norm(_norm_kind(norm),
                       _tri_mat(a, uplo, diag, opts, device)))


# ---- solves and inverses from factors (ref: lapack_api/lapack_getrs.cc,
# _getri, _potri, _gesv_mixed) ----

def _lu_factors(lu, perm, opts, device):
    from ..drivers.lu import LUFactors
    A = _mat(np.asarray(lu), opts=opts, device=device)
    return LUFactors(A, as_tensor(np.asarray(perm), A.device))


def getrs(lu, perm, b, trans: str = "n", opts=None, device=None):
    """Solve op(A) X = B from getrf's (lu, perm) (dgetrs)."""
    from ..drivers.blas3 import trsm as _t
    from ..drivers.lu import getrs as _getrs
    F = _lu_factors(lu, perm, opts, device)
    B = _mat(b, opts=opts, device=device)
    t = trans.lower()
    if t.startswith("n"):
        return _np(_getrs(F, B, opts))
    # op(A) x = b with A[perm] = L U:  op(A) = op(U) op(L) P, so
    # w = op(U)^-1 b, v = op(L)^-1 w, x[perm] = v
    conj = t.startswith("c")
    U = F.upper().conj_transpose() if conj else F.upper().transpose()
    L = F.lower().conj_transpose() if conj else F.lower().transpose()
    v = _np(_t("l", 1.0, L, _t("l", 1.0, U, B, opts), opts))
    x = np.zeros_like(v)
    x[np.asarray(perm)] = v
    return x


def getri(lu, perm, opts=None, device=None):
    """Matrix inverse from getrf factors (dgetri)."""
    from ..drivers.lu import getri as _getri
    return _np(_getri(_lu_factors(lu, perm, opts, device), opts))


def potri(l, uplo: str = "L", opts=None, device=None):
    """Inverse from the Cholesky factor (dpotri).  Returns the full
    (Hermitian-completed) inverse."""
    from ..core.matrix import TriangularMatrix
    from ..drivers.cholesky import potri as _potri
    T = TriangularMatrix._from_view(
        _mat(np.asarray(l), opts=opts, device=device), _uplo(uplo))
    return _np(_potri(T, opts).general())


def gesv_mixed(a, b, opts=None, device=None):
    """Mixed-precision iterative-refinement solve (dsgesv analog).
    Returns (x, iters)."""
    from ..drivers.mixed import gesv_mixed as _gm
    res = _gm(_mat(a, opts=opts, device=device),
              _mat(b, opts=opts, device=device), opts)
    return _np(res.X), int(res.iters)
