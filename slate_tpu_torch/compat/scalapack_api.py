"""ScaLAPACK-style routine entry points over descriptor + local arrays
(port of slate_tpu/compat/scalapack_api.py).

The analog of the reference's scalapack_api tier (ref:
scalapack_api/scalapack_gemm.cc:24-38 slate_pdgemm and the pdgesv /
pdpotrf / pdgeqrf / pdsyev wrappers): each ``pd*`` function takes the
9-integer descriptor plus a ``{(pr, pc): local array}`` mapping per
matrix, runs the port's driver, and returns its results in ScaLAPACK
layout (``to_scalapack``).  On a p x q grid with a process group every
rank calls the routine with the whole map of locals and the drivers take
their mesh routes (``pdsyev`` and ``pdgesvd`` the distributed spectral
reductions, parallel/dist_he2hb.py and dist_ge2tb.py).  Full
matrices (IA = JA = 1) and RSRC = CSRC = 0, as the reference's wrappers
assert.  ``device=None`` means the grid's device, on the serial grid
CUDA, and raises without it.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import Grid
from ..core.matrix import HermitianMatrix, Matrix
from ..exceptions import slate_error
from ..types import Uplo
from .scalapack import from_scalapack, to_scalapack


def _mat(desc, locals_, grid, device) -> Matrix:
    return from_scalapack(desc, locals_, grid, device=device)


def _herm(uplo, desc, locals_, grid, device) -> HermitianMatrix:
    up = Uplo.Lower if str(uplo).lower().startswith("l") else Uplo.Upper
    return HermitianMatrix._from_view(_mat(desc, locals_, grid, device), up)


def _trans_mat(trans: str, A: Matrix):
    t = trans.lower()
    slate_error(t in ("n", "t", "c"), "trans must be 'n', 't' or 'c'")
    if t == "n":
        return A
    return A.transpose() if t == "t" else A.conj_transpose()


def pdgemm(transa, transb, m, n, k, alpha, desca, a_locals, descb,
           b_locals, beta, descc, c_locals, grid: Grid | None = None,
           device=None):
    """C = alpha op(A) op(B) + beta C (ref: scalapack_gemm.cc
    slate_pdgemm).  Returns (descc, c_locals)."""
    from ..drivers.blas3 import gemm
    A = _trans_mat(transa, _mat(desca, a_locals, grid, device))
    B = _trans_mat(transb, _mat(descb, b_locals, grid, device))
    C = _mat(descc, c_locals, grid, device)
    slate_error((A.m, A.n, B.n) == (m, k, n), "pdgemm: dims vs descriptors")
    return to_scalapack(gemm(alpha, A, B, beta, C))


def pdgesv(n, nrhs, desca, a_locals, descb, b_locals,
           grid: Grid | None = None, device=None):
    """Solve A X = B by LU (ref: scalapack_gesv.cc).  Returns
    (descx, x_locals)."""
    from ..drivers.lu import gesv
    A = _mat(desca, a_locals, grid, device)
    B = _mat(descb, b_locals, grid, device)
    slate_error(A.m == n and B.n == nrhs, "pdgesv: dims vs descriptors")
    _, X = gesv(A, B)
    return to_scalapack(X)


def pdpotrf(uplo, n, desca, a_locals, grid: Grid | None = None,
            device=None):
    """Cholesky factor (ref: scalapack_potrf.cc).  Returns (desc, locals)
    of the triangular factor (L for 'l', U for 'u')."""
    from ..drivers.cholesky import potrf
    A = _herm(uplo, desca, a_locals, grid, device)
    slate_error(A.m == n, "pdpotrf: dims vs descriptor")
    return to_scalapack(potrf(A).general())


def pdposv(uplo, n, nrhs, desca, a_locals, descb, b_locals,
           grid: Grid | None = None, device=None):
    """Hermitian positive-definite solve (ref: scalapack_posv.cc).
    Returns (descx, x_locals)."""
    from ..drivers.cholesky import posv
    A = _herm(uplo, desca, a_locals, grid, device)
    B = _mat(descb, b_locals, grid, device)
    slate_error(A.m == n and B.n == nrhs, "pdposv: dims vs descriptors")
    _, X = posv(A, B)
    return to_scalapack(X)


def pdgels(m, n, nrhs, desca, a_locals, descb, b_locals,
           grid: Grid | None = None, device=None):
    """Least squares min ||A X - B|| (ref: scalapack_gels.cc).  Returns
    (descx, x_locals)."""
    from ..drivers.qr import gels
    A = _mat(desca, a_locals, grid, device)
    B = _mat(descb, b_locals, grid, device)
    slate_error((A.m, A.n, B.n) == (m, n, nrhs),
                "pdgels: dims vs descriptors")
    return to_scalapack(gels(A, B))


def pdsyev(jobz, uplo, n, desca, a_locals, grid: Grid | None = None,
           device=None):
    """Symmetric eigendecomposition (ref: scalapack_heev.cc).  Returns
    (w, descz, z_locals), the z parts None for jobz='n'."""
    from ..drivers.heev import heev
    A = _herm(uplo, desca, a_locals, grid, device)
    slate_error(A.m == n, "pdsyev: dims vs descriptor")
    want_z = str(jobz).lower().startswith("v")
    w, Z = heev(A, jobz=want_z)
    w = w.cpu().numpy()
    if not want_z:
        return w, None, None
    descz, z_locals = to_scalapack(Z)
    return w, descz, z_locals


def pdgesvd(jobu, m, n, desca, a_locals, grid: Grid | None = None,
            device=None):
    """SVD (ref: scalapack_gesvd.cc).  Returns (s, descu, u_locals,
    descvt, vt_locals), the U and V parts None for jobu='n'."""
    from ..drivers.svd import svd
    A = _mat(desca, a_locals, grid, device)
    slate_error((A.m, A.n) == (m, n), "pdgesvd: dims vs descriptor")
    want_uv = str(jobu).lower().startswith("v")
    s, U, V = svd(A, jobu=want_uv)
    s = np.asarray(s.cpu().numpy())
    if not want_uv:
        return s, None, None, None, None
    descu, u_locals = to_scalapack(U)
    descvt, vt_locals = to_scalapack(V.conj_transpose())
    return s, descu, u_locals, descvt, vt_locals
