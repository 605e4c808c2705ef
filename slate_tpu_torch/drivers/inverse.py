"""Triangular inverse and the triangular product of potri: trtri, trtrm
(port of slate_tpu/drivers/inverse.py; ref: src/trtri.cc, src/trtrm.cc).
getri and getriOOP live with the LU drivers, potri with the Cholesky
drivers, as in the reference.
"""

from __future__ import annotations

import torch

from ..core.matrix import (BaseTrapezoidMatrix, HermitianMatrix, Matrix,
                           TriangularMatrix)
from ..core.storage import TileStorage
from ..exceptions import SlateSingularError, slate_error
from ..options import Options
from ..robust import health as _health
from ..types import Diag, Uplo
from ..util.trace import annotate


def _singular_exc(name):
    def make(h: _health.HealthInfo):
        return SlateSingularError(f"{name}: {h.describe()}", info=h.info)
    return make


@annotate("slate.trtri")
def trtri(A: TriangularMatrix, opts: Options | None = None):
    """Triangular inverse (ref: src/trtri.cc): solves op(A) X = I through
    the trsm driver, so it runs where trsm does: the dist_trsm
    substitution pipeline on a mesh (the reference's distributed trtri,
    ref: inverse.py:33), block substitution against the inverted diagonal
    blocks from two block rows up on one device.

    A zero diagonal entry of A makes op(A) exactly singular: reported as
    ``info = k`` (1-based index of the first zero pivot) and resolved
    against ``Option.ErrorPolicy`` (raise, NaN-fill or
    ``(X, HealthInfo)``)."""
    from .blas3 import trsm
    slate_error(isinstance(A, BaseTrapezoidMatrix), "trtri: need triangular")
    n = A.m
    nb = A.storage.nb
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    I = Matrix(TileStorage.from_dense(eye, nb, nb, A.grid))
    X = trsm("l", 1.0, A, I, opts)
    # the result has the effective (logical) triangle of op(A)
    eff_lower = A._uplo_logical() is Uplo.Lower
    Xt = TriangularMatrix._from_view(
        X, Uplo.Lower if eff_lower else Uplo.Upper, A.diag)
    if A.diag is Diag.Unit:
        # a unit diagonal is implicit ones: never singular
        h = _health.from_result(X.storage.data, X.grid)
    else:
        h = _health.merge(
            _health.from_pivots(torch.diagonal(A.to_dense())),
            _health.from_result(X.storage.data, X.grid))
    return _health.finalize("trtri", Xt, h, opts, _singular_exc("trtri"))


@annotate("slate.trtrm")
def trtrm(L: TriangularMatrix, opts: Options | None = None):
    """The Hermitian product of a triangular factor with its adjoint (ref:
    src/trtrm.cc): for a lower Linv, Linv^H Linv, the second half of
    potri, through the herk driver (on a mesh, its triangle-aware
    kernel)."""
    from .blas3 import herk
    n = L.m
    nb = L.storage.nb
    C0 = HermitianMatrix._from_view(
        Matrix.zeros(n, n, nb, nb, L.grid, L.dtype, L.device), Uplo.Lower)
    if L._uplo_logical() is Uplo.Lower:
        C = herk(1.0, L.conj_transpose().general(), 0.0, C0, opts)
    else:
        C = herk(1.0, L.general(), 0.0, C0, opts)
    h = _health.from_result(C.storage.data, C.grid)
    return _health.finalize("trtrm", C, h, opts, _singular_exc("trtrm"))
