"""BLAS-3 drivers (port of slate_tpu/drivers/blas3.py): ``trsm`` and
``as_root_general``, what the Cholesky solve needs.  The rest of BLAS-3
(gemm, trmm, herk/syrk, hemm/symm, ...) comes with a later slice.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.matrix import BaseMatrix, BaseTrapezoidMatrix, Matrix
from ..core.storage import TileStorage
from ..exceptions import slate_error
from ..options import Options, resolve_abft, resolve_target
from ..types import Diag, Op, Side, Uplo


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


def trsm(side, alpha, A, B, opts: Options | None = None) -> Matrix:
    """Solve op(A) X = alpha B (Left) or X op(A) = alpha B (Right), A
    triangular (ref: src/trsm.cc).  From two block rows up, block
    substitution against the batch-inverted diagonal blocks
    (internal/trsm.py); below that one ``torch.linalg.solve_triangular``."""
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
