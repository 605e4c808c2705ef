"""Auxiliary drivers: add, copy, scale, scale_row_col, set, norm,
col_norms, redistribute (port of slate_tpu/drivers/auxiliary.py; ref:
src/add.cc, src/copy.cc, src/scale.cc, src/scale_row_col.cc, src/set.cc,
src/norm.cc, src/redistribute.cc:17-154).

Root, untransposed operands of one structure run the tile kernels of
ops/elementwise.py and ops/norms.py on the canonical tiles; any other mix
of views, ops and structures takes the dense path, which is right for all
of them.  Every driver returns a new matrix and leaves its operands as
they were.
"""

from __future__ import annotations

import torch

from ..core.grid import Grid
from ..core.matrix import (BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
                           HermitianBandMatrix, HermitianMatrix, Matrix,
                           SymmetricMatrix)
from ..core.storage import TileStorage
from ..exceptions import slate_error
from ..ops import elementwise as ew
from ..ops import norms as nrm
from ..options import NormScope
from ..types import Diag, Norm, Op, Uplo


def _simple(*mats) -> bool:
    """True when tile kernels may run directly on storage: every operand
    is a root, untransposed view AND the operands agree structurally (all
    general, or all the same trapezoid class with matching uplo/diag).
    Otherwise the drivers take the dense path, which is right for any
    view/op/structure mix."""
    if not all(m.is_root_view() and m.op is Op.NoTrans for m in mats):
        return False
    first = mats[0]
    if type(first) is Matrix:
        return all(type(m) is Matrix for m in mats)
    return all(type(m) is type(first) and m.uplo is first.uplo
               and m.diag is first.diag for m in mats)


def _vector(v, like: BaseMatrix) -> torch.Tensor:
    """A scaling vector (array, list or tensor) as a tensor on ``like``'s
    device, its own dtype kept (a wider vector widens the product, as
    the reference's promotion does)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return t.to(like.device)


def add(alpha, A: BaseMatrix, beta, B: BaseMatrix) -> BaseMatrix:
    """B = alpha A + beta B (ref: src/add.cc -> internal_geadd/tzadd),
    returned as a new matrix of B's class and view; for a trapezoid pair
    only the stored triangle is updated, the rest of B's tiles kept."""
    slate_error(A.m == B.m and A.n == B.n, "add: dims differ")
    if not _simple(A, B):
        return B.with_dense(alpha * A.to_dense() + beta * B.to_dense())
    sa, sb = A.storage, B.storage
    if isinstance(B, BaseTrapezoidMatrix):
        out = ew.tzadd(alpha, sa.canonical(), beta, sb.canonical(), sb.m,
                       sb.n, sb.mb, sb.nb, B._uplo_logical() is Uplo.Lower)
    else:
        out = ew.geadd(alpha, sa.canonical(), beta, sb.canonical())
    return B._same_view(sb.with_canonical(out))


def copy(A: BaseMatrix, B: BaseMatrix) -> BaseMatrix:
    """B = A converted to B's dtype (ref: src/copy.cc gecopy/tzcopy)."""
    slate_error(A.m == B.m and A.n == B.n, "copy: dims differ")
    if not _simple(A, B):
        return B.with_dense(A.to_dense().to(B.dtype))
    sa, sb = A.storage, B.storage
    if isinstance(B, BaseTrapezoidMatrix):
        out = ew.tzcopy(sa.canonical(), sb.canonical(), sb.m, sb.n, sb.mb,
                        sb.nb, B._uplo_logical() is Uplo.Lower, sb.dtype)
    else:
        out = ew.gecopy(sa.canonical(), sb.dtype)
    return B._same_view(sb.with_canonical(out))


def scale(numer, denom, A: BaseMatrix) -> BaseMatrix:
    """A *= numer / denom (ref: src/scale.cc)."""
    if not _simple(A):
        return A.with_dense(A.to_dense() * (numer / denom))
    sa = A.storage
    if isinstance(A, BaseTrapezoidMatrix):
        out = ew.tzscale(numer, denom, sa.canonical(), sa.m, sa.n, sa.mb,
                         sa.nb, A._uplo_logical() is Uplo.Lower)
    else:
        out = ew.gescale(numer, denom, sa.canonical())
    return A._same_view(sa.with_canonical(out))


def scale_row_col(r, c, A: BaseMatrix) -> BaseMatrix:
    """A[i, j] *= r[i] c[j] (ref: src/scale_row_col.cc, equilibration)."""
    r, c = _vector(r, A), _vector(c, A)
    if not _simple(A):
        return A.with_dense(A.to_dense() * r[:, None] * c[None, :])
    sa = A.storage
    out = ew.gescale_row_col(r, c, sa.canonical(), sa.m, sa.n, sa.mb, sa.nb)
    return A._same_view(sa.with_canonical(out))


def set(offdiag, diag, A: BaseMatrix) -> BaseMatrix:  # noqa: A001
    """A = offdiag off the diagonal, diag on it (ref: src/set.cc)."""
    if not _simple(A):
        d = torch.full((A.m, A.n), offdiag, dtype=A.dtype, device=A.device)
        d.diagonal().fill_(diag)
        return A.with_dense(d)
    sa = A.storage
    if isinstance(A, BaseTrapezoidMatrix):
        out = ew.tzset(offdiag, diag, sa.canonical(), sa.m, sa.n, sa.mb,
                       sa.nb, A._uplo_logical() is Uplo.Lower)
    else:
        out = ew.geset(offdiag, diag, sa.canonical(), sa.m, sa.n, sa.mb,
                       sa.nb)
    return A._same_view(sa.with_canonical(out))


def norm(norm_type: Norm, A: BaseMatrix,
         scope: NormScope = NormScope.Matrix):
    """Matrix norm dispatching on structure (ref: src/norm.cc), as a 0-d
    tensor on A's device (``scope=Columns``: the per-column max-abs).
    Views and transposes are materialised and measured as general."""
    if not _simple(A) or (scope is NormScope.Columns
                          and type(A) is not Matrix):
        absd = A.to_dense().abs()
        if scope is NormScope.Columns:
            return absd.amax(dim=0)
        if norm_type is Norm.Max:
            return absd.max()
        if norm_type is Norm.One:
            return absd.sum(dim=0).max()
        if norm_type is Norm.Inf:
            return absd.sum(dim=1).max()
        return torch.linalg.norm(A.to_dense())
    sa = A.storage
    tiles = sa.canonical()
    if scope is NormScope.Columns:
        return nrm.ge_col_norms(tiles, sa.m, sa.n, sa.mb, sa.nb)
    if isinstance(A, HermitianBandMatrix):
        return nrm.hb_norm(norm_type, tiles, sa.n, sa.nb, A.kd,
                           A.uplo is Uplo.Lower)
    if isinstance(A, BaseBandMatrix):
        return nrm.gb_norm(norm_type, tiles, sa.m, sa.n, sa.mb, sa.nb,
                           A.kl, A.ku)
    if isinstance(A, (SymmetricMatrix, HermitianMatrix)):
        return nrm.sy_norm(norm_type, tiles, sa.n, sa.nb,
                           A.uplo is Uplo.Lower,
                           hermitian=isinstance(A, HermitianMatrix))
    if isinstance(A, BaseTrapezoidMatrix):
        return nrm.tr_norm(norm_type, tiles, sa.m, sa.n, sa.mb, sa.nb,
                           A._uplo_logical() is Uplo.Lower,
                           unit_diag=A.diag is Diag.Unit)
    return nrm.ge_norm(norm_type, tiles, sa.m, sa.n, sa.mb, sa.nb)


def col_norms(A: BaseMatrix):
    """Per-column max-abs (ref: colNorms driver)."""
    return norm(Norm.Max, A, scope=NormScope.Columns)


def redistribute(A: BaseMatrix, mb: int | None = None, nb: int | None = None,
                 grid: Grid | None = None) -> Matrix:
    """Re-tile a matrix (ref: src/redistribute.cc:17-154).  A root general
    matrix keeping its tile sizes keeps its tiles; anything else is
    re-tiled from its dense view.  The port holds 1 x 1 grids only."""
    mb = mb or A.mb
    nb = nb or A.nb
    grid = grid or A.grid
    if (type(A) is Matrix and A.op is Op.NoTrans and A.is_root_view()
            and mb == A.storage.mb and nb == A.storage.nb):
        return Matrix(TileStorage.from_canonical(A.storage.canonical(), A.m,
                                                 A.n, grid))
    return Matrix(TileStorage.from_dense(A.to_dense(), mb, nb, grid))
