"""Auxiliary drivers: ``add`` and ``norm`` (port of those two of
slate_tpu/drivers/auxiliary.py; ref: src/add.cc, src/norm.cc), the ones
the certified speculative rungs call.  copy, scale, scale_row_col, set,
col_norms and redistribute come with queue 1, item 7.
"""

from __future__ import annotations

import torch

from ..core.matrix import (BaseMatrix, BaseTrapezoidMatrix, HermitianMatrix,
                           Matrix, SymmetricMatrix)
from ..exceptions import slate_error
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


def add(alpha, A: BaseMatrix, beta, B: BaseMatrix) -> BaseMatrix:
    """B = alpha A + beta B (ref: src/add.cc -> internal_geadd/tzadd),
    returned as a new matrix of B's class and view; for a trapezoid pair
    only the stored triangle is updated, the rest of B's tiles kept."""
    slate_error(A.m == B.m and A.n == B.n, "add: dims differ")
    if not _simple(A, B):
        return B.with_dense(alpha * A.to_dense() + beta * B.to_dense())
    sa, sb = A.storage, B.storage
    out = alpha * sa.canonical() + beta * sb.canonical()
    if isinstance(B, BaseTrapezoidMatrix):
        out = torch.where(nrm.tri_mask(
            sb.m, sb.n, sb.mb, sb.nb, B._uplo_logical() is Uplo.Lower,
            device=out.device), out, sb.canonical())
    return B._same_view(sb.with_canonical(out))


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
    if isinstance(A, (SymmetricMatrix, HermitianMatrix)):
        return nrm.sy_norm(norm_type, tiles, sa.n, sa.nb,
                           A.uplo is Uplo.Lower,
                           hermitian=isinstance(A, HermitianMatrix))
    if isinstance(A, BaseTrapezoidMatrix):
        return nrm.tr_norm(norm_type, tiles, sa.m, sa.n, sa.mb, sa.nb,
                           A._uplo_logical() is Uplo.Lower,
                           unit_diag=A.diag is Diag.Unit)
    return nrm.ge_norm(norm_type, tiles, sa.m, sa.n, sa.mb, sa.nb)
