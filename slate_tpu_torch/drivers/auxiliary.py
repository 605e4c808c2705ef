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
    Views and transposes are materialised and measured as general.  A
    root matrix on a grid with a process group is never gathered: each
    rank reduces its own tiles under the structure's masks and the
    partials are all-reduced (:func:`_mesh_norm`), where the reference's
    reductions over its sharded array compile to psum/pmax (ref:
    auxiliary.py:122-150)."""
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
    if sa.sharded:
        return _mesh_norm(norm_type, A, scope)
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


def _mesh_masks(A: BaseMatrix):
    """Masks over this rank's local tiles [mtl, ntl, mb, nb], by GLOBAL
    element index: (stored entries, their strictly off-diagonal part or
    None, unit-diagonal entries or None, global row index, global column
    index)."""
    st = A.storage
    g = st.grid
    r, c = g.coords
    dev = st.data.device
    gi = ((r + g.p * torch.arange(st.mtl, device=dev))[:, None] * st.mb
          + torch.arange(st.mb, device=dev)[None, :])[:, None, :, None]
    gj = ((c + g.q * torch.arange(st.ntl, device=dev))[:, None] * st.nb
          + torch.arange(st.nb, device=dev)[None, :])[None, :, None, :]
    mask = (gi < st.m) & (gj < st.n)
    strict = unit = None
    if isinstance(A, BaseBandMatrix):
        mask = mask & (gj - gi <= A.ku) & (gi - gj <= A.kl)
    if isinstance(A, (SymmetricMatrix, HermitianMatrix,
                      HermitianBandMatrix)):
        lower = A.uplo is Uplo.Lower
        mask = mask & ((gi >= gj) if lower else (gi <= gj))
        strict = mask & (gi != gj)
    elif isinstance(A, BaseTrapezoidMatrix):
        lower = A._uplo_logical() is Uplo.Lower
        unit_diag = A.diag is Diag.Unit
        if unit_diag:
            mask = mask & ((gi > gj) if lower else (gi < gj))
            unit = (gi == gj) & (gi < min(st.m, st.n))
        else:
            mask = mask & ((gi >= gj) if lower else (gi <= gj))
    return mask, strict, unit, gi, gj


def _mesh_sumsq(absa: torch.Tensor, grid) -> torch.Tensor:
    """(scale, sumsq) of |entries| over the whole grid, each rank's
    lassq pair rescaled to the grid-wide scale before the sum:
    ||x||_F = scale * sqrt(sumsq)."""
    from ..comm.collectives import reduce_grid
    scale_l = absa.max()
    safe = torch.where(scale_l == 0, torch.ones_like(scale_l), scale_l)
    ssq_l = ((absa / safe) ** 2).sum()
    scale = reduce_grid(scale_l, grid, op="max")
    gsafe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return scale, reduce_grid(ssq_l * (scale_l / gsafe) ** 2, grid)


def _mesh_norm(norm_type: Norm, A: BaseMatrix, scope: NormScope):
    """The norm of a root matrix on a grid with a process group: each rank
    reduces its local tiles under the structure's masks (ops/norms.py's,
    over global indices), then the partials are all-reduced (max; the
    column or row sums as vectors over the global index; the scaled sum
    of squares)."""
    from ..comm.collectives import reduce_grid
    st = A.storage
    g = st.grid
    mask, strict, unit, gi, gj = _mesh_masks(A)
    absa = torch.where(mask, st.data.abs(), 0)
    if unit is not None:
        absa = torch.where(unit, torch.ones_like(absa), absa)
    ncol = g.q * st.ntl * st.nb
    nrow = g.p * st.mtl * st.mb
    gjf = gj.expand_as(absa).reshape(-1)
    gif = gi.expand_as(absa).reshape(-1)

    def vec(values, index, size):
        v = torch.zeros(size, dtype=values.dtype, device=values.device)
        return v.index_add_(0, index.clamp(max=size - 1), values.reshape(-1))

    if scope is NormScope.Columns:
        v = torch.zeros(ncol, dtype=absa.dtype, device=absa.device)
        v = v.index_reduce_(0, gjf.clamp(max=ncol - 1), absa.reshape(-1),
                            "amax")
        return reduce_grid(v, g, op="max")[:st.n]
    if norm_type is Norm.Max:
        return reduce_grid(absa.max(), g, op="max")
    if norm_type is Norm.Fro:
        if strict is None:
            scale, ssq = _mesh_sumsq(absa, g)
            return scale * torch.sqrt(ssq)
        # the stored off-diagonal entries count twice, the diagonal once
        off = torch.where(strict, absa, 0)
        scale, ssq = _mesh_sumsq(off, g)
        dscale, dssq = _mesh_sumsq(torch.where(strict, 0, absa), g)
        return torch.sqrt(2.0 * scale ** 2 * ssq + dscale ** 2 * dssq)
    if strict is not None:
        # One == Inf: each column's stored sum plus its mirrored row's
        size = max(ncol, nrow)
        v = (vec(absa, gjf, size)
             + vec(torch.where(strict, absa, 0), gif, size))
        return reduce_grid(v, g).max()
    if norm_type is Norm.One:
        return reduce_grid(vec(absa, gjf, ncol), g).max()
    if norm_type is Norm.Inf:
        return reduce_grid(vec(absa, gif, nrow), g).max()
    raise ValueError(norm_type)


def col_norms(A: BaseMatrix):
    """Per-column max-abs (ref: colNorms driver)."""
    return norm(Norm.Max, A, scope=NormScope.Columns)


def redistribute(A: BaseMatrix, mb: int | None = None, nb: int | None = None,
                 grid: Grid | None = None) -> Matrix:
    """General re-distribution between two layouts or grids (ref:
    src/redistribute.cc:17-154, tile-by-tile send/recv).  A root general
    matrix keeping its tile sizes keeps its tiles: between two grids with
    process groups each tile goes point to point from its old owner to
    its new one (:func:`_send_tiles`); from or to a serial grid the tiles
    are re-cut from the canonical order.  A change of tile size, a view or
    a structure is re-tiled from the dense view (an all-gather on every
    rank of a grid with a group)."""
    mb = mb or A.mb
    nb = nb or A.nb
    grid = grid or A.grid
    if (type(A) is Matrix and A.op is Op.NoTrans and A.is_root_view()
            and mb == A.storage.mb and nb == A.storage.nb):
        st = A.storage
        if st.sharded and grid.group is not None:
            return Matrix(_send_tiles(st, grid))
        return Matrix(TileStorage.from_canonical(st.canonical(), A.m, A.n,
                                                 grid))
    return Matrix(TileStorage.from_dense(A.to_dense(), mb, nb, grid))


def _send_tiles(st: TileStorage, grid: Grid) -> TileStorage:
    """``st``'s tiles on ``grid``, moved point to point: every rank sends
    each other rank, in one message, the tiles it owns that the other
    owns on the new grid (in (i, j) order) and receives likewise; tiles
    that stay on a rank are copied.  Every rank of the default group
    takes part."""
    import torch.distributed as dist
    from ..comm.collectives import _wire
    src_g = st.grid
    out = TileStorage.zeros(st.m, st.n, st.mb, st.nb, grid, st.dtype,
                            st.data.device)
    me = dist.get_rank()
    sends, recvs = {}, {}
    for i in range(st.Mt):
        for j in range(st.Nt):
            old = src_g.global_rank(i % src_g.p, j % src_g.q)
            new = grid.global_rank(i % grid.p, j % grid.q)
            old_slot = (i // src_g.p, j // src_g.q)
            new_slot = (i // grid.p, j // grid.q)
            if old == me and new == me:
                out.data[new_slot] = st.data[old_slot]
            elif old == me:
                sends.setdefault(new, []).append(old_slot)
            elif new == me:
                recvs.setdefault(old, []).append(new_slot)
    ops, bufs = [], []
    for peer, slots_ in sorted(sends.items()):
        buf = torch.stack([st.data[s] for s in slots_])
        ops.append(dist.P2POp(dist.isend, _wire(buf), peer))
    for peer, slots_ in sorted(recvs.items()):
        buf = torch.empty((len(slots_), st.mb, st.nb), dtype=st.dtype,
                          device=st.data.device)
        bufs.append((slots_, buf))
        ops.append(dist.P2POp(dist.irecv, _wire(buf), peer))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for slots_, buf in bufs:
        for s, t in zip(slots_, buf):
            out.data[s] = t
    return out
