"""Distributed triangular solve over the 2D block-cyclic grid (port of
slate_tpu/parallel/dist_trsm.py; ref: trsmB.cc -> work_trsm.cc:395).

Left: op(A) X = alpha B with A triangular and B on the same grid.  The
four (uplo, op) cases reduce to forward substitution on an effective
lower factor or backward substitution on an effective upper one; the
panel of effective column k is A's column k (NoTrans) or A's row k with
op applied (Trans / ConjTrans), as work::trsm walks the transposed
matrix.  Step k:

1. the diagonal tile A(k, k) is broadcast from its owner to every rank
   (along p, then along q), op applied, its pad diagonal set to one so
   that a ragged last tile stays nonsingular (B's pad rows are zero, so
   their solution is exactly zero);
2. the owner row of B(k, :) solves its tiles (``solve_triangular``, as
   the reference's XLA ``triangular_solve``) and broadcasts X(k, :)
   along p (the ``post_collective`` fault site);
3. A's effective panel column k is gathered along its owner axis and
   broadcast along the other;
4. every rank updates its unsolved local rows: B(i, :) -= Aeff(i, k)
   X(k, :), over the exact slice of rows below (lower) or above (upper)
   step k.

Right: X op(A) = alpha B by column-block substitution, the mirror with
the q axis in the starring role.  The reference's superblocks bound XLA's
compile time; eager torch needs none.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, AXIS_Q, Grid
from ..internal.gemm import tile_outer_product
from ..robust import faults
from ..types import Op
from ..util.trace import span


def apply_op_tile(t: torch.Tensor, op: Op) -> torch.Tensor:
    """op(t) over the last two axes (ref: internal/trsm.py:18)."""
    if op is Op.NoTrans:
        return t
    t = t.transpose(-1, -2)
    return t.conj() if op is Op.ConjTrans else t


def _diag_tile(a_loc, k: int, grid: Grid) -> torch.Tensor:
    """A(k, k) on every rank: broadcast from its owner along p, then q."""
    p, q = grid.p, grid.q
    t = a_loc[k // p, k // q]
    t = cc.bcast_from_row(t, k % p, grid)
    return cc.bcast_from_col(t, k % q, grid)


def slots(lo: int, hi: int, r: int, p: int) -> slice:
    """The local slots s whose global index r + p*s lies in [lo, hi): a
    contiguous range of a rank's rows (or columns)."""
    s0 = max(0, -(-(lo - r) // p))
    return slice(s0, max(s0, -(-(hi - r) // p)))


def pad_diag(t: torch.Tensor, k: int, Nt: int, n: int) -> torch.Tensor:
    """Diagonal tile k with ones on its pad diagonal (the rows past n, in
    a ragged last tile), so that it stays nonsingular; other tiles as
    they are."""
    nb = t.shape[-1]
    vk = nb if k < Nt - 1 else n - (Nt - 1) * nb
    if vk == nb:
        return t
    idx = torch.arange(nb, device=t.device)
    return t + torch.diag((idx >= vk).to(t.dtype))


def _panel(a_loc, k: int, grid: Grid, op_a: Op, along_cols: bool):
    """A's effective panel k as a global tile stack, on every rank.

    ``along_cols``: the tiles of A's tile column k (owned by grid column
    k % q, stacked by global row: gathered along p, broadcast along q);
    else A's tile row k (grid row k % p, by global column: gathered along
    q, broadcast along p), op applied."""
    p, q = grid.p, grid.q
    if along_cols:
        pan = apply_op_tile(a_loc[:, k // q], op_a)       # [mtl, nb, nb]
        g = cc.allgather_along(pan, AXIS_P, grid, concat_axis=None)
        g = g.transpose(0, 1).reshape(-1, *pan.shape[1:])  # by global row
        return cc.bcast_from_col(g, k % q, grid)
    pan = apply_op_tile(a_loc[k // p], op_a)               # [ntl, nb, nb]
    g = cc.allgather_along(pan, AXIS_Q, grid, concat_axis=None)
    g = g.transpose(0, 1).reshape(-1, *pan.shape[1:])      # by global col
    return cc.bcast_from_row(g, k % p, grid)


def dist_trsm_left(a_data, b_data, alpha, *, Nt: int, grid: Grid,
                   lower: bool, op_a: Op, unit_diag: bool,
                   n: int | None = None):
    """Solve op(A) X = alpha B; returns X in B's local block layout."""
    p = grid.p
    r, _ = grid.coords
    nb = a_data.shape[-1]
    n = n if n is not None else Nt * nb
    ntl_b, nbr = b_data.shape[1], b_data.shape[3]
    b_loc = alpha * b_data
    eff_lower = lower if op_a is Op.NoTrans else not lower
    order = range(Nt) if eff_lower else range(Nt - 1, -1, -1)
    for k in order:
        with span("slate.trsm/bcast"):
            deff = pad_diag(apply_op_tile(_diag_tile(a_data, k, grid), op_a),
                            k, Nt, n)
            kk = k // p
            if r == k % p:
                # the block row's tiles side by side: one solve
                brow = b_loc[kk].permute(1, 0, 2).reshape(nb, ntl_b * nbr)
                xk = torch.linalg.solve_triangular(
                    deff, brow, upper=not eff_lower, left=True,
                    unitriangular=unit_diag)
                xk = xk.reshape(nb, ntl_b, nbr).permute(1, 0, 2)
            else:
                xk = b_loc[kk]
            xk = cc.bcast_from_row(xk, k % p, grid)
            xk = faults.maybe_corrupt("post_collective", xk)
            if r == k % p:
                b_loc[kk] = xk
            live = (k < Nt - 1) if eff_lower else (k > 0)
            if not live:
                continue
            gpan = _panel(a_data, k, grid, op_a,
                          along_cols=op_a is Op.NoTrans)
        with span("slate.trsm/update"):
            sel = (slots(k + 1, Nt, r, p) if eff_lower
                   else slots(0, k, r, p))
            S = sel.stop - sel.start
            if S == 0:
                continue
            arow = gpan[r + p * sel.start:r + p * sel.stop:p]  # [S, nb, nb]
            b_loc[sel] -= tile_outer_product(arow, xk)
    return b_loc


def dist_trsm_right(a_data, b_data, alpha, *, Nt: int, grid: Grid,
                    lower: bool, op_a: Op, unit_diag: bool,
                    n: int | None = None):
    """Solve X op(A) = alpha B; returns X in B's local block layout."""
    q = grid.q
    _, c = grid.coords
    nb = a_data.shape[-1]
    n = n if n is not None else Nt * nb
    mtl_b, mbr = b_data.shape[0], b_data.shape[2]
    b_loc = alpha * b_data
    eff_lower = lower if op_a is Op.NoTrans else not lower
    # X Aeff = B: a lower Aeff couples column k to EARLIER columns, so k
    # walks downward; an upper one walks upward
    order = range(Nt - 1, -1, -1) if eff_lower else range(Nt)
    for k in order:
        with span("slate.trsm/bcast"):
            deff = pad_diag(apply_op_tile(_diag_tile(a_data, k, grid), op_a),
                            k, Nt, n)
            kk = k // q
            if c == k % q:
                # the block column's tiles stacked: one solve
                xk = torch.linalg.solve_triangular(
                    deff, b_loc[:, kk].reshape(mtl_b * mbr, nb),
                    upper=not eff_lower, left=False,
                    unitriangular=unit_diag).reshape(mtl_b, mbr, nb)
            else:
                xk = b_loc[:, kk]
            xk = cc.bcast_from_col(xk, k % q, grid)
            xk = faults.maybe_corrupt("post_collective", xk)
            if c == k % q:
                b_loc[:, kk] = xk
            live = (k > 0) if eff_lower else (k < Nt - 1)
            if not live:
                continue
            # effective row k of A over tile columns j: A(k, j) (NoTrans,
            # grid row k % p) or op(A(j, k)) (grid column k % q)
            gpan = _panel(a_data, k, grid, op_a,
                          along_cols=op_a is not Op.NoTrans)
        with span("slate.trsm/update"):
            sel = (slots(0, k, c, q) if eff_lower
                   else slots(k + 1, Nt, c, q))
            T = sel.stop - sel.start
            if T == 0:
                continue
            acol = gpan[c + q * sel.start:c + q * sel.stop:q]  # [T, nb, nb]
            b_loc[:, sel] -= tile_outer_product(xk, acol)
    return b_loc
