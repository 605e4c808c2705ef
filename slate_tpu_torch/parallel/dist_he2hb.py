"""Distributed two-stage eig stage 1: Hermitian full -> band over the 2D
block-cyclic grid (port of slate_tpu/parallel/dist_he2hb.py; ref:
src/he2hb.cc:25-600, internal_he2hb_hemm.cc, internal_he2hb_her2k_
offdiag_ranks.cc, unmtr_he2hb.cc).

reference panel k                        | here (every rank, eagerly)
---------------------------------------- | ---------------------------------
geqrf on the panel block column          | tile column k all-gathered along
  (he2hb.cc:112 internal::geqrf)         |   p on its owner column, broadcast
                                         |   along q (a ring in flight at
                                         |   lookahead depth >= 1), factored
                                         |   REPLICATED on every rank by
                                         |   ``householder_panel_blocked``
listBcast of V, T to trailing owners     | (absorbed: the panel is replicated)
he2hb_hemm: Y = A V over lower tiles     | one product over the rank's exact
                                         |   trailing slice: lower entries
                                         |   give A_ij V_j to Y_i and
                                         |   A_ij^H V_i to Y_j, the diagonal
                                         |   read real; ONE all-reduce of Y
                                         |   over the grid
W = Y T - 1/2 V (T^H (V^H Y) T)          | replicated skinny products
her2k: A -= V W^H + W V^H                | one product over the rank's
                                         |   slice, applied to its tiles with
                                         |   gi >= gj: no communication

A rank keeps its local tiles as one row-major block for the whole
reduction (local row s*nb + a is global row (r + p s) nb + a), so that
every trailing slice is a strided view and each panel's products are one
call each.  The panels are factored from the live rows of the tile
window (the ragged last tile's pad rows zero, so that they stay zero
through every update); the panel routine's route is chosen on the
reference's superblocked panel height (``sb``), as the reference's is.
Every depth forms step k's update with the same calls over the same
slice (depth >= 1 only splits its write-back around the next panel's
gather), and the broadcasts move exact bytes, so depths 0, 1 and 2 give
the same bits.  No superblocks: eager torch takes exact slices.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, AXIS_Q, Grid
from ..internal.qr import householder_panel_blocked, unit_lower
from ..util.trace import span
from .dist_lu import superblock
from .dist_qr import _rows, _tiles
from .dist_trsm import slots


def global_index(count: int, nb: int, r: int, p: int,
                 device) -> torch.Tensor:
    """Global element index of each of ``count`` local tiles' rows (or
    columns): local slot s holds global tile r + p s."""
    s = torch.arange(count, device=device)
    a = torch.arange(nb, device=device)
    return ((r + p * s)[:, None] * nb + a[None, :]).reshape(-1)


def own_rows(tiles: torch.Tensor) -> torch.Tensor:
    """A rank's local tiles [S, T, nb, nbc] as one row-major block [S*nb,
    T*nbc] in a new tensor, whatever the shape (a reshape would return a
    view of the caller's tiles where T is 1)."""
    S, T, nb, nbc = tiles.shape
    out = torch.empty((S * nb, T * nbc), dtype=tiles.dtype,
                      device=tiles.device)
    out.view(S, nb, T, nbc).copy_(tiles.permute(0, 2, 1, 3))
    return out


def gather_col(a_rows: torch.Tensor, k: int, nb: int, grid: Grid,
               ring: bool = False) -> cc.Pending:
    """Tile column k of a rank's row-major local block on every rank, as
    one flat column in global row order [p*mtl*nb, nb]: all-gathered
    along p on its owner column, broadcast along q (a ring in flight when
    ``ring``).  Returns a handle whose ``wait()`` gives it (ref:
    dist_lu._gather_panel)."""
    p, q = grid.p, grid.q
    ck = k % q
    mtl = a_rows.shape[0] // nb
    if grid.coords[1] == ck:
        kk = k // q
        g = cc.allgather_along(a_rows[:, kk * nb:(kk + 1) * nb], AXIS_P,
                               grid, concat_axis=None)
        g = g.reshape(p, mtl, nb, nb).transpose(0, 1).reshape(
            p * mtl * nb, nb)
    else:
        g = torch.empty((p * mtl * nb, nb), dtype=a_rows.dtype,
                        device=a_rows.device)
    if ring:
        return cc.ring_bcast_from_col(g, ck, grid)
    return cc.Pending(cc.bcast_from_col(g, ck, grid))


def gather_row(a_rows: torch.Tensor, k: int, nb: int,
               grid: Grid) -> torch.Tensor:
    """Tile row k of a rank's row-major local block on every rank, as one
    flat row in global column order [nb, q*ntl*nb]: all-gathered along q
    on its owner row, broadcast along p (the row mirror of
    :func:`gather_col`; ref: dist_ge2tb._gather_row)."""
    p, q = grid.p, grid.q
    rk = k % p
    ntl = a_rows.shape[1] // nb
    if grid.coords[0] == rk:
        kk = k // p
        g = cc.allgather_along(a_rows[kk * nb:(kk + 1) * nb], AXIS_Q, grid,
                               concat_axis=None)
        g = g.reshape(q, nb, ntl, nb).permute(1, 2, 0, 3).reshape(
            nb, ntl * q * nb)
    else:
        g = torch.empty((nb, q * ntl * nb), dtype=a_rows.dtype,
                        device=a_rows.device)
    return cc.bcast_from_row(g, rk, grid)


def factor_window(flat: torch.Tensor, lo: int, hi: int, live: int,
                  route_rows: int):
    """Factor the panel rows [lo, hi) of a gathered flat column, the rows
    from ``lo + live`` on (pad rows) zeroed, replicated: returns (packed,
    T, V) with V the unit-lower reflector block, zero on the pad rows.
    ``route_rows`` is the height the reference factors (its superblocked
    window), on which the panel routine picks its route."""
    panel = flat[lo:hi].clone()
    panel[live:] = 0
    packed, T = householder_panel_blocked(panel, rows=route_rows)
    V = unit_lower(packed)
    V[live:] = 0
    return packed, T, V


class _HE:
    """One rank's state of the reduction (see :func:`dist_he2hb`)."""

    def __init__(self, a_loc, Nt: int, n: int, grid: Grid, sb: int):
        self.Nt, self.n, self.grid, self.sb = Nt, n, grid, sb
        self.p, self.q = grid.p, grid.q
        self.r, self.c = grid.coords
        mtl, ntl, nb, _ = a_loc.shape
        self.mtl, self.ntl, self.nb = mtl, ntl, nb
        dev = a_loc.device
        self.A = own_rows(a_loc)
        self.Ts = torch.zeros((max(Nt - 1, 1), nb, nb), dtype=a_loc.dtype,
                              device=dev)
        self.grow = global_index(mtl, nb, self.r, self.p, dev)
        self.gcol = global_index(ntl, nb, self.c, self.q, dev)
        # the local column of each local row's diagonal entry (-1 where the
        # rank does not hold it): the diagonal without a host read
        pos = torch.full((max(self.p * mtl, self.q * ntl) * nb,), -1,
                         dtype=torch.int64, device=dev)
        pos[self.gcol] = torch.arange(ntl * nb, device=dev)
        self.diag_col = pos[self.grow]

    def panel(self, k: int, flat: torch.Tensor):
        """Factor panel k (rows (k+1) nb .. of the gathered column k), keep
        its T and write the packed panel back on the owner column; returns
        (V, T) with V over the global rows [(k+1) nb, Nt nb)."""
        nb, Nt = self.nb, self.Nt
        lo = (k + 1) * nb
        k0 = (k // self.sb) * self.sb
        with span("slate.he2hb/panel"):
            packed, T, V = factor_window(flat, lo, Nt * nb, self.n - lo,
                                         (Nt - k0 - 1) * nb)
            self.Ts[k] = T
            if self.c == k % self.q:
                rows = slots(k + 1, Nt, self.r, self.p)
                if rows.stop > rows.start:
                    idx = self.grow[rows.start * nb:rows.stop * nb] - lo
                    kk = k // self.q
                    self.A[rows.start * nb:rows.stop * nb,
                           kk * nb:(kk + 1) * nb] = packed[idx]
        return V, T

    def update(self, k: int, V, T):
        """Y = A V from the stored lower triangle, one all-reduce, W, and
        the her2k product on this rank's trailing slice: returns (cols,
        the masked update) for :meth:`write`."""
        nb, Nt = self.nb, self.Nt
        lo = (k + 1) * nb
        rows = slots(k + 1, Nt, self.r, self.p)
        cols = slots(k + 1, Nt, self.c, self.q)
        r0, r1 = rows.start * nb, rows.stop * nb
        c0, c1 = cols.start * nb, cols.stop * nb
        gR, gC = self.grow[r0:r1], self.gcol[c0:c1]
        Vr, Vc = V[gR - lo], V[gC - lo]
        Aw = self.A[r0:r1, c0:c1]
        with span("slate.he2hb/hemm"):
            Y = torch.zeros_like(V)
            if r1 > r0 and c1 > c0:
                # strictly lower entries both ways, the diagonal once and
                # read real (the reference's _tril_real_diag: a Hermitian
                # diagonal may carry junk imaginary parts in storage)
                low = torch.where(gR[:, None] > gC[None, :], Aw,
                                  torch.zeros((), dtype=Aw.dtype,
                                              device=Aw.device))
                y1 = low @ Vc
                Y[gC - lo] = low.conj().T @ Vr
                jd = self.diag_col[r0:r1] - c0
                on = jd >= 0
                jd = jd.clamp(min=0)
                d = Aw.gather(1, jd[:, None])[:, 0].real.to(Aw.dtype)
                y1 += torch.where(on, d, 0)[:, None] * Vc[jd]
                Y[gR - lo] += y1
            Y = cc.reduce_grid(Y, self.grid)
            VY = V.conj().T @ Y
            W = Y @ T - 0.5 * (V @ (T.conj().T @ VY @ T))
        if r1 == r0 or c1 == c0:
            return cols, None, r0, r1
        with span("slate.he2hb/her2k"):
            Wr, Wc = W[gR - lo], W[gC - lo]
            upd = (torch.cat([Vr, Wr], dim=1)
                   @ torch.cat([Wc, Vc], dim=1).conj().T)
            tile_ge = (gR // nb)[:, None] >= (gC // nb)[None, :]
            upd.masked_fill_(~tile_ge, 0)
        return cols, upd, r0, r1

    def write(self, tr, c_lo: int, c_hi: int):
        """Subtract step k's update from this rank's trailing tiles of the
        global columns [c_lo, c_hi)."""
        cols, upd, r0, r1 = tr
        if upd is None:
            return
        nb = self.nb
        sub = slots(c_lo, c_hi, self.c, self.q)
        t0 = max(sub.start, cols.start)
        t1 = min(sub.stop, cols.stop)
        if t1 <= t0:
            return
        self.A[r0:r1, t0 * nb:t1 * nb] -= \
            upd[:, (t0 - cols.start) * nb:(t1 - cols.start) * nb]

    def gather(self, k: int, ring: bool) -> cc.Pending:
        with span("slate.he2hb/bcast_ahead" if ring
                  else "slate.he2hb/bcast"):
            return gather_col(self.A, k, self.nb, self.grid, ring)


def dist_he2hb(data, Nt: int, grid: Grid, n: int | None = None,
               sb: int | None = None, la: int | None = None):
    """Reduce this rank's local tiles of a Hermitian (lower-stored) matrix
    to band form (ref: dist_he2hb.py:171): diagonal tiles hold the band's
    diagonal blocks, tile (k+1, k) holds R (upper triangle, the band's
    subdiagonal block) over the Householder panel V (strictly below),
    tiles (i, k), i > k+1, the rest of V: the dense he2hb packing.  The
    input is not changed.

    Returns (data, Ts [max(Nt - 1, 1), nb, nb]), the Ts the same on
    every rank.  ``sb`` is the reference's superblock span (None: its
    default), which sizes only the panel routine's route; ``la`` the
    lookahead depth (None: the tuned ``dist_lookahead`` plan)."""
    nb = data.shape[-1]
    n = n if n is not None else Nt * nb
    K = Nt - 1
    sb = sb if sb is not None else superblock(max(K, 1))
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(n, data.dtype)
    st = _HE(data, Nt, n, grid, sb)
    if K > 0:
        nxt = st.gather(0, la > 0)
        for k in range(K):
            V, T = st.panel(k, nxt.wait())
            tr = st.update(k, V, T)
            split = k + 1 + la if la else Nt
            st.write(tr, k + 1, split)
            if k + 1 < K:
                nxt = st.gather(k + 1, la > 0)
            st.write(tr, split, Nt)
        cc.flush(grid)
    return _tiles(st.A, st.mtl, st.ntl, nb, nb).contiguous(), st.Ts


def v_from_gathered(flat: torch.Tensor, b: int, lim: int,
                    hi: int) -> torch.Tensor:
    """The unit-lower reflector block V of a gathered flat panel: its rows
    [b, hi), the unit diagonal from row b, zero from row ``lim`` on (ref:
    dist_he2hb.py:200)."""
    V = unit_lower(flat[b:hi])
    V[max(lim - b, 0):] = 0
    return V


def larfb_left_local(z_rows: torch.Tensor, V: torch.Tensor,
                     Tk: torch.Tensor, lo: int, gR: torch.Tensor,
                     r0: int, r1: int, grid: Grid) -> None:
    """One distributed larfb in place: Z -= V Tk (V^H Z), V replicated over
    the global rows from ``lo``, Z's rows [r0, r1) of the rank's local
    block (global rows ``gR``) inside V's range, one all-reduce along p
    (ref: dist_he2hb.py:217)."""
    Zw = z_rows[r0:r1]
    Vr = V[gR - lo]
    G = cc.reduce_along(Vr.conj().T @ Zw, AXIS_P, grid)
    if r1 > r0:
        Zw -= Vr @ (Tk @ G)


def dist_unmtr_he2hb(a_data, Ts, z_data, Nt: int, grid: Grid,
                     n: int | None = None):
    """Z <- Q1 Z with Q1 the he2hb panel product, on this rank's local
    tiles of Z (tiled in rows as A): the panels in descending order, each
    V rebuilt from the stored tiles on its owner column and broadcast, one
    reduction along p a panel, then local products (ref:
    dist_he2hb.py:226-260, src/unmtr_he2hb.cc)."""
    nb = a_data.shape[-1]
    n = n if n is not None else Nt * nb
    a_rows = _rows(a_data)
    mtl_z, ntl_z, _, nbz = z_data.shape
    z_rows = own_rows(z_data)
    r = grid.coords[0]
    gR_all = global_index(mtl_z, nb, r, grid.p, z_data.device)
    for k in reversed(range(Nt - 1)):
        lo = (k + 1) * nb
        flat = gather_col(a_rows, k, nb, grid).wait()
        V = v_from_gathered(flat, lo, n, Nt * nb)
        rows = slots(k + 1, Nt, r, grid.p)
        r0, r1 = rows.start * nb, rows.stop * nb
        larfb_left_local(z_rows, V, Ts[k], lo, gR_all[r0:r1], r0, r1, grid)
    return _tiles(z_rows, mtl_z, ntl_z, nb, nbz).contiguous()
