"""Distributed two-stage SVD stage 1: general m x n (m >= n) -> upper band
over the 2D block-cyclic grid (port of slate_tpu/parallel/dist_ge2tb.py;
ref: src/ge2tb.cc, unmbr_ge2tb.cc).

reference panel k                        | here (every rank, eagerly)
---------------------------------------- | ---------------------------------
geqrf on block column k (rows >= k)      | tile column k gathered (a ring in
                                         |   flight at depth >= 1), factored
                                         |   REPLICATED
unmqr trailing: C -= V Tq^H V^H C        | one all-reduce of G = V^H C along
                                         |   p, then the rank's product
                                         |   (columns > k)
gelqf on block row k (columns >= k+1)    | tile row k gathered along q and
                                         |   broadcast along p, conjugate-
                                         |   transposed, factored REPLICATED
unmlq trailing: C -= (C Vl) Tl Vl^H      | one all-reduce of H = C Vl along
                                         |   q, then the rank's product
                                         |   (rows > k)

A rank keeps its local tiles as one row-major block (as
parallel/dist_he2hb.py does), so that each trailing update is one product
over a strided view.  The packed result is the dense ge2tb packing: the
QR reflectors below the diagonal, the LQ block row merged (L on and below
its diagonal, the conjugated reflector rows above the band), the band on
and above the diagonal (tile (g, g) triu, tile (g, g+1) tril).  Every
depth forms step k's updates with the same calls over the same slices
(depth >= 1 only splits the right update's write-back around the next
panel's gather), so depths 0, 1 and 2 give the same bits.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, AXIS_Q, Grid
from ..util.trace import span
from .dist_he2hb import (factor_window, gather_col, gather_row,
                         global_index, larfb_left_local, own_rows,
                         v_from_gathered)
from .dist_lu import superblock
from .dist_qr import _rows, _tiles
from .dist_trsm import slots


class _GE:
    """One rank's state of the reduction (see :func:`dist_ge2tb`)."""

    def __init__(self, a_loc, Mt: int, Ntn: int, m: int, n: int,
                 grid: Grid, sb: int):
        self.Mt, self.Ntn, self.m, self.n = Mt, Ntn, m, n
        self.grid, self.sb = grid, sb
        self.p, self.q = grid.p, grid.q
        self.r, self.c = grid.coords
        mtl, ntl, nb, _ = a_loc.shape
        self.mtl, self.ntl, self.nb = mtl, ntl, nb
        dev, dt = a_loc.device, a_loc.dtype
        self.A = own_rows(a_loc)
        self.Tqs = torch.zeros((Ntn, nb, nb), dtype=dt, device=dev)
        self.Tls = torch.zeros((Ntn, nb, nb), dtype=dt, device=dev)
        self.grow = global_index(mtl, nb, self.r, self.p, dev)
        self.gcol = global_index(ntl, nb, self.c, self.q, dev)

    def gather(self, k: int, ring: bool) -> cc.Pending:
        with span("slate.ge2tb/bcast_ahead" if ring
                  else "slate.ge2tb/bcast"):
            return gather_col(self.A, k, self.nb, self.grid, ring)

    def qr(self, k: int, flat: torch.Tensor) -> None:
        """QR panel k (block column k, rows >= k), its write-back on the
        owner column and the left update of the columns past k."""
        nb, Mt = self.nb, self.Mt
        lo = k * nb
        k0 = (k // self.sb) * self.sb
        with span("slate.ge2tb/qr_panel"):
            packed, Tq, V = factor_window(flat, lo, Mt * nb, self.m - lo,
                                          (Mt - k0) * nb)
            self.Tqs[k] = Tq
            rows = slots(k, Mt, self.r, self.p)
            r0, r1 = rows.start * nb, rows.stop * nb
            gR = self.grow[r0:r1]
            if self.c == k % self.q and r1 > r0:
                kk = k // self.q
                self.A[r0:r1, kk * nb:(kk + 1) * nb] = packed[gR - lo]
        cols = slots(k + 1, self.Ntn, self.c, self.q)
        c0, c1 = cols.start * nb, cols.stop * nb
        if c1 == c0:
            return                  # nor has any rank of this grid column
        with span("slate.ge2tb/unmqr"):
            Vr = V[gR - lo]
            C = self.A[r0:r1, c0:c1]
            G = cc.reduce_along(Vr.conj().T @ C, AXIS_P, self.grid)
            if r1 > r0:
                C -= Vr @ (Tq.conj().T @ G)

    def lq(self, k: int):
        """LQ panel k (block row k, columns >= k+1), its merged write-back
        on the owner row and the right update's product on the rows past
        k: returns (columns, rows, update) for :meth:`write`."""
        nb, Ntn = self.nb, self.Ntn
        lo = (k + 1) * nb
        k0 = (k // self.sb) * self.sb
        with span("slate.ge2tb/lq_panel"):
            grw = gather_row(self.A, k, nb, self.grid)
            flat = grw[:, :Ntn * nb].conj().T
            packed, Tl, Vl = factor_window(flat, lo, Ntn * nb, self.n - lo,
                                           (Ntn - k0 - 1) * nb)
            self.Tls[k] = Tl
            cols = slots(k + 1, Ntn, self.c, self.q)
            c0, c1 = cols.start * nb, cols.stop * nb
            gC = self.gcol[c0:c1]
            if self.r == k % self.p and c1 > c0:
                # L on and below the block's diagonal, the conjugated
                # reflector rows above: together packed^H
                kk = k // self.p
                self.A[kk * nb:(kk + 1) * nb, c0:c1] = \
                    packed.conj().T[:, gC - lo]
        rows = slots(k + 1, self.Mt, self.r, self.p)
        r0, r1 = rows.start * nb, rows.stop * nb
        if r1 == r0:
            return cols, r0, r1, None   # nor has any rank of this grid row
        with span("slate.ge2tb/unmlq"):
            Vc = Vl[gC - lo]
            B = self.A[r0:r1, c0:c1]
            H = cc.reduce_along(B @ Vc, AXIS_Q, self.grid)
            upd = (H @ Tl) @ Vc.conj().T if c1 > c0 else None
        return cols, r0, r1, upd

    def write(self, tr, c_lo: int, c_hi: int) -> None:
        """Subtract the right update ``tr`` (None when there is no LQ
        panel) from this rank's tiles of the global columns [c_lo,
        c_hi)."""
        if tr is None or tr[3] is None:
            return
        cols, r0, r1, upd = tr
        nb = self.nb
        sub = slots(c_lo, c_hi, self.c, self.q)
        t0 = max(sub.start, cols.start)
        t1 = min(sub.stop, cols.stop)
        if t1 > t0:
            self.A[r0:r1, t0 * nb:t1 * nb] -= \
                upd[:, (t0 - cols.start) * nb:(t1 - cols.start) * nb]


def dist_ge2tb(data, Mt: int, Ntn: int, m: int, n: int, grid: Grid,
               sb: int | None = None, la: int | None = None):
    """Reduce this rank's local tiles of a general m x n (m >= n) matrix to
    the two-stage upper band form (ref: dist_ge2tb.py:209).  The input is
    not changed.  Returns (data, Tqs [Ntn, nb, nb], Tls [Ntn, nb, nb]),
    the Ts the same on every rank (the last LQ triangle zero).  ``sb`` is
    the reference's superblock span (None: its default), which sizes only
    the panel routine's route; ``la`` the lookahead depth (None: the
    tuned ``dist_lookahead`` plan)."""
    nb = data.shape[-1]
    sb = sb if sb is not None else superblock(max(Ntn, 1))
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(n, data.dtype)
    st = _GE(data, Mt, Ntn, m, n, grid, sb)
    nxt = st.gather(0, la > 0)
    for k in range(Ntn):
        st.qr(k, nxt.wait())
        tr = st.lq(k) if has_lq(k, nb, n) else None
        split = k + 1 + la if la else Ntn
        st.write(tr, k + 1, split)
        if k + 1 < Ntn:
            nxt = st.gather(k + 1, la > 0)
        st.write(tr, split, Ntn)
    cc.flush(grid)
    return (_tiles(st.A, st.mtl, st.ntl, nb, nb).contiguous(), st.Tqs,
            st.Tls)


def has_lq(k: int, nb: int, n: int) -> bool:
    """True when block row k has columns right of its panel: an LQ panel
    (the last block column has none, and its LQ triangle stays zero)."""
    return (k + 1) * nb < n


def dist_unmbr_ge2tb_u(a_data, Tqs, z_data, grid: Grid, m: int):
    """Z <- U1 Z, the QR chain in descending order, on this rank's local
    tiles of Z (tiled in rows as A; ref: dist_ge2tb.py:276)."""
    nb = a_data.shape[-1]
    Mt = -(-m // nb)
    a_rows = _rows(a_data)
    mtl_z, ntl_z, _, nbz = z_data.shape
    z_rows = own_rows(z_data)
    r = grid.coords[0]
    gR_all = global_index(mtl_z, nb, r, grid.p, z_data.device)
    for k in reversed(range(Tqs.shape[0])):
        lo = k * nb
        flat = gather_col(a_rows, k, nb, grid).wait()
        V = v_from_gathered(flat, lo, m, Mt * nb)
        rows = slots(k, Mt, r, grid.p)
        r0, r1 = rows.start * nb, rows.stop * nb
        larfb_left_local(z_rows, V, Tqs[k], lo, gR_all[r0:r1], r0, r1, grid)
    return _tiles(z_rows, mtl_z, ntl_z, nb, nbz).contiguous()


def dist_unmbr_ge2tb_v(a_data, Tls, z_data, grid: Grid, n: int):
    """Z <- V1 Z, the LQ chain in descending order, on this rank's local
    tiles of Z, whose rows are A's columns (ref: dist_ge2tb.py:286): each
    V is tile row k of A, gathered and conjugate-transposed."""
    nb = a_data.shape[-1]
    Ntn = -(-n // nb)
    a_rows = _rows(a_data)
    mtl_z, ntl_z, _, nbz = z_data.shape
    z_rows = own_rows(z_data)
    r = grid.coords[0]
    gR_all = global_index(mtl_z, nb, r, grid.p, z_data.device)
    for k in reversed(range(Tls.shape[0])):
        if not has_lq(k, nb, n):
            continue                       # no LQ panel: its T is zero
        lo = (k + 1) * nb
        grw = gather_row(a_rows, k, nb, grid)
        V = v_from_gathered(grw[:, :Ntn * nb].conj().T, lo, n, Ntn * nb)
        rows = slots(k + 1, Ntn, r, grid.p)
        r0, r1 = rows.start * nb, rows.stop * nb
        larfb_left_local(z_rows, V, Tls[k], lo, gR_all[r0:r1], r0, r1, grid)
    return _tiles(z_rows, mtl_z, ntl_z, nb, nbz).contiguous()
