"""Distributed communication-avoiding QR (CAQR) over the 2D block-cyclic
grid (port of slate_tpu/parallel/dist_qr.py; ref: geqrf.cc:195-206,
internal_ttqrt.cc, internal_ttmqr.cc, internal_unmqr.cc).

reference step k                        | here (every rank, eagerly)
--------------------------------------- | ----------------------------------
internal::geqrf local panel             | each grid row factors its OWN
  (internal_geqrf.cc:450)               |   block-cyclic rows of tile column
                                        |   k on the owner column
                                        |   (internal/qr.py ``geqrf_panel``:
                                        |   K5 within its gate), broadcast
                                        |   along q (a ring in flight at
                                        |   lookahead depth >= 1)
ttqrt pairwise tree over panel ranks    | the p nb x nb R factors
                                        |   all-gathered along p and the
                                        |   stacked tree QR factored
                                        |   REPLICATED (``householder_panel``,
                                        |   no kernel)
unmqr + ttmqr trailing updates          | local larfb on the rank's exact
                                        |   trailing slice, one all-reduce
                                        |   along p for the tree stage
T triangles per rank                    | Tloc [p, Kt, nb, nb] and the tree
                                        |   factors Vtree / Ttree, replicated

A rank's rows of a panel are its local tiles from global row k down, in
local order; the R stack takes the grid rows' R factors in the static
order of :func:`_panel_tables`, real rows first, so that no reflector
touches a pad row or a rank without rows.  Both the factorization and the
apply use the same order, which is all correctness needs.  Every depth
forms step k's trailing update with the same calls over the same slice
(depth >= 1 only splits its write-back around the next panel), and the
broadcasts move exact bytes, so depths 0, 1 and 2 give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, Grid
from ..internal.qr import build_t, geqrf_panel, householder_panel, unit_lower
from ..util.trace import span
from .dist_trsm import slots


def _panel_tables(k: int, Mt: int, m: int, nb: int, p: int):
    """Panel k's static tables (ref: dist_qr.py:46-67): ``skip[r]``, the
    local tiles of grid row r above global row k; ``real[r]``, the real
    rows of its R block; ``pos[r]``, its R block's rows in the stack (real
    rows first, grid rows in rotated order from the diagonal owner)."""
    skip = np.array([max(0, -(-(k - r) // p)) for r in range(p)], np.int64)
    real = np.zeros(p, np.int64)
    for r in range(p):
        rows = sum(min(nb, m - gi * nb)
                   for gi in range(k, Mt) if gi % p == r)
        real[r] = min(nb, rows)
    order = [(k + t) % p for t in range(p)]
    pos = np.zeros((p, nb), np.int64)
    nxt = 0
    for r in order:
        pos[r, :real[r]] = np.arange(nxt, nxt + real[r])
        nxt += int(real[r])
    for r in order:
        pad = nb - real[r]
        pos[r, real[r]:] = np.arange(nxt, nxt + pad)
        nxt += pad
    return skip, real, pos


def _rows(tiles: torch.Tensor) -> torch.Tensor:
    """Tiles [S, T, nb, nbc] -> the rows they hold [S*nb, T*nbc]."""
    S, T, nb, nbc = tiles.shape
    return tiles.permute(0, 2, 1, 3).reshape(S * nb, T * nbc)


def _tiles(rows: torch.Tensor, S: int, T: int, nb: int, nbc: int):
    return rows.reshape(S, nb, T, nbc).permute(0, 2, 1, 3)


def _local_apply(C, Vr, Tr, conj_trans: bool):
    W1 = Vr.conj().T @ C
    Tm = Tr.conj().T if conj_trans else Tr
    return C - Vr @ (Tm @ W1)


def _tree_apply(Y, Vs_mine, Ts, conj_trans: bool, grid: Grid):
    """The replicated tree reflector on the R-slot rows ``Y`` [nb, W] of
    every grid row: one all-reduce along p forms Vs^H Y."""
    Z = cc.reduce_along(Vs_mine.conj().T @ Y, AXIS_P, grid)
    Tm = Ts.conj().T if conj_trans else Ts
    return Y - Vs_mine @ (Tm @ Z)


def _panel_apply(C, Vr, Tr, Vs_mine, Ts, conj_trans: bool, grid: Grid):
    """This panel's Q (or Q^H) on the rank's rows ``C`` [h*nb, W] from
    global row k down (h may be 0: the rank then only joins the tree's
    all-reduce).  Q = diag(Q_local) Q_tree: Q^H applies local then tree,
    Q tree then local (ref: dist_qr.py:96-110)."""
    nb = Vs_mine.shape[0]
    live = C.shape[0] > 0

    def tree(C):
        Y = C[:nb] if live else C.new_zeros((nb, C.shape[1]))
        Y = _tree_apply(Y, Vs_mine, Ts, conj_trans, grid)
        if live:
            C = torch.cat([Y, C[nb:]])
        return C

    if conj_trans:
        if live:
            C = _local_apply(C, Vr, Tr, True)
        return tree(C)
    C = tree(C)
    return _local_apply(C, Vr, Tr, False) if live else C


class _QR:
    """One rank's state of the factorization (see :func:`dist_geqrf_data`)."""

    def __init__(self, a_loc, Kt, Mt, m, Nt, grid):
        self.a = a_loc.clone()
        self.Kt, self.Nt, self.grid = Kt, Nt, grid
        self.p, self.q = grid.p, grid.q
        self.r, self.c = grid.coords
        self.mtl, _, self.nb, _ = a_loc.shape
        nb, dt, dev = self.nb, a_loc.dtype, a_loc.device
        self.tables = [_panel_tables(k, Mt, m, nb, self.p)
                       for k in range(Kt)]
        self.Tloc = torch.zeros((Kt, nb, nb), dtype=dt, device=dev)
        self.Vtree = torch.zeros((Kt, self.p * nb, nb), dtype=dt,
                                 device=dev)
        self.Ttree = torch.zeros((Kt, nb, nb), dtype=dt, device=dev)

    def panel(self, k: int, ring: bool):
        """Panel k factored on its owner column (this grid row's rows
        from global row k down, zero-padded to the local height) and
        broadcast along q with its T: a handle whose ``wait()`` gives
        ``[packed; T]`` [(mtl + 1) nb, nb]."""
        nb, mtl, ck = self.nb, self.mtl, k % self.q
        skip = int(self.tables[k][0][self.r])
        with span("slate.geqrf/bcast_ahead" if ring else "slate.geqrf/panel"):
            if self.c == ck:
                slab = torch.zeros((mtl, nb, nb), dtype=self.a.dtype,
                                   device=self.a.device)
                slab[:mtl - skip] = self.a[skip:, k // self.q]
                packed, Tr = geqrf_panel(slab.reshape(mtl * nb, nb))
                pay = torch.cat([packed, Tr])
            else:
                pay = torch.empty(((mtl + 1) * nb, nb), dtype=self.a.dtype,
                                  device=self.a.device)
            if ring:
                return cc.ring_bcast_from_col(pay, ck, self.grid)
            return cc.Pending(cc.bcast_from_col(pay, ck, self.grid))

    def consume(self, k: int, pay):
        """The tree factor of step k and its V write-back; returns the
        reflectors the trailing update needs."""
        nb, mtl, p = self.nb, self.mtl, self.p
        skip, _, pos = self.tables[k]
        skip = int(skip[self.r])
        packed, Tr = pay[:mtl * nb], pay[mtl * nb:]
        self.Tloc[k] = Tr
        with span("slate.geqrf/tree"):
            Rall = cc.allgather_along(torch.triu(packed[:nb]), AXIS_P,
                                      self.grid, concat_axis=None)
            stack = torch.zeros((p * nb, nb), dtype=packed.dtype,
                                device=packed.device)
            stack[torch.as_tensor(pos.reshape(-1), device=packed.device)] = \
                Rall.reshape(p * nb, nb)
            packed_s, taus_s = householder_panel(stack)
            Ts = build_t(packed_s, taus_s)
            Vs = unit_lower(packed_s)
            self.Vtree[k] = Vs
            self.Ttree[k] = Ts
            Vs_mine = Vs[torch.as_tensor(pos[self.r], device=Vs.device)]
        if self.c == k % self.q:
            with span("slate.geqrf/writeback"):
                head = torch.tril(packed[:nb], -1)
                if self.r == k % p:
                    head = head + torch.triu(packed_s[:nb])
                vstore = torch.cat([head, packed[nb:]])
                self.a[skip:, k // self.q] = vstore.reshape(mtl, nb, nb)[
                    :mtl - skip]
        h = mtl - skip
        return unit_lower(packed)[:h * nb], Tr, Vs_mine, Ts

    def trailing(self, k: int, refl):
        """Q^H of step k on this rank's rows from global row k down and
        its columns past k: (cols, new rows) for :meth:`write`."""
        cols = slots(k + 1, self.Nt, self.c, self.q)
        T = cols.stop - cols.start
        if T == 0:
            return None
        skip = int(self.tables[k][0][self.r])
        h = self.mtl - skip
        with span("slate.geqrf/update"):
            C = _rows(self.a[skip:, cols])
            C = _panel_apply(C, *refl, conj_trans=True, grid=self.grid)
        return cols, _tiles(C, h, T, self.nb, self.nb), skip

    def write(self, tr, c_lo: int, c_hi: int):
        """Write back the trailing tiles of global columns [c_lo, c_hi)."""
        if tr is None:
            return
        cols, new, skip = tr
        sub = slots(c_lo, c_hi, self.c, self.q)
        t0 = max(sub.start, cols.start) - cols.start
        t1 = min(sub.stop, cols.stop) - cols.start
        if t1 > t0 and new.shape[0]:
            self.a[skip:, cols.start + t0:cols.start + t1] = new[:, t0:t1]


def dist_geqrf_data(data, Kt: int, Mt: int, m: int, n: int, grid: Grid,
                    la: int | None = None):
    """CAQR of this rank's local tiles (ref: dist_qr.py:265-285): returns
    ``(data, Tloc [p, Kt, nb, nb], Vtree [Kt, p*nb, nb], Ttree [Kt, nb,
    nb])``, the packed local V's with the final R on the diagonal owners,
    every grid row's local T triangles and the tree factors, the last
    three the same on every rank.  ``la`` is the lookahead depth (None:
    the tuned ``dist_lookahead`` plan)."""
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(n, data.dtype)
    st = _QR(data, Kt, Mt, m, -(-n // data.shape[-1]), grid)
    if la == 0:
        for k in range(Kt):
            refl = st.consume(k, st.panel(k, False).wait())
            st.write(st.trailing(k, refl), k + 1, st.Nt)
    else:
        nxt = st.panel(0, True)
        for k in range(Kt):
            refl = st.consume(k, nxt.wait())
            tr = st.trailing(k, refl)
            st.write(tr, k + 1, k + 1 + la)
            if k + 1 < Kt:
                nxt = st.panel(k + 1, True)
            st.write(tr, k + 1 + la, st.Nt)
        cc.flush(grid)
    Tloc = cc.allgather_along(st.Tloc, AXIS_P, grid, concat_axis=None)
    return st.a, Tloc, st.Vtree, st.Ttree


def dist_unmqr_data(a_data, c_data, Tloc, Vtree, Ttree, Kt: int, Mt: int,
                    m: int, grid: Grid, conj_trans: bool):
    """Q (or Q^H) of CAQR factors from the left on this rank's local tiles
    of C, tiled in rows as the factor (ref: dist_qr.py:288-347): the
    panels in order for Q^H, in reverse for Q, each V rebuilt from the
    stored tiles on its owner column and broadcast along q."""
    p, q = grid.p, grid.q
    r, c = grid.coords
    mtl, _, nb, _ = a_data.shape
    _, ntl_c, _, nbc = c_data.shape
    c_loc = c_data.clone()
    dev = a_data.device
    rows = torch.arange(mtl * nb, device=dev)[:, None]
    cols_ = torch.arange(nb, device=dev)[None, :]
    for t in range(Kt):
        k = t if conj_trans else Kt - 1 - t
        ck = k % q
        skip, _, pos = _panel_tables(k, Mt, m, nb, p)
        skip = int(skip[r])
        h = mtl - skip
        if c == ck:
            slab = torch.zeros((mtl, nb, nb), dtype=a_data.dtype, device=dev)
            slab[:h] = a_data[skip:, k // q]
            slab = slab.reshape(mtl * nb, nb)
        else:
            slab = torch.empty((mtl * nb, nb), dtype=a_data.dtype,
                               device=dev)
        slab = cc.bcast_from_col(slab, ck, grid)
        # the head tile: strict lower and the implied unit diagonal
        head = rows < nb
        Vr = torch.where(head & (rows <= cols_), torch.zeros_like(slab),
                         slab)
        Vr = torch.where(head & (rows == cols_), torch.ones_like(slab), Vr)
        Vs_mine = Vtree[k][torch.as_tensor(pos[r], device=dev)]
        C = _rows(c_loc[skip:])
        C = _panel_apply(C, Vr[:h * nb], Tloc[r, k], Vs_mine, Ttree[k],
                         conj_trans, grid)
        if h:
            c_loc[skip:] = _tiles(C, h, ntl_c, nb, nbc)
    return c_loc
