"""Distributed LU over the 2D block-cyclic grid (port of
slate_tpu/parallel/dist_lu.py; ref: getrf.cc:23-240).

reference step k                         | here (every rank, eagerly)
---------------------------------------- | ---------------------------------
getrf_panel: panel ranks, MAXLOC a       | tile column k all-gathered along
  column (internal_getrf.cc:20-119)      |   p on its owner column, broadcast
                                         |   along q (a ring in flight at
                                         |   lookahead depth >= 1) and
                                         |   factored REPLICATED on every
                                         |   rank (internal/getrf.py: K3 for
                                         |   NoPiv, K4's tournament and K3
                                         |   for CALU, the library's pivoted
                                         |   LU, threshold pivoting)
internal::permuteRows (internal_swap.cc) | the <= 2 nb displaced rows of all
                                         |   local columns fetched by their
                                         |   owners, summed along p, written
                                         |   by the owners of their targets
trsm U12 row + listBcast (getrf.cc:174)  | the row-k owners solve their
                                         |   trailing tiles, broadcast along p
batched trailing gemm                    | one product over the rank's exact
                                         |   trailing slice
lookahead tasks                          | depth la >= 1: step k's product
                                         |   formed, columns k+1..k+la written
                                         |   back, panel k+1's gather put in
                                         |   flight, then the rest written

Every rank factors the same replicated panel, so the pivots, the health
trace and the panel's checksum counters are the same on every rank
without a reduction; the U12 and trailing checks count each rank's own
tiles and are summed over the grid once, at the end (ref:
dist_lu.py:146-153).  No superblocks: eager torch takes exact slices.
The CALU tournament sizes its row blocks from the panel height the
reference's superblocked buffer gives it (``sb``), so that the pivots
agree; zero rows lose every pivot contest, so the live rows' factor is
the same at either height.  Every depth forms step k's trailing product
with one call over the same slice, and the broadcasts move exact bytes,
so depths 0, 1 and 2 give the same bits, counters included.

The permutation is one row-permutation vector ``perm`` with ``A[perm] ==
L U`` over the padded row space.  Square matrices only (the gesv path);
the ragged last tile's pad block is identity-augmented in its panel.
"""

from __future__ import annotations

import math

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, AXIS_Q, Grid
from ..internal.gemm import (tile_outer_product, tile_product_col_sums,
                             tile_product_row_sums)
from ..internal.getrf import (panel_lu, panel_lu_nopiv, panel_lu_threshold,
                              panel_lu_tournament)
from ..robust import abft as _abft
from ..robust import faults
from ..util.trace import span
from .dist_chol import _add, _zero_counts
from .dist_trsm import slots

#: the reference's compile-time superblock count (ref: dist_chol.py:58):
#: here it only sizes the CALU row blocks, through :func:`superblock`
SUPERBLOCKS = 16


def superblock(Nt: int, target: int = SUPERBLOCKS) -> int:
    """The reference's superblock span: ``ceil(Nt / target)`` steps."""
    return max(1, -(-Nt // target))


def calu_block_rows(height: int, nb: int, ib: int, mpt: int) -> int:
    """CALU's round-1 row block for a panel of ``height`` rows (ref:
    dist_lu.py:205-209): about ``mpt`` blocks, at least ``ib`` and ``nb``
    rows, a multiple of nb."""
    return max(ib, nb, -(-height // (mpt * nb)) * nb)


class _LU:
    """One rank's state of the factorization (see :func:`dist_getrf`)."""

    def __init__(self, a_loc, Nt, n, grid, method, ib, sb, tau, mpt, depth,
                 abft):
        self.Nt, self.n, self.grid, self.abft = Nt, n, grid, abft
        self.method, self.ib, self.sb = method, ib, sb
        self.tau, self.mpt, self.depth = tau, mpt, depth
        self.p, self.q = grid.p, grid.q
        self.r, self.c = grid.coords
        mtl, ntl, nb, _ = a_loc.shape
        self.mtl, self.nb = mtl, nb
        dev = a_loc.device
        self.dev = dev
        # one spare tile row: the row exchange writes the rows a rank does
        # not own there, so that every rank runs one indexed write
        self.buf = torch.zeros((mtl + 1, ntl, nb, nb), dtype=a_loc.dtype,
                               device=dev)
        self.buf[:mtl] = a_loc
        self.a = self.buf[:mtl]
        self.m_pad = self.p * mtl * nb
        self.perm_g = torch.arange(self.m_pad + Nt * nb, device=dev)
        self.idx = torch.arange(nb, device=dev)
        rdt = torch.zeros((), dtype=a_loc.dtype).real.dtype
        self.minpiv = torch.full((), math.inf, dtype=rdt, device=dev)
        self.minidx = torch.zeros((), dtype=torch.int64, device=dev)
        # ``rep``: checks of the replicated panel, never summed over the
        # grid; ``loc``: each rank's own U12 and trailing tiles, summed at
        # the end (ref: dist_lu.py:146-153)
        self.rep = _zero_counts(dev)
        self.loc = _zero_counts(dev)

    # ---- the panel ----
    def gather(self, k: int, ring: bool):
        """Tile column k on every rank, by global tile row [p*mtl, nb, nb]:
        all-gathered along p on its owner column, broadcast along q (a
        ring in flight when ``ring``).  Returns a handle whose ``wait()``
        gives it.  The other columns join only the broadcast."""
        p, q, nb, ck = self.p, self.q, self.nb, k % self.q
        name = "slate.getrf/bcast_ahead" if ring else "slate.getrf/bcast"
        with span(name):
            if self.c == ck:
                g = cc.allgather_along(self.a[:, k // q], AXIS_P, self.grid,
                                       concat_axis=None)
                g = g.transpose(0, 1).reshape(p * self.mtl, nb, nb)
            else:
                g = torch.empty((p * self.mtl, nb, nb), dtype=self.a.dtype,
                                device=self.dev)
            if ring:
                return cc.ring_bcast_from_col(g, ck, self.grid)
            return cc.Pending(cc.bcast_from_col(g, ck, self.grid))

    def factor(self, k: int, gpan):
        """Factor panel k (tiles k..Nt-1 of the gathered column) on every
        rank; returns (L\\U tiles [Nt-k, nb, nb], the panel permutation)."""
        Nt, nb, n = self.Nt, self.nb, self.n
        vk = nb if k < Nt - 1 else n - (Nt - 1) * nb
        with span("slate.getrf/panel"):
            panel = gpan[k:Nt].reshape((Nt - k) * nb, nb)
            if vk < nb:
                # the ragged last tile (then the panel's only tile): its pad
                # block is the identity
                panel = panel + torch.diag((self.idx >= vk).to(panel.dtype))
            if self.method == "nopiv":
                lu, perm = panel_lu_nopiv(panel)
            elif self.method == "tntpiv":
                k0 = (k // self.sb) * self.sb
                br = calu_block_rows((Nt - k0) * nb, nb, self.ib, self.mpt)
                lu, perm = panel_lu_tournament(panel, block_rows=br,
                                               arity=self.depth)
            elif self.tau < 1.0:
                lu, perm = panel_lu_threshold(panel, self.tau)
            else:
                lu, perm = panel_lu(panel)
            lu = faults.maybe_corrupt("post_panel", lu)
        if self.abft:
            # replicated data, replicated counters: panel row i0 is global
            # element row k*nb + i0
            lu, det, cor, pi_, _ = _abft.lu_panel_check(panel, lu, perm,
                                                        n_ctx=n)
            self.rep = _add(self.rep, *_abft.count_event(det, cor,
                                                         k + pi_ // nb, k))
        lut = lu.reshape(Nt - k, nb, nb)
        # health: this step's U diagonal; NaN counts as a zero pivot, the
        # ragged tile's pad entries are excluded
        d = torch.diagonal(lut[0]).abs()
        d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
        d = torch.where(self.idx < vk, d, torch.full_like(d, math.inf))
        j = torch.argmin(d)
        better = d[j] < self.minpiv
        self.minpiv = torch.where(better, d[j], self.minpiv)
        self.minidx = torch.where(better, k * nb + j, self.minidx)
        return lut, perm

    def exchange(self, k: int, perm):
        """Apply the panel's row permutation to every local column (left,
        panel and right): the <= 2 nb displaced rows, fetched by their
        owners and summed along p, are written by the owners of their
        target rows (ref: _row_bundle_exchange, dist_lu.py:92-122)."""
        p, nb, r, mtl = self.p, self.nb, self.r, self.mtl
        w = perm.shape[0]
        with span("slate.getrf/swap"):
            iota = torch.arange(w, device=self.dev)
            # the displaced rows, lowest first (fixed points pad the
            # bundle, rewriting a row with itself), with no host read
            key = torch.where(perm != iota, w - iota, 0)
            moved = torch.topk(key, min(2 * nb, w)).indices
            dst = moved + k * nb
            src = perm[moved] + k * nb
            st_, so = src // nb, src % nb
            mine = (st_ % p) == r
            rows = self.a[(st_ // p).clamp(max=mtl - 1), :, so, :]
            rows = torch.where(mine[:, None, None], rows,
                               torch.zeros_like(rows))
            rows = cc.reduce_along(rows, AXIS_P, self.grid)
            dt_ = dst // nb
            slot = torch.where((dt_ % p) == r, dt_ // p, mtl)
            self.buf[slot, :, dst % nb, :] = rows
            pw = self.perm_g[k * nb:k * nb + w]
            self.perm_g[k * nb:k * nb + w] = pw[perm]

    def write_panel(self, k: int, lut):
        """The factored panel into its owner column's tiles."""
        if self.c != k % self.q:
            return
        rows = slots(k, self.Nt, self.r, self.p)
        if rows.stop > rows.start:
            g0 = self.r + self.p * rows.start - k
            self.a[rows, k // self.q] = lut[g0::self.p][:rows.stop
                                                         - rows.start]

    # ---- U12 and the trailing update ----
    def solve_u12(self, k: int, l11):
        """U12 = L11^-1 A(k, j) for this rank's trailing columns, solved by
        the row-k owners and broadcast along p (with R's checksums under
        ABFT, verified and repaired on every rank); returns them
        [T, nb, nb] (None when the rank has none)."""
        p, nb, n = self.p, self.nb, self.n
        rk, kkr = k % p, k // p
        cols = slots(k + 1, self.Nt, self.c, self.q)
        T = cols.stop - cols.start
        if T == 0:
            return None
        with span("slate.getrf/trsm"):
            w = nb + 1 if self.abft else nb
            pay = torch.empty((T, w, w), dtype=self.a.dtype, device=self.dev)
            if self.r == rk:
                urow = self.a[kkr, cols]
                u12 = torch.linalg.solve_triangular(
                    l11, urow.permute(1, 0, 2).reshape(nb, T * nb),
                    upper=False, unitriangular=True)
                pay[:, :nb, :nb] = u12.reshape(nb, T, nb).permute(1, 0, 2)
                if self.abft:
                    # R's checksums ride the same broadcast
                    pay[:, :nb, nb] = urow.sum(dim=2)
                    pay[:, nb, :nb] = urow.sum(dim=1)
                    pay[:, nb, nb] = 0
            pay = cc.bcast_from_row(pay, rk, self.grid)
            if not self.abft:
                u12 = faults.maybe_corrupt("post_collective", pay)
            else:
                u12 = faults.maybe_corrupt("post_collective",
                                           pay[:, :nb, :nb])
                u12, det_t, cor_t, _, _ = _abft.left_product_check(
                    l11.expand(T, nb, nb), u12, pay[:, :nb, nb],
                    pay[:, nb, :nb], unit=True, n_ctx=n)
                # each global tile counted once: on its owner row only
                if self.r == rk:
                    tj = torch.argmax(det_t.to(torch.int64))
                    det_n = det_t.sum()
                    site = torch.where(det_n > 0, _abft.site_code(
                        k, self.c + self.q * (cols.start + tj)), -1)
                    self.loc = _add(self.loc, det_n, cor_t.sum(), site)
            if self.r == rk:
                self.a[kkr, cols] = u12
        return u12

    def trailing(self, k: int, lut, u12):
        """Step k's trailing product over this rank's exact slice (rows
        and columns past k): (rows, cols, new tiles or None, upd) for
        :meth:`write`; under ABFT the new tiles are formed and checked
        here, whole."""
        p, q, Nt = self.p, self.q, self.Nt
        rows = slots(k + 1, Nt, self.r, p)
        cols = slots(k + 1, Nt, self.c, q)
        S = rows.stop - rows.start
        if S == 0 or u12 is None:
            return None
        prow = lut[self.r + p * rows.start - k::p][:S]
        with span("slate.getrf/gemm"):
            upd = tile_outer_product(prow, u12)            # [S, T, nb, nb]
        if not self.abft:
            return rows, cols, None, upd
        cur = self.a[rows, cols]
        exp_r = (cur.sum(dim=3)
                 - tile_product_row_sums(prow[:, None], u12[None]))
        exp_c = (cur.sum(dim=2)
                 - tile_product_col_sums(prow[:, None], u12[None]))
        new, ev, ti_l, tj_l = _abft.tile_sum_check(cur - upd, exp_r, exp_c,
                                                   n_ctx=self.n)
        gi = self.r + p * (rows.start + ti_l)
        gj = self.c + q * (cols.start + tj_l)
        site = torch.where(ev.detected > 0, _abft.site_code(gi, gj), -1)
        self.loc = _add(self.loc, ev.detected, ev.corrected, site)
        return rows, cols, new, upd

    def write(self, tr, c_lo: int, c_hi: int):
        """Write back the trailing tiles of global columns [c_lo, c_hi)."""
        if tr is None:
            return
        rows, cols, new, upd = tr
        sub = slots(c_lo, c_hi, self.c, self.q)
        t0 = max(sub.start, cols.start) - cols.start
        t1 = min(sub.stop, cols.stop) - cols.start
        if t1 <= t0:
            return
        dst = self.a[rows, cols.start + t0:cols.start + t1]
        if new is None:
            dst.sub_(upd[:, t0:t1])
        else:
            dst.copy_(new[:, t0:t1])

    def step(self, k: int, gpan):
        """Factor panel k, exchange its rows, write it back and solve its
        U12 row; returns the trailing product for :meth:`write`."""
        lut, perm = self.factor(k, gpan)
        if self.method != "nopiv":
            self.exchange(k, perm)
        self.write_panel(k, lut)
        if k == self.Nt - 1:
            return None
        u12 = self.solve_u12(k, lut[0])
        return self.trailing(k, lut, u12)


def dist_getrf(data, Nt: int, grid: Grid, n: int, method: str = "partial",
               ib: int = 16, sb: int | None = None, tau: float = 1.0,
               mpt: int = 4, depth: int = 2, abft: bool = False,
               la: int | None = None):
    """Factor this rank's local tiles of a square matrix; returns ``(data,
    perm, minpiv, minidx, abft_detected, abft_corrected, abft_site)``
    with A[perm] = L U (perm over the padded row space, identity on the
    pads; the caller's ``data`` is not written), the smallest |U
    diagonal| and its global row, and the checksum counters summed over
    the grid, all the same on every rank (ref: dist_lu.py:570).

    ``method`` is "partial", "nopiv" or "tntpiv"; ``tau`` < 1 switches
    partial pivoting to threshold pivoting (Option.PivotThreshold);
    ``mpt`` (Option.MaxPanelThreads), ``ib`` (Option.InnerBlocking) and
    ``sb``, the reference's superblock span, size the CALU row blocks,
    ``depth`` (Option.Depth) is its tree's fan-in.  ``abft`` verifies
    every panel, U12 broadcast and trailing update.  ``la`` is the
    lookahead depth (None: the tuned ``dist_lookahead`` plan, 0 when
    untuned); the ragged last tile's pad entries are left for the caller
    to clear."""
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(n, data.dtype)
    sb = sb if sb is not None else superblock(Nt)
    st = _LU(data, Nt, n, grid, method, ib, sb, tau, mpt, depth, abft)
    if la == 0:
        for k in range(Nt):
            tr = st.step(k, st.gather(k, False).wait())
            st.write(tr, k + 1, Nt)
    else:
        nxt = st.gather(0, True)
        for k in range(Nt):
            tr = st.step(k, nxt.wait())
            # (1) priority: columns k+1..k+la get step k's update
            st.write(tr, k + 1, k + 1 + la)
            # (2) panel k+1's gather put in flight
            if k + 1 < Nt:
                nxt = st.gather(k + 1, True)
            # (3) the rest of step k's trailing slice
            st.write(tr, k + 1 + la, Nt)
        cc.flush(grid)
    ldet = cc.reduce_grid(st.loc[0], grid)
    lcor = cc.reduce_grid(st.loc[1], grid)
    lsite = cc.reduce_grid(st.loc[2], grid, op="max")
    site = torch.where(st.rep[2] >= 0, st.rep[2], lsite)
    return (st.a, st.perm_g[:st.m_pad], st.minpiv, st.minidx,
            st.rep[0] + ldet, st.rep[1] + lcor, site)


def local_entry_mask(st) -> torch.Tensor:
    """[mtl, ntl, mb, nb] mask of a sharded storage's local entries that
    lie inside the m x n matrix (False on the pads)."""
    g = st.grid
    r, c = g.coords
    dev = st.data.device
    gi = ((r + g.p * torch.arange(st.mtl, device=dev))[:, None] * st.mb
          + torch.arange(st.mb, device=dev)[None])
    gj = ((c + g.q * torch.arange(st.ntl, device=dev))[:, None] * st.nb
          + torch.arange(st.nb, device=dev)[None])
    return (gi < st.m)[:, None, :, None] & (gj < st.n)[None, :, None, :]


def _strip_index(g: torch.Tensor, nb: int, p: int, mtl: int):
    """Index of global element row ``g`` in a column strip gathered along
    p ([p, mtl, nb] rows flattened, member-major)."""
    gt = g // nb
    return (gt % p) * (mtl * nb) + (gt // p) * nb + g % nb


def _my_rows(r: int, p: int, mtl: int, nb: int, dev) -> torch.Tensor:
    """The global element rows of this rank's local tile rows, in order."""
    gt = r + p * torch.arange(mtl, device=dev)
    return (gt[:, None] * nb + torch.arange(nb, device=dev)[None]).reshape(-1)


def dist_permute_rows(b_data, perm, grid: Grid):
    """new B[g, :] = old B[perm[g], :] on this rank's local tiles (the
    getrs pivot apply; ref: dist_lu.py:467-510).  Each rank all-gathers its
    tile-column strip along p (an m x n/q slice, never the whole matrix)
    and takes its own rows from it.  B's row tiling may differ from the
    LU's: ``perm`` is extended by the identity over B's own padded row
    space."""
    p = grid.p
    r = grid.coords[0]
    mtl, ntl, mb, nbr = b_data.shape
    dev = b_data.device
    m_pad = p * mtl * mb
    perm = perm.to(dev)
    perm_pad = torch.cat([perm, torch.arange(perm.shape[0], m_pad,
                                             device=dev)])
    allb = cc.allgather_along(b_data, AXIS_P, grid, concat_axis=None)
    strip = allb.permute(0, 1, 3, 2, 4).reshape(m_pad, ntl, nbr)
    src = perm_pad[_my_rows(r, p, mtl, mb, dev)]
    mine = strip[_strip_index(src, mb, p, mtl)]
    return mine.reshape(mtl, mb, ntl, nbr).permute(0, 2, 1, 3).contiguous()


def dist_rbt_two_sided(data, u_levels, v_levels, grid: Grid, n: int,
                       Mt: int):
    """The two-sided butterfly U^T diag(A, I_pad) V on this rank's local
    tiles (ref: dist_lu.py:513-568), over the Mt*nb global rows and
    columns (``u_levels``/``v_levels`` of that size): the tile-column strip
    all-gathered along p for the row pass, then the tile-row strip along
    q for the column pass, each an elementwise pass in global order.  The
    reference sizes its strips p*mtl*nb and fails where that exceeds
    Mt*nb (a 4 x 2 grid at Mt = 6); storage pad tiles stay zero here."""
    from ..internal import rbt
    p, q = grid.p, grid.q
    r, c = grid.coords
    mtl, ntl, nb, _ = data.shape
    dev = data.device
    size = Mt * nb
    data = data.clone()
    # the pad diagonal is 1: the transform acts on diag(A, I), not
    # diag(A, 0); the entries past n lie in the last tile row and column
    for g in range(n, size):
        gt = g // nb
        if gt % p == r and gt % q == c:
            data[gt // p, gt // q, g % nb, g % nb] = 1
    gidx = torch.arange(size, device=dev)
    # row pass: U^T (.) on the column strip in global row order
    allp = cc.allgather_along(data, AXIS_P, grid, concat_axis=None)
    strip = allp.permute(0, 1, 3, 2, 4).reshape(p * mtl * nb, ntl, nb)
    ordered = rbt.apply_axis(u_levels, strip[_strip_index(gidx, nb, p, mtl)],
                             "t", 0)
    full = torch.zeros((p * mtl * nb, ntl, nb), dtype=data.dtype,
                       device=dev)
    full[:size] = ordered
    mine = _my_rows(r, p, mtl, nb, dev)
    rows_done = full[mine].reshape(mtl, nb, ntl, nb).permute(0, 2, 1, 3)
    # column pass: (.) V on the row strip in global column order
    allq = cc.allgather_along(rows_done.contiguous(), AXIS_Q, grid,
                              concat_axis=None)
    cstrip = allq.permute(1, 3, 0, 2, 4).reshape(mtl, nb, q * ntl * nb)
    cordered = rbt.apply_axis(v_levels,
                              cstrip[:, :, _strip_index(gidx, nb, q, ntl)],
                              "t", 2)
    cfull = torch.zeros((mtl, nb, q * ntl * nb), dtype=data.dtype,
                        device=dev)
    cfull[:, :, :size] = cordered
    out = cfull[:, :, _my_rows(c, q, ntl, nb, dev)]
    return out.reshape(mtl, nb, ntl, nb).permute(0, 2, 1, 3).contiguous()
