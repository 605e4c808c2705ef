"""Distributed right-looking Cholesky over the 2D block-cyclic grid (port
of slate_tpu/parallel/dist_chol.py; ref: potrf.cc:141-302).

reference step k                       | here (every rank, eagerly)
-------------------------------------- | ---------------------------------
internal::potrf on the diagonal tile   | the tile broadcast from its owner
  (potrf.cc:213)                       |   (along p, then q), Hermitian-
                                       |   completed from its lower
                                       |   triangle and factored on every
                                       |   rank by internal/potrf.py
                                       |   ``potrf_tile``: K1 (csrc/
                                       |   chol_tile.cu) for f32 tiles of
                                       |   32 <= nb <= 1024
internal::trsm on the panel column     | ``solve_triangular`` on the owner
  (:225)                               |   column's tiles below the diagonal
listBcastMT(A(i, k) -> row i, col i)   | all-gather along p, broadcast
  (:232-242)                           |   along q: the whole panel on
                                       |   every rank
internal::herk trailing update (:254)  | one product over the rank's exact
                                       |   trailing slice (rows and columns
                                       |   past k)
lookahead tasks (:266-287)             | depth la >= 1: step k's product is
                                       |   formed, columns k+1..k+la written
                                       |   back, panel k+1 factored and its
                                       |   broadcast put in flight (a ring),
                                       |   then the rest of the trailing
                                       |   slice written

No superblocks: the reference's static shrinking slices bound XLA's
compile time, and eager torch takes exact slices.  Only Uplo.Lower is
implemented; the driver maps Upper onto it, as the reference does.

Every depth forms step k's trailing product with the same call over the
same slice (depth >= 1 only splits its write-back around the next
panel), and both broadcast routes move exact bytes, so depths 0, 1 and 2
give the same bits, health and checksum counters included.  Unlike the
reference, depth >= 1 forms the product before it issues the next panel
(a different product shape for the priority columns could round
differently); what overlaps the in-flight broadcast is the write-back.
"""

from __future__ import annotations

import math

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, Grid
from ..internal.herk import herk_panel_update
from ..internal.potrf import potrf_tile
from ..robust import abft as _abft
from ..robust import faults
from ..util.trace import span
from .dist_trsm import pad_diag, slots


def _zero_counts(dev):
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return (z, z, torch.full((), -1, dtype=torch.int64, device=dev))


def _add(cnt, det, cor, site):
    """Accumulate one event: counters sum, the first located site wins."""
    return (cnt[0] + det, cnt[1] + cor,
            torch.where(cnt[2] >= 0, cnt[2], site))


class _Chol:
    """One rank's state of the factorization (see :func:`dist_potrf`)."""

    def __init__(self, a_loc, Nt, n, grid, abft):
        self.a, self.Nt, self.n = a_loc, Nt, n
        self.grid, self.abft = grid, abft
        self.p, self.q = grid.p, grid.q
        self.r, self.c = grid.coords
        self.mtl = a_loc.shape[0]
        self.nb = a_loc.shape[-1]
        dev = a_loc.device
        self.dev = dev
        self.idx = torch.arange(self.nb, device=dev)
        rdt = torch.zeros((), dtype=a_loc.dtype).real.dtype
        self.minpiv = torch.full((), math.inf, dtype=rdt, device=dev)
        self.minidx = torch.zeros((), dtype=torch.int64, device=dev)
        # ``rep``: checks of replicated data (the diagonal factor, the
        # broadcast panel), never summed over the grid; ``loc``: each
        # rank's trailing tiles, summed at the end (ref: dist_chol.py:105)
        self.rep = _zero_counts(dev)
        self.loc = _zero_counts(dev)

    # ---- the diagonal tile and the panel ----
    def factor(self, k: int, ring: bool):
        """Factor diagonal tile k on every rank and solve panel k on its
        owner column; returns the broadcast payload of this rank (its
        panel tiles below the diagonal, with their checksums under
        ABFT)."""
        p, q, nb, a = self.p, self.q, self.nb, self.a
        rk, ck, kkr, kkc = k % p, k % q, k // p, k // q
        vk = nb if k < self.Nt - 1 else self.n - (self.Nt - 1) * nb
        idx = self.idx
        with span("slate.potrf/panel"):
            t = a[kkr, kkc]
            if ring:
                t = cc.ring_bcast_from_row(t, rk, self.grid).wait()
                t = cc.ring_bcast_from_col(t, ck, self.grid).wait()
            else:
                t = cc.bcast_from_row(t, rk, self.grid)
                t = cc.bcast_from_col(t, ck, self.grid)
            # Hermitian-complete from the stored lower triangle: only the
            # lower triangle of the input is ever read
            low = torch.tril(t)
            full = low + low.conj().T
            full.diagonal().copy_(t.diagonal().real)
            hh = pad_diag(full, k, self.Nt, self.n)
            lkk = potrf_tile(hh)
            lkk = faults.maybe_corrupt("post_panel", lkk)
            if self.abft:
                # verify/repair the replicated factor BEFORE the health
                # trace reads its diagonal
                lkk, det, cor = _abft.chol_tile_check(hh, lkk, n_ctx=self.n)
                ev = _abft.count_event(det, cor, k, k)
                self.rep = _add(self.rep, *ev)
            self.lkk = lkk
            vmask = (idx[:, None] < vk) & (idx[None, :] < vk)
            # health: the smallest L diagonal and its global row; a NaN
            # (non-HPD leading minor) counts as a zero pivot
            d = torch.diagonal(lkk).abs()
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            d = torch.where(idx < vk, d, torch.full_like(d, math.inf))
            j = torch.argmin(d)
            better = d[j] < self.minpiv
            self.minpiv = torch.where(better, d[j], self.minpiv)
            self.minidx = torch.where(better, k * nb + j, self.minidx)

            w = nb + 1 if self.abft else nb
            payload = torch.zeros((self.mtl, w, w), dtype=a.dtype,
                                  device=self.dev)
            if self.c == ck:
                if self.r == rk:
                    a[kkr, kkc] = torch.where(vmask, lkk,
                                              torch.zeros_like(lkk))
                sel = slots(k + 1, self.Nt, self.r, p)
                if sel.stop > sel.start:
                    pan = a[sel, kkc]
                    if self.abft:
                        # the checksums of R (the pre-solve panel) ride
                        # the same broadcast: payload [.., nb+1, nb+1]
                        payload[sel, :nb, nb] = pan.sum(dim=2)
                        payload[sel, nb, :nb] = pan.sum(dim=1)
                    # X L^H = pan, the tiles stacked: one solve
                    S = sel.stop - sel.start
                    sol = torch.linalg.solve_triangular(
                        lkk.conj().T, pan.reshape(S * nb, nb), upper=True,
                        left=False).reshape(S, nb, nb)
                    a[sel, kkc] = sol
                    payload[sel, :nb, :nb] = sol
        return payload

    def gather(self, payload, k: int, ring: bool):
        """The panel on every rank: the owner column's tiles all-gathered
        along p, then broadcast along q (a ring in flight when ``ring``).
        Returns a handle whose ``wait()`` gives the stack by global row."""
        with span("slate.potrf/bcast_ahead" if ring else "slate.potrf/bcast"):
            g = cc.allgather_along(payload, AXIS_P, self.grid,
                                   concat_axis=None)
            g = g.transpose(0, 1).reshape(-1, *payload.shape[1:])
            if ring:
                return cc.ring_bcast_from_col(g, k % self.q, self.grid)
            return cc.Pending(cc.bcast_from_col(g, k % self.q, self.grid))

    def finish(self, handle, k: int):
        """The broadcast panel of step k, struck at ``post_collective``
        when a plan is armed and, under ABFT, every live tile verified
        against its checksums (one struck element repaired)."""
        aug = handle.wait()
        nb = self.nb
        if not self.abft:
            return faults.maybe_corrupt("post_collective", aug)
        gpan = faults.maybe_corrupt("post_collective", aug[:, :nb, :nb])
        r_row = aug[:, nb, :nb].conj()                 # (R^H) e
        r_col = aug[:, :nb, nb].conj()                 # e^T R^H
        B = gpan.shape[0]
        xh, det_t, cor_t, _, _ = _abft.left_product_check(
            self.lkk.expand(B, nb, nb), gpan.conj().transpose(1, 2), r_row,
            r_col, unit=False, n_ctx=self.n)
        gpan = xh.conj().transpose(1, 2)
        live = torch.arange(B, device=self.dev) > k
        det_n = (live & det_t).sum()
        cor_n = (live & cor_t).sum()
        ti_g = torch.argmax((live & det_t).to(torch.int64))
        site = torch.where(det_n > 0, _abft.site_code(ti_g, k), -1)
        self.rep = _add(self.rep, det_n, cor_n, site)
        return gpan

    # ---- the trailing update ----
    def trailing(self, k: int, gpan):
        """Step k's trailing product over this rank's exact slice (rows
        and columns past k): returns (rows, cols, new tiles or None, upd)
        for :meth:`write`; under ABFT the new tiles are formed and checked
        here, whole."""
        p, q, Nt = self.p, self.q, self.Nt
        rows = slots(k + 1, Nt, self.r, p)
        cols = slots(k + 1, Nt, self.c, q)
        if rows.stop == rows.start or cols.stop == cols.start:
            return None
        prow = gpan[self.r + p * rows.start:self.r + p * rows.stop:p]
        pcol = gpan[self.c + q * cols.start:self.c + q * cols.stop:q]
        with span("slate.potrf/herk"):
            upd = herk_panel_update(prow, pcol)        # [S, T, nb, nb]
        if not self.abft:
            return rows, cols, None, upd
        cur = self.a[rows, cols]
        pch = pcol.conj().transpose(1, 2)
        exp_r = (cur.sum(dim=3)
                 - _abft.tile_product_row_sums(prow[:, None], pch[None]))
        exp_c = (cur.sum(dim=2)
                 - _abft.tile_product_col_sums(prow[:, None], pch[None]))
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


def dist_potrf(data, Nt: int, grid: Grid, n: int | None = None,
               abft: bool = False, la: int | None = None):
    """Factor the local blocks of a Hermitian (lower) matrix: returns
    ``(data, minpiv, minidx, abft_detected, abft_corrected, abft_site)``,
    the factored local block (lower tiles hold L; the caller's ``data``
    is not written), the smallest L-diagonal magnitude and its global
    row (a NaN diagonal, a non-HPD leading minor, reads as a zero pivot),
    and the checksum counters summed over the grid, all 0-d device
    tensors, the same on every rank (ref: dist_chol.py:454).  ``n`` is
    the element dimension (ragged last tile), ``abft`` verifies the
    diagonal factor, the broadcast panel and the trailing herk, and
    ``la`` is the lookahead depth (None: the tuned ``dist_lookahead``
    plan, depth 0 when untuned)."""
    nb = data.shape[-1]
    n = n if n is not None else Nt * nb
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(n, data.dtype)
    st = _Chol(data.clone(), Nt, n, grid, abft)
    if la == 0:
        for k in range(Nt):
            gpan = st.finish(st.gather(st.factor(k, False), k, False), k)
            tr = st.trailing(k, gpan)
            st.write(tr, k + 1, Nt)
    else:
        nxt = st.gather(st.factor(0, True), 0, True)
        for k in range(Nt):
            gpan = st.finish(nxt, k)
            tr = st.trailing(k, gpan)
            # (1) priority: columns k+1..k+la get step k's update
            st.write(tr, k + 1, k + 1 + la)
            # (2) panel k+1 factored, its broadcast put in flight
            if k + 1 < Nt:
                nxt = st.gather(st.factor(k + 1, True), k + 1, True)
            # (3) the rest of step k's trailing slice
            st.write(tr, k + 1 + la, Nt)
        cc.flush(grid)
    ldet = cc.reduce_grid(st.loc[0], grid)
    lcor = cc.reduce_grid(st.loc[1], grid)
    lsite = cc.reduce_grid(st.loc[2], grid, op="max")
    site = torch.where(st.rep[2] >= 0, st.rep[2], lsite)
    return (st.a, st.minpiv, st.minidx, st.rep[0] + ldet, st.rep[1] + lcor,
            site)
