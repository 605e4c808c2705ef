"""Distributed gemm: stationary-C SUMMA over the 2D block-cyclic grid
(port of slate_tpu/parallel/summa.py; ref: gemmC.cc:29-192,
internal_gemm.cc:383-688).

reference                             | here
------------------------------------- | ----------------------------------
fori_loop over k inside shard_map     | a Python loop over k on every rank
bcast_from_col / bcast_from_row       | ``dist.broadcast`` in the grid row /
  (masked psum, depth 0)              |   column (comm/collectives.py)
ring_bcast (ppermute, depth >= 1)     | ring of isend/irecv, step k+la's
                                      |   issued before step k accumulates
one einsum over the local tile batch  | one matmul (internal/gemm.py) into
                                      |   an accumulator kept as the local
                                      |   dense block [mtl*mb, ntl*nb]

Every depth accumulates the same products in the same order, and both
broadcasts move the owner's exact bytes, so depths 0, 1 and 2 give the
same bits, checksum counters included; depth 0 stays the oracle.  Unlike
the reference's static loop, the pipeline issues no broadcast past the
last step.
"""

from __future__ import annotations

import collections

import torch

from ..comm import collectives as cc
from ..core.grid import Grid
from ..robust import abft as _abft
from ..robust import faults
from ..util.trace import span


def _tiles(acc: torch.Tensor, mtl: int, mb: int, ntl: int, nb: int):
    """Local dense block [mtl*mb, ntl*nb] -> tiles [mtl, ntl, mb, nb]."""
    return acc.reshape(mtl, mb, ntl, nb).permute(0, 2, 1, 3).contiguous()


def summa_local(a_loc, b_loc, c_loc, alpha, beta, Kt: int, grid: Grid,
                abft: bool = False, la: int = 0):
    """This rank's SUMMA: a_loc [mtl, ktl_a, mb, kb], b_loc [ktl_b, ntl,
    kb, nb], c_loc [mtl, ntl, mb, nb] its block-cyclic tiles.  Returns
    ``alpha sum_k A(:, k) B(k, :) + beta C`` as local tiles and, with
    ``abft``, ``(tiles, detected, corrected, site)``: Huang-Abraham
    checksums of the accumulator carried through the k loop from the
    broadcast panels (no extra communication), one struck element
    repaired, the counters summed and the site maxed over the grid as
    0-d tensors (ref: summa.py:41-163).  ``la`` (0, 1, 2) is the
    lookahead depth (see the module docstring)."""
    p, q = grid.p, grid.q
    mtl, ntl, mb, nb = c_loc.shape
    kb = a_loc.shape[3]
    dt = c_loc.dtype

    def fetch(k):
        return a_loc[:, k // q], b_loc[k // p]

    def step(k):
        with span("slate.gemm/bcast"):
            a_col, b_row = fetch(k)
            return (cc.bcast_from_col(a_col, k % q, grid),
                    cc.bcast_from_row(b_row, k % p, grid))

    def issue(k):
        with span("slate.gemm/bcast_ahead"):
            a_col, b_row = fetch(k)
            return (cc.ring_bcast_from_col(a_col, k % q, grid),
                    cc.ring_bcast_from_row(b_row, k % p, grid))

    acc = torch.zeros((mtl * mb, ntl * nb), dtype=dt, device=c_loc.device)
    if abft:
        rexp = torch.zeros((mtl, ntl, mb), dtype=dt, device=c_loc.device)
        cexp = torch.zeros((mtl, ntl, nb), dtype=dt, device=c_loc.device)

    def consume(a_col, b_row):
        with span("slate.gemm/accumulate"):
            acc.addmm_(a_col.reshape(mtl * mb, kb),
                       b_row.permute(1, 0, 2).reshape(kb, ntl * nb))
            if abft:
                # checksum maintenance without forming the product:
                # A (B e) and (e^T A) B per tile pair, O(tiles * nb^2)
                rexp.add_(_abft.tile_product_row_sums(a_col[:, None],
                                                      b_row[None]))
                cexp.add_(_abft.tile_product_col_sums(a_col[:, None],
                                                      b_row[None]))

    if la == 0:
        for k in range(Kt):
            consume(*step(k))
    else:
        bufs = collections.deque(issue(d) for d in range(min(la, Kt)))
        for k in range(Kt):
            if k + la < Kt:
                bufs.append(issue(k + la))
            a_h, b_h = bufs.popleft()
            consume(a_h.wait(), b_h.wait())
        cc.flush(grid)
    tiles = faults.maybe_corrupt("post_collective",
                                 _tiles(acc, mtl, mb, ntl, nb))
    if not abft:
        return alpha * tiles + beta * c_loc
    tiles, ev, ti_l, tj_l = _abft.tile_sum_check(tiles, rexp, cexp,
                                                 n_ctx=Kt * kb)
    r, c = grid.coords
    site_l = torch.where(ev.detected > 0,
                         _abft.site_code(r + p * ti_l, c + q * tj_l), -1)
    det = cc.reduce_grid(ev.detected, grid)
    cor = cc.reduce_grid(ev.corrected, grid)
    site = cc.reduce_grid(site_l, grid, op="max")
    return alpha * tiles + beta * c_loc, det, cor, site


def summa_gemm_data(a_data, b_data, c_data, alpha, beta, Kt: int,
                    grid: Grid, abft: bool = False, la: int | None = None):
    """SUMMA over the ranks' local tile blocks; with ``abft`` returns
    ``(data, detected, corrected, site)``.  ``la`` is the lookahead depth;
    None resolves the tuned depth through the ``dist_lookahead`` plan
    (tune/plans.py: untuned cards stay on the depth-0 oracle)."""
    if la is None:
        from ..tune.plans import lookahead_depth
        la = lookahead_depth(Kt * a_data.shape[3], a_data.dtype)
    return summa_local(a_data, b_data, c_data, alpha, beta, Kt, grid,
                       abft=abft, la=la)
