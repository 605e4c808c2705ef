"""Triangle-aware distributed rank-k / rank-2k updates and trmm (port of
slate_tpu/parallel/dist_herk.py; ref: internal_herk.cc, internal_her2k.cc,
internal_syrk.cc, internal_trmm.cc).

The reference enumerates only the STORED triangle's tiles, so a rank-k
update costs half a gemm's flops and communication: each rank's local
tiles in the stored triangle form a pair list (row tile, column tile),
and step k multiplies the broadcast panel rows and columns of every pair
at once.  The pair list is exact here (no padding to the grid-wide
maximum: every rank runs its own Python loop), and its products run in
chunks of pairs, so that the gathered operands of one step stay small (at
n = 20480, nb = 128 one rank holds ~12,900 pairs; gathering both tiles of
every pair at once would take ~1.6 GB a step).

Per step k the panel (A's tile column k) is broadcast along q to its
row owners and all-gathered along p for its column owners, the
reference's symmetric listBcast (potrf.cc:232-242).

trmm: a SUMMA k loop over A's stored tiles only, each step's product
restricted to the exact rows (left) or columns (right) the triangle
touches, the diagonal tiles masked on the fly, so that junk in A's
unstored half never leaks in.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, Grid
from ..util.trace import span
from .dist_trsm import slots

#: tile pairs multiplied in one batched product (the chunk of the pair
#: list whose gathered operands live at once)
PAIR_CHUNK = 2048


def local_pairs(r: int, c: int, p: int, q: int, mtl: int, ntl: int,
                Mt: int, Nt: int, lower: bool):
    """This rank's local tiles in the stored triangle (ref:
    dist_herk.py:53): (il, jl) local slot lists and their flat indices
    into [mtl * ntl], row-major."""
    gi = r + p * torch.arange(mtl)
    gj = c + q * torch.arange(ntl)
    cmp = (gi[:, None] >= gj[None, :]) if lower else \
        (gi[:, None] <= gj[None, :])
    mask = cmp & (gi[:, None] < Mt) & (gj[None, :] < Nt)
    idx = torch.nonzero(mask.reshape(-1)).flatten()
    return idx // ntl, idx % ntl, idx, mask


def _gather_panel_rows(pan: torch.Tensor, c: int, q: int, ntl: int,
                       grid: Grid) -> torch.Tensor:
    """Every grid row's panel tiles along p, then the rows this rank's
    columns need: pan [mtl, nb, kb] -> [ntl, nb, kb] (global column gj
    = c + q*t is panel row gj, held by grid row gj % p at slot gj // p)."""
    allpan = cc.allgather_along(pan, AXIS_P, grid, concat_axis=None)
    p = grid.p
    gj = c + q * torch.arange(ntl)
    ok = (gj // p) < allpan.shape[1]
    gjc = torch.where(ok, gj, torch.zeros_like(gj))
    out = allpan[gjc % p, gjc // p]
    return torch.where(ok[:, None, None].to(out.device), out,
                       torch.zeros_like(out))


def dist_herk_data(a_data, c_data, alpha, beta, Kt: int, Mt: int, Nt: int,
                   grid: Grid, lower: bool, conj: bool, b_data=None,
                   alpha2=None):
    """C_tri = alpha A op(A) + beta C_tri on the stored triangle's tiles
    (this rank's): a_data [mtl, ktl, nb, kb], c_data [mtl, ntl, nb, nb];
    with ``b_data`` the rank-2k C += alpha A op(B) + alpha2 B op(A).  op
    is the conjugate transpose (``conj``: herk, her2k) or the transpose
    (syrk, syr2k).  Tiles outside the stored triangle come back as they
    were."""
    p, q = grid.p, grid.q
    r, c = grid.coords
    mtl, ntl, nb, _ = c_data.shape
    il, jl, idx, mask = local_pairs(r, c, p, q, mtl, ntl, Mt, Nt, lower)
    a2 = alpha2 if alpha2 is not None else alpha
    dev = c_data.device
    il, jl = il.to(dev), jl.to(dev)
    S = int(idx.numel())
    acc = torch.zeros((S, nb, nb), dtype=c_data.dtype, device=dev)

    def panel(k, data):
        with span("slate.herk/bcast"):
            pan = cc.bcast_from_col(data[:, k // q], k % q, grid)
            return pan, _gather_panel_rows(pan, c, q, ntl, grid)

    def pair_update(rows, cols, s0, s1, coef):
        rg = rows.index_select(0, il[s0:s1])        # [chunk, nb, kb]
        cg = cols.index_select(0, jl[s0:s1])
        cg = cg.conj() if conj else cg
        acc[s0:s1] += coef * torch.bmm(rg, cg.transpose(1, 2))

    for k in range(Kt):
        arow, acol = panel(k, a_data)
        if b_data is not None:
            brow, bcol = panel(k, b_data)
        with span("slate.herk/update"):
            for s0 in range(0, S, PAIR_CHUNK):
                s1 = min(S, s0 + PAIR_CHUNK)
                if b_data is None:
                    pair_update(arow, acol, s0, s1, alpha)
                else:
                    pair_update(arow, bcol, s0, s1, alpha)
                    pair_update(brow, acol, s0, s1, a2)
    cflat = c_data.reshape(mtl * ntl, nb, nb).clone()
    # beta applies to the stored triangle only; other tiles unchanged
    tri = torch.nonzero(mask.reshape(-1)).flatten().to(dev)
    cflat[tri] = beta * cflat[tri] + acc
    return cflat.reshape(mtl, ntl, nb, nb)


def _tri_mask_tile(tile: torch.Tensor, on_diag, before_diag, lower: bool,
                   unit_diag: bool) -> torch.Tensor:
    """Mask a batch of A tiles [T, nb, nb] to the stored triangle: whole
    on the triangle's full side (``before_diag``), triangle-masked on the
    diagonal (``on_diag``; a unit diagonal set to one), zero elsewhere."""
    nb = tile.shape[-1]
    tri = torch.ones(nb, nb, dtype=torch.bool, device=tile.device)
    tri = torch.tril(tri) if lower else torch.triu(tri)
    out = torch.where(on_diag[:, None, None], tile * tri, tile)
    if unit_diag:
        eye = torch.eye(nb, dtype=tile.dtype, device=tile.device)
        out = torch.where(on_diag[:, None, None], out * (1 - eye) + eye,
                          out)
    keep = (on_diag | before_diag)[:, None, None]
    return torch.where(keep, out, torch.zeros_like(out))


def dist_trmm_data(a_data, b_data, alpha, Kt: int, Mt: int, grid: Grid,
                   lower: bool, unit_diag: bool, n: int):
    """B = alpha A B with A triangular, its stored triangle only (ref:
    trmm.cc -> work::trmm): a_data [mtl, ktl, nb, nb], b_data [mtl, ntl,
    nb, cb] local blocks.  Step k multiplies A's masked tile column k
    (broadcast along q) by B's tile row k (broadcast along p) into the
    exact rows the triangle touches: gi >= k (lower) or gi <= k
    (upper)."""
    p, q = grid.p, grid.q
    r, _ = grid.coords
    mtl, ntl, nb, cb = b_data.shape
    dev = b_data.device
    gi_all = r + p * torch.arange(mtl, device=dev)
    acc = torch.zeros((mtl * nb, ntl * cb), dtype=b_data.dtype, device=dev)
    for k in range(Kt):
        with span("slate.trmm/bcast"):
            pan = cc.bcast_from_col(a_data[:, k // q], k % q, grid)
            pan = _tri_mask_tile(pan, gi_all == k,
                                 (gi_all > k) if lower else (gi_all < k),
                                 lower, unit_diag)
            row = cc.bcast_from_row(b_data[k // p], k % p, grid)
        with span("slate.trmm/update"):
            sel = slots(k, Mt, r, p) if lower else slots(0, k + 1, r, p)
            S = sel.stop - sel.start
            if S == 0:
                continue
            acc[sel.start * nb:sel.stop * nb].addmm_(
                pan[sel].reshape(S * nb, nb),
                row.permute(1, 0, 2).reshape(nb, ntl * cb))
    out = acc.reshape(mtl, nb, ntl, cb).permute(0, 2, 1, 3)
    return alpha * out


def dist_trmm_right_data(a_data, b_data, alpha, Kt: int, Nt: int,
                         grid: Grid, lower: bool, unit_diag: bool, n: int):
    """B = alpha B A with A triangular: the mirror of the left kernel: k
    runs over A's tile rows (broadcast along p), B's tile column k is
    broadcast along q, into the exact columns the triangle touches: gj <=
    k (lower) or gj >= k (upper)."""
    p, q = grid.p, grid.q
    _, c = grid.coords
    mtl, ntl, cb, nb = b_data.shape
    dev = b_data.device
    gj_all = c + q * torch.arange(ntl, device=dev)
    acc = torch.zeros((mtl * cb, ntl * nb), dtype=b_data.dtype, device=dev)
    for k in range(Kt):
        with span("slate.trmm/bcast"):
            arow = cc.bcast_from_row(a_data[k // p], k % p, grid)
            arow = _tri_mask_tile(arow, gj_all == k,
                                  (gj_all < k) if lower else (gj_all > k),
                                  lower, unit_diag)
            bcol = cc.bcast_from_col(b_data[:, k // q], k % q, grid)
        with span("slate.trmm/update"):
            sel = slots(0, k + 1, c, q) if lower else slots(k, Nt, c, q)
            T = sel.stop - sel.start
            if T == 0:
                continue
            upd = (bcol.reshape(mtl * cb, nb)
                   @ arow[sel].permute(1, 0, 2).reshape(nb, T * nb))
            acc.view(mtl * cb, ntl, nb)[:, sel] += upd.view(mtl * cb, T, nb)
    out = acc.reshape(mtl, cb, ntl, nb).permute(0, 2, 1, 3)
    return alpha * out
