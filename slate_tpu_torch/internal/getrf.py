"""internal::getrf: the LU panel factorizations (port of
slate_tpu/internal/getrf.py).

- partial pivoting: ``torch.linalg.lu_factor_ex`` on the panel, as the
  reference leaves it to XLA's pivoted LU;
- no pivoting: under the default plan an f32 panel is K3 (the fused
  panel, internal/lu_kernels.py), else the recursively blocked tile LU
  and one matmul against the inverted U;
- threshold pivoting (``Option.PivotThreshold`` < 1);
- CALU tournament: each round selects its candidates' pivot rows in one
  batched call, K4 where the gate admits the round, ``lu_factor_ex``
  otherwise; the chosen rows move to the top and the permuted panel takes
  the no-pivot route.

The gates carry this card's limits, not the TPU's VMEM ones, and on the
card ask the kernel for them (lu_kernels.py: K3's ``slate_lu_panel_fits``,
nb in {32, 64, 96, 128, 256, 384, 512}; K4's ``slate_lu_select_fits``, nb
<= 128 or nb in {256, 384, 512}, with a chunk's rows of one 128-column
block in one thread-block cluster's shared memory).  Nothing here reads a
tensor's values on the host.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..tune.plans import resolve_plan
from .lu_kernels import (lu_panel_fused, lu_select, panel_fits,
                         select_fits, select_width_ok)
from .trsm import tri_inv_lower, tri_inv_upper


def pivots_to_perm(piv: torch.Tensor, m: int) -> torch.Tensor:
    """The row permutation ``perm`` (A[perm] = L U) of LAPACK's pivots.

    ``piv`` [..., k] holds 0-based swaps: at step i rows i and piv[i] >= i
    trade places.  Returns perm [..., m] without building the [m, m] P and
    without a host round trip: w[j], the row at position j just before
    step j, follows the chain of earlier swaps into j (pointer jumping);
    position i < k ends with the row at piv[i] before step i, and a
    position q >= k with what the last swap into q left there."""
    k = piv.shape[-1]
    dev = piv.device
    steps = torch.arange(k, device=dev)
    earlier = steps[None, :] < steps[:, None]              # [i, j]: j < i

    def latest(hit):                                       # [..., i, j]
        return torch.where(hit & earlier, steps, -1).amax(dim=-1)

    prev_to = latest(piv[..., None, :] == steps[:, None])
    prev_same = latest(piv[..., None, :] == piv[..., :, None])
    w = torch.where(prev_to >= 0, prev_to, steps)
    for _ in range(max(1, math.ceil(math.log2(max(k, 2)))) + 1):
        w = torch.gather(w, -1, w)
    head = torch.where(prev_same >= 0,
                       torch.gather(w, -1, prev_same.clamp(min=0)), piv)
    last = torch.full((*piv.shape[:-1], m), -1, dtype=piv.dtype, device=dev)
    last.scatter_reduce_(-1, piv, steps.expand_as(piv), reduce="amax")
    perm = torch.where(last >= 0, torch.gather(w, -1, last.clamp(min=0)),
                       torch.arange(m, device=dev))
    perm[..., :k] = head
    return perm


def panel_lu(panel: torch.Tensor):
    """Partially pivoted LU of a panel [W, nb] (or a batch): (lu, perm)
    with panel[perm] = L @ U, L unit lower, U upper."""
    lu, piv, _ = torch.linalg.lu_factor_ex(panel)
    return lu, pivots_to_perm(piv.long() - 1, panel.shape[-2])


# ---- out-of-core steps (drivers/lu.py getrf_ooc) ----
# Pure functions of the device windows the TileMap brings in; the same
# launches on the same window shapes make a resumed run repeat the
# uninterrupted one bit for bit.

def ooc_lu_panel(panel: torch.Tensor):
    """Partially pivoted LU of the current panel [W, nb]: (lu, perm) with
    panel[perm] = L U.  The reference's panel is XLA's pivoted LU, outside
    any Pallas kernel; here it is ``lu_factor_ex``, its LAPACK swaps
    turned into the reference's gather index (:func:`pivots_to_perm`)."""
    return panel_lu(panel)


def ooc_lu_trailing(colj: torch.Tensor, lu: torch.Tensor,
                    perm: torch.Tensor,
                    l11_inv: torch.Tensor | None = None) -> torch.Tensor:
    """One streamed right-looking trailing update: apply the panel's row
    permutation to trailing block column ``colj`` [W, wj], solve the U12
    strip against unit L11 and subtract L21 @ U12.  Returns the updated
    [U12; trailing] column.  ``l11_inv``, unit L11's inverse, is formed
    here when not given (a caller updating many columns of one panel
    forms it once: the same launches, the same bits)."""
    w = lu.shape[1]
    colj = colj[perm]
    if l11_inv is None:
        l11_inv = tri_inv_lower(lu[:w, :w], unit_diag=True)
    u12 = l11_inv @ colj[:w]
    tail = colj[w:] - lu[w:, :w] @ u12
    return torch.cat([u12, tail], dim=0)


def _nopiv_fused_ok(panel: torch.Tensor) -> bool:
    """True when the plan routes this no-pivot panel through K3: f32, a
    full tile on top, the plan's bw dividing nb, and on the card the
    kernel's own gate (``slate_lu_panel_fits``: nb in {32, 64, 96, 128,
    256, 384, 512} and its factor launch's resources); the plain version
    that CPU tensors take has no such limit."""
    w, nb = panel.shape
    if not (panel.dtype == torch.float32 and w >= nb):
        return False
    plan = resolve_plan("getrf_panel", w, "float32")
    if plan.kernel != "cuda" or nb % plan.bw:
        return False
    return panel.device.type == "cpu" or panel_fits(panel.device, nb,
                                                    plan.bw)


def panel_lu_nopiv(panel: torch.Tensor):
    """No-pivot LU of a panel [W, nb] (ref: Tile_getrf_nopiv.hh): K3 when
    the plan says so (ragged W zero-padded to a tile multiple: zero rows
    factor to zero L rows), else the blocked square LU of the top block
    and the rows below times the inverted U."""
    w, nb = panel.shape
    if _nopiv_fused_ok(panel):
        bw = resolve_plan("getrf_panel", w, "float32").bw
        wp = -(-w // nb) * nb
        pp = F.pad(panel, (0, 0, 0, wp - w)) if wp != w else panel
        lu = lu_panel_fused(pp, bw=bw)[:w]
        return lu, torch.arange(w, device=panel.device)
    lu_top = _lu_nopiv_square(panel[:nb])
    below = panel[nb:] @ tri_inv_upper(torch.triu(lu_top))
    return (torch.cat([lu_top, below]),
            torch.arange(w, device=panel.device))


def _lu_nopiv_base(a: torch.Tensor) -> torch.Tensor:
    """Unpivoted LU of a small square block, one rank-1 step a column."""
    n = a.shape[0]
    a = a.clone()
    later = torch.arange(n, device=a.device)
    for j in range(n):
        below = later > j
        col = a[:, j].clone()
        l = torch.where(below, col / col[j], 0.0)
        a -= torch.outer(l, torch.where(below, a[j], 0.0))
        a[:, j] = torch.where(below, l, col)
    return a


def _lu_nopiv_square(a: torch.Tensor, base: int = 64) -> torch.Tensor:
    """Unpivoted LU of a square block, recursively blocked: the rank-1 loop
    runs only on <= base-wide blocks, everything between is matmuls
    against triangular inverses."""
    n = a.shape[0]
    if n <= base:
        return _lu_nopiv_base(a)
    h = n // 2
    a11 = _lu_nopiv_square(a[:h, :h], base)
    l11 = torch.tril(a11, -1) + torch.eye(h, dtype=a.dtype, device=a.device)
    u12 = tri_inv_lower(l11, unit_diag=True) @ a[:h, h:]
    l21 = a[h:, :h] @ tri_inv_upper(torch.triu(a11))
    a22 = _lu_nopiv_square(a[h:, h:] - l21 @ u12, base)
    return torch.cat([torch.cat([a11, u12], dim=1),
                      torch.cat([l21, a22], dim=1)])


def panel_lu_threshold(panel: torch.Tensor, tau: float):
    """Threshold-pivoted LU of a panel [W, nb] (ref: Option::PivotThreshold):
    the diagonal stays the pivot while it is within ``tau`` of the column's
    largest magnitude.  Returns (lu, perm) like :func:`panel_lu`."""
    w, nb = panel.shape
    dev = panel.device
    a = panel.clone()
    perm = torch.arange(w, device=dev)
    rows = torch.arange(w, device=dev)
    cols = torch.arange(nb, device=dev)
    for j in range(min(w, nb)):
        mag = torch.where(rows >= j, a[:, j].abs(), -1.0)
        pos = torch.where(a[j, j].abs() >= tau * mag.max(),
                          torch.tensor(j, device=dev), mag.argmax())
        swap = torch.stack([torch.tensor(j, device=dev), pos])
        a[swap] = a[swap.flip(0)]
        perm[swap] = perm[swap.flip(0)]
        colj = a[:, j].clone()
        piv = colj[j]
        l = torch.where((rows > j) & (piv != 0),
                        colj / torch.where(piv == 0, 1.0, piv), 0.0)
        a -= torch.outer(l, torch.where(cols > j, a[j], 0.0))
        a[:, j] = torch.where(rows > j, l, colj)
    return a, perm


def _lu_select_ok(blocks: torch.Tensor, nb: int) -> bool:
    """True when the plan sends this tournament round through K4: f32, the
    "cuda" plan, and the kernel's gate: on the card its own answer
    (``slate_lu_select_fits``: nb <= 128 or nb in {256, 384, 512}, the
    plan's bw dividing nb (and 128), and a thread-block cluster of at most
    16 CTAs whose shared memory holds a chunk's rows of one 128-column
    block); on the CPU the same widths (:func:`select_width_ok`), so that
    both devices route a round alike."""
    w = blocks.shape[1]
    if blocks.dtype != torch.float32:
        return False
    plan = resolve_plan("lu_select", w, "float32")
    if plan.kernel != "cuda":
        return False
    if blocks.device.type == "cpu":
        return select_width_ok(nb, plan.bw)
    return select_fits(blocks.device, w, nb, plan.bw)


def _keep_best(blocks, idx, nb: int):
    """One tournament round: each block's nb pivot rows (original values)
    and their panel indices."""
    if _lu_select_ok(blocks, nb):
        take = lu_select(blocks,
                         bw=resolve_plan("lu_select", blocks.shape[1]).bw)
    else:
        take = panel_lu(blocks)[1][:, :nb]
    return (torch.take_along_dim(blocks, take[:, :, None], dim=1),
            torch.take_along_dim(idx, take, dim=1))


def tournament_perm(panel: torch.Tensor, block_rows: int,
                    arity: int = 2) -> torch.Tensor:
    """The CALU row permutation of a panel [W, nb], W > nb (ref:
    internal_getrf_tntpiv.cc): round 1 keeps each block of ``block_rows``
    rows' nb pivot rows, the reduction rounds merge ``arity`` candidate
    sets at a time (Option.Depth), and the winners move to the top by a
    permutation that displaces at most 2 nb rows."""
    arity = max(2, int(arity))
    w, nb = panel.shape
    dev = panel.device
    iota = torch.arange(w, device=dev)
    block_rows = max(block_rows, nb)
    nch = -(-w // block_rows)
    wp = nch * block_rows
    cand = F.pad(panel, (0, 0, 0, wp - w)).reshape(nch, block_rows, nb)
    # pad rows carry sentinel index w; all-zero, they lose every pivot
    # contest against any nonzero row
    cidx = torch.cat([iota, torch.full((wp - w,), w, device=dev)]
                     ).reshape(nch, block_rows)
    if block_rows > nb:
        cand, cidx = _keep_best(cand, cidx, nb)
    while cand.shape[0] > 1:
        g = cand.shape[0]
        gp = -(-g // arity) * arity
        if gp > g:
            cand = torch.cat([cand, cand.new_zeros((gp - g,)
                                                   + cand.shape[1:])])
            cidx = torch.cat([cidx, cidx.new_full((gp - g, cidx.shape[1]),
                                                  w)])
        rows_per = cand.shape[1]
        cand, cidx = _keep_best(cand.reshape(gp // arity, arity * rows_per,
                                             nb),
                                cidx.reshape(gp // arity, arity * rows_per),
                                nb)
    chosen = cidx[0, :nb]
    # sentinel guard (only reachable for a singular panel): sentinel slots
    # take the smallest rows not chosen, so that `chosen` stays nb distinct
    # rows; sentinels scatter into a spare slot past the end
    valid = chosen < w
    in_ch0 = torch.zeros(w + 1, dtype=torch.bool, device=dev)
    in_ch0[torch.where(valid, chosen, w)] = True
    free = torch.sort(torch.where(in_ch0[:w], w + iota, iota)).values
    kfree = torch.cumsum((~valid).long(), 0) - 1
    chosen = torch.where(valid, chosen, free[kfree.clamp(0, w - 1)])
    # perm[j] = chosen[j] for j < nb; the top rows pushed out fill the holes
    # the chosen rows left below, both in ascending order
    in_ch = torch.zeros(w, dtype=torch.bool, device=dev)
    in_ch[chosen] = True
    s1 = ~in_ch & (iota < nb)
    s2 = in_ch & (iota >= nb)
    idx1 = torch.sort(torch.where(s1, iota, w + iota)).values[:nb]
    fill = idx1[(torch.cumsum(s2.long(), 0) - 1).clamp(0, nb - 1)]
    perm = iota.clone()
    perm[:nb] = chosen
    return torch.where(s2, torch.where(fill < w, fill, iota), perm)


def panel_lu_tournament(panel: torch.Tensor, block_rows: int,
                        arity: int = 2):
    """CALU tournament pivot selection and the clean no-pivot factor of the
    permuted panel (ref: getrf.py:200).  Returns (lu, perm) like
    :func:`panel_lu`; a panel of at most nb rows takes :func:`panel_lu`."""
    if panel.shape[0] <= panel.shape[1]:
        return panel_lu(panel)
    perm = tournament_perm(panel, block_rows, arity)
    lu, _ = panel_lu_nopiv(panel[perm])
    return lu, perm
