"""K3, K4 and K7: the fused no-pivot LU panel, the CALU pivot selection and
the ragged batched no-pivot panel step (port of
slate_tpu/internal/pallas_lu.py ``lu_panel_fused``, ``lu_select_pallas``
and ``lu_panel_batched``).

Each kernel has a plain version here that repeats its arithmetic in torch
ops: the CPU tests run it, and on the card it is only the comparison.  A
wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches the kernel (``csrc/lu_panel.cu``, ``csrc/lu_select.cu``,
``csrc/lu_panel_batched.cu``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .chol_kernels import live_rows
from .chol_kernels import PANEL_NB
from .kernels import (BATCHED_PANEL_ARGS, BATCHED_PLAN_ARGS,
                      BATCHED_WORK_ARGS, I32, I64, P, CudaKernel,
                      batched_panel_step, batched_panel_step_plan,
                      check_cuda_f32, device_and_stream, query,
                      shape_query, workspace)
from .tri_inv import (STAMPS, WIDE_CLUSTER, back_substitution_plain,
                      upper_tri_inv_plain)

LU_PANEL = CudaKernel("lu_panel_fused", "lu_panel.cu", {
    "slate_lu_panel_factor": [I32, P, P, I64, I64, I32, I32, P, P, P],
    "slate_lu_panel_work": [I32, I32, ctypes.POINTER(I32)],
    "slate_lu_panel_below": [I32, P, P, I64, I64, I32, I32, P, P],
    "slate_lu_panel_fits": [I32, I32, I32, ctypes.POINTER(I32)],
    "slate_lu_panel_plan": [I32, P, I64, I64, ctypes.POINTER(I32)],
    "slate_lu_panel_trace": [I32, P, P, I64, I64, I32, I32, P, P, P, P,
                             ctypes.POINTER(I32)]})
LU_SELECT = CudaKernel("lu_select", "lu_select.cu", {
    "slate_lu_select": [I32, P, P, I64, I64, I64, P, I32, I32, I32, I32, P,
                        P],
    "slate_lu_select_fits": [I32, I32, I32, I32, ctypes.POINTER(I32)],
    "slate_lu_select_work": [I32, I32, I32, I32, ctypes.POINTER(I32)],
    "slate_lu_select_plan": [I32, I32, I32, I32, *[ctypes.POINTER(I32)] * 5],
    "slate_lu_select_trace": [I32, P, P, I64, I64, I64, P, I32, I32, I32,
                              I32, P, P, P, ctypes.POINTER(I32)]})
LU_PANEL_BATCHED = CudaKernel("lu_panel_batched", "lu_panel_batched.cu", {
    "slate_lu_panel_batched": BATCHED_PANEL_ARGS,
    "slate_lu_panel_batched_fits": [I32, I32, I32, ctypes.POINTER(I32)],
    "slate_lu_panel_batched_work": BATCHED_WORK_ARGS,
    "slate_lu_panel_batched_plan": BATCHED_PLAN_ARGS,
    "slate_lu_panel_batched_cluster": [I32, I32, ctypes.POINTER(I32)]})

# K4's widths as the CPU route mirrors them; on the card the wrapper asks
# the kernel (slate_lu_select_fits).  Past SELECT_BLOCK columns a chunk is
# walked by blocks of that many, in the kernel and in the plain version.
SELECT_BLOCK = 128
SELECT_NB = (256, 384, 512)   # the wide widths; any nb up to 128 besides


def panel_fits(device: torch.device, nb: int, bw: int) -> bool:
    """True when K3 takes a panel of width nb at slab width bw on this CUDA
    device: the kernel's own answer (``slate_lu_panel_fits``: nb in {32,
    64, 96, 128} with bw dividing nb and its factor launch's shared memory,
    or nb in {256, 384, 512} with bw dividing 128 and its wide factor's
    thread-block cluster)."""
    return bool(shape_query(LU_PANEL, "slate_lu_panel_fits", device, nb,
                            bw))


def panel_plan(panel: torch.Tensor) -> dict:
    """How K3's launch for the rows below stages this CUDA panel, as the
    kernel's library reports it (``slate_lu_panel_plan``): ``strips`` is
    "cp.async" (16-byte copies: unit stride along the columns, aligned
    rows) or "loads"."""
    staging = query(LU_PANEL, "slate_lu_panel_plan", panel.device,
                    panel.data_ptr(), panel.stride(0), panel.stride(1))
    return {"strips": "cp.async" if staging else "loads"}


def select_fits(device: torch.device, w: int, nb: int, bw: int) -> bool:
    """True when K4 can take a round of w-row chunks on this CUDA device:
    the kernel's own answer (``slate_lu_select_fits``: nb <= 128 with bw
    dividing it, or nb in {256, 384, 512} with bw dividing 128; bw <= 8;
    and a thread-block cluster of at most 16 CTAs that holds a chunk's rows
    of one 128-column block in its shared memory)."""
    return bool(shape_query(LU_SELECT, "slate_lu_select_fits", device, w,
                            nb, bw))


def select_width_ok(nb: int, bw: int) -> bool:
    """The widths K4 takes, as the CPU route mirrors the kernel's gate: nb
    up to 128, or 256, 384 or 512 walked by 128-column blocks, bw dividing
    the block (the plain version takes any bw that does)."""
    return bw >= 1 and nb % bw == 0 and (
        nb <= SELECT_BLOCK or (nb in SELECT_NB and SELECT_BLOCK % bw == 0))


def batched_width_ok(nb: int, bw: int) -> bool:
    """The widths K7 takes, as the CPU route mirrors the kernel's gate
    (``slate_lu_panel_batched_fits``): nb in {32, 64, 96, 128} with bw
    dividing nb, or 256, 384 or 512 with bw dividing 128 (a zero-pivot slab
    inside one 128-column diagonal block of the wide factor).  The serving
    route asks it of CPU tensors, so that a bucket takes the same route on
    both devices."""
    return nb in PANEL_NB and bw >= 1 and nb % bw == 0 and (
        nb <= 128 or 128 % bw == 0)


def select_plan(device: torch.device, w: int, nb: int, bw: int) -> dict:
    """How K4 launches a round of w-row chunks on this CUDA device, as the
    kernel's library reports it (``slate_lu_select_plan``): ``cluster``, the
    CTAs a chunk is split over (from w, nb, bw and the device alone; 0 when
    it does not fit); ``rows``, a CTA's rows; ``smem_bytes``, a CTA's shared
    memory; ``resident``, the clusters of that size the card holds at
    once; ``block``, the chunk's columns in shared memory at once, and
    ``chunk``, where the chunk lives for the launch ("shared memory", or
    "workspace" when it is walked by 128-column blocks)."""
    c, rows, smem, resident, block = query(
        LU_SELECT, "slate_lu_select_plan", device, w, nb, bw, outs=5)
    return {"cluster": c, "rows": rows, "smem_bytes": smem,
            "resident": resident, "block": block,
            "chunk": "shared memory" if block == nb else "workspace"}


def lu_tile_plain(a: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Unpivoted packed L\\U of a square tile by the column loop of
    ``_lu_factor_in_place`` (pallas_lu.py:137), in bw-row slabs: the slab's
    rows eliminate against themselves column by column (a zero pivot
    divides by 1, as the reference does), then the tile's rows below the
    slab get l21 = A21 D^-1 (D the slab's upper block, inverted by back
    substitution, so a zero pivot makes them Inf or NaN) and the rank-bw
    trailing update.  The kernel (csrc/lu_factor.cuh) factors in 32-column
    blocks of its own, scaling a row by 1 at a zero pivot only inside the
    pivot's slab; the two agree up to the order of their f32 sums, and on
    the health read's info and nonfinite."""
    s = a.clone()
    n = s.shape[0]
    for j0 in range(0, n, bw):
        j1 = j0 + bw
        for j in range(j0, j1):
            piv = s[j, j]
            l = s[j + 1:j1, j] / torch.where(piv == 0, 1.0, piv)
            s[j + 1:j1, j + 1:] -= l[:, None] * s[j, j + 1:]
            s[j + 1:j1, j] = l
        if j1 < n:
            l21 = s[j1:, j0:j1] @ back_substitution_plain(s[j0:j1, j0:j1])
            s[j1:, j1:] -= l21 @ s[j0:j1, j1:]
            s[j1:, j0:j1] = l21
    return s


def lu_panel_plain(panel: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """The fused panel in torch ops: row tile 0 by :func:`lu_tile_plain`,
    the rows below times U^-1 (K0's blocked doubling on triu(tile 0), as
    the kernel's factor launch forms it)."""
    nb = panel.shape[1]
    top = lu_tile_plain(panel[:nb], bw)
    if panel.shape[0] == nb:
        return top
    return torch.cat([top, panel[nb:] @ upper_tri_inv_plain(top)])


def lu_panel_fused(panel: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Fused unpivoted LU panel: the packed L\\U of [W, nb], W % nb == 0,
    unit lower diagonal implied (getrf.panel_lu_nopiv's contract).  Any
    strides.  A CPU tensor takes the plain version; CUDA tensors launch K3
    (f32, nb and bw within :func:`panel_fits`) or raise.  On CUDA, on the
    current stream: K3's factor launch (row tile 0 factored and, when W >
    nb, U^-1 formed: one block up to nb = 128, in the same launch; past it
    one thread-block cluster, then K0's wide kernel on the packed L\\U as
    the call's second launch, with their scratch allocated here) and, when
    W > nb, its launch for the rows below; LU_PANEL counts the one or two
    calls."""
    w, nb = panel.shape
    if w < nb or w % nb or bw < 1 or nb % bw:
        raise ValueError(f"lu_panel_fused: needs W % nb == 0 and nb % bw == "
                         f"0, got {tuple(panel.shape)} and bw={bw}")
    if panel.device.type == "cpu":
        return lu_panel_plain(panel, bw)
    check_cuda_f32("lu_panel_fused", panel)
    if not panel_fits(panel.device, nb, bw):
        raise ValueError(f"lu_panel_fused: nb = {nb}, bw = {bw} past the "
                         f"kernel's limits (slate_lu_panel_fits)")
    out = torch.empty((w, nb), dtype=panel.dtype, device=panel.device)
    uinv = (torch.empty((nb, nb), dtype=panel.dtype, device=panel.device)
            if w > nb else None)
    work, work_ptr = workspace(LU_PANEL, "slate_lu_panel_work", panel, nb)
    dev, stream = device_and_stream(panel)
    strides = (panel.data_ptr(), panel.stride(0), panel.stride(1), nb)
    LU_PANEL.launch("slate_lu_panel_factor", dev, stream, *strides, bw,
                    out.data_ptr(), None if uinv is None else uinv.data_ptr(),
                    work_ptr)
    if uinv is not None:
        LU_PANEL.launch("slate_lu_panel_below", dev, stream, *strides, w,
                        uinv.data_ptr(), out.data_ptr())
    return out


# the wide factor's stamps a row (csrc/wide_factor.cuh WFL_STAMP_ROW), and
# K4's a (block, CTA) (csrc/lu_select.cu SEL_STAMPS, SEL_MAX_CLUSTER CTAs)
PANEL_STAMP_ROW = 20
SELECT_STAMPS = 5
SELECT_MAX_CLUSTER = 16


def lu_panel_stamps(panel: torch.Tensor, bw: int = 8):
    """K3's wide factor launch once on a CUDA f32 panel [W, nb] (nb in
    {256, 384, 512}) with its globaltimer stamps: (the top nb rows of out,
    U^-1 or None when W == nb, stamps, k0_stamps, cluster).  stamps is
    [nb / 128 + 1, PANEL_STAMP_ROW] int64 nanoseconds (``wf_lu``'s layout:
    row j, entry r in 2 .. 15 the time rank r ended its tiles of step j, 0
    the time rank 0 held block j's updated quarters, 1 the time rank 1 held
    L_jj^T, 16 rank 0's time past the step's closing barrier, 17-19 block
    j's factor start, factor end and U_jj^-1's end; the last row's entries
    0 and 1 the start and the end); k0_stamps is [WIDE_CLUSTER, STAMPS],
    each CTA's stamps of the U^-1 launch (``tri_inv.cu``'s layout, zero
    when W == nb).  For chip_smoke.py's
    split of K3's time; the launch is not counted in ``LU_PANEL.launches``,
    and its bits are the counted launch's."""
    check_cuda_f32("lu_panel_stamps", panel)
    w, nb = panel.shape
    if nb not in SELECT_NB or w % nb:
        raise ValueError(f"lu_panel_stamps: needs a wide panel, got "
                         f"{tuple(panel.shape)}")
    out = torch.empty((nb, nb), dtype=panel.dtype, device=panel.device)
    uinv = (torch.empty((nb, nb), dtype=panel.dtype, device=panel.device)
            if w > nb else None)
    work, work_ptr = workspace(LU_PANEL, "slate_lu_panel_work", panel, nb)
    rows = (nb // 128 + 1) * PANEL_STAMP_ROW
    stamps = torch.zeros(rows + WIDE_CLUSTER * STAMPS, dtype=torch.int64,
                         device=panel.device)
    cluster = ctypes.c_int32(0)
    LU_PANEL.call("slate_lu_panel_trace", *device_and_stream(panel),
                  panel.data_ptr(), panel.stride(0), panel.stride(1), nb, bw,
                  out.data_ptr(), None if uinv is None else uinv.data_ptr(),
                  work_ptr, stamps.data_ptr(), ctypes.byref(cluster))
    return (out, uinv, stamps[:rows].view(-1, PANEL_STAMP_ROW),
            stamps[rows:].view(WIDE_CLUSTER, STAMPS), cluster.value)


def _live_rows(nrows, g: int, w: int, device) -> torch.Tensor:
    """[g] int32 live-row counts from None (all), an int or a tensor."""
    if nrows is None:
        nrows = w
    if isinstance(nrows, int):
        return torch.full((g,), nrows, dtype=torch.int32, device=device)
    return (torch.as_tensor(nrows, device=device).to(torch.int32).expand(g)
            .contiguous())


def _select_columns(ws, live, piv, gi, c0: int, c1: int, bw: int):
    """K4's column loop on columns [c0, c1) of the batch ``ws`` [G, W, nb]
    (in place): per bw-column slab, column by column the masked argmax
    (first maximum; dead rows count -1), the live rows' multipliers (0 for
    a zero pivot) and the slab's later columns; then the U rows of the
    slab's pivots and the update of the live rows' columns up to c1.  The
    slab's values (the multipliers of the live rows) are written back;
    ``piv`` and ``live`` are filled in as the pivots are chosen."""
    for j0 in range(c0, c1, bw):
        j1 = j0 + bw
        slab = ws[:, :, j0:j1].clone()
        for i in range(bw):
            col = slab[:, :, i]
            p = torch.where(live, col.abs(), -1.0).argmax(dim=1)
            piv[:, j0 + i] = p
            pv = col[gi, p]
            live[gi, p] = False
            mult = torch.where(live & (pv != 0)[:, None],
                               col / torch.where(pv == 0, 1.0, pv)[:, None],
                               0.0)
            slab[:, :, i] = torch.where(live, mult, col)
            prow = slab[gi, p, i + 1:]
            slab[:, :, i + 1:] -= mult[:, :, None] * prow[:, None]
        if j1 < c1:
            rows = piv[:, j0:j1]
            us = []
            for i in range(bw):
                u = ws[gi, rows[:, i], j1:c1]
                for k in range(i):
                    u = u - slab[gi, rows[:, i], k][:, None] * us[k]
                us.append(u)
            mult = torch.where(live[:, :, None], slab, 0.0)
            ws[:, :, j1:c1] -= mult @ torch.stack(us, dim=1)
        ws[:, :, j0:j1] = slab


def lu_select_plain(chunks: torch.Tensor, nrows=None,
                    bw: int = 8) -> torch.Tensor:
    """K4's steps in torch ops over a batch [G, W, nb]: the column loop
    (:func:`_select_columns`) over all nb columns at nb <= 128; past it,
    as the wide kernel walks them, over 128-column blocks, each followed by
    U = L11^-1 A(pivots, right of the block), L11 the pivot rows' unit
    lower multipliers, and the update of the live rows right of the
    block, A -= L U.  Returns [G, nb] int64."""
    g, w, nb = chunks.shape
    gi = torch.arange(g, device=chunks.device)
    ws = chunks.clone()
    live = (torch.arange(w, device=chunks.device)[None, :]
            < _live_rows(nrows, g, w, chunks.device)[:, None])
    piv = torch.empty((g, nb), dtype=torch.int64, device=chunks.device)
    blk = nb if nb <= SELECT_BLOCK else SELECT_BLOCK
    for c0 in range(0, nb, blk):
        c1 = c0 + blk
        _select_columns(ws, live, piv, gi, c0, c1, bw)
        if c1 == nb:
            break
        rows = piv[:, c0:c1]
        lpiv = ws[gi[:, None], rows, c0:c1]             # [G, blk, blk]
        l11 = torch.tril(lpiv, -1) + torch.eye(blk, dtype=ws.dtype,
                                               device=ws.device)
        u = torch.linalg.solve_triangular(l11, ws[gi[:, None], rows, c1:],
                                          upper=False, unitriangular=True)
        mult = torch.where(live[:, :, None], ws[:, :, c0:c1], 0.0)
        ws[:, :, c1:] -= mult @ u
    return piv


def lu_select(chunks: torch.Tensor, nrows=None, bw: int = 8) -> torch.Tensor:
    """Partial-pivot rows of each chunk of a round: [G, W, nb] -> [G, nb]
    int64, in elimination order; rows at or past ``nrows`` (None: all
    live; an int or a [G] tensor) are dead.  On input without ties this is
    lax.linalg.lu's perm[:nb] of each chunk.  A CPU tensor takes the plain
    version; CUDA tensors launch K4 once for the whole batch (f32, within
    :func:`select_fits`: one thread-block cluster a chunk; past nb = 128
    the chunks' working copies in a workspace allocated here) or raise."""
    g, w, nb = chunks.shape
    if bw < 1 or nb % bw or w < nb:
        raise ValueError(f"lu_select: needs W >= nb and nb % bw == 0, got "
                         f"{tuple(chunks.shape)} and bw={bw}")
    if chunks.device.type == "cpu":
        return lu_select_plain(chunks, nrows, bw)
    check_cuda_f32("lu_select", chunks)
    live = _live_rows(nrows, g, w, chunks.device)
    piv = torch.empty((g, nb), dtype=torch.int64, device=chunks.device)
    work, work_ptr = workspace(LU_SELECT, "slate_lu_select_work", chunks, w,
                               nb, g)
    LU_SELECT.launch("slate_lu_select", *device_and_stream(chunks),
                     chunks.data_ptr(), chunks.stride(0), chunks.stride(1),
                     chunks.stride(2), live.data_ptr(), g, w, nb, bw,
                     piv.data_ptr(), work_ptr)
    return piv


def lu_select_stamps(chunks: torch.Tensor, nrows=None, bw: int = 8):
    """K4's wide launch once on a CUDA round [G, W, nb] (nb in {256, 384,
    512}) with chunk 0's globaltimer stamps: (piv, stamps, cluster).
    stamps is [nb / 128, cluster, SELECT_STAMPS] int64 nanoseconds, a
    (128-column block, CTA): the block's start, its rows loaded, its
    column chain done, L11 and U formed, the update done (0 where the last
    block has none).  For chip_smoke.py's split of K4's time; the launch
    is not counted in ``LU_SELECT.launches``, and piv is the counted
    launch's."""
    check_cuda_f32("lu_select_stamps", chunks)
    g, w, nb = chunks.shape
    if nb not in SELECT_NB:
        raise ValueError(f"lu_select_stamps: needs a wide round, got "
                         f"{tuple(chunks.shape)}")
    live = _live_rows(nrows, g, w, chunks.device)
    piv = torch.empty((g, nb), dtype=torch.int64, device=chunks.device)
    work, work_ptr = workspace(LU_SELECT, "slate_lu_select_work", chunks, w,
                               nb, g)
    stamps = torch.zeros((nb // SELECT_BLOCK, SELECT_MAX_CLUSTER,
                          SELECT_STAMPS), dtype=torch.int64,
                         device=chunks.device)
    cluster = ctypes.c_int32(0)
    LU_SELECT.call("slate_lu_select_trace", *device_and_stream(chunks),
                   chunks.data_ptr(), chunks.stride(0), chunks.stride(1),
                   chunks.stride(2), live.data_ptr(), g, w, nb, bw,
                   piv.data_ptr(), work_ptr, stamps.data_ptr(),
                   ctypes.byref(cluster))
    return piv, stamps[:, :cluster.value], cluster.value


def batched_factor_cluster(device: torch.device, batch: int) -> int:
    """The CTAs of each problem's cluster in K7's wide factor launch over
    ``batch`` problems on this CUDA device, as the kernel's library picks
    it (``slate_lu_panel_batched_cluster``): 16 where the card places that
    many clusters of 16 at once, else 8."""
    return query(LU_PANEL_BATCHED, "slate_lu_panel_batched_cluster", device,
                 batch)


def lu_panel_batched_plain(col, left, lead, tiles, k: int, bw: int = 8):
    """K7's arithmetic in torch ops: per problem, on the operands widened
    to f32, upd = col - left @ lead, row tile 0 by :func:`lu_tile_plain`
    and the rows below times U^-1 (K0's blocked doubling on triu(tile 0),
    as the kernel's factor launch forms it), rounded to the storage dtype;
    dead tiles are ``col`` itself, bit for bit."""
    nb = col.shape[2]
    upd = col.float() - left.float() @ lead.float()
    top = torch.stack([lu_tile_plain(t, bw) for t in upd[:, :nb]])
    uinv = torch.stack([upper_tri_inv_plain(t) for t in top])
    fac = torch.cat([top, upd[:, nb:] @ uinv], dim=1)
    live = live_rows(tiles, k, col.shape[1], nb)
    return (torch.where(live, upd.to(col.dtype), col),
            torch.where(live, fac.to(col.dtype), col))


def lu_panel_batched(col: torch.Tensor, left: torch.Tensor,
                     lead: torch.Tensor, tiles: torch.Tensor, k: int,
                     bw: int = 8):
    """Ragged batched fused no-pivot LU panel step (K3 with K2's update,
    over a batch).

    col:   [B, M, nb] trailing block columns A[:, k0:, k0:k0+nb]
    left:  [B, M, K]  packed L block rows A[:, k0:, :k0]
    lead:  [B, K, nb] packed U block column A[:, :k0, k0:k0+nb]
    tiles: [B] int32  live tile counts ceil(size / nb)
    k:     the panel index

    Returns (upd, fac) [B, M, nb] in the storage dtype (f32 or bf16; sums
    in f32), fac packed L\\U with the unit lower diagonal implied; dead
    tiles (k + i >= tiles[b]) are ``col``'s bits in both outputs.  Any
    strides; M % nb == 0.  A CPU tensor takes the plain version; CUDA
    tensors launch K7 (nb and bw within ``slate_lu_panel_batched_fits``,
    :func:`batched_width_ok` on the CPU) or raise.  On CUDA, on the current
    stream: K7's update launch (every 128-row tile of every problem, the K
    loop split over a thread-block cluster; past nb = 128 every 128-column
    tile too), its factor launch (the no-pivot LU of tile 0 and, when M >
    nb, U^-1 by K0's doubling, one block a problem up to nb = 128; past it
    one thread-block cluster a problem by 128-column diagonal blocks, then
    K0's wide kernel a problem as the call's second launch)
    and, when M > nb, its solve launch (the live rows below tile 0): three
    launches a step, two when M == nb, counted by LU_PANEL_BATCHED.  ``tiles`` is read on the
    device only."""
    bsz, m, nb = col.shape
    kk = left.shape[2]
    if (left.shape != (bsz, m, kk) or lead.shape != (bsz, kk, nb)
            or tiles.shape != (bsz,) or m < nb or m % nb or bw < 1
            or nb % bw):
        raise ValueError(f"lu_panel_batched: bad shapes col "
                         f"{tuple(col.shape)}, left {tuple(left.shape)}, "
                         f"lead {tuple(lead.shape)}, tiles "
                         f"{tuple(tiles.shape)}, bw={bw}")
    if col.device.type == "cpu":
        return lu_panel_batched_plain(col, left, lead, tiles, k, bw)
    return batched_panel_step(LU_PANEL_BATCHED, col, left, lead, tiles, k, bw)


def batched_panel_plan(col: torch.Tensor, left: torch.Tensor,
                       lead: torch.Tensor) -> dict:
    """How K7's update launch takes these CUDA operands, as the kernel's
    library reports it (``slate_lu_panel_batched_plan``; keys as
    :func:`~.kernels.batched_panel_step_plan` gives them)."""
    return batched_panel_step_plan(LU_PANEL_BATCHED, col, left, lead)
