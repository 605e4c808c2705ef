"""K1, K2 and K6: the Cholesky tile, the fused Cholesky panel step and its
ragged batched form (port of slate_tpu/internal/pallas_chol.py
``chol_tile_pallas``, ``chol_panel_fused`` and ``chol_panel_batched``).

Each kernel has a plain version here that repeats its arithmetic in torch
ops: the CPU tests run it, and on the card it is only the comparison.
A wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (``csrc/chol_tile.cu``, ``csrc/chol_panel.cu``,
``csrc/chol_panel_batched.cu``) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import (BATCHED_PANEL_ARGS, BATCHED_PLAN_ARGS,
                      BATCHED_WORK_ARGS, I32, I64, P, CudaKernel,
                      batched_panel_step, batched_panel_step_plan,
                      check_cuda_f32, device_and_stream, query, shape_query,
                      workspace)
from .tri_inv import upper_tri_inv, upper_tri_inv_plain

CHOL_TILE = CudaKernel("chol_tile", "chol_tile.cu", {
    "slate_chol_tile": [I32, P, P, I64, I64, P, I32, P],
    "slate_chol_tile_fits": [I32, I32, ctypes.POINTER(I32)],
    "slate_chol_tile_work": [I32, I32, ctypes.POINTER(I32)],
    "slate_chol_tile_trace": [I32, P, P, I64, I64, P, I32, P, P,
                              ctypes.POINTER(I32)]})
# a row of the wide route's stamps (csrc/wide_factor.cuh WFC_STAMP_ROW)
TILE_STAMP_ROW = 17
CHOL_PANEL = CudaKernel("chol_panel_fused", "chol_panel.cu", {
    "slate_chol_panel_update": [I32, P, P, I64, I64, P, I64, I64, P, I64,
                                I64, I32, I32, I32, P],
    "slate_chol_panel_factor": [I32, P, P, I32, P, P],
    "slate_chol_panel_fits": [I32, I32, ctypes.POINTER(I32)],
    "slate_chol_panel_work": [I32, I32, ctypes.POINTER(I32)],
    "slate_chol_panel_solve": [I32, P, P, P, I32, I32, P],
    "slate_chol_panel_plan": [I32, I32, I32, I32, P, I64, I64, P, I64, I64,
                              ctypes.POINTER(I32), ctypes.POINTER(I32)]})

CHOL_PANEL_BATCHED = CudaKernel("chol_panel_batched", "chol_panel_batched.cu", {
    "slate_chol_panel_batched": BATCHED_PANEL_ARGS,
    "slate_chol_panel_batched_fits": [I32, I32, I32, ctypes.POINTER(I32)],
    "slate_chol_panel_batched_work": BATCHED_WORK_ARGS,
    "slate_chol_panel_batched_plan": BATCHED_PLAN_ARGS})

# The kernels' limits as the CPU routes mirror them; on the card each
# wrapper asks its kernel (slate_chol_tile_fits, slate_chol_panel_fits,
# slate_chol_panel_batched_fits).
TILE_MAX_N = 1024         # one block up to 128, one cluster past it
PANEL_NB = (32, 64, 96, 128, 256, 384, 512)   # the one-block factor's
                          # widths, then the wide factor's (128-column tiles)


def batched_width_ok(nb: int, bw: int) -> bool:
    """The widths K6 takes, as the CPU route mirrors the kernel's gate
    (``slate_chol_panel_batched_fits``): nb in :data:`PANEL_NB` and bw
    dividing nb (the plain version's slabs).  The serving route asks it
    of CPU tensors, so that a bucket takes the same route on both
    devices."""
    return nb in PANEL_NB and bw >= 1 and nb % bw == 0


def chol_tile_plain(a: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Lower Cholesky factor of an SPD tile by the column loop of
    ``_chol_factor_in_place`` (pallas_chol.py:63), in lower form: in each
    bw-column panel, column by column, pivot = sqrt, the column below it
    times 1/pivot, rank-1 update of the panel's later columns; after the
    panel, rank-bw update of the trailing columns.  Upper part exactly 0;
    a non-positive pivot poisons every later column with NaN/Inf.  The
    kernel (csrc/chol_factor.cuh) factors in 32-column blocks of its own;
    the two agree up to the order of their f32 sums, and on the first bad
    pivot."""
    s = a.clone()
    n = s.shape[0]
    for p0 in range(0, n, bw):
        p1 = p0 + bw
        for j in range(p0, p1):
            piv = torch.sqrt(s[j, j])
            s[j + 1:, j] *= 1.0 / piv
            s[j, j] = piv
            s[j + 1:, j + 1:p1] -= torch.outer(s[j + 1:, j], s[j + 1:p1, j])
        s[p1:, p1:] -= s[p1:, p0:p1] @ s[p1:, p0:p1].T
    return torch.tril(s)


def tile_fits_on(device: torch.device, n: int) -> bool:
    """True when K1 takes an n x n tile on this CUDA device: the kernel's
    own answer (``slate_chol_tile_fits``: n % 32 == 0, 32 <= n <= 1024)."""
    return bool(shape_query(CHOL_TILE, "slate_chol_tile_fits", device, n))


def panel_fits(device: torch.device, nb: int) -> bool:
    """True when K2 takes a panel nb wide on this CUDA device: the kernel's
    own answer (``slate_chol_panel_fits``: nb in {32, 64, 96, 128, 256,
    384, 512})."""
    return bool(shape_query(CHOL_PANEL, "slate_chol_panel_fits", device, nb))


def chol_tile(a: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Lower Cholesky factor of one SPD [n, n] tile, n % bw == 0.  A CPU
    tensor takes the plain version (bw-column slabs, as the reference); a
    CUDA tensor launches K1 (f32, within :func:`tile_fits_on`: one block
    up to n = 128, its own 32-column blocking; one thread-block cluster
    past it, 128-column diagonal blocks in a workspace allocated here) or
    raises."""
    n = a.shape[-1]
    if a.dim() != 2 or a.shape[0] != n or bw < 1 or n % bw:
        raise ValueError(f"chol_tile: needs one square tile with n % bw == "
                         f"0, got {tuple(a.shape)} and bw={bw}")
    if a.device.type == "cpu":
        return chol_tile_plain(a, bw)
    check_cuda_f32("chol_tile", a)
    if not tile_fits_on(a.device, n):
        raise ValueError(f"chol_tile: n = {n} past the kernel's limits "
                         f"(slate_chol_tile_fits)")
    out = torch.empty((n, n), dtype=a.dtype, device=a.device)
    work, work_ptr = workspace(CHOL_TILE, "slate_chol_tile_work", a, n)
    CHOL_TILE.launch("slate_chol_tile", *device_and_stream(a), a.data_ptr(),
                     a.stride(0), a.stride(1), out.data_ptr(), n, work_ptr)
    return out


def chol_tile_stamps(a: torch.Tensor):
    """K1's wide route once on a CUDA f32 tile (128 < n <= 1024, n % 32
    == 0) with the diagonal chain's timestamps: (L, stamps, cluster).
    stamps is [n_blocks + 1, TILE_STAMP_ROW] int64 globaltimer
    nanoseconds (``wf_chol``'s layout: row s, entry r the time rank r ended
    step s; entry 16 rank 0's time past the step's barrier; row n_blocks
    entry 0 the start).  For chip_smoke.py's split of K1's time; the
    launch is not counted in ``CHOL_TILE.launches``."""
    n = a.shape[-1]
    check_cuda_f32("chol_tile_stamps", a)
    if not (128 < n <= TILE_MAX_N and n % 32 == 0 and a.shape == (n, n)):
        raise ValueError(f"chol_tile_stamps: needs one tile past 128, got "
                         f"{tuple(a.shape)}")
    out = torch.empty((n, n), dtype=a.dtype, device=a.device)
    work, work_ptr = workspace(CHOL_TILE, "slate_chol_tile_work", a, n)
    stamps = torch.zeros((-(-n // 128) + 1, TILE_STAMP_ROW),
                         dtype=torch.int64, device=a.device)
    cluster = ctypes.c_int32(0)
    CHOL_TILE.call("slate_chol_tile_trace", *device_and_stream(a),
                   a.data_ptr(), a.stride(0), a.stride(1), out.data_ptr(), n,
                   work_ptr, stamps.data_ptr(), ctypes.byref(cluster))
    return out, stamps, cluster.value


def chol_panel_plain(col, left, lead, bw: int = 8):
    """The fused panel step in torch ops: upd = col - left @ lead; row
    tile 0 factored by :func:`chol_tile_plain`; fac rows below = upd @
    U^-1 with U = L00^T inverted as K0 inverts it."""
    nb = col.shape[1]
    upd = col - left @ lead
    l00 = chol_tile_plain(upd[:nb], bw)
    fac = torch.cat([l00, upd[nb:] @ upper_tri_inv_plain(l00.T)])
    return upd, fac


def chol_panel_fused(col: torch.Tensor, left: torch.Tensor,
                     lead: torch.Tensor, bw: int = 8):
    """Fused left-looking Cholesky panel step.

    col:  [M, nb] trailing block column A[k0:, k0:k0+nb]
    left: [M, K]  factored block row A[k0:, :k0] (K == 0 on panel 0)
    lead: [K, nb] conj(A[k0:k0+nb, :k0])^T

    Returns (upd, fac): ``upd`` = col - left @ lead, the pre-factor panel;
    ``fac`` = [L00; L21], the factored panel.  Any strides; M % nb == 0.
    A CPU tensor takes the plain version; CUDA tensors launch K2 (f32,
    nb within :func:`panel_fits`: 32, 64, 96, 128, 256, 384 or 512) or
    raise.  On CUDA, on the current stream: K2's update launch (upd over
    every 128-row tile, and every 128-column tile of a wider panel, the K
    loop split over a thread-block cluster when tiles are few) and its
    factor launch (L00 from tile 0: K1's blocked factor on one block up to
    nb = 128, K1's wide route on one cluster past it); when M > nb, K0 on
    U = L00^T (counted by K0's wrapper) and K2's solve launch, fac rows
    below = upd rows @ U^-1.  CHOL_PANEL counts K2's two or three
    launches; :func:`panel_plan` says how the update launch splits and
    stages.
    """
    m, nb = col.shape
    k = left.shape[1]
    if (left.shape != (m, k) or lead.shape != (k, nb) or m < nb or m % nb
            or bw < 1 or nb % bw):
        raise ValueError(f"chol_panel_fused: bad shapes col {tuple(col.shape)}"
                         f", left {tuple(left.shape)}, lead "
                         f"{tuple(lead.shape)}, bw={bw}")
    if col.device.type == "cpu":
        return chol_panel_plain(col, left, lead, bw)
    check_cuda_f32("chol_panel_fused", col, left, lead)
    if not panel_fits(col.device, nb):
        raise ValueError(f"chol_panel_fused: nb = {nb} past the kernel's "
                         f"limits (slate_chol_panel_fits)")
    upd = torch.empty((m, nb), dtype=col.dtype, device=col.device)
    fac = torch.empty_like(upd)
    work, work_ptr = workspace(CHOL_PANEL, "slate_chol_panel_work", col, nb)
    dev, stream = device_and_stream(col)
    CHOL_PANEL.launch("slate_chol_panel_update", dev, stream, col.data_ptr(),
                      col.stride(0), col.stride(1), left.data_ptr(),
                      left.stride(0), left.stride(1), lead.data_ptr(),
                      lead.stride(0), lead.stride(1), k, nb, m,
                      upd.data_ptr())
    CHOL_PANEL.launch("slate_chol_panel_factor", dev, stream, upd.data_ptr(),
                      nb, fac.data_ptr(), work_ptr)
    if m > nb:
        uinv = upper_tri_inv(fac[:nb].mT)        # K0 on U = L00^T
        CHOL_PANEL.launch("slate_chol_panel_solve", dev, stream,
                          upd.data_ptr(), uinv.data_ptr(), nb, m,
                          fac.data_ptr())
    return upd, fac


def panel_plan(col: torch.Tensor, left: torch.Tensor,
               lead: torch.Tensor) -> dict:
    """How K2's update launch takes these CUDA operands, as the kernel's
    library reports it (``slate_chol_panel_plan``): ``split``, the CTAs
    of one row tile's cluster that share its K loop (a function of M, K,
    nb and the device alone), and ``left``/``lead``, each "cp.async" (unit
    stride along K, 16-byte aligned rows, as on the posv path) or "loads"
    (any other strides)."""
    m, nb = col.shape
    k = left.shape[1]
    split, staging = query(CHOL_PANEL, "slate_chol_panel_plan", col.device,
                           m, k, nb, left.data_ptr(), left.stride(0),
                           left.stride(1), lead.data_ptr(), lead.stride(0),
                           lead.stride(1), outs=2)
    return {"split": split,
            "left": "cp.async" if staging & 1 else "loads",
            "lead": "cp.async" if staging & 2 else "loads"}


def live_rows(tiles: torch.Tensor, k: int, m: int, nb: int) -> torch.Tensor:
    """[B, M, 1] bool: row r of panel k of problem b lies in a live tile,
    k + r // nb < tiles[b] (the ragged contract of K6 and K7)."""
    tile = k + torch.arange(m, device=tiles.device) // nb
    return (tile[None, :] < tiles[:, None])[..., None]


def chol_panel_batched_plain(col, left, lead, tiles, k: int, bw: int = 8):
    """K6's arithmetic in torch ops: per problem, K2's plain step on the
    operands widened to f32 (upd = col - left @ lead, L00 by
    :func:`chol_tile_plain`, L21 = upd_below @ (L00^T)^-1 with the inverse
    by K0's blocked doubling, as the kernel's factor launch forms it),
    rounded to the storage dtype; dead tiles are ``col`` itself, bit for
    bit."""
    nb = col.shape[2]
    upd = col.float() - left.float() @ lead.float()
    l00 = torch.stack([chol_tile_plain(t, bw) for t in upd[:, :nb]])
    uinv = torch.stack([upper_tri_inv_plain(t.T) for t in l00])
    fac = torch.cat([l00, upd[:, nb:] @ uinv], dim=1)
    live = live_rows(tiles, k, col.shape[1], nb)
    return (torch.where(live, upd.to(col.dtype), col),
            torch.where(live, fac.to(col.dtype), col))


def chol_panel_batched(col: torch.Tensor, left: torch.Tensor,
                       lead: torch.Tensor, tiles: torch.Tensor, k: int,
                       bw: int = 8):
    """Ragged batched fused Cholesky panel step (K2 over a batch).

    col:   [B, M, nb] trailing block columns A[:, k0:, k0:k0+nb]
    left:  [B, M, K]  factored block rows A[:, k0:, :k0]
    lead:  [B, K, nb] A[:, k0:k0+nb, :k0]^T per problem
    tiles: [B] int32  live tile counts ceil(size / nb)
    k:     the panel index (block columns already factored)

    Returns (upd, fac) [B, M, nb] in the storage dtype (f32 or bf16; sums
    in f32): row tile i of problem b is live iff k + i < tiles[b], and a
    dead tile is ``col``'s bits in both outputs.  Any strides; M % nb ==
    0.  A CPU tensor takes the plain version; CUDA tensors launch K6 (nb
    and bw within ``slate_chol_panel_batched_fits``: nb in {32, 64, 96,
    128, 256, 384, 512}) or raise.  On CUDA, on the current stream: K6's
    update launch (every 128-row tile of every problem, the K loop split
    over a thread-block cluster; past nb = 128 every 128-column tile too),
    its factor launch (L00 and, when M > nb, U^-1, one block a problem up
    to nb = 128, one thread-block cluster a problem past it) and, when M >
    nb, its solve launch (the live rows below tile 0): three launches a
    step, two when M == nb, counted by CHOL_PANEL_BATCHED.  ``tiles`` is
    read on the device only; the f32 scratch the launches hand on (upd
    before rounding on bf16 storage, U^-1) is allocated here."""
    bsz, m, nb = col.shape
    kk = left.shape[2]
    if (left.shape != (bsz, m, kk) or lead.shape != (bsz, kk, nb)
            or tiles.shape != (bsz,) or m < nb or m % nb or bw < 1
            or nb % bw):
        raise ValueError(f"chol_panel_batched: bad shapes col "
                         f"{tuple(col.shape)}, left {tuple(left.shape)}, "
                         f"lead {tuple(lead.shape)}, tiles "
                         f"{tuple(tiles.shape)}, bw={bw}")
    if col.device.type == "cpu":
        return chol_panel_batched_plain(col, left, lead, tiles, k, bw)
    return batched_panel_step(CHOL_PANEL_BATCHED, col, left, lead, tiles, k,
                              bw)


def batched_panel_plan(col: torch.Tensor, left: torch.Tensor,
                       lead: torch.Tensor) -> dict:
    """How K6's update launch takes these CUDA operands, as the kernel's
    library reports it (``slate_chol_panel_batched_plan``; keys as
    :func:`~.kernels.batched_panel_step_plan` gives them)."""
    return batched_panel_step_plan(CHOL_PANEL_BATCHED, col, left, lead)
