"""K1 and K2: the Cholesky tile and the fused Cholesky panel step (port of
slate_tpu/internal/pallas_chol.py ``chol_tile_pallas`` and
``chol_panel_fused``).

Each kernel has a plain version here that repeats its arithmetic in torch
ops: the CPU tests run it, and on the card it is only the comparison.
A wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel (``csrc/chol_tile.cu``, ``csrc/chol_panel.cu``) or
raises.
"""

from __future__ import annotations

import torch

from .kernels import I32, I64, P, CudaKernel, check_cuda_f32, \
    device_and_stream
from .tri_inv import upper_tri_inv, upper_tri_inv_plain

CHOL_TILE = CudaKernel("chol_tile", "chol_tile.cu", {
    "slate_chol_tile": [I32, P, P, I64, I64, P, I32, I32]})
CHOL_PANEL = CudaKernel("chol_panel_fused", "chol_panel.cu", {
    "slate_chol_panel_diag": [I32, P, P, I64, I64, P, I64, I64, P, I64, I64,
                              I32, I32, I32, P, P],
    "slate_chol_panel_below": [I32, P, P, I64, I64, P, I64, I64, P, I64, I64,
                               I32, I32, I32, P, P, P]})

TILE_MAX_N = 128          # one n x (n+1) f32 tile in shared memory
PANEL_NB = (32, 64, 96, 128)   # the instantiated widths (an 8 x 8 register
                               # tile per thread at 128)


def chol_tile_plain(a: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Lower Cholesky factor of an SPD tile by the column loop of
    ``_chol_factor_in_place`` (pallas_chol.py:63), in lower form: in each
    bw-column panel, column by column, pivot = sqrt, the column below it
    times 1/pivot, rank-1 update of the panel's later columns; after the
    panel, rank-bw update of the trailing columns.  Upper part exactly 0;
    a non-positive pivot poisons every later column with NaN/Inf."""
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


def chol_tile(a: torch.Tensor, bw: int = 8) -> torch.Tensor:
    """Lower Cholesky factor of one SPD [n, n] tile, n % bw == 0.  A CPU
    tensor takes the plain version; a CUDA tensor launches K1 (f32,
    n <= 128) or raises."""
    n = a.shape[-1]
    if a.dim() != 2 or a.shape[0] != n or bw < 1 or n % bw:
        raise ValueError(f"chol_tile: needs one square tile with n % bw == "
                         f"0, got {tuple(a.shape)} and bw={bw}")
    if a.device.type == "cpu":
        return chol_tile_plain(a, bw)
    check_cuda_f32("chol_tile", a)
    if n > TILE_MAX_N:
        raise ValueError(f"chol_tile: n = {n} > {TILE_MAX_N} does not fit "
                         f"one block's shared memory")
    out = torch.empty((n, n), dtype=a.dtype, device=a.device)
    CHOL_TILE.launch("slate_chol_tile", *device_and_stream(a), a.data_ptr(),
                     a.stride(0), a.stride(1), out.data_ptr(), n, bw)
    return out


def chol_panel_plain(col, left, lead, bw: int = 8):
    """The fused panel step in torch ops: upd = col - left @ lead; row
    tile 0 factored by the K1 column loop; fac rows below = upd @ U^-1
    with U = L00^T inverted by the K0 series."""
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
    nb in {32, 64, 96, 128}) or raise.  On CUDA, on the current stream:
    K2's diagonal launch (upd and fac of row tile 0); when M > nb, K0 on
    U = L00^T (counted by K0's wrapper) and K2's launch for the rows
    below.  CHOL_PANEL counts K2's one or two launches.
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
    if nb not in PANEL_NB:
        raise ValueError(f"chol_panel_fused: nb = {nb} not in {PANEL_NB}")
    upd = torch.empty((m, nb), dtype=col.dtype, device=col.device)
    fac = torch.empty_like(upd)
    dev, stream = device_and_stream(col)
    operands = (col.data_ptr(), col.stride(0), col.stride(1),
                left.data_ptr(), left.stride(0), left.stride(1),
                lead.data_ptr(), lead.stride(0), lead.stride(1), k, nb)
    CHOL_PANEL.launch("slate_chol_panel_diag", dev, stream, *operands, bw,
                      upd.data_ptr(), fac.data_ptr())
    if m > nb:
        uinv = upper_tri_inv(fac[:nb].mT)        # K0 on U = L00^T
        CHOL_PANEL.launch("slate_chol_panel_below", dev, stream, *operands,
                          m, uinv.data_ptr(), upd.data_ptr(), fac.data_ptr())
    return upd, fac
