"""internal::potrf: the diagonal-tile factor and the fused panel seam (port
of slate_tpu/internal/potrf.py).

Both seams consult the tile plan (tune/plans.py).  The gates carry this
card's limits, not the TPU's VMEM ones, at the reference's widths: K1
holds one n x (n+4) f32 tile in a block's shared memory up to n = 128 and
factors a wider one (up to 1024) on one thread-block cluster, in device
memory by 128-column diagonal blocks; K2's factor launch does the same at
nb = 32 .. 128 and 256, 384, 512, while its update and solve launches
keep a 16 x 8 register tile a thread over 128-column tiles.  The CPU
routes take the same widths, so that both devices route a panel alike;
on the card each wrapper asks its kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..tune.plans import resolve_plan
from .chol_kernels import PANEL_NB, TILE_MAX_N, chol_panel_fused, chol_tile


def tile_fits(n: int) -> bool:
    """True when K1 takes an n x n tile: n % 32 == 0, 32 <= n <= 1024 (one
    block's shared memory up to 128, one thread-block cluster past it)."""
    return n % 32 == 0 and 32 <= n <= TILE_MAX_N


def _tile_plan_ok(dtype: torch.dtype, n: int) -> bool:
    if not (dtype == torch.float32 and tile_fits(n)):
        return False
    plan = resolve_plan("potrf_tile", n, "float32")
    return plan.kernel == "cuda" and n % plan.bw == 0


def potrf_tile(a: torch.Tensor) -> torch.Tensor:
    """Factor one Hermitian positive-definite tile: returns lower L.

    Under the "cuda" plan an f32 tile with 32 <= n <= 1024, n % 32 == 0
    goes to K1; anything else to ``torch.linalg.cholesky_ex``, whose failed
    factor is NaN-filled from the first failing minor's column on (its
    ``info``), so that the first bad diagonal is the same on every route
    and dtype, as K1 leaves it.  (The reference's XLA route NaN-fills a
    failed tile whole and so reports the tile's first row.)"""
    n = a.shape[-1]
    if a.dim() == 2 and _tile_plan_ok(a.dtype, n):
        return chol_tile(a, bw=resolve_plan("potrf_tile", n, "float32").bw)
    L, info = torch.linalg.cholesky_ex(a)
    cols = torch.arange(n, device=a.device)
    bad = (info[..., None] > 0) & (cols >= info[..., None] - 1)
    return L.masked_fill(bad[..., None, :], math.nan)


def potrf_panel_ok(dtype: torch.dtype, m: int, w: int, nb: int) -> bool:
    """True when the fused panel step (K2) serves this panel: the "cuda"
    plan, f32, a full-width panel, nb in {32, 64, 96, 128, 256, 384,
    512}."""
    if not (dtype == torch.float32 and w == nb and m >= nb
            and nb in PANEL_NB):
        return False
    plan = resolve_plan("potrf_panel", m, "float32")
    return plan.kernel == "cuda" and nb % plan.bw == 0


def potrf_panel_fused(col, left, lead):
    """Fused left-looking panel step (chol_kernels.chol_panel_fused):
    returns (upd, fac) = (pre-factor panel, [L00; L21]).  Caller gates
    with potrf_panel_ok; ragged row counts are zero-padded to a tile
    multiple here (zero rows factor to zero L21 rows) and sliced back."""
    m, nb = col.shape
    plan = resolve_plan("potrf_panel", m, "float32")
    mp = -(-m // nb) * nb
    if mp != m:
        col = F.pad(col, (0, 0, 0, mp - m))
        left = F.pad(left, (0, 0, 0, mp - m))
    upd, fac = chol_panel_fused(col, left, lead, bw=plan.bw)
    return upd[:m], fac[:m]


# ---- out-of-core panel steps (drivers/cholesky.py potrf_ooc) ----
# Each step of the streamed left-looking loop is a pure function of the
# device windows the TileMap brings in, with the same launches on the
# same shapes every time: a resumed run repeats the uninterrupted run's
# steps bit for bit.

def ooc_chol_update(acc: torch.Tensor, left: torch.Tensor,
                    lead: torch.Tensor) -> torch.Tensor:
    """One streamed left-looking accumulation: subtract the contribution
    of a previous block column.  ``acc`` [m-k0, w] is the running panel,
    ``left`` = A[k0:, j0:j1], ``lead`` = A[k0:k1, j0:j1]."""
    return acc - left @ lead.conj().T


def ooc_chol_panel(upd: torch.Tensor) -> torch.Tensor:
    """Factor the accumulated [m-k0, w] panel: [L00; L21], the diagonal
    tile through :func:`potrf_tile` (K1 for an f32 tile with w <= 1024
    under the "cuda" plan) and the rows below one matmul against the
    inverted L00, as the in-core blocked loop does."""
    from .trsm import tri_inv_lower
    w = upd.shape[1]
    lkk = potrf_tile(upd[:w])
    tail = upd[w:] @ tri_inv_lower(lkk).conj().T
    return torch.cat([lkk, tail], dim=0)
