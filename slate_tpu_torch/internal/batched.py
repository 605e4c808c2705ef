"""Ragged batched factorizations over the batched panel kernels (port of
slate_tpu/internal/batched.py).

The serving layer packs mixed-size problems into one identity-augmented
bucket stack (serve/bucket.py ``pad_square``/``pad_tall``): problem i of
size s_i fills the top-left s_i x s_i of its [n, n] slot, the rest of the
diagonal is I, and filler slots are whole identity (zero rows for QR).
These drivers run a left-looking blocked loop over the bucket's block
columns in which every panel step is ONE batched kernel call (K6
``chol_panel_batched``, K7 ``lu_panel_batched``, K8 ``qr_panel_batched``)
that reads the per-problem sizes on the device: each problem computes only
its own live tiles, and dead tiles copy their input through bit for bit,
which for identity-augmented packing IS their factor.  So the batched
factor is bit-identical to the augmented input in the padding region and
numerically equal to the per-problem factor on the live region.

Raggedness: Cholesky and LU skip per row TILE (k + i >= ceil(s_i / nb));
QR per PROBLEM only (its identity-augmented padding columns own real
reflectors), so a live problem factors its whole bucket panel while
zero-row filler slots pass through.

Storage is f32 or bf16.  On bf16 every panel accumulates in f32 inside its
kernel, and the glue between panels (the U12 solves, the compact-WY
trailing updates, the solves) widens factor blocks to f32, computes, and
rounds only the values stored back; solves against a bf16 factor return
``b``'s dtype.  The glue is PyTorch (cuBLAS on the card), as the reference
leaves it to XLA.  ``abft=True`` (the checksum rungs) is not ported.
"""

from __future__ import annotations

import torch

from ..exceptions import not_ported
from ..robust import health as _h
from .chol_kernels import chol_panel_batched
from .lu_kernels import lu_panel_batched
from .qr_kernels import qr_panel_batched


def _f32(x: torch.Tensor) -> torch.Tensor:
    """A factor block widened to f32 for the glue between panels (no copy
    on f32 input, so the f32 route's numerics are unchanged)."""
    return x.to(torch.float32)


def tile_counts(sizes: torch.Tensor, nb: int) -> torch.Tensor:
    """Per-problem live tile counts ceil(sizes / nb), int32 [B], on the
    device ``sizes`` lies on."""
    return ((sizes + (nb - 1)) // nb).to(torch.int32)


def batch_potrf(a: torch.Tensor, sizes: torch.Tensor, *, nb: int,
                bw: int = 8, abft: bool = False) -> torch.Tensor:
    """Ragged batched Cholesky: the lower factors of identity-augmented HPD
    slots ``a`` [B, n, n] with live sizes ``sizes`` [B], n % nb == 0.  L is
    in the lower triangle; the strict upper triangle of the diagonal tiles
    is 0 and the rest of it keeps the input, as in the single-problem
    driver.  (The reference also returns the ABFT counters, which are zero
    without ``abft``.)  One K6 step a block column: 3 n / nb - 1 launches
    on the card (update, factor and solve a step, the last step no
    solve)."""
    if abft:
        raise not_ported("batch_potrf's in-batch ABFT checksum rungs "
                         "(robust/abft.py)", "queue 1, item 6 (robustness)")
    n = a.shape[1]
    tiles = tile_counts(sizes, nb)
    fa = a.clone(memory_format=torch.contiguous_format)
    for k in range(n // nb):
        k0, k1 = k * nb, (k + 1) * nb
        _, fac = chol_panel_batched(fa[:, k0:, k0:k1], fa[:, k0:, :k0],
                                    fa[:, k0:k1, :k0].mT, tiles, k, bw)
        fa[:, k0:, k0:k1] = fac
    return fa


def batch_getrf(a: torch.Tensor, sizes: torch.Tensor, *, nb: int,
                bw: int = 8) -> torch.Tensor:
    """Ragged batched no-pivot LU: the packed L\\U (unit lower implied) of
    identity-augmented slots ``a`` [B, n, n] with live sizes ``sizes``,
    n % nb == 0.  One K7 step a block column (3 n / nb - 1 launches on the
    card), then the U12 row block by a unit-lower solve: its padding rows
    are exactly zero (zero A rows, zero L10 rows) and the solve against the
    block-diagonal L11 never mixes padding and live rows, so the padding
    region stays exact."""
    n = a.shape[1]
    tiles = tile_counts(sizes, nb)
    fa = a.clone(memory_format=torch.contiguous_format)
    for k in range(n // nb):
        k0, k1 = k * nb, (k + 1) * nb
        _, fac = lu_panel_batched(fa[:, k0:, k0:k1], fa[:, k0:, :k0],
                                  fa[:, :k0, k0:k1], tiles, k, bw)
        fa[:, k0:, k0:k1] = fac
        if k1 < n:
            r = _f32(fa[:, k0:k1, k1:]) - _f32(fa[:, k0:k1, :k0]) @ _f32(
                fa[:, :k0, k1:])
            u12 = torch.linalg.solve_triangular(
                _f32(fac[:, :nb]), r, upper=False, unitriangular=True)
            fa[:, k0:k1, k1:] = u12.to(a.dtype)
    return fa


def batch_getrs(fa: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve with a batched packed no-pivot L\\U: unit-lower forward, upper
    back substitution; fa [B, n, n], b [B, n, k].  A bf16 factor is widened
    and solved in f32; the result takes ``b``'s dtype."""
    fh = _f32(fa)
    y = torch.linalg.solve_triangular(fh, _f32(b), upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(fh, y, upper=True).to(b.dtype)


def _unit_lower(pk: torch.Tensor) -> torch.Tensor:
    """V of a packed panel [B, m, w] in f32: below the diagonal, 1 on it."""
    m, w = pk.shape[1:]
    return _f32(torch.tril(pk, -1)) + torch.eye(m, w, dtype=torch.float32,
                                                device=pk.device)


def batch_geqrf(a: torch.Tensor, rows: torch.Tensor, *, nb: int,
                bw: int = 8):
    """Ragged batched Householder QR of ``a`` [B, mb, n] with per-problem
    live row counts ``rows`` [B] (0 marks a filler slot), w = min(nb, n),
    n % w == 0, mb >= n.  Returns ``(packed, ts)``: per-problem packed
    panels (R on and above the diagonal, Householder vectors below) and the
    compact-WY triangles ts [B, n // w, w, w]; Q = prod_j (I - V_j T_j
    V_j^T).  One K8 launch a panel, then the trailing update in f32."""
    n = a.shape[2]
    w = min(nb, n)
    packed = a.clone(memory_format=torch.contiguous_format)
    ts = []
    for j in range(n // w):
        j0, j1 = j * w, (j + 1) * w
        pk, t = qr_panel_batched(packed[:, j0:, j0:j1], rows, bw)
        packed[:, j0:, j0:j1] = pk
        ts.append(t)
        if j1 < n:
            v = _unit_lower(pk)
            c = _f32(packed[:, j0:, j1:])
            g = _f32(t).mT @ (v.mT @ c)
            packed[:, j0:, j1:] = (c - v @ g).to(a.dtype)
    return packed, torch.stack(ts, dim=1)


def batch_gels(a: torch.Tensor, b: torch.Tensor, rows: torch.Tensor, *,
               nb: int, bw: int = 8):
    """Ragged batched least squares through :func:`batch_geqrf`: per
    problem min ||a_i x_i - b_i||, a [B, mb, n], b [B, mb, k].  Returns
    ``(x [B, n, k], packed)`` with x = R^-1 (Q^T b)[:n]; a bf16 factor is
    applied and solved in f32 and x takes ``b``'s dtype."""
    n = a.shape[2]
    packed, ts = batch_geqrf(a, rows, nb=nb, bw=bw)
    w = ts.shape[2]
    y = _f32(b).clone()
    for j in range(n // w):
        j0 = j * w
        v = _unit_lower(packed[:, j0:, j0:j0 + w])
        c = y[:, j0:]
        g = _f32(ts[:, j]).mT @ (v.mT @ c)
        y[:, j0:] = c - v @ g
    x = torch.linalg.solve_triangular(_f32(packed[:, :n, :n]), y[:, :n],
                                      upper=True)
    return x.to(b.dtype), packed


def chol_health(fa: torch.Tensor) -> _h.BatchHealth:
    """The Cholesky health of each factor of :func:`batch_potrf`, on the
    device (drivers/cholesky.py ``_chol_health`` per problem): padding
    diagonal entries are exactly 1, so they never win the min-pivot argmin
    away from a real failure."""
    d = torch.diagonal(fa, dim1=1, dim2=2).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    mi = torch.argmin(d, dim=1)
    mp = d.gather(1, mi[:, None])[:, 0]
    bad = (mp == 0) | ~torch.isfinite(mp)
    finite = torch.isfinite(torch.tril(fa)).flatten(1).all(dim=1)
    return _h.batch_healthy(fa.shape[0], fa.device)._replace(
        nonfinite=~finite, info=torch.where(bad, mi + 1, 0),
        min_pivot=mp.double(), min_pivot_index=mi)


def lu_health(a: torch.Tensor, fa: torch.Tensor) -> _h.BatchHealth:
    """The LU health of each factor of :func:`batch_getrf`, on the device
    (drivers/lu.py ``_lu_health`` per problem): a zero or NaN pivot sets
    ``info``; growth = max|L\\U| / max|A| (padding adds 1s to both and never
    masks a blow-up)."""
    ud = torch.diagonal(fa, dim1=1, dim2=2).abs()
    mi = torch.argmin(ud, dim=1)
    mp = ud.gather(1, mi[:, None])[:, 0]
    bad = (mp == 0) | ~torch.isfinite(mp)
    fmax = fa.abs().flatten(1).amax(dim=1)
    amax = a.abs().flatten(1).amax(dim=1)
    growth = torch.where(amax > 0, fmax / amax,
                         torch.full_like(fmax, float("inf")))
    finite = torch.isfinite(fa).flatten(1).all(dim=1)
    return _h.batch_healthy(fa.shape[0], fa.device)._replace(
        nonfinite=~finite, info=torch.where(bad, mi + 1, 0),
        min_pivot=mp.double(), min_pivot_index=mi, growth=growth.double())


def batch_chol_health(fa: torch.Tensor) -> list[_h.HealthInfo]:
    """One HealthInfo per factor of :func:`batch_potrf`, read in one copy."""
    return chol_health(fa).to_list()


def batch_lu_health(a: torch.Tensor,
                    fa: torch.Tensor) -> list[_h.HealthInfo]:
    """One HealthInfo per factor of :func:`batch_getrf`, read in one copy."""
    return lu_health(a, fa).to_list()
