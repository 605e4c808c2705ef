"""Batched norm kernels: Max / One / Inf / Fro for every matrix structure,
over canonical tiles [Mt, Nt, mb, nb] (port of slate_tpu/ops/norms.py;
ref: src/internal/internal_genorm.cc, internal_synorm.cc,
internal_henorm.cc, internal_trnorm.cc, internal_gbnorm.cc,
internal_hbnorm.cc), including the scaled-sumsq form of the Frobenius norm
(LAPACK's lassq) that avoids overflow and underflow.

The reference has no Pallas kernel here: these are torch reductions with
explicit validity masks over the padded tiles, taken from
ops/elementwise.py as the reference takes them.
"""

from __future__ import annotations

import torch

from ..types import Norm
from .elementwise import _grid_index, entry_mask, tri_mask


def band_mask(m, n, mb, nb, kl, ku, device=None) -> torch.Tensor:
    """[Mt, Nt, mb, nb] mask of the band kl below, ku above the diagonal."""
    gi, gj = _grid_index(m, n, mb, nb, device)
    return (gj - gi <= ku) & (gi - gj <= kl)


def _masked(a_tiles, mask):
    absa = a_tiles.abs()
    return torch.where(mask, absa, torch.zeros_like(absa))


def _sumsq_scaled(absa):
    """(scale, sumsq) with ||x||_F = scale * sqrt(sumsq) (lassq)."""
    scale = absa.max()
    scale_safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return scale, ((absa / scale_safe) ** 2).sum()


def _reduce(norm: Norm, absa):
    """Max / One / Inf / Fro of masked |tiles| [Mt, Nt, mb, nb]."""
    if norm is Norm.Max:
        return absa.max()
    if norm is Norm.One:                      # max column sum
        return absa.sum(dim=(0, 2)).max()
    if norm is Norm.Inf:                      # max row sum
        return absa.sum(dim=(1, 3)).max()
    if norm is Norm.Fro:
        scale, s = _sumsq_scaled(absa)
        return scale * torch.sqrt(s)
    raise ValueError(norm)


def ge_norm(norm: Norm, a_tiles, m, n, mb, nb):
    """General-matrix norm over masked tiles (ref: internal_genorm.cc)."""
    return _reduce(norm, _masked(a_tiles, entry_mask(
        m, n, mb, nb, a_tiles.device)))


def ge_col_norms(a_tiles, m, n, mb, nb):
    """Per-column max-abs (ref: colNorms, Norm::Max scope=Columns).
    Returns [n]."""
    absa = _masked(a_tiles, entry_mask(m, n, mb, nb, a_tiles.device))
    per_col = absa.amax(dim=(0, 2))           # [Nt, nb]
    return per_col.reshape(-1)[:n]


def _diag_mask(shape, mb, nb, k, device):
    Mt, Nt = shape[:2]
    gi, gj = _grid_index(Mt * mb, Nt * nb, mb, nb, device)
    return (gi == gj) & (gi < k)


def tr_norm(norm: Norm, a_tiles, m, n, mb, nb, uplo_lower, unit_diag=False):
    """Trapezoid/triangular norm (ref: internal_trnorm.cc)."""
    dev = a_tiles.device
    mask = entry_mask(m, n, mb, nb, dev) & tri_mask(
        m, n, mb, nb, uplo_lower, strict=unit_diag, device=dev)
    absa = _masked(a_tiles, mask)
    if unit_diag:
        # the implicit unit diagonal
        diag = _diag_mask(a_tiles.shape, mb, nb, min(m, n), dev)
        absa = torch.where(diag, torch.ones_like(absa), absa)
    return _reduce(norm, absa)


def sy_norm(norm: Norm, a_tiles, n, nb, uplo_lower, hermitian=False):
    """Symmetric/Hermitian norm from one stored triangle (ref:
    internal_synorm.cc, internal_henorm.cc).  One == Inf by symmetry; row
    and column sums combine the stored triangle with its mirror exactly
    once (the diagonal not twice)."""
    dev = a_tiles.device
    full = entry_mask(n, n, nb, nb, dev)
    tri = tri_mask(n, n, nb, nb, uplo_lower, device=dev)
    stri = tri_mask(n, n, nb, nb, uplo_lower, strict=True, device=dev)
    absa = _masked(a_tiles, full & tri)
    abs_strict = _masked(a_tiles, full & stri)
    if norm is Norm.Max:
        return absa.max()
    if norm in (Norm.One, Norm.Inf):
        col = absa.sum(dim=(0, 2))                # stored triangle col sums
        row_of_strict = abs_strict.sum(dim=(1, 3))  # the mirrored part
        return (col.reshape(-1) + row_of_strict.reshape(-1)).max()
    if norm is Norm.Fro:
        scale, s = _sumsq_scaled(abs_strict)
        # off-diagonal counted twice, the diagonal once
        dscale, ds = _sumsq_scaled(_masked(a_tiles, full & tri & ~stri))
        return torch.sqrt(2.0 * scale ** 2 * s + dscale ** 2 * ds)
    raise ValueError(norm)


def gb_norm(norm: Norm, a_tiles, m, n, mb, nb, kl, ku):
    """General band norm (ref: internal_gbnorm.cc)."""
    dev = a_tiles.device
    mask = entry_mask(m, n, mb, nb, dev) & band_mask(m, n, mb, nb, kl, ku,
                                                     dev)
    return _reduce(norm, _masked(a_tiles, mask))


def hb_norm(norm: Norm, a_tiles, n, nb, kd, uplo_lower):
    """Hermitian band norm (ref: internal_hbnorm.cc)."""
    dev = a_tiles.device
    kl, ku = (kd, 0) if uplo_lower else (0, kd)
    mask = (entry_mask(n, n, nb, nb, dev) & band_mask(n, n, nb, nb, kl, ku,
                                                      dev)
            & tri_mask(n, n, nb, nb, uplo_lower, device=dev))
    stri = tri_mask(n, n, nb, nb, uplo_lower, strict=True, device=dev)
    absa = _masked(a_tiles, mask)
    abs_strict = _masked(a_tiles, mask & stri)
    if norm is Norm.Max:
        return absa.max()
    if norm in (Norm.One, Norm.Inf):
        col = absa.sum(dim=(0, 2)).reshape(-1)
        row = abs_strict.sum(dim=(1, 3)).reshape(-1)
        return (col + row).max()
    if norm is Norm.Fro:
        oscale, os_ = _sumsq_scaled(abs_strict)
        dscale, ds = _sumsq_scaled(_masked(a_tiles, mask & ~stri))
        return torch.sqrt(2.0 * oscale ** 2 * os_ + dscale ** 2 * ds)
    raise ValueError(norm)
