"""Batched elementwise tile kernels (port of slate_tpu/ops/elementwise.py;
ref: src/cuda/device_geadd.cu, device_gecopy.cu, device_gescale.cu,
device_gescale_row_col.cu, device_geset.cu, device_transpose.cu and the
tz* triangular variants).

Each kernel is one torch op over the canonical tile tensor
``[Mt, Nt, mb, nb]``, as the reference's is one XLA op; the reference has
no Pallas kernel here.  The triangular (tz*) variants mask by the global
triangle, and every kernel keeps the pad region at zero.  The masks are
built on the tiles' device (the reference builds them with host numpy, as
constants of its compiled program).
"""

from __future__ import annotations

import torch


def _grid_index(m, n, mb, nb, device=None):
    """Global row and column indices of every tile entry, [Mt, 1, mb, 1]
    and [1, Nt, 1, nb]."""
    Mt, Nt = -(-m // mb), -(-n // nb)
    gi = (torch.arange(Mt, device=device)[:, None] * mb
          + torch.arange(mb, device=device)[None, :])
    gj = (torch.arange(Nt, device=device)[:, None] * nb
          + torch.arange(nb, device=device)[None, :])
    return gi[:, None, :, None], gj[None, :, None, :]


def valid_masks(m, n, mb, nb, device=None):
    """Masks of valid (non-pad) entries: ([Mt, mb], [Nt, nb])."""
    gi, gj = _grid_index(m, n, mb, nb, device)
    return (gi < m)[:, 0, :, 0], (gj < n)[0, :, 0, :]


def entry_mask(m, n, mb, nb, device=None) -> torch.Tensor:
    """[Mt, Nt, mb, nb] mask of valid (non-pad) entries."""
    gi, gj = _grid_index(m, n, mb, nb, device)
    return (gi < m) & (gj < n)


def tri_mask(m, n, mb, nb, uplo_lower: bool, strict: bool = False,
             device=None) -> torch.Tensor:
    """[Mt, Nt, mb, nb] triangle mask over GLOBAL indices (tz* kernels)."""
    gi, gj = _grid_index(m, n, mb, nb, device)
    if uplo_lower:
        return (gi > gj) if strict else (gi >= gj)
    return (gi < gj) if strict else (gi <= gj)


def _eye_mask(like_tiles, mb, nb):
    Mt, Nt = like_tiles.shape[:2]
    gi, gj = _grid_index(Mt * mb, Nt * nb, mb, nb, like_tiles.device)
    return gi == gj


# ---- general kernels (ge*) ----

def geadd(alpha, a_tiles, beta, b_tiles):
    """B = alpha A + beta B (ref: device_geadd.cu)."""
    return alpha * a_tiles + beta * b_tiles


def gecopy(a_tiles, dtype=None):
    """Precision-converting copy (ref: device_gecopy.cu)."""
    return a_tiles.to(dtype) if dtype is not None else a_tiles


def gescale(numer, denom, a_tiles):
    """A *= numer / denom (ref: device_gescale.cu)."""
    return a_tiles * (numer / denom)


def gescale_row_col(r, c, a_tiles, m, n, mb, nb):
    """A[i, j] *= r[i] c[j] (ref: device_gescale_row_col.cu); r [m], c [n]."""
    Mt, Nt = -(-m // mb), -(-n // nb)
    rp = torch.nn.functional.pad(r, (0, Mt * mb - m)).reshape(Mt, mb)
    cp = torch.nn.functional.pad(c, (0, Nt * nb - n)).reshape(Nt, nb)
    return a_tiles * rp[:, None, :, None] * cp[None, :, None, :]


def geset(offdiag, diag, like_tiles, m, n, mb, nb):
    """A = offdiag everywhere, diag on the diagonal (ref: device_geset.cu;
    geset(0, 1) builds the identity).  The pad region is zero."""
    out = torch.where(_eye_mask(like_tiles, mb, nb),
                      torch.full_like(like_tiles, diag),
                      torch.full_like(like_tiles, offdiag))
    return out * entry_mask(m, n, mb, nb, like_tiles.device).to(out.dtype)


def transpose_tiles(a_tiles, conj=False):
    """Out-of-place blocked transpose: [Mt, Nt, mb, nb] -> [Nt, Mt, nb, mb]
    (ref: device_transpose.cu)."""
    t = a_tiles.permute(1, 0, 3, 2)
    return t.conj() if conj else t


# ---- triangular/trapezoid kernels (tz*) ----

def tzadd(alpha, a_tiles, beta, b_tiles, m, n, mb, nb, uplo_lower):
    """Triangle-masked add (ref: device_tzadd.cu)."""
    mask = tri_mask(m, n, mb, nb, uplo_lower, device=b_tiles.device)
    return torch.where(mask, alpha * a_tiles + beta * b_tiles, b_tiles)


def tzcopy(a_tiles, b_tiles, m, n, mb, nb, uplo_lower, dtype=None):
    """Triangle-masked converting copy (ref: device_tzcopy.cu)."""
    src = a_tiles.to(dtype or b_tiles.dtype)
    mask = tri_mask(m, n, mb, nb, uplo_lower, device=b_tiles.device)
    return torch.where(mask, src, b_tiles)


def tzscale(numer, denom, a_tiles, m, n, mb, nb, uplo_lower):
    """Triangle-masked scale (ref: device_tzscale.cu)."""
    mask = tri_mask(m, n, mb, nb, uplo_lower, device=a_tiles.device)
    return torch.where(mask, a_tiles * (numer / denom), a_tiles)


def tzset(offdiag, diag, like_tiles, m, n, mb, nb, uplo_lower):
    """Triangle set (ref: device_tzset.cu)."""
    full = geset(offdiag, offdiag, like_tiles, m, n, mb, nb)
    full = torch.where(_eye_mask(like_tiles, mb, nb),
                       torch.full_like(full, diag), full)
    dev = like_tiles.device
    mask = (tri_mask(m, n, mb, nb, uplo_lower, device=dev)
            & entry_mask(m, n, mb, nb, dev))
    return torch.where(mask, full, torch.zeros_like(full))
