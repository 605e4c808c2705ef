"""Dense <-> blocked-tile layout conversion (port of slate_tpu/core/layout.py).

The whole matrix is one blocked tensor ``[Mt, Nt, mb, nb]``; partial
boundary tiles are zero-padded, and every kernel keeps the pad at zero.
The cyclic maps order tiles for a p x q grid exactly as the reference
does, so tile data moves between the packages unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def num_tiles(m: int, mb: int) -> int:
    return -(-m // mb)


def tile_dense(dense: torch.Tensor, mb: int, nb: int) -> torch.Tensor:
    """[m, n] -> canonical tile tensor [Mt, Nt, mb, nb], zero-padded."""
    m, n = dense.shape
    Mt, Nt = num_tiles(m, mb), num_tiles(n, nb)
    if Mt * mb != m or Nt * nb != n:
        dense = torch.nn.functional.pad(dense, (0, Nt * nb - n, 0, Mt * mb - m))
    return dense.reshape(Mt, mb, Nt, nb).permute(0, 2, 1, 3).contiguous()


def untile_dense(tiles: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Canonical tile tensor [Mt, Nt, mb, nb] -> dense [m, n].  The result
    may share memory with ``tiles`` (a single tile row or column reshapes
    as a view): callers that write to it copy first."""
    Mt, Nt, mb, nb = tiles.shape
    dense = tiles.permute(0, 2, 1, 3).reshape(Mt * mb, Nt * nb)
    return dense[:m, :n]


def assemble_band(dd: torch.Tensor, ss: torch.Tensor, *,
                  lower: bool) -> torch.Tensor:
    """Dense [K nb, K nb] block band from the diagonal tiles ``dd``
    [K, nb, nb] and the off-diagonal tiles ``ss`` [>= K-1, nb, nb]
    (already masked by the caller), tile g of ``ss`` at (g+1, g) when
    ``lower`` else at (g, g+1): the band gather of the heev and svd
    stage-1 reductions."""
    K, nb = dd.shape[0], dd.shape[1]
    g = torch.arange(K, device=dd.device)
    tiles = torch.zeros((K, K, nb, nb), dtype=dd.dtype, device=dd.device)
    tiles[g, g] = dd
    if K > 1 and ss.shape[0]:
        if lower:
            tiles[g[:-1] + 1, g[:-1]] = ss[:K - 1]
        else:
            tiles[g[:-1], g[:-1] + 1] = ss[:K - 1]
    return untile_dense(tiles, K * nb, K * nb)


def cyclic_row_maps(Mt: int, p: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Index maps between canonical tile order and 2D block-cyclic storage:
    storage row ``s`` holds canonical tile-row ``(s % mtl) * p + s // mtl``.
    Returns (c2s, s2c, mtl); s2c holds Mt for padding slots."""
    mtl = -(-Mt // p)
    c2s = np.empty(Mt, dtype=np.int32)
    s2c = np.full(p * mtl, Mt, dtype=np.int32)
    for i in range(Mt):
        s = (i % p) * mtl + i // p
        c2s[i] = s
        s2c[s] = i
    return c2s, s2c, mtl


def canonical_to_cyclic(tiles: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """[Mt, Nt, mb, nb] canonical -> [p*mtl, q*ntl, mb, nb] cyclic storage
    (a reshape + permute after zero-padding ragged tile counts)."""
    Mt, Nt, mb, nb = tiles.shape
    mtl, ntl = -(-Mt // p), -(-Nt // q)
    if p * mtl > Mt or q * ntl > Nt:
        tiles = torch.nn.functional.pad(
            tiles, (0, 0, 0, 0, 0, q * ntl - Nt, 0, p * mtl - Mt))
    x = tiles.reshape(mtl, p, ntl, q, mb, nb).permute(1, 0, 3, 2, 4, 5)
    return x.reshape(p * mtl, q * ntl, mb, nb)


def cyclic_to_canonical(data: torch.Tensor, Mt: int, Nt: int, p: int,
                        q: int) -> torch.Tensor:
    """Inverse of :func:`canonical_to_cyclic`."""
    S, T, mb, nb = data.shape
    mtl, ntl = S // p, T // q
    x = data.reshape(p, mtl, q, ntl, mb, nb).permute(1, 0, 3, 2, 4, 5)
    return x.reshape(p * mtl, q * ntl, mb, nb)[:Mt, :Nt]
