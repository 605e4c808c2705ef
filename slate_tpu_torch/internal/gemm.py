"""internal::gemm: one trailing-update step on local tiles and the
Huang-Abraham checksum shadows of the blocked tile product (port of
slate_tpu/internal/gemm.py; ref: internal_gemm.cc:383-688).

The reference's einsums become one matmul over the tiles flattened into
rows and columns; the pad-to-zero tiles make every tile uniform, so the
reference's four boundary regions stay one product.  These are plain
products outside any Pallas kernel, so ``torch.matmul`` (cuBLAS in full
f32 on the card: the package turns TF32 off) is their port.
"""

from __future__ import annotations

import torch


def tile_outer_product(a_col: torch.Tensor,
                       b_row: torch.Tensor) -> torch.Tensor:
    """C[i, j] = A[i] @ B[j] over tile batches: a_col [mtl, mb, kb] (one
    broadcast block column of A), b_row [ntl, kb, nb] (one broadcast block
    row of B) -> [mtl, ntl, mb, nb], the SUMMA rank-kb update, as one
    matmul."""
    mtl, mb, kb = a_col.shape
    ntl, _, nb = b_row.shape
    prod = a_col.reshape(mtl * mb, kb) @ b_row.permute(1, 0, 2).reshape(
        kb, ntl * nb)
    return prod.reshape(mtl, mb, ntl, nb).permute(0, 2, 1, 3)


def blocked_gemm(a_tiles: torch.Tensor, b_tiles: torch.Tensor):
    """Full blocked product over canonical tile arrays: a_tiles [Mt, Kt,
    mb, kb], b_tiles [Kt, Nt, kb, nb] -> [Mt, Nt, mb, nb], one contraction
    over (k, kb)."""
    Mt, Kt, mb, kb = a_tiles.shape
    Nt, nb = b_tiles.shape[1], b_tiles.shape[3]
    prod = (a_tiles.permute(0, 2, 1, 3).reshape(Mt * mb, Kt * kb)
            @ b_tiles.permute(0, 2, 1, 3).reshape(Kt * kb, Nt * nb))
    return prod.reshape(Mt, mb, Nt, nb).permute(0, 2, 1, 3)


def tile_product_row_sums(a_tiles: torch.Tensor,
                          b_tiles: torch.Tensor) -> torch.Tensor:
    """Row checksums of the blocked product ``sum_k A[i,k] B[k,j]``
    computed WITHOUT forming it: ``A (B e)`` at O(tiles * nb^2).
    a_tiles [Mt, Kt, mb, kb], b_tiles [Kt, Nt, kb, nb] -> [Mt, Nt, mb]."""
    be = b_tiles.sum(dim=-1)
    return torch.einsum("ikab,kjb->ija", a_tiles, be)


def tile_product_col_sums(a_tiles: torch.Tensor,
                          b_tiles: torch.Tensor) -> torch.Tensor:
    """Column checksums of the blocked product: ``(e^T A) B``
    -> [Mt, Nt, nb]."""
    ea = a_tiles.sum(dim=-2)
    return torch.einsum("ikb,kjbc->ijc", ea, b_tiles)
