"""internal::gemm: the Huang-Abraham checksum shadows of the blocked tile
product (port of ``tile_product_row_sums`` and ``tile_product_col_sums``
of slate_tpu/internal/gemm.py).  The tile products themselves
(``tile_outer_product``, ``blocked_gemm``) serve only the mesh drivers and
come with them.
"""

from __future__ import annotations

import torch


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
