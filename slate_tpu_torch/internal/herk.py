"""internal::herk / syrk: the rank-k trailing update on local tiles (port
of slate_tpu/internal/herk.py; ref: internal_herk.cc:843,
internal_syrk.cc:836).

As in the reference, diagonal and off-diagonal tiles take one uniform
product; the diagonal tiles' redundant strictly-upper half is left for
the consumers' triangular reads.  The reference's einsum is one matmul
over the tiles flattened into rows (a plain product outside any Pallas
kernel).
"""

from __future__ import annotations

import torch


def herk_panel_update(prow: torch.Tensor, pcol: torch.Tensor,
                      conj: bool = True) -> torch.Tensor:
    """The SUBTRACTED term of C[i, j] -= P[i] @ op(P[j]) for tile batches
    (the caller applies the sign and beta): prow [S, mb, kb] the panel
    tiles of the rows updated, pcol [T, nb, kb] those of the columns ->
    [S, T, mb, nb]; op is the conjugate transpose (``conj``) or the
    transpose."""
    S, mb, kb = prow.shape
    T, nb, _ = pcol.shape
    pc = pcol.reshape(T * nb, kb)
    pc = pc.conj() if conj else pc
    prod = prow.reshape(S * mb, kb) @ pc.T
    return prod.reshape(S, mb, T, nb).permute(0, 2, 1, 3)
