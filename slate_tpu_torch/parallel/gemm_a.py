"""Stationary-A distributed gemm: reduce over C instead of broadcasting A
(port of slate_tpu/parallel/gemm_a.py; ref: gemmA.cc, internal_gemmA.cc).

When C is much smaller than A (single-block-column solves, skinny
projections), SUMMA's panel broadcasts of A dwarf the useful work; gemmA
keeps A where it is:

1. B (k x n, n << k) is replicated by two all-gathers, along p then q;
2. each rank contracts its local A tiles against the B rows they meet,
   in one matmul: A never moves;
3. one reduce-scatter along q both completes the k sum and hands each
   rank exactly its C tiles.

The k sum is a sum of true partials, so its order (the backend's
reduce-scatter) differs from the reference's psum_scatter: parity with it
is by tolerance.
"""

from __future__ import annotations

import torch

from ..comm import collectives as cc
from ..core.grid import AXIS_P, AXIS_Q, Grid
from ..internal.gemm import blocked_gemm


def dist_gemmA_data(a_data, b_data, c_data, alpha, beta, Kt: int,
                    grid: Grid):
    """C = alpha A B + beta C with A stationary, over this rank's local
    blocks: a_data [mtl, ktl_a, mb, kb], b_data [ktl_b, ntl, kb, nb],
    c_data [mtl, ntl, mb, nb]."""
    p, q = grid.p, grid.q
    _, c = grid.coords
    ktl_a = a_data.shape[1]
    ktl_b, ntl = b_data.shape[:2]

    # ---- step 1: replicate B (skinny) ----
    ball = cc.allgather_along(b_data, AXIS_P, grid, concat_axis=None)
    ball = cc.allgather_along(ball, AXIS_Q, grid, concat_axis=None)
    # ball[c', r', kl, jl] = B tile (gk = r' + p*kl, gj = c' + q*jl)

    # ---- step 2: local contraction, A stationary ----
    # this rank's A k tiles are gk = c + q*ka; the B rows they meet, for
    # every column; k tiles past B's (A's pad columns, zero) meet zeros
    dev = b_data.device
    gk = c + q * torch.arange(ktl_a, device=dev)
    gj = torch.arange(q * ntl, device=dev)
    live = (gk // p) < ktl_b
    gkc = torch.where(live, gk, torch.zeros_like(gk))
    bsel = ball[(gj % q)[None, :], (gkc % p)[:, None], (gkc // p)[:, None],
                (gj // q)[None, :]]                  # [ktl_a, q*ntl, kb, nb]
    bsel = torch.where(live[:, None, None, None], bsel,
                       torch.zeros_like(bsel))
    partial = blocked_gemm(a_data, bsel)         # [mtl, q*ntl, mb, nb]

    # ---- step 3: fused k sum + scatter to C's owners along q ----
    # global column j = c' + q*jl: chunk c' carries the columns j = c' mod q
    chunks = torch.stack([partial[:, c2::q] for c2 in range(q)])
    mine = cc.reduce_scatter_along(chunks, AXIS_Q, grid)[0]
    return alpha * mine + beta * c_data
