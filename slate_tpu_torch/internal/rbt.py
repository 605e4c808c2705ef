"""internal::rbt: recursive random butterfly transforms (port of
slate_tpu/internal/rbt.py).

Random butterflies precondition A so that LU needs no pivoting with
probability ~1 (Parker '95; Baboulin et al.):

    A~ = U^T diag(A, I_pad) V,      x = V y,   A~ y = U^T [b; 0]

with U, V independent depth-``d`` recursive butterflies.  A butterfly of
size s is B = (1/sqrt(2)) [[R0, R1], [R0, -R1]] with R0, R1 random
diagonal, so applying B, B^T or B^-1 is an add/sub of halves and a
diagonal scale: elementwise torch ops, no kernel.

A butterfly is a tuple of ``depth`` levels, level ``l`` a pair ``(r0, r1)``
of flat [n/2] real tensors (the top-half / bottom-half diagonals of that
level's 2^l butterflies).  They are drawn with numpy from a seed exactly as
the reference draws them, so the same seed gives the same bits in both
packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..types import real_dtype

#: element padding granularity for a depth-2 transform
DEFAULT_DEPTH = 2

_NUMPY_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def padded_size(n: int, depth: int = DEFAULT_DEPTH) -> int:
    """Smallest multiple of 2**depth that is >= n (and >= 2**depth)."""
    m = 1 << depth
    return max(-(-int(n) // m) * m, m)


def generate(n: int, depth: int = DEFAULT_DEPTH, seed: int = 0,
             dtype: torch.dtype = torch.float64, device=None):
    """A random depth-``depth`` butterfly of size ``n`` (n % 2**depth == 0)
    as a tuple of per-level ``(r0, r1)`` diagonal pairs on ``device``.

    Entries are exp(u/10), u ~ U(-1/2, 1/2), from ``np.random.default_rng
    (seed)`` in the reference's order; ``dtype`` may be complex, the
    diagonals are always its real counterpart."""
    if n <= 0 or n % (1 << depth):
        raise ValueError(
            f"rbt.generate: n={n} must be a positive multiple of "
            f"2**depth={1 << depth}")
    rdt = _NUMPY_REAL[real_dtype(dtype)]
    rng = np.random.default_rng(seed)
    levels = []
    for _ in range(depth):
        r = np.exp(rng.uniform(-0.5, 0.5, size=n) / 10.0).astype(rdt)
        levels.append((torch.from_numpy(r[: n // 2].copy()).to(device),
                       torch.from_numpy(r[n // 2:].copy()).to(device)))
    return tuple(levels)


def _combine(r0, r1, top, bot, mode, s):
    """One butterfly block: B = s[[R0, R1], [R0, -R1]], s = 1/sqrt(2)."""
    if mode == "n":                         # B x
        return s * (r0 * top + r1 * bot), s * (r0 * top - r1 * bot)
    if mode == "t":                         # B^T x
        return s * r0 * (top + bot), s * r1 * (top - bot)
    if mode == "inv":                       # B^-1 x  (B^T with R -> R^-1)
        return s * (top + bot) / r0, s * (top - bot) / r1
    # "invt": B^-T x  (B with R -> R^-1)
    return s * (top / r0 + bot / r1), s * (top / r0 - bot / r1)


def apply_axis(levels, x: torch.Tensor, mode: str,
               axis: int = 0) -> torch.Tensor:
    """Apply W = L_0 L_1 ... L_{d-1} (or its transpose/inverse) along one
    axis of ``x``.  ``mode``: "n" W, "t" W^T, "inv" W^-1, "invt" W^-T."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    d = len(levels)
    s = math.sqrt(0.5)
    # W x applies the innermost (smallest-block) level first; W^T / W^-1
    # reverse the product, so they apply the full-size level first.
    order = range(d) if mode in ("t", "inv") else range(d - 1, -1, -1)
    for lev in order:
        r0, r1 = levels[lev]
        nblk = 1 << lev
        half = n // nblk // 2
        shp = (nblk, half) + (1,) * (x.dim() - 1)
        xb = x.reshape(nblk, 2, half, *x.shape[1:])
        top, bot = _combine(r0.reshape(shp), r1.reshape(shp), xb[:, 0],
                            xb[:, 1], mode, s)
        x = torch.stack([top, bot], dim=1).reshape(n, *x.shape[1:])
    return torch.movedim(x, 0, axis)


def apply_left(levels, x):
    """W @ x: the solution back-transform x = V y."""
    return apply_axis(levels, x, "n", 0)


def apply_left_t(levels, x):
    """W^T @ x: the right-hand side's forward transform U^T b."""
    return apply_axis(levels, x, "t", 0)


def apply_left_inv(levels, x):
    """W^-1 @ x (the exact elementwise inverse)."""
    return apply_axis(levels, x, "inv", 0)


def apply_right(levels, a):
    """a @ W: the column side of the two-sided transform."""
    # a @ W == (W^T a^T)^T: the "t" combine along axis 1, same level order.
    return apply_axis(levels, a, "t", 1)


def transform(a, u_levels, v_levels):
    """A~ = U^T A V (two independent butterflies, O(d n^2) elementwise)."""
    return apply_right(v_levels, apply_left_t(u_levels, a))


def untransform(at, u_levels, v_levels):
    """A = U^-T A~ V^-1, the exact inverse of :func:`transform`."""
    left = apply_axis(u_levels, at, "invt", 0)      # U^-T A~
    return apply_axis(v_levels, left, "invt", 1)    # ... V^-1
