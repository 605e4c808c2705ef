"""Deterministic test-matrix generator (port of slate_tpu/util/generator.py;
ref: test/matrix_generator.{hh,cc}, test/matrix_params.hh:17-77).

Named kinds with optional condition-number control, deterministic for a
seed whatever the tiling: the matrix is drawn in the global index space
on the host with numpy, by the reference's own ``_dense`` (copied here),
so one seed gives the same bits in both packages; the result is then
placed on the device (``device=None`` means CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.grid import Grid
from ..core.matrix import HermitianMatrix, Matrix
from ..exceptions import slate_error
from ..types import Uplo

KINDS = ("zeros", "ones", "identity", "jordan", "rand", "randn", "rands",
         "rand_dominant", "svd", "poev", "heev", "chebspec")


def _dense(kind: str, m: int, n: int, rng, dtype, cond: float):
    cplx = np.issubdtype(dtype, np.complexfloating)

    def rnd(shape, dist):
        if dist == "rand":
            x = rng.random(shape)
        elif dist == "rands":
            x = 2.0 * rng.random(shape) - 1.0
        else:
            x = rng.standard_normal(shape)
        if cplx:
            x = x + 1j * (rng.random(shape) if dist == "rand"
                          else rng.standard_normal(shape))
        return x.astype(dtype)

    if kind == "zeros":
        return np.zeros((m, n), dtype)
    if kind == "ones":
        return np.ones((m, n), dtype)
    if kind == "identity":
        return np.eye(m, n, dtype=dtype)
    if kind == "jordan":
        return (np.eye(m, n, dtype=dtype) +
                np.eye(m, n, k=1, dtype=dtype))
    if kind in ("rand", "randn", "rands"):
        return rnd((m, n), kind)
    if kind == "rand_dominant":
        a = rnd((m, n), "rand")
        k = min(m, n)
        a[np.arange(k), np.arange(k)] += max(m, n)
        return a
    if kind == "chebspec":
        # mild deterministic non-normal test matrix
        i = np.arange(m)[:, None]
        j = np.arange(n)[None, :]
        return np.cos(np.pi * (i * j) / max(m, n)).astype(dtype)
    if kind in ("svd", "poev", "heev"):
        k = min(m, n)
        # geometric singular/eigen-value distribution sigma_i = cond^{-i/(k-1)}
        # (ref: matrix_generator geometric sigma)
        c = cond or 1e3
        sigma = c ** (-np.arange(k) / max(k - 1, 1))
        q1, _ = np.linalg.qr(rnd((m, k), "randn"))
        if kind == "svd":
            q2, _ = np.linalg.qr(rnd((n, k), "randn"))
            return (q1 * sigma) @ q2.conj().T
        # the reference also draws and factors a q2 here that poev and heev
        # never read; nothing is drawn after it, so leaving it out keeps
        # the bits and halves the cost (two n x n QRs are most of it)
        if kind == "poev":                      # SPD/HPD with cond c
            return ((q1 * sigma) @ q1.conj().T).astype(dtype)
        lam = np.linspace(-1.0, 1.0, k) * sigma[::-1]
        return ((q1 * lam) @ q1.conj().T).astype(dtype)
    raise ValueError(f"unknown matrix kind {kind!r}")


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy or torch dtype spelling."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def generate_matrix(kind: str, m: int, n: int, mb: int, nb: int | None = None,
                    *, seed: int = 0, dtype=np.float64,
                    cond: float | None = None, grid: Grid | None = None,
                    device=None) -> Matrix:
    """Generate a general matrix of a named kind on ``device``."""
    slate_error(kind in KINDS, f"kind must be one of {KINDS}")
    rng = np.random.default_rng(seed)
    a = _dense(kind, m, n, rng, _np_dtype(dtype), cond or 0.0)
    return Matrix.from_numpy(a, mb, nb or mb, grid, device=device)


def generate_hermitian(kind: str, n: int, nb: int, *, seed: int = 0,
                       dtype=np.float64, cond: float | None = None,
                       grid: Grid | None = None, uplo: Uplo = Uplo.Lower,
                       device=None) -> HermitianMatrix:
    """Hermitian (or HPD for kind='poev') generator."""
    rng = np.random.default_rng(seed)
    a = _dense(kind if kind in ("poev", "heev") else "randn",
               n, n, rng, _np_dtype(dtype), cond or 0.0)
    if kind not in ("poev", "heev"):
        a = (a + a.conj().T) / 2
    return HermitianMatrix.from_numpy(a, nb, uplo, grid, device=device)
