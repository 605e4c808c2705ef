"""Cholesky solvers: potrf, potrs, posv (port of the single-device path
of slate_tpu/drivers/cholesky.py).

potrf is a blocked left-looking factorisation of the dense matrix: for
each block column, the rank-k update from the columns already factored,
the diagonal-tile factor and the panel solve.  Under the default plan an
f32 panel runs as one fused kernel step (K2); otherwise the update is a
matmul, the tile goes through potrf_tile (K1 for f32) and the panel is
multiplied by the inverted diagonal block.  f64 and complex go through
``torch.linalg.cholesky_ex``, as the reference sends them to XLA.
"""

from __future__ import annotations

import math

import torch

from ..core.matrix import (BaseTrapezoidMatrix, HermitianMatrix, Matrix,
                           SymmetricMatrix, TriangularMatrix)
from ..core.storage import TileStorage
from ..exceptions import SlateNotPositiveDefiniteError, not_ported, \
    slate_error
from ..internal.potrf import potrf_panel_fused, potrf_panel_ok, potrf_tile
from ..internal.trsm import tri_inv_lower
from ..options import (Option, Options, get_option, resolve_abft,
                       resolve_target)
from ..robust import health as _health
from ..types import Uplo
from .blas3 import trsm


def _potrf_dense_blocked(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Blocked left-looking Cholesky, lower, of the dense ``a``, which it
    factors IN PLACE and returns (the reference builds a new array per
    step with ``.at[].set``; here each factored block column is written
    back into ``a``).  The strictly upper part of each diagonal tile is
    zeroed; the rest of the upper triangle keeps the input."""
    n = a.shape[0]
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        fused = potrf_panel_ok(a.dtype, n - k0, w, nb)
        left = a[k0:, :k0]
        lead = a[k0:k1, :k0].conj().T
        if fused:
            upd, fac = potrf_panel_fused(a[k0:, k0:k1], left, lead)
            lkk, panel = fac[:w], fac[w:]
        else:
            upd = a[k0:, k0:k1] - left @ lead if k0 else a[k0:, k0:k1]
            lkk = potrf_tile(upd[:w])
            panel = (upd[w:] @ tri_inv_lower(lkk).conj().T if k1 < n
                     else None)
        a[k0:k1, k0:k1] = lkk
        if k1 < n:
            a[k1:, k0:k1] = panel
    return a


def potrf(A, opts: Options | None = None):
    """Factor A = L L^H (Lower) or A = U^H U (Upper); returns the
    triangular factor (ref: src/potrf.cc).

    Failure contract (Option.ErrorPolicy): Raise raises
    :class:`SlateNotPositiveDefiniteError` when a leading minor is not
    positive definite (a NaN/zero L diagonal); Info returns
    ``(L, HealthInfo)`` with the LAPACK-style 1-based index of the first
    bad diagonal; Nan NaN-fills the factor."""
    slate_error(isinstance(A, (HermitianMatrix, SymmetricMatrix)),
                "potrf: need HermitianMatrix/SymmetricMatrix")
    uplo = A._uplo_logical()
    resolve_target(opts, A)
    resolve_abft(opts)
    nb = A.nb
    # to_dense expands the stored triangle into a new tensor, which the
    # blocked loop may then factor in place
    lfac = _potrf_dense_blocked(A.to_dense(), nb)
    st_out = TileStorage.from_dense(lfac, nb, nb, A.grid)
    L = TriangularMatrix._from_view(Matrix(st_out), Uplo.Lower)
    d = torch.diagonal(lfac).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    minidx = int(torch.argmin(d))
    h = _chol_health(torch.tril(lfac), float(d[minidx]), minidx)
    return _finalize_potrf(L, h, uplo, opts)


def _chol_health(lower: torch.Tensor, minpiv: float,
                 minidx: int) -> _health.HealthInfo:
    """HealthInfo for a Cholesky factor: diagonal record + finiteness of
    the written triangle.  Growth stays 1.0: unpivoted Cholesky of an HPD
    matrix cannot grow."""
    bad = minpiv == 0 or not math.isfinite(minpiv)
    return _health.healthy()._replace(
        nonfinite=not bool(torch.isfinite(lower).all()),
        info=minidx + 1 if bad else 0,
        min_pivot=minpiv,
        min_pivot_index=minidx)


def _finalize_potrf(L, h, uplo, opts):
    Lv = L.conj_transpose() if uplo is Uplo.Upper else L
    return _health.finalize(
        "potrf", Lv, h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"potrf: leading minor not positive definite "
            f"({hh.describe()})", info=hh.info))


def potrs(L: TriangularMatrix, B, opts: Options | None = None) -> Matrix:
    """Solve with the Cholesky factor: two triangular sweeps
    (ref: src/potrs.cc)."""
    slate_error(isinstance(L, BaseTrapezoidMatrix), "potrs: need factor")
    if L._uplo_logical() is Uplo.Lower:
        Y = trsm("l", 1.0, L, B, opts)
        return trsm("l", 1.0, L.conj_transpose(), Y, opts)
    Y = trsm("l", 1.0, L.conj_transpose(), B, opts)
    return trsm("l", 1.0, L, Y, opts)


def posv(A, B, opts: Options | None = None):
    """Solve A X = B for Hermitian positive definite A (ref: src/posv.cc).
    Returns (L, X), or (L, X, HealthInfo) under ErrorPolicy.Info; see
    robust/recovery.py for the retry ladder."""
    if get_option(opts, Option.HoldLocalWorkspace):
        raise not_ported("Option.HoldLocalWorkspace (factor and solve as "
                         "one captured program)",
                         "queue 1, item 9 (CUDA-graph capture)")
    from ..robust.recovery import posv_with_recovery
    return posv_with_recovery(A, B, opts)
