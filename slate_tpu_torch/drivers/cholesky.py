"""Cholesky solvers: potrf, potrs, posv (port of the single-device path
of slate_tpu/drivers/cholesky.py).

potrf is a blocked left-looking factorisation of the dense matrix: for
each block column, the rank-k update from the columns already factored,
the diagonal-tile factor and the panel solve.  Under the default plan an
f32 panel runs as one fused kernel step (K2); otherwise the update is a
matmul, the tile goes through potrf_tile (K1 for f32) and the panel is
multiplied by the inverted diagonal block.  f64 and complex go through
``torch.linalg.cholesky_ex``, as the reference sends them to XLA.
``Option.Abft`` adds the reference's three checksum rungs to every step,
and the fault sites ``input``, ``post_panel`` and ``solve`` sit where the
reference's do.
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
from ..robust import abft as _abft
from ..robust import faults
from ..robust import health as _health
from ..types import Uplo
from .blas3 import trsm


def _potrf_dense_blocked(a: torch.Tensor, nb: int, abft: bool = False):
    """Blocked left-looking Cholesky, lower, of the dense ``a``, which it
    factors IN PLACE (the reference builds a new array per step with
    ``.at[].set``; here each factored block column is written back into
    ``a``).  The strictly upper part of each diagonal tile is zeroed; the
    rest of the upper triangle keeps the input.

    ``abft`` verifies every step against Huang-Abraham checksums
    (robust/abft.py), in the reference's order: the pre-factor panel
    ``upd`` against checksums of ``a``'s block column read BEFORE the
    write-back, the diagonal tile through its Cholesky residual, the panel
    through the checksums of its right-hand side.  On the fused route the
    ``upd`` checked is the one K2 returned, so a fault in K2's update is
    caught as one in the library's product is; after ``sum_check`` repairs
    ``upd``, the tile and panel rungs see (and repair) the stale factored
    element, and K2 is not launched again.  Returns ``(a, AbftCounts)``,
    the counts on ``a``'s device (zero without ``abft``)."""
    n = a.shape[0]
    counts = _abft.zero_counts(a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        w = k1 - k0
        kt = k0 // nb
        fused = potrf_panel_ok(a.dtype, n - k0, w, nb)
        left = a[k0:, :k0]
        lead = a[k0:k1, :k0].conj().T
        if abft and k0:
            col = a[k0:, k0:k1]
            exp_r = col.sum(dim=1) - left @ lead.sum(dim=1)
            exp_c = col.sum(dim=0) - left.sum(dim=0) @ lead
        if fused:
            upd, fac = potrf_panel_fused(a[k0:, k0:k1], left, lead)
        else:
            upd = a[k0:, k0:k1] - left @ lead if k0 else a[k0:, k0:k1]
        if abft and k0:
            upd, ev = _abft.sum_check(upd, exp_r, exp_c, n_ctx=n, nb=nb,
                                      row0=k0, col0=k0)
            counts = _abft.add_counts(counts, ev)
        lkk = faults.maybe_corrupt(
            "post_panel", fac[:w] if fused else potrf_tile(upd[:w]))
        if abft:
            lkk, det, cor = _abft.chol_tile_check(upd[:w], lkk, n_ctx=n)
            counts = _abft.add_counts(
                counts, _abft.count_event(det, cor, kt, kt))
        if k1 < n:
            panel = (fac[w:] if fused          # the kernel's own solve
                     else upd[w:] @ tri_inv_lower(lkk).conj().T)
            if abft:
                # panel X solves X L^H = R; conjugate-transpose it into the
                # canonical left product L X^H = R^H, verified through R's
                # checksums
                xh, det, cor, _, pj = _abft.left_product_check(
                    lkk, panel.conj().T, upd[w:].sum(dim=0).conj(),
                    upd[w:].sum(dim=1).conj(), unit=False, n_ctx=n)
                panel = xh.conj().T
                counts = _abft.add_counts(
                    counts, _abft.count_event(det, cor, (k1 + pj) // nb, kt))
        # upd may be a view of this block column (k0 = 0, library route):
        # the panel is formed before the write-back
        a[k0:k1, k0:k1] = lkk
        if k1 < n:
            a[k1:, k0:k1] = panel
    return a, counts


def potrf(A, opts: Options | None = None):
    """Factor A = L L^H (Lower) or A = U^H U (Upper); returns the
    triangular factor (ref: src/potrf.cc).

    Failure contract (Option.ErrorPolicy): Raise raises
    :class:`SlateNotPositiveDefiniteError` when a leading minor is not
    positive definite (a NaN/zero L diagonal); Info returns
    ``(L, HealthInfo)`` with the LAPACK-style 1-based index of the first
    bad diagonal; Nan NaN-fills the factor.  ``Option.Abft`` checks every
    panel step (see :func:`_potrf_dense_blocked`) and folds its counts
    into the health, read with the rest of it in one copy."""
    slate_error(isinstance(A, (HermitianMatrix, SymmetricMatrix)),
                "potrf: need HermitianMatrix/SymmetricMatrix")
    uplo = A._uplo_logical()
    resolve_target(opts, A)
    abft = resolve_abft(opts)  # the one Option.Abft read (driver boundary)
    nb = A.nb
    # to_dense expands the stored triangle into a new tensor, which the
    # blocked loop may then factor in place (a struck copy, when armed)
    full = faults.maybe_corrupt("input", A.to_dense())
    lfac, counts = _potrf_dense_blocked(full, nb, abft=abft)
    st_out = TileStorage.from_dense(lfac, nb, nb, A.grid)
    L = TriangularMatrix._from_view(Matrix(st_out), Uplo.Lower)
    d = torch.diagonal(lfac).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    h = _chol_health(torch.tril(lfac), d.amin(), torch.argmin(d), counts)
    return _finalize_potrf(L, h, uplo, opts)


def _chol_health(lower: torch.Tensor, minpiv: torch.Tensor,
                 minidx: torch.Tensor,
                 counts: _abft.AbftCounts) -> _health.HealthInfo:
    """HealthInfo for a Cholesky factor: diagonal record, finiteness of the
    written triangle and the checksum counts, read from the device in one
    copy.  Growth stays 1.0: unpivoted Cholesky of an HPD matrix cannot
    grow."""
    mp, mi, finite, det, cor, site = torch.stack([
        minpiv.double(), minidx.double(),
        torch.isfinite(lower).all().double(), *(c.double()
                                                 for c in counts)]).tolist()
    bad = mp == 0 or not math.isfinite(mp)
    return _health.healthy()._replace(
        nonfinite=not finite,
        info=int(mi) + 1 if bad else 0,
        min_pivot=mp,
        min_pivot_index=int(mi),
        abft_detected=int(det), abft_corrected=int(cor),
        abft_site=int(site))


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
        X = trsm("l", 1.0, L.conj_transpose(), Y, opts)
    else:
        Y = trsm("l", 1.0, L.conj_transpose(), B, opts)
        X = trsm("l", 1.0, L, Y, opts)
    if faults.active("solve") is not None:
        sx = X.storage
        X = Matrix(TileStorage(faults.maybe_corrupt("solve", sx.data),
                               sx.m, sx.n, sx.mb, sx.nb, sx.grid))
    return X


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
