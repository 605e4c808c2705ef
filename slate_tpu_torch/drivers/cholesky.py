"""Cholesky solvers: potrf, potrs, posv, potri (port of
slate_tpu/drivers/cholesky.py).

On a mesh (the target mesh and a grid with a process group) potrf is the
distributed right-looking factorization of parallel/dist_chol.py, which
factors every diagonal tile through K1, and potrs and posv solve through
the distributed trsm.  On one device:

potrf is a blocked left-looking factorisation of the dense matrix: for
each block column, the rank-k update from the columns already factored,
the diagonal-tile factor and the panel solve.  Under the default plan an
f32 panel runs as one fused kernel step (K2); otherwise the update is a
matmul, the tile goes through potrf_tile (K1 for f32) and the panel is
multiplied by the inverted diagonal block.  f64 and complex go through
``torch.linalg.cholesky_ex``, as the reference sends them to XLA.
``Option.Abft`` adds the reference's three checksum rungs to every step,
and the fault sites ``input``, ``post_panel`` and ``solve`` sit where the
reference's do.  ``Option.HoldLocalWorkspace`` runs posv's Cholesky
attempt as one CUDA graph on the card (the reference's one jitted
factor+solve program): potrf's device work (:func:`_potrf_device`) is
split from its health read (:func:`_chol_health`) for it.

``potrf_ooc`` is the out-of-core factorization of a host matrix: a
``TileMap`` streams block-column panels through the device, with
checkpoints at panel-step boundaries and a bit-identical resume.
"""

from __future__ import annotations

import collections
import math
import threading

import torch

from ..core.matrix import (BaseTrapezoidMatrix, HermitianMatrix, Matrix,
                           SymmetricMatrix, TriangularMatrix)
from ..core.storage import TileStorage
from ..exceptions import SlateNotPositiveDefiniteError, slate_error
from ..internal.potrf import potrf_panel_fused, potrf_panel_ok, potrf_tile
from ..internal.trsm import tri_inv_lower
from ..obs import sentinel as _sentinel
from ..options import (ErrorPolicy, Option, Options, get_option, on_mesh,
                       options_fingerprint, resolve_abft, resolve_target)
from ..robust import abft as _abft
from ..robust import faults
from ..robust import health as _health
from ..types import Op, Uplo
from ..util.trace import annotate
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


@annotate("slate.potrf")
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
    mesh = on_mesh(opts, A)
    abft = resolve_abft(opts)  # the one Option.Abft read (driver boundary)
    if mesh:
        L, stats = _potrf_mesh(A, abft)
        return _finalize_potrf(L, _chol_health(stats), A._uplo_logical(),
                               opts)
    lfac, stats = _potrf_device(A, abft)
    return _finalize_potrf(_lower_factor(lfac, A), _chol_health(stats),
                           A._uplo_logical(), opts)


def _corrupt_storage(site: str, st: TileStorage) -> torch.Tensor:
    """``faults.maybe_corrupt`` of a storage's tiles: on a grid with a
    group the strike lands where the reference's lands in its global
    cyclic array (gathered, struck, this rank's block kept)."""
    if not st.sharded or faults.active(site) is None:
        return faults.maybe_corrupt(site, st.data)
    return st.local_block(faults.maybe_corrupt(site, st.cyclic()))


def _lower_finite(st: TileStorage) -> torch.Tensor:
    """1 when every element of the factor's lower triangle (the tiles the
    factorization writes) is finite, over the whole grid (0-d int)."""
    from ..comm.collectives import reduce_grid
    g = st.grid
    r, c = g.coords
    dev = st.data.device
    gi = (r + g.p * torch.arange(st.mtl, device=dev))[:, None, None, None]
    gj = (c + g.q * torch.arange(st.ntl, device=dev))[None, :, None, None]
    ii = torch.arange(st.nb, device=dev)
    low = ii[:, None] >= ii[None, :]
    keep = ((gi > gj) | ((gi == gj) & low)) & (gi < st.Mt) & (gj < st.Nt)
    bad = keep & ~torch.isfinite(st.data)
    return reduce_grid((~bad.any()).to(torch.int32), g, op="min")


def _potrf_mesh(A, abft: bool):
    """potrf's mesh route (ref: cholesky.py:138-163): the LOWER
    representation factored by dist_potrf.  dist_potrf reads only the
    lower triangle (the diagonal tiles are Hermitian-completed), so a
    lower-stored root view goes in zero-copy; any other view is densified
    (an all-gather on every rank) and re-tiled.  Returns the lower factor
    and its health statistics (:func:`_chol_stats`' layout), the same on
    every rank."""
    from ..parallel.dist_chol import dist_potrf
    nb = A.nb
    if (A.uplo is Uplo.Lower and A.op is Op.NoTrans and A.is_root_view()
            and A.storage.mb == nb):
        st_l = A.storage
    else:
        st_l = TileStorage.from_dense(A.to_dense(), nb, nb, A.grid)
    data_in = _corrupt_storage("input", st_l)
    out, minpiv, minidx, det, cor, site = dist_potrf(
        data_in, st_l.Nt, A.grid, n=st_l.n, abft=abft)
    st_out = TileStorage(out, st_l.m, st_l.n, nb, nb, A.grid)
    L = TriangularMatrix._from_view(Matrix(st_out), Uplo.Lower)
    stats = torch.stack([minpiv.double(), minidx.double(),
                         _lower_finite(st_out).double(), det.double(),
                         cor.double(), site.double()])
    return L, stats


def _potrf_device(A, abft: bool):
    """potrf's work on the device, with no host read: the dense lower
    factor and its health statistics (:func:`_chol_stats`)."""
    # to_dense expands the stored triangle into a new tensor, which the
    # blocked loop may then factor in place (a struck copy, when armed)
    full = faults.maybe_corrupt("input", A.to_dense())
    lfac, counts = _potrf_dense_blocked(full, A.nb, abft=abft)
    d = torch.diagonal(lfac).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return lfac, _chol_stats(torch.tril(lfac), d.amin(), torch.argmin(d),
                             counts)


def _lower_factor(lfac: torch.Tensor, A) -> TriangularMatrix:
    st_out = TileStorage.from_dense(lfac, A.nb, A.nb, A.grid)
    return TriangularMatrix._from_view(Matrix(st_out), Uplo.Lower)


def _chol_stats(lower: torch.Tensor, minpiv: torch.Tensor,
                minidx: torch.Tensor,
                counts: _abft.AbftCounts) -> torch.Tensor:
    """A Cholesky factor's health statistics as one f64 device tensor: the
    diagonal record, the finiteness of the written triangle and the
    checksum counts."""
    return torch.stack([minpiv.double(), minidx.double(),
                        torch.isfinite(lower).all().double(),
                        *(c.double() for c in counts)])


def _chol_health(stats: torch.Tensor) -> _health.HealthInfo:
    """HealthInfo for a Cholesky factor from :func:`_chol_stats`, read
    from the device in one copy.  Growth stays 1.0: unpivoted Cholesky of
    an HPD matrix cannot grow."""
    mp, mi, finite, det, cor, site = stats.tolist()
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


def _ooc_chol_health(lfac_host) -> _health.HealthInfo:
    """Cholesky health from host reductions: the out-of-core factor is not
    brought back to the device to be checked (it may not fit)."""
    import numpy as np
    d = np.abs(np.diagonal(lfac_host))
    d = np.where(np.isnan(d), 0.0, d)
    minidx = int(np.argmin(d)) if d.size else 0
    minpiv = float(d[minidx]) if d.size else math.inf
    bad = (minpiv == 0.0) or not math.isfinite(minpiv)
    return _health.healthy()._replace(
        nonfinite=not bool(np.all(np.isfinite(lfac_host))),
        info=minidx + 1 if bad else 0,
        min_pivot=minpiv, min_pivot_index=minidx)


@annotate("slate.potrf_ooc")
def potrf_ooc(a, nb: int | None = None, opts: Options | None = None,
              checkpoint=None, resume: bool = False, device=None):
    """Out-of-core Cholesky of a host-resident SPD matrix (lower; ref:
    drivers/cholesky.py:229).

    ``a`` is a dense host numpy array that need not fit device memory: a
    :class:`~slate_tpu_torch.core.storage.TileMap` on ``device`` (``None``
    means CUDA and raises without it) streams block-column panels through
    it, the next left panel's H2D copy issued on the side stream while the
    current update runs.  Each step accumulates the panel against every
    earlier block column (``ooc_chol_update``) and factors it
    (``ooc_chol_panel``: K1 for an f32 diagonal tile of width <= 1024).
    ``nb`` defaults to the tuned ``ooc_panel_width``.  Only the lower
    triangle of ``a`` is read.  Returns the lower factor as a host numpy
    array; Option.ErrorPolicy resolves failures as :func:`potrf` does.

    With a ``checkpoint`` :class:`~slate_tpu_torch.robust.checkpoint.
    CheckpointManager` the host tile map is snapshotted at panel-step
    boundaries at the manager's cadence; ``resume=True`` verifies the
    latest snapshot and continues from it, bit-identical to the
    uninterrupted run, or refuses with a typed ``SlateCheckpointError``.
    """
    import numpy as np
    from ..core.storage import TileMap
    from ..internal.potrf import ooc_chol_panel, ooc_chol_update
    from ..robust.checkpoint import ensure_fingerprint, ooc_fingerprint
    from ..tune.plans import ooc_panel_width

    if resume:
        slate_error(checkpoint is not None,
                    "potrf_ooc: resume=True needs a checkpoint manager")
        ck = checkpoint.load(op="potrf_ooc")
        n = ck.matrix.shape[0]
        nb = int(ck.meta["nb"])
        fp = ooc_fingerprint("potrf_ooc", n, n, nb, ck.meta["dtype"])
        ensure_fingerprint(ck, fp)
        tm = TileMap(ck.matrix, nb, nb, device=device)
        k_start = int(ck.step)
    else:
        ad = np.asarray(a)
        slate_error(ad.ndim == 2 and ad.shape[0] == ad.shape[1],
                    "potrf_ooc: square 2D host matrix")
        n = ad.shape[0]
        nb = int(nb) if nb else ooc_panel_width(n, ad.dtype.name)
        fp = ooc_fingerprint("potrf_ooc", n, n, nb, ad.dtype.name)
        tm = TileMap(ad, nb, nb, device=device)
        k_start = 0

    steps = list(range(0, n, nb))
    for si in range(k_start, len(steps)):
        k0 = steps[si]
        k1 = min(k0 + nb, n)
        w = k1 - k0
        if checkpoint is not None and checkpoint.should_save(si):
            checkpoint.save("potrf_ooc", si, tm.host_array(), nb, nb, fp)
        prev = steps[:si]
        if prev:
            tm.prefetch(k0, n, prev[0], prev[0] + nb)
        acc = tm.fetch(k0, n, k0, k1)
        for idx, j0 in enumerate(prev):
            left = tm.fetch(k0, n, j0, j0 + nb)
            if idx + 1 < len(prev):
                tm.prefetch(k0, n, prev[idx + 1], prev[idx + 1] + nb)
            # A[k0:k1, j0:j1] is the leading w rows of the left panel
            acc = ooc_chol_update(acc, left, left[:w])
        tm.store(k0, n, k0, k1, ooc_chol_panel(acc))
    lfac = np.tril(tm.host_array())
    return _health.finalize(
        "potrf_ooc", lfac, _ooc_chol_health(lfac), opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"potrf_ooc: leading minor not positive definite "
            f"({hh.describe()})", info=hh.info))


@annotate("slate.potrs")
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
        X = Matrix(TileStorage(_corrupt_storage("solve", sx), sx.m, sx.n,
                               sx.mb, sx.nb, sx.grid))
    return X


@annotate("slate.posv")
def posv(A, B, opts: Options | None = None):
    """Solve A X = B for Hermitian positive definite A (ref: src/posv.cc).
    Returns (L, X), or (L, X, HealthInfo) under ErrorPolicy.Info; see
    robust/recovery.py for the retry ladder.

    ``Option.HoldLocalWorkspace`` keeps the factor's workspace on the
    device between the phases, as the reference's one jitted factor+solve
    program does: on the card the f32 (or f64) Cholesky attempt, factor,
    both triangular solves and the statistics its health is built from,
    is captured once per (shape, tiling, dtype, options) as a CUDA graph
    and replayed; the host then reads the health and runs the ladder's
    rungs eagerly.  The results equal a plain posv's bit for bit.  On CPU
    tensors, on a grid with a process group (whose collectives stay out of
    a graph), and while a fault plan is armed at a device site, the body
    runs eagerly.  On a mesh the attempt is the distributed potrf and
    trsm."""
    from ..robust.recovery import posv_with_recovery
    if (get_option(opts, Option.HoldLocalWorkspace)
            and A.storage.data.device.type == "cuda"
            and A.grid.group is None
            and not faults.device_plans_active()):
        return posv_with_recovery(A, B, opts, chol_attempt=_held_attempt)
    return posv_with_recovery(A, B, opts)


@annotate("slate.potri")
def potri(L: TriangularMatrix, opts: Options | None = None):
    """Inverse from the Cholesky factor, A^-1 = L^-H L^-1 (ref:
    src/potri.cc = trtri + trtrm).  Returns a HermitianMatrix; under
    ``ErrorPolicy.Info``, ``(Ainv, HealthInfo)`` with the two stages'
    healths merged."""
    from .inverse import trtri, trtrm
    if _health.error_policy(opts) is ErrorPolicy.Info:
        Linv, h1 = trtri(L, opts)
        C, h2 = trtrm(Linv, opts)
        return C, _health.merge(h1, h2)
    return trtrm(trtri(L, opts), opts)


# Option.HoldLocalWorkspace: one captured Cholesky attempt per key, the
# few most recent kept (each graph holds its workspace on the device)
_HELD_MAX = 4
_HELD: collections.OrderedDict = collections.OrderedDict()
_HELD_LOCK = threading.Lock()


def _solve_factor(lfac: torch.Tensor, A):
    """The factor potrf returns for ``A``: L, or L^H for an upper A."""
    L = _lower_factor(lfac, A)
    return L.conj_transpose() if A._uplo_logical() is Uplo.Upper else L


class _HeldAttempt:
    """posv's Cholesky attempt (recovery._chol_attempt) captured over
    static copies of A's and B's tile data.  ``x_view`` is the solution's
    matrix as the capture built it (the replay's data goes under its
    view); the lock serializes the calls that share the static data."""

    def __init__(self, A, B, o):
        from ..internal.graphs import Captured
        sa, sb = A.storage.data.clone(), B.storage.data.clone()
        A2 = A._same_view(_same_tiling(A.storage, sa))
        B2 = B._same_view(_same_tiling(B.storage, sb))
        abft = resolve_abft(o)

        def attempt(a, b):
            lfac, stats = _potrf_device(A2, abft)
            X = potrs(_solve_factor(lfac, A2), B2, o)
            self.x_view = X
            return lfac, stats, X.storage.data, \
                torch.isfinite(X.storage.data).all()

        self.captured = Captured(attempt, (sa, sb))
        self.lock = threading.Lock()

    def __call__(self, a: torch.Tensor, b: torch.Tensor):
        """Replay on ``a`` and ``b`` (A's and B's tile data) and read the
        health on the host: ``(lfac, X data, HealthInfo)``."""
        with self.lock:
            lfac, stats, X, xfin = self.captured(a, b)
            h = _health.merge(_chol_health(stats), _health.healthy()._replace(
                nonfinite=not bool(xfin)))
        return lfac, X, h


def _same_tiling(st: TileStorage, data: torch.Tensor) -> TileStorage:
    return TileStorage(data, st.m, st.n, st.mb, st.nb, st.grid)


def _view_key(M) -> tuple:
    st = M.storage
    return (type(M).__name__, M.io, M.jo, M._mt, M._nt, M.op,
            getattr(M, "uplo", None), getattr(M, "diag", None), st.m, st.n,
            st.mb, st.nb, st.grid.p, st.grid.q, str(st.data.dtype),
            str(st.data.device))


def _held_attempt(A, B, opts):
    """recovery._chol_attempt through a captured graph: replay it on A's
    and B's data, then read the health on the host."""
    from ..robust.recovery import _with
    slate_error(isinstance(A, (HermitianMatrix, SymmetricMatrix)),
                "potrf: need HermitianMatrix/SymmetricMatrix")
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    resolve_target(o, A)
    key = (_view_key(A), _view_key(B), options_fingerprint(o))
    with _HELD_LOCK:
        held = _HELD.get(key)
        if held is not None:
            _HELD.move_to_end(key)
    if held is None:
        held = _HeldAttempt(A, B, o)
        _sentinel.record_trace("posv", repr(key[:2]))
        with _HELD_LOCK:
            held = _HELD.setdefault(key, held)
            while len(_HELD) > _HELD_MAX:
                _HELD.popitem(last=False)
    lfac, X, h = held(A.storage.data, B.storage.data)
    xv = held.x_view
    return ((_solve_factor(lfac, A),
             xv._same_view(_same_tiling(xv.storage, X))), h)

