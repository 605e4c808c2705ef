"""Mixed-precision solvers: low-precision factor + working-precision
refinement (port of slate_tpu/drivers/mixed.py; ref: src/gesv_mixed.cc,
src/gesv_mixed_gmres.cc:24-117, src/posv_mixed.cc,
src/posv_mixed_gmres.cc).

Each driver factors once in ``types.lower_precision`` (f64 -> f32, c128 ->
c64; an f32 system, whose factor would be bf16, raises
SlateUnsupportedDtypeError), on the port's f32 drivers for an f64 system:
posv's Cholesky through K2 (with K1's loop) and K0, gesv's LU on the
library's pivoted panels, or, under ``Option.Speculate``, the
RBT-preconditioned NoPiv LU through K3.  A is cast to the low precision
once; each iteration casts only the n x nrhs residual.  The refinement
runs in the working precision: plain iterative refinement or restarted
GMRES-IR, up to ``Option.MaxIterations`` (30), with the reference's
per-column stop test
||r_j||_max <= ||x_j||_max ||A||_inf eps sqrt(n) (``Option.Tolerance``
replaces eps sqrt(n)).  ``Option.UseFallbackSolver`` re-solves in the
working precision through ``bounded_retry`` when the loop does not
converge.

The reference's ``lax.while_loop``s are Python loops: the stop flag is
read from the device once per refinement step, or once per GMRES restart
cycle (GMRES tests convergence at the start of a cycle, as the reference
does, so a converged x costs one more cycle).  ``STOP_READS`` counts those
reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.matrix import HermitianMatrix, Matrix
from ..core.storage import TileStorage
from ..exceptions import SlateUnsupportedDtypeError
from ..options import (ErrorPolicy, Option, Options, get_option,
                       resolve_speculate)
from ..robust import health as _health
from ..robust.health import HealthInfo
from ..robust.recovery import bounded_retry
from ..types import Norm, eps, lower_precision
from ..util.trace import annotate
from . import auxiliary as aux
from .blas3 import gemm
from .cholesky import potrf, potrs
from .lu import getrf, getrs

#: host reads of a refinement stop flag since the last reset (instrumentation
#: read by the chip smoke; nothing in the package reads it)
STOP_READS = 0


def _stop(flag: torch.Tensor) -> bool:
    """Read one stop flag from the device."""
    global STOP_READS
    STOP_READS += 1
    return bool(flag)


class MixedResult(NamedTuple):
    """Mixed-precision solve result.  ``converged`` is the contract: a
    mixed driver never raises on mere non-convergence; ``health`` carries
    the HealthInfo of whichever attempt produced X."""
    X: Matrix
    iters: int
    converged: bool
    health: HealthInfo | None = None


def _info_opts(opts: Options | None) -> dict:
    """Internal factor calls run under ErrorPolicy.Info: the low-precision
    factor is expected to fail on hard inputs, so its health is data."""
    o = dict(opts or {})
    o[Option.ErrorPolicy] = ErrorPolicy.Info
    return o


def _cast_matrix(M, dt) -> Matrix:
    return Matrix(M.storage.astype(dt), M.io, M.jo, M._mt, M._nt, M.op)


def _residual(A, X: Matrix, B, opts) -> Matrix:
    """R = B - A X through the gemm driver."""
    return gemm(-1.0, A, X, 1.0, _cast_matrix(B, X.dtype), opts)


def _tolerance(A, opts) -> float:
    t = get_option(opts, Option.Tolerance)
    return t if t is not None else eps(A.dtype) * math.sqrt(A.m)


def _refine(A, B, solve_lo, opts: Options | None):
    """Iterative refinement (ref: gesv_mixed.cc body): ``(x, iters,
    converged)``."""
    itermax = get_option(opts, Option.MaxIterations)
    anorm = aux.norm(Norm.Inf, A)
    tol = _tolerance(A, opts)

    def is_conv(x, r):
        # per-column test (ref: gesv_mixed.cc:188-193 colNorms(Max))
        return _stop((aux.col_norms(r)
                      <= aux.col_norms(x) * anorm * tol).all())

    x = solve_lo(B)
    r = _residual(A, x, B, opts)
    conv = is_conv(x, r)
    it = 0
    while not conv and it < itermax:
        x = aux.add(1.0, solve_lo(r), 1.0, x)
        r = _residual(A, x, B, opts)
        it += 1
        conv = is_conv(x, r)
    return x, it, conv


def _mixed_health(fh, x, it, ok) -> HealthInfo:
    """Health of a refinement attempt: the low-precision factor's record
    and the final x's finiteness; ``converged`` is the loop's verdict."""
    h = _health.merge(fh, _health.from_result(x.storage.data))
    return h._replace(iters=int(it), converged=bool(ok))


def _full_lu_attempt(A, B, opts):
    """Working-precision fallback (ref: gesv_mixed_gmres.cc:58-77)."""
    F, fh = getrf(A, _info_opts(opts))
    X = getrs(F, B, opts)
    return X, _health.merge(fh, _health.from_result(X.storage.data))


def _full_chol_attempt(A, B, opts):
    L, fh = potrf(A, _info_opts(opts))
    X = potrs(L, B, opts)
    return X, _health.merge(fh, _health.from_result(X.storage.data))


def _finish_mixed(x, it, h, fallback, opts):
    """The optional working-precision fallback through bounded_retry."""
    fallbacks = ([fallback] if get_option(opts, Option.UseFallbackSolver)
                 else [])
    x, h, _ = bounded_retry((x, h), fallbacks, dtype=x.dtype, max_retries=1)
    return MixedResult(x, it, h.ok, h)


def _low(A) -> torch.dtype:
    """The factor precision of A's system.  An f32 system would factor in
    bf16, which the reference's own factorizations refuse on the CPU
    (XLA: unsupported dtype) and torch's Cholesky and LU take on neither
    device; the port raises rather than factor in f32 instead."""
    lo = lower_precision(A.dtype)
    if lo == torch.bfloat16:
        raise SlateUnsupportedDtypeError(
            f"mixed-precision solvers: a {A.dtype} system factors in "
            f"bfloat16, which has no Cholesky or LU here; use an f64 "
            f"system or the f32 drivers", dtype="bfloat16")
    return lo


def _lu_solver(A, opts, rbt: bool = False):
    """The low-precision LU of A (the RBT NoPiv factor when ``rbt``) and
    its solve in A's precision."""
    lo = _low(A)
    Alo = _cast_matrix(A, lo)
    if rbt:
        from .lu import getrf_rbt
        F, fh = getrf_rbt(Alo, _info_opts(opts))
    else:
        F, fh = getrf(Alo, _info_opts(opts))
    del Alo

    def solve_lo(R):
        return _cast_matrix(getrs(F, _cast_matrix(R, lo), opts), A.dtype)
    return solve_lo, fh


def _chol_solver(A, opts):
    """The low-precision Cholesky of A and its solve in A's precision."""
    lo = _low(A)
    Alo = HermitianMatrix._from_view(_cast_matrix(A, lo), A.uplo)
    L, fh = potrf(Alo, _info_opts(opts))
    del Alo

    def solve_lo(R):
        return _cast_matrix(potrs(L, _cast_matrix(R, lo), opts), A.dtype)
    return solve_lo, fh


@annotate("slate.gesv_mixed")
def gesv_mixed(A: Matrix, B, opts: Options | None = None) -> MixedResult:
    """LU in low precision + IR to working precision (ref:
    src/gesv_mixed.cc).  The low factor is getrf's partial pivoting, as
    the reference's; ``Option.Speculate = On`` swaps in the
    RBT-preconditioned NoPiv factor (lu.getrf_rbt): the loop certifies the
    solve against the working-precision A, so a bad NoPiv factor reads as
    non-convergence and the fallback engages."""
    solve_lo, fh = _lu_solver(A, opts, rbt=resolve_speculate(opts))
    x, it, ok = _refine(A, B, solve_lo, opts)
    return _finish_mixed(x, it, _mixed_health(fh, x, it, ok),
                         lambda: _full_lu_attempt(A, B, opts), opts)


@annotate("slate.posv_mixed")
def posv_mixed(A: HermitianMatrix, B, opts: Options | None = None
               ) -> MixedResult:
    """Cholesky in low precision + IR (ref: src/posv_mixed.cc)."""
    solve_lo, fh = _chol_solver(A, opts)
    x, it, ok = _refine(A, B, solve_lo, opts)
    return _finish_mixed(x, it, _mixed_health(fh, x, it, ok),
                         lambda: _full_chol_attempt(A, B, opts), opts)


# ---------------------------------------------------------------- GMRES-IR

def _gmres_ir(A, B: Matrix, solve_lo, opts: Options | None,
              restart: int = 10):
    """Blocked right-preconditioned restarted GMRES in working precision
    (ref: src/gesv_mixed_gmres.cc:24-117; restart depth 10, itermax 30).
    Every column keeps its own Krylov basis and Hessenberg, advanced in
    lockstep; each matvec is the gemm driver and each preconditioner
    application the low-precision solve."""
    itermax = get_option(opts, Option.MaxIterations)
    n = A.m
    dt = A.dtype
    anorm = aux.norm(Norm.Inf, A)
    tol = _tolerance(A, opts)
    bd = B.to_dense()                         # skinny [n, nrhs]
    nrhs = bd.shape[1]
    dev = bd.device

    def as_matrix(z):
        return Matrix(TileStorage.from_dense(z, A.nb, B.nb, A.grid))

    def mat_vec(z):
        return gemm(1.0, A, as_matrix(z), 0.0, None, opts).to_dense()

    def prec(z):
        return solve_lo(as_matrix(z)).to_dense()

    def arnoldi(x):
        """One restart cycle for every column at once."""
        r = bd - mat_vec(x)
        beta = torch.linalg.vector_norm(r, dim=0)            # [nrhs]
        conv = (r.abs().amax(dim=0)
                <= x.abs().amax(dim=0) * anorm * tol + 1e-300)
        safe_beta = torch.where(beta > 0, beta, torch.ones_like(beta))
        V = torch.zeros((restart + 1, n, nrhs), dtype=dt, device=dev)
        V[0] = r / safe_beta
        H = torch.zeros((restart + 1, restart, nrhs), dtype=dt, device=dev)
        for i in range(restart):
            w = mat_vec(prec(V[i]))
            # modified Gram-Schmidt against the stored vectors (the rows
            # past i are zero, so the reference's coefficients there are 0)
            for t in range(i + 1):
                h = (V[t].conj() * w).sum(dim=0)             # [nrhs]
                H[t, i] = h
                w = w - V[t] * h[None, :]
            hn = torch.linalg.vector_norm(w, dim=0)
            H[i + 1, i] = hn.to(dt)
            # happy breakdown (hn == 0): a zero basis vector, not NaN
            ok = hn[None, :] > 0
            V[i + 1] = torch.where(ok, w / torch.where(ok, hn, 1), 0)

        # per-column least squares min_y ||beta e1 - H_j y|| by a batched
        # QR of the (restart+1) x restart Hessenberg
        Hc = H.permute(2, 0, 1)                              # [nrhs, m+1, m]
        rhs = torch.zeros((nrhs, restart + 1), dtype=dt, device=dev)
        rhs[:, 0] = beta.to(dt)
        Q, R = torch.linalg.qr(Hc)
        qb = torch.einsum("nij,ni->nj", Q.conj(), rhs)       # [nrhs, m]
        # guard a (near-)singular R with a relative threshold
        diag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
        floor = eps(dt) * diag.amax(dim=-1, keepdim=True)
        shift = torch.where(diag > floor, 0.0, 1.0).to(dt)
        R = R + shift[..., None] * torch.eye(restart, dtype=dt,
                                             device=dev)[None]
        y = torch.linalg.solve_triangular(R, qb[..., None],
                                          upper=True)[..., 0]
        vy = torch.einsum("inr,ir->nr", V[:restart], y.T)
        x_new = x + prec(vy)
        return torch.where(conv[None, :], x, x_new), conv

    x = torch.zeros_like(bd)
    it = 0
    conv = torch.zeros((nrhs,), dtype=torch.bool, device=dev)
    while not _stop(conv.all()) and it < itermax:
        x, conv = arnoldi(x)
        it += restart
    X = Matrix(TileStorage.from_dense(x, B.mb, B.nb, B.grid))
    return X, it, bool(conv.all())


@annotate("slate.gesv_mixed_gmres")
def gesv_mixed_gmres(A: Matrix, B, opts: Options | None = None
                     ) -> MixedResult:
    """ref: src/gesv_mixed_gmres.cc (partial pivoting; Speculate is not
    read here, as in the reference)"""
    solve_lo, fh = _lu_solver(A, opts)
    x, it, ok = _gmres_ir(A, B, solve_lo, opts)
    return _finish_mixed(x, it, _mixed_health(fh, x, it, ok),
                         lambda: _full_lu_attempt(A, B, opts), opts)


@annotate("slate.posv_mixed_gmres")
def posv_mixed_gmres(A: HermitianMatrix, B, opts: Options | None = None
                     ) -> MixedResult:
    """ref: src/posv_mixed_gmres.cc"""
    solve_lo, fh = _chol_solver(A, opts)
    x, it, ok = _gmres_ir(A, B, solve_lo, opts)
    return _finish_mixed(x, it, _mixed_health(fh, x, it, ok),
                         lambda: _full_chol_attempt(A, B, opts), opts)
