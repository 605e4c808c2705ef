"""Condition estimation: the Hager/Higham 1-norm estimator, gecondest and
trcondest (port of slate_tpu/drivers/condest.py; ref: src/gecondest.cc,
src/trcondest.cc, src/internal/internal_norm1est.cc, LAPACK xLACN2).

The reference's ``lax.while_loop`` is a Python loop here, with the same
start vector, the same ``itmax`` and the same stop test; each iteration
reads its stop flag (and the non-finite flag) from the device once.

Failure contract: a singular factor poisons the appliers (NaN/Inf flow
through the triangular solves).  The loop carries an explicit ``bad`` flag
checked on every applier output and freezes once it is set; gecondest and
trcondest resolve a poisoned estimate to ``rcond = 0``, never NaN, and
report ``nonfinite=True`` through HealthInfo under ``ErrorPolicy.Info``.
"""

from __future__ import annotations

import math

import torch

from ..core.matrix import TriangularMatrix
from ..exceptions import slate_error
from ..internal.qr import phase_of
from ..options import ErrorPolicy, Options
from ..robust import health as _health
from ..types import Diag, Norm, Uplo
from ..util.trace import annotate


def _norm1est_flag(apply_inv, apply_inv_h, n: int, dtype, device,
                   itmax: int = 5):
    """Guarded Hager/Higham iteration on vectors of ``device``: returns
    ``(est, bad, iters)``, the estimate as a float, ``bad`` True when an
    applier produced a non-finite value, and the loop's iteration count.
    Once bad, the state freezes and the loop exits."""
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    est_old, jprev, k, done, bad = 0.0, -1, 0, False, False
    while k < itmax and not done:
        y = apply_inv(x)
        z = apply_inv_h(phase_of(y))
        az = z.abs()
        j_t = torch.argmax(az)
        y_ok, z_ok, est, j, zj, ztx = torch.stack([
            torch.isfinite(y.abs()).all().double(),
            torch.isfinite(az).all().double(), y.abs().sum().double(),
            j_t.double(), az[j_t].double(),
            torch.real(torch.vdot(z, x)).double()]).tolist()
        j = int(j)
        newly_bad = not (y_ok and z_ok)
        # convergence: repeated index or no growth in the dual norm
        stop = (zj <= ztx) or (j == jprev) or (est <= est_old)
        if not newly_bad:
            x = torch.zeros((n,), dtype=dtype, device=device)
            x[j] = 1
            est_old = max(est, est_old)
            jprev = j
        k += 1
        done = stop or newly_bad
        bad = bad or newly_bad

    # the alternating-magnitude safeguard vector (xLACN2's final stage)
    i = torch.arange(n, dtype=torch.float64, device=device)
    v = ((1.0 - 2.0 * (i % 2)) * (1.0 + i / max(n - 1, 1))).to(dtype)
    est2 = float(2.0 * apply_inv(v).abs().sum() / (3.0 * n))
    bad = bad or not math.isfinite(est2)
    est = max(est_old, est2 if math.isfinite(est2) else 0.0)
    return est, bad, k


def norm1est(apply_inv, apply_inv_h, n: int, dtype, itmax: int = 5,
             device=None):
    """Estimate ||A^-1||_1 from the appliers y = A^-1 x and z = A^-H x
    (Hager/Higham, ref internal_norm1est.cc, LAPACK xLACN2), whose vectors
    lie on ``device`` (``None`` means CUDA, as for every entry point).
    Returns ``+inf`` (not NaN) when an applier produces non-finite
    values: the factor is singular as far as the estimate is
    concerned."""
    from ..core.storage import resolve_device
    est, bad, _ = _norm1est_flag(apply_inv, apply_inv_h, n, dtype,
                                 resolve_device(device), itmax)
    return math.inf if bad else est


def _condest_result(rcond: float, bad: bool, opts):
    """rcond = 0 IS the failure resolution (never a raise, never NaN, as
    LAPACK's xxCON returns rcond = 0 for a singular factor); Info also
    returns the HealthInfo with ``nonfinite`` set."""
    if _health.error_policy(opts) is ErrorPolicy.Info:
        return rcond, _health.healthy()._replace(nonfinite=bad,
                                                 converged=not bad)
    return rcond


def _rcond(anorm, ainv: float, bad: bool):
    an = float(anorm)
    bad = bad or not math.isfinite(an)
    safe = an > 0 and ainv > 0 and not bad
    return (1.0 / (an * ainv) if safe else 0.0), bad


@annotate("slate.gecondest")
def gecondest(F, anorm, opts: Options | None = None, norm: Norm = Norm.One):
    """Reciprocal condition estimate from LU factors (ref:
    src/gecondest.cc): rcond = 1 / (||A|| est(||A^-1||)), a float.

    ``F`` is an LUFactors; ``anorm`` the 1-norm (or Inf-norm) of the
    original A.  A singular or non-finite factor returns ``rcond = 0``;
    under ``ErrorPolicy.Info``, ``(rcond, HealthInfo)`` with
    ``nonfinite=True`` flagging the poisoned estimate."""
    slate_error(norm in (Norm.One, Norm.Inf), "gecondest: One or Inf norm")
    lu = F.LU.to_dense()
    n = lu.shape[0]
    perm = F.perm

    def apply_inv(x):
        # A^-1 x = U^-1 L^-1 (P x)
        y = torch.linalg.solve_triangular(lu, x[perm][:, None], upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(lu, y, upper=True)[:, 0]

    def apply_inv_h(x):
        # A^-H x = P^H L^-H U^-H x
        luh = lu.mH
        y = torch.linalg.solve_triangular(luh, x[:, None], upper=False)
        y = torch.linalg.solve_triangular(luh, y, upper=True,
                                          unitriangular=True)[:, 0]
        return torch.zeros_like(y).index_copy_(0, perm, y)

    if norm is Norm.Inf:
        # ||A^-1||_inf = ||A^-H||_1: swap the appliers
        apply_inv, apply_inv_h = apply_inv_h, apply_inv
    ainv, bad, _ = _norm1est_flag(apply_inv, apply_inv_h, n, lu.dtype,
                                  lu.device)
    rcond, bad = _rcond(anorm, ainv, bad)
    return _condest_result(rcond, bad, opts)


@annotate("slate.trcondest")
def trcondest(R, opts: Options | None = None, norm: Norm = Norm.One):
    """Reciprocal condition estimate of a triangular matrix (ref:
    src/trcondest.cc): rcond = 1 / (||R|| est(||R^-1||)), a float.  A
    singular or non-finite R returns ``rcond = 0``; under
    ``ErrorPolicy.Info``, ``(rcond, HealthInfo)``."""
    slate_error(isinstance(R, TriangularMatrix), "trcondest: triangular")
    slate_error(norm in (Norm.One, Norm.Inf), "trcondest: One or Inf norm")
    rd = R.to_dense()
    n = rd.shape[0]
    lower = R.uplo is Uplo.Lower
    unit = R.diag is Diag.Unit

    def apply_inv(x):
        return torch.linalg.solve_triangular(
            rd, x[:, None], upper=not lower, unitriangular=unit)[:, 0]

    def apply_inv_h(x):
        return torch.linalg.solve_triangular(
            rd.mH, x[:, None], upper=lower, unitriangular=unit)[:, 0]

    a1, a2 = (apply_inv, apply_inv_h) if norm is Norm.One else (
        apply_inv_h, apply_inv)
    rinv, bad, _ = _norm1est_flag(a1, a2, n, rd.dtype, rd.device)
    ard = rd.abs()
    rnorm = ard.sum(dim=0).max() if norm is Norm.One \
        else ard.sum(dim=1).max()
    rcond, bad = _rcond(rnorm, rinv, bad)
    return _condest_result(rcond, bad, opts)
