"""A-posteriori certificates of speculative solves (port of the solve,
least-squares and Aasen parts of slate_tpu/robust/certify.py).

A fast attempt (the bf16 serving rung, gels' certified CholQR) produces a
finite-looking answer with nothing in its factor to flag a wrong one; a
residual check against the ORIGINAL operands closes that gap.  Each
certificate is a :class:`~slate_tpu_torch.robust.health.BatchHealth`,
batched over a leading axis of problems, with the reference's mapping:

- ``converged``        False when the residual ratio exceeds the tolerance
- ``growth``           the residual ratio
- ``min_pivot_index``  0-based column of the worst residual column
- ``nonfinite``        any NaN/Inf in X

``min_pivot`` stays +inf, so merging a certificate into a factor's health
keeps the factor's pivot record.  :func:`certify_ldlt` certifies one Aasen
factorization the same way, as a HealthInfo.  ``certify_eig`` and
``certify_svd`` come with the spectral slice.
"""

from __future__ import annotations

import torch

from ..types import eps
from . import health as _health


def tolerance(dtype, n: int, factor: float = 50.0) -> float:
    """``factor * n * eps`` of the real dtype (a torch dtype or a name):
    clean residual ratios sit near 0.5 n eps, so 50 n eps accepts every
    healthy route with a wide margin."""
    if not isinstance(dtype, torch.dtype):
        from .precision import torch_dtype
        dtype = torch_dtype(dtype)
    return float(factor * max(int(n), 1) * eps(dtype))


def _fro(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of each problem of a [B, m, n] stack."""
    ax = x.abs()
    return torch.sqrt((ax * ax).sum(dim=(-2, -1)))


def _certificate(ratio, worst, x, tol, iters) -> _health.BatchHealth:
    finite = torch.isfinite(x).flatten(1).all(dim=1)
    return _health.batch_healthy(x.shape[0], x.device)._replace(
        nonfinite=~finite, min_pivot_index=worst, growth=ratio.double(),
        iters=torch.full_like(worst, iters),
        converged=finite & (ratio <= tol))


def certify_solve(anorm, x, b, r, *, tol: float | None = None,
                  iters: int = 0) -> _health.BatchHealth:
    """Certificates of linear solves A X = B from their residuals r = B -
    A X, all [B, n, k]: the ratio ||r||_F / (||A||_F ||X||_F + ||B||_F)
    against :func:`tolerance` at n = X's rows.  ``anorm`` [B] holds
    ||A||_F; ``iters`` records refinement steps."""
    if tol is None:
        tol = tolerance(x.dtype, x.shape[-2])
    col = (r.abs() ** 2).sum(dim=-2)
    worst = torch.argmax(col, dim=-1)
    denom = anorm * _fro(x) + _fro(b)
    tiny = torch.finfo(col.dtype).tiny
    ratio = _fro(r) / torch.clamp(denom, min=tiny)
    return _certificate(ratio, worst, x, tol, iters)


def certify_lstsq(anorm, x, b, rn, *,
                  tol: float | None = None) -> _health.BatchHealth:
    """Certificates of least-squares solves min ||A X - B|| from their
    normal-equations residuals rn = A^H (B - A X): the ratio ||rn||_F /
    (||A||_F^2 ||X||_F + ||A||_F ||B||_F) against :func:`tolerance` at
    max(m, n).  X [B, n, k], B [B, m, k], rn [B, n, k], ``anorm`` [B]."""
    if tol is None:
        tol = tolerance(x.dtype, max(x.shape[-2], b.shape[-2]))
    col = (rn.abs() ** 2).sum(dim=-2)
    worst = torch.argmax(col, dim=-1)
    denom = anorm * anorm * _fro(x) + anorm * _fro(b)
    tiny = torch.finfo(col.dtype).tiny
    ratio = _fro(rn) / torch.clamp(denom, min=tiny)
    return _certificate(ratio, worst, x, tol, 0)


def certify_ldlt(a, L, T, piv, *, tol: float | None = None
                 ) -> _health.HealthInfo:
    """Certificate of the blocked Aasen factorization P A P^H = L T L^H
    (ref: certify.py:194): the relative residual ||A[piv][:, piv] -
    L T L^H||_F / ||A||_F against :func:`tolerance`, read from the device
    in one copy.  ``a`` dense Hermitian [n, n], ``L`` unit lower, ``T``
    the assembled band (``HEFactors.T_dense()``), ``piv`` the symmetric
    permutation."""
    n = a.shape[0]
    if tol is None:
        tol = tolerance(a.dtype, n)
    R = a[piv][:, piv] - L @ T @ L.mH
    col = (R.abs() * R.abs()).sum(dim=0)
    tiny = torch.finfo(col.dtype).tiny
    resid = _fro(R) / torch.clamp(_fro(a), min=tiny)
    finite = torch.isfinite(L.abs()).all() & torch.isfinite(T.abs()).all()
    worst, ratio, fin = torch.stack([torch.argmax(col).double(),
                                     resid.double(),
                                     finite.double()]).tolist()
    return _health.healthy()._replace(
        nonfinite=not fin, min_pivot_index=int(worst), growth=ratio,
        converged=bool(fin) and ratio <= tol)
