"""A-posteriori certificates of speculative solves and spectral results
(port of slate_tpu/robust/certify.py).

A fast attempt (the bf16 serving rung, gels' certified CholQR) or a
spectral result (a corrupted bulge chase, a bad secular solve) produces a
finite-looking answer with nothing in its factor to flag a wrong one; a
residual check against the ORIGINAL operands closes that gap.  Each
certificate is a :class:`~slate_tpu_torch.robust.health.BatchHealth`,
batched over a leading axis of problems, with the reference's mapping:

- ``converged``        False when the residual ratio exceeds the tolerance
- ``growth``           the residual ratio
- ``min_pivot_index``  0-based column of the worst residual column
- ``nonfinite``        any NaN/Inf in X

``min_pivot`` stays +inf, so merging a certificate into a factor's health
keeps the factor's pivot record.  :func:`certify_eig` and
:func:`certify_svd` certify one eigen- or singular value decomposition
(the ratio being the worst of the residual and the orthogonality defects)
as a BatchHealth of one problem, on the device, with no host read.
:func:`certify_ldlt` certifies one Aasen factorization the same way, as a
HealthInfo.
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


def _one(ratio, worst, finite, converged) -> _health.BatchHealth:
    """A BatchHealth of one problem from 0-d device tensors."""
    return _health.batch_healthy(1, ratio.device)._replace(
        nonfinite=(~finite).reshape(1), min_pivot_index=worst.reshape(1),
        growth=ratio.double().reshape(1), converged=converged.reshape(1))


def certify_eig(a, w, v, *, tol: float | None = None) -> _health.BatchHealth:
    """Certificate of A = V diag(w) V^H (ref: certify.py:59): the relative
    residual ||A V - V diag(w)||_F / ||A||_F and the orthogonality defect
    ||V^H V - I||_F / sqrt(n), each against :func:`tolerance`; ``worst`` is
    the column of the largest residual.  ``a`` and ``v`` dense [n, n],
    ``w`` real [n].  Nothing reads the host."""
    n = a.shape[0]
    if tol is None:
        tol = tolerance(a.dtype, n)
    R = a @ v - v * w[None, :].to(v.dtype)
    col = (R.abs() * R.abs()).sum(dim=0)
    tiny = torch.finfo(col.dtype).tiny
    resid = _fro(R) / torch.clamp(_fro(a), min=tiny)
    gram = v.conj().T @ v - torch.eye(n, dtype=v.dtype, device=v.device)
    ortho = _fro(gram) / (float(max(n, 1)) ** 0.5)
    finite = torch.isfinite(v.abs()).all() & torch.isfinite(w).all()
    return _one(torch.maximum(resid, ortho), torch.argmax(col), finite,
                finite & (resid <= tol) & (ortho <= tol))


def certify_svd(a, s, u, v, *, tol: float | None = None
                ) -> _health.BatchHealth:
    """Certificate of A = U diag(s) V^H with thin factors, r = min(m, n)
    (ref: certify.py:94): the relative residual ||A - U diag(s) V^H||_F /
    ||A||_F and the left and right orthogonality defects, each against
    :func:`tolerance` at max(m, n).  Nothing reads the host."""
    m, n = a.shape
    r = min(m, n)
    if tol is None:
        tol = tolerance(a.dtype, max(m, n))
    ur, vr = u[:, :r], v[:, :r]
    R = a - (ur * s[None, :r].to(ur.dtype)) @ vr.conj().T
    col = (R.abs() * R.abs()).sum(dim=0)
    tiny = torch.finfo(col.dtype).tiny
    resid = _fro(R) / torch.clamp(_fro(a), min=tiny)
    rnorm = float(max(r, 1)) ** 0.5
    eye = torch.eye(r, dtype=ur.dtype, device=ur.device)
    ou = _fro(ur.conj().T @ ur - eye) / rnorm
    ov = _fro(vr.conj().T @ vr - eye) / rnorm
    finite = (torch.isfinite(u.abs()).all() & torch.isfinite(v.abs()).all()
              & torch.isfinite(s).all())
    return _one(torch.maximum(torch.maximum(resid, ou), ov),
                torch.argmax(col), finite,
                finite & (resid <= tol) & (ou <= tol) & (ov <= tol))


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
