"""Driver-level graceful degradation: escalate, fall back, retry, bounded
(port of the gesv, posv and gels parts of slate_tpu/robust/recovery.py).

Each solver factors and solves under ErrorPolicy.Info and resolves the
health at its boundary, where every option it reads is resolved once:
``Option.Speculate`` (:func:`resolve_speculate`), ``Option.Precision``
(:func:`precision.resolve_precision`) and ``Option.Abft``
(:func:`resolve_abft`).

- gesv escalates the pivoting on an unhealthy factor, NoPiv -> PartialPiv
  -> CALU, through :func:`bounded_retry` (``Option.UseFallbackSolver``).
  ``Option.Speculate = On`` runs the ladder forwards: the first attempt is
  the RBT-preconditioned NoPiv solve, refined in the original system and
  certified by its residual (:func:`_rbt_attempt`); the pivoted chain
  without NoPiv runs only when the certificate fails.
- posv: Cholesky first.  With Speculate and ``Option.Precision = bf16`` a
  rung BELOW it factors the bf16-rounded operand, refines in the original
  system and accepts only on the residual certificate
  (:func:`_chol_bf16_attempt`), the f32 Cholesky attempt its escalation.
  With ``Option.UseFallbackSolver`` (the default) the reference retries a
  non-HPD input as Hermitian-indefinite (hesv) and then as plain LU
  (gesv); hesv is not ported yet, so that rung raises
  ``NotImplementedError`` when it is reached (an HPD input never reaches
  it).
- gels (m >= n) takes CholQR or Householder QR per ``select_gels_method``;
  Speculate puts the certified CholQR2 rung first, and with
  ``Option.Precision = bf16`` the bf16 QR rung below it
  (:func:`_gels_bf16_attempt`); ``Option.UseFallbackSolver`` adds
  Householder QR as the last rung.
- ``Option.Abft``: the drivers repair a single struck element in place;
  an UNREPAIRED detection (``abft_detected > abft_corrected``, which fails
  ``HealthInfo.ok``) retries the SAME attempt once, before any method
  escalation -- a transient strike will not repeat.
"""

from __future__ import annotations

import torch

from ..exceptions import (SlateNotPositiveDefiniteError, SlateSingularError,
                          not_ported)
from ..options import (ErrorPolicy, MethodGels, MethodLU, Option, Options,
                       get_option, resolve_abft, resolve_speculate,
                       select_gels_method, select_lu_method)
from . import health as _h
from .precision import resolve_precision


def _with(opts: Options | None, **kv) -> dict:
    o = dict(opts or {})
    for name, v in kv.items():
        o[Option[name]] = v
    return o


def bounded_retry(first, fallbacks, *, dtype, max_retries: int = 2):
    """Run ``fallbacks`` (closures returning ``(result, HealthInfo)``) in
    order until a health passes :func:`health.acceptable`, trying at most
    ``max_retries`` of them; ``first`` is the primary attempt's
    ``(result, HealthInfo)``.  Returns ``(result, health, retries_used)``,
    with ``converged`` demoted when growth exceeds the dtype's limit."""
    result, h = first
    used = 0
    for fb in fallbacks:
        if _h.acceptable(h, dtype) or used >= max_retries:
            break
        result, h = fb()
        used += 1
    h = h._replace(converged=h.converged
                   and h.growth <= _h.growth_limit(dtype))
    return result, h, used


def _certify_solve(A, X, B, R, iters: int) -> _h.HealthInfo:
    """The residual certificate of one solve (certify.certify_solve on a
    batch of one): ||R||_F / (||A||_F ||X||_F + ||B||_F) against the
    dtype's tolerance."""
    from ..drivers import auxiliary as _aux
    from ..types import Norm
    from . import certify as _certify
    anorm = _aux.norm(Norm.Fro, A)
    return _certify.certify_solve(
        anorm[None], X.to_dense()[None], B.to_dense()[None],
        R.to_dense()[None], iters=iters).to_list()[0]


# ------------------------------------------------------------------ gesv

_LU_CHAIN = {
    MethodLU.NoPiv: (MethodLU.NoPiv, MethodLU.PartialPiv, MethodLU.CALU),
    MethodLU.PartialPiv: (MethodLU.PartialPiv, MethodLU.CALU),
    MethodLU.CALU: (MethodLU.CALU,),
}


def _lu_attempt(A, B, opts, method):
    """One factor+solve attempt under ErrorPolicy.Info; health merges the
    factor's pivot record with the solution's finiteness."""
    from ..drivers import lu as _lu
    o = _with(opts, MethodLU=method, ErrorPolicy=ErrorPolicy.Info)
    factor = {MethodLU.NoPiv: _lu.getrf_nopiv,
              MethodLU.CALU: _lu.getrf_tntpiv}.get(method, _lu.getrf)
    F, fh = factor(A, o)
    X = _lu.getrs(F, B, o)
    return (F, X), _h.merge(fh, _h.from_result(X.storage.data))


def _rbt_attempt(A, B, opts, ir_steps: int = 2):
    """The speculative gesv fast path: RBT-preconditioned NoPiv LU
    (drivers/lu.py getrf_rbt, K3 at the padded width on the card),
    ``ir_steps`` rounds of iterative refinement in the ORIGINAL system,
    then the residual certificate read on the original system and merged
    into the factor health -- a wrong fast-path solve (adversarial growth,
    a post_rbt bit flip) reads as ``converged=False`` and escalates."""
    from ..drivers import auxiliary as _aux
    from ..drivers import lu as _lu
    from ..drivers.blas3 import gemm
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    F, fh = _lu.getrf_rbt(A, o)
    X = _lu.getrs(F, B, o)
    for _ in range(ir_steps):
        R = gemm(-1.0, A, X, 1.0, B, opts)         # r = B - A X
        X = _aux.add(1.0, _lu.getrs(F, R, o), 1.0, X)
    R = gemm(-1.0, A, X, 1.0, B, opts)
    return (F, X), _h.merge(fh, _certify_solve(A, X, B, R, ir_steps))


def gesv_with_recovery(A, B, opts: Options | None = None):
    """gesv body: the requested method first (or, speculating, the
    certified RBT attempt), then, with Option.UseFallbackSolver, a retry
    of the same attempt under Abft and the rest of the pivoting ladder
    while the health is not acceptable.  Returns ``(F, X)`` under
    Raise/Nan, ``(F, X, HealthInfo)`` under Info."""
    method = select_lu_method(opts)
    speculate = resolve_speculate(opts)
    abft = resolve_abft(opts)  # the one Option.Abft read (like Speculate)
    chain = _LU_CHAIN[method]
    if speculate:
        # the RBT attempt IS the NoPiv rung: escalation goes pivoted
        fb_methods = tuple(m for m in chain if m is not MethodLU.NoPiv)
        first = _rbt_attempt(A, B, opts)
        same = lambda: _rbt_attempt(A, B, opts)            # noqa: E731
    else:
        fb_methods = chain[1:]
        first = _lu_attempt(A, B, opts, chain[0])
        same = lambda: _lu_attempt(A, B, opts, chain[0])   # noqa: E731
    if not get_option(opts, Option.UseFallbackSolver):
        fb_methods = ()
    retry_same = [same] if (abft and fb_methods) else []
    (F, X), h, _ = bounded_retry(
        first,
        retry_same + [lambda m=m: _lu_attempt(A, B, opts, m)
                      for m in fb_methods],
        dtype=A.dtype,
        max_retries=max(len(fb_methods) + len(retry_same), 1))
    return _finalize_solve("gesv", F, X, h, opts, _singular_exc("gesv"))


def gesv_nopiv_raw(A, B, opts: Options | None = None):
    """gesv_nopiv body: one NoPiv attempt, no escalation and no growth
    demotion: a finite (if catastrophic) NoPiv solve returns, as in the
    reference."""
    (F, X), h = _lu_attempt(A, B, opts, MethodLU.NoPiv)
    return _finalize_solve("gesv_nopiv", F, X, h, opts,
                           _singular_exc("gesv_nopiv"))


def _singular_exc(name):
    return lambda h: SlateSingularError(
        f"{name}: singular or numerically unusable factor "
        f"({h.describe()})", info=h.info)


# ------------------------------------------------------------------ posv

def _chol_attempt(A, B, opts):
    """One potrf+potrs attempt under Info: an indefinite input NaN-fills
    the factor, which reads as ``nonfinite``."""
    from ..drivers import cholesky as _chol
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    L, fh = _chol.potrf(A, o)
    X = _chol.potrs(L, B, o)
    return (L, X), _h.merge(fh, _h.from_result(X.storage.data))


def _round_bf16(M):
    """Round a matrix's values through bf16 storage (precision.py
    round_through), kept in the caller's dtype: the dense model of
    factor-low storage.  ``with_dense`` keeps the matrix class, so
    triangular factors stay triangular."""
    from .precision import round_through
    return M.with_dense(round_through(M.to_dense()))


def _chol_bf16_attempt(A, B, opts, ir_steps: int = 2):
    """The speculative posv fast path one precision lower (Speculate +
    Precision = bf16): Cholesky of the bf16-ROUNDED operand with the
    factor itself bf16-rounded, then ``ir_steps`` refinement sweeps in the
    ORIGINAL system and the residual certificate at the f32 tolerance.  A
    failed certificate (or a non-HPD rounding) escalates to the f32
    Cholesky attempt.

    The rung runs the f32 kernels (K2 on the card) on values bf16 can
    represent; it is NOT the serving layer's bf16 storage route (K6-K8 on
    bf16 tensors), and it should stay on the f32 drivers: its factor is
    the reference's dense model, bit for bit a rounding of the f32
    route's input."""
    from ..drivers import auxiliary as _aux
    from ..drivers import cholesky as _chol
    from ..drivers.blas3 import gemm
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    L, fh = _chol.potrf(_round_bf16(A), o)
    L = _round_bf16(L)
    X = _chol.potrs(L, B, o)
    for _ in range(ir_steps):
        R = gemm(-1.0, A, X, 1.0, B, opts)     # r = B - A X, ORIGINAL A
        X = _aux.add(1.0, _chol.potrs(L, R, o), 1.0, X)
    R = gemm(-1.0, A, X, 1.0, B, opts)
    return (L, X), _h.merge(fh, _certify_solve(A, X, B, R, ir_steps))


def _indefinite_fallback():
    raise not_ported("posv's fallback to hesv (then gesv) for a matrix "
                     "that is not positive definite (Option.UseFallbackSolver;"
                     " set it False to get the Cholesky result and its "
                     "health)", "queue 1, item 8 (hesv)")


def posv_with_recovery(A, B, opts: Options | None = None,
                       chol_attempt=None):
    """posv body: the bf16 rung when speculating at Precision = bf16, the
    f32 (or f64/complex) Cholesky attempt, and with UseFallbackSolver the
    Abft retry of the first attempt and the indefinite fallback, then the
    ErrorPolicy boundary.  The first returned element is the Cholesky
    factor of whichever attempt succeeded.  ``chol_attempt`` replaces
    :func:`_chol_attempt` (posv's captured one under
    Option.HoldLocalWorkspace)."""
    chol = chol_attempt or _chol_attempt
    speculate = resolve_speculate(opts)   # resolved ONCE, like ErrorPolicy
    low = resolve_precision(opts)         # the one Option.Precision read
    if speculate and low:
        first = _chol_bf16_attempt(A, B, opts)
        same = lambda: _chol_bf16_attempt(A, B, opts)      # noqa: E731
        fallbacks = [lambda: chol(A, B, opts)]
    else:
        first = chol(A, B, opts)
        same = lambda: chol(A, B, opts)                    # noqa: E731
        fallbacks = []
    if get_option(opts, Option.UseFallbackSolver):
        fallbacks.append(_indefinite_fallback)
        if resolve_abft(opts):  # the one Option.Abft read here
            fallbacks.insert(0, same)
    (F, X), h, _ = bounded_retry(first, fallbacks, dtype=A.dtype,
                                 max_retries=max(len(fallbacks), 2))
    return _finalize_solve(
        "posv", F, X, h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"posv: not positive definite and fallback failed "
            f"({hh.describe()})", info=hh.info))


# ------------------------------------------------------------------ gels

def _gels_bf16_attempt(A, B, opts, refine: int = 2):
    """The speculative gels fast path one precision lower (Speculate +
    Precision = bf16): Householder QR of the bf16-ROUNDED operand (K5 on
    the card, on values bf16 can represent) with R itself bf16-rounded,
    then Bjorck CSNE sweeps through R against the ORIGINAL system and the
    normal-equations certificate at the f32 tolerance.  The certificate is
    a backward-error gate that a rank-collapsed rounding can pass (a huge
    ||x|| from a tiny R pivot), so a conditioning estimate through R's
    diagonal is folded into ``growth``, whose demotion escalates it."""
    from ..drivers import auxiliary as _aux
    from ..drivers import qr as _qr
    from ..drivers.blas3 import gemm
    from ..types import Norm
    from . import certify as _certify
    from .precision import round_through
    n = A.n
    F = _qr.geqrf(_round_bf16(A), opts)
    rd = round_through(torch.triu(F.QR.to_dense()[:n, :n]))

    def sne(Rhs):
        # dx = R^-1 R^-T (A^H rhs): semi-normal equations through the low
        # factor (R^T, not R^H, as the reference solves it)
        Z = gemm(1.0, A.conj_transpose(), Rhs, 0.0, None, opts)
        y = torch.linalg.solve_triangular(rd.T, Z.to_dense(), upper=False)
        return Z.with_dense(torch.linalg.solve_triangular(rd, y,
                                                          upper=True))

    X = sne(B)
    for _ in range(refine):
        R = gemm(-1.0, A, X, 1.0, B, opts)     # r = B - A X, ORIGINAL A
        X = _aux.add(1.0, sne(R), 1.0, X)
    R = gemm(-1.0, A, X, 1.0, B, opts)
    Rn = gemm(1.0, A.conj_transpose(), R, 0.0, None, opts)
    anorm = _aux.norm(Norm.Fro, A)
    cert = _certify.certify_lstsq(
        anorm[None], X.to_dense()[None], B.to_dense()[None],
        Rn.to_dense()[None],
        tol=_certify.tolerance(A.dtype, max(A.m, A.n))).to_list()[0]
    d = torch.diagonal(rd).abs()
    dmin = torch.clamp(d.min(), min=torch.finfo(d.dtype).tiny)
    piv = _h.from_pivots(d)._replace(growth=float(anorm / dmin))
    h = _h.merge(piv, _h.merge(_h.from_result(X.storage.data),
                               cert._replace(iters=refine)))
    return X, h


def gels_with_recovery(A, B, opts: Options | None = None):
    """gels body for m >= n (drivers/qr.py delegates here).  The first
    attempt: the bf16 QR rung (Speculate + Precision = bf16), whose
    escalation is the certified CholQR2 rung; the certified CholQR2 rung
    (Speculate); CholQR when select_gels_method picks it (m >= 3 n by
    default); Householder QR otherwise.  ``Option.UseFallbackSolver`` adds
    Householder QR after any first attempt that is not QR.  Resolves
    ErrorPolicy here: ``X``, or ``(X, HealthInfo)`` under Info."""
    from ..drivers import qr as _qr
    speculate = resolve_speculate(opts)
    low = resolve_precision(opts)         # the one Option.Precision read
    method = select_gels_method(opts, A.m, A.n)
    fallbacks = []
    house = False
    if speculate and low:
        first = _gels_bf16_attempt(A, B, opts)
        fallbacks = [lambda: _qr._gels_cholqr_attempt(A, B, opts, refine=1,
                                                      certify=True)]
        exc = _qr._gram_exc("gels")
    elif speculate:
        first = _qr._gels_cholqr_attempt(A, B, opts, refine=1, certify=True)
        exc = _qr._gram_exc("gels")
    elif method is MethodGels.CholQR:
        first = _qr._gels_cholqr_attempt(A, B, opts)
        exc = _qr._gram_exc("gels")
    else:
        # Householder QR directly: no speculation rung, but ErrorPolicy
        # still resolves at this boundary, and bounded_retry with no
        # fallbacks is just the growth demotion
        house = True
        first = _qr._gels_qr_attempt(A, B, opts)
        exc = _singular_exc("gels")
    if not house and get_option(opts, Option.UseFallbackSolver):
        fallbacks.append(lambda: _qr._gels_qr_attempt(A, B, opts))
    X, h, _ = bounded_retry(first, fallbacks, dtype=A.dtype,
                            max_retries=max(len(fallbacks), 1))
    return _h.finalize("gels", X, h, opts, exc)


def _finalize_solve(name, F, X, h, opts, make_exc):
    res = _h.finalize(name, (F, X), h, opts, make_exc)
    if _h.error_policy(opts) is ErrorPolicy.Info:
        (F, X), h = res
        return F, X, h
    return res
