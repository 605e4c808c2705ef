"""The retry ladders of gesv, posv and gels (port of the gesv, posv and
gels parts of slate_tpu/robust/recovery.py).

Each solver factors and solves under ErrorPolicy.Info and resolves the
health at its boundary.

- gesv escalates the pivoting on an unhealthy factor, NoPiv -> PartialPiv
  -> CALU, through :func:`bounded_retry` (``Option.UseFallbackSolver``).
  Its speculative first rung (``Option.Speculate = On``: the RBT
  preconditioned NoPiv solve, refined and certified) raises
  ``NotImplementedError``: it needs gemm, norm and the certificates.
- posv: with ``Option.UseFallbackSolver`` (the default) the reference
  retries a non-HPD input as Hermitian-indefinite (hesv) and then as
  plain LU (gesv); hesv is not ported yet, so that rung raises
  ``NotImplementedError`` when it is reached (a HPD input never reaches
  it).  The bf16 rung (Speculate + Precision = bf16) raises too.
- gels (m >= n) takes CholQR or Householder QR per ``select_gels_method``,
  and with ``Option.UseFallbackSolver`` retries a failed CholQR by QR.
  Its speculative rungs (``Option.Speculate = On``: certified CholQR2,
  and below it with ``Option.Precision = bf16`` the bf16 QR) raise
  ``NotImplementedError``: they need the least-squares certificate.
"""

from __future__ import annotations

from ..exceptions import (SlateNotPositiveDefiniteError, SlateSingularError,
                          not_ported)
from ..options import (ErrorPolicy, MethodGels, MethodLU, Option, Options,
                       Precision, get_option, resolve_speculate,
                       select_gels_method, select_lu_method)
from . import health as _h


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


def gesv_with_recovery(A, B, opts: Options | None = None):
    """gesv body: the requested method first, then (with
    Option.UseFallbackSolver) the rest of its pivoting ladder while the
    health is not acceptable.  Returns ``(F, X)`` under Raise/Nan,
    ``(F, X, HealthInfo)`` under Info."""
    method = select_lu_method(opts)
    if resolve_speculate(opts):
        raise not_ported("gesv's speculative RBT rung (Option.Speculate = "
                         "On: getrf_rbt with refinement and a residual "
                         "certificate)", "queue 1, item 6 (robustness)")
    chain = _LU_CHAIN[method]
    fb_methods = (chain[1:] if get_option(opts, Option.UseFallbackSolver)
                  else ())
    (F, X), h, _ = bounded_retry(
        _lu_attempt(A, B, opts, chain[0]),
        [lambda m=m: _lu_attempt(A, B, opts, m) for m in fb_methods],
        dtype=A.dtype, max_retries=max(len(fb_methods), 1))
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


def _chol_attempt(A, B, opts):
    """One potrf+potrs attempt under Info: an indefinite input NaN-fills
    the factor, which reads as ``nonfinite``."""
    from ..drivers import cholesky as _chol
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    L, fh = _chol.potrf(A, o)
    X = _chol.potrs(L, B, o)
    return (L, X), _h.merge(fh, _h.from_result(X.storage.data))


def _indefinite_fallback():
    raise not_ported("posv's fallback to hesv (then gesv) for a matrix "
                     "that is not positive definite (Option.UseFallbackSolver;"
                     " set it False to get the Cholesky result and its "
                     "health)", "queue 1, item 8 (hesv)")


def posv_with_recovery(A, B, opts: Options | None = None):
    """posv body: the f32 (or f64/complex) Cholesky attempt, the
    UseFallbackSolver rung, and the ErrorPolicy boundary."""
    if (resolve_speculate(opts)
            and get_option(opts, Option.Precision) is Precision.Bf16):
        raise not_ported("posv's bf16 rung (Option.Speculate with "
                         "Option.Precision = bf16)",
                         "queue 1, item 6 (robustness)")
    first = _chol_attempt(A, B, opts)
    fallbacks = ([_indefinite_fallback]
                 if get_option(opts, Option.UseFallbackSolver) else [])
    (F, X), h, _ = bounded_retry(first, fallbacks, dtype=A.dtype,
                                 max_retries=max(len(fallbacks), 2))
    return _finalize_solve(
        "posv", F, X, h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"posv: not positive definite and fallback failed "
            f"({hh.describe()})", info=hh.info))


def gels_with_recovery(A, B, opts: Options | None = None):
    """gels body for m >= n (drivers/qr.py delegates here): the CholQR
    semi-normal-equations attempt when select_gels_method picks CholQR
    (m >= 3 n by default), with Option.UseFallbackSolver a Householder QR
    retry when its health fails; the QR attempt alone otherwise.  Both
    resolve ErrorPolicy here: ``X``, or ``(X, HealthInfo)`` under Info."""
    from ..drivers import qr as _qr
    if resolve_speculate(opts):
        low = get_option(opts, Option.Precision) is Precision.Bf16
        raise not_ported(
            "gels's speculative " + ("qr_bf16 rung (Option.Speculate with "
                                     "Option.Precision = bf16)" if low else
                                     "cholqr2 rung (Option.Speculate = On: "
                                     "refined and certified CholQR2)"),
            "queue 1, item 6 (robustness)")
    if select_gels_method(opts, A.m, A.n) is MethodGels.CholQR:
        first = _qr._gels_cholqr_attempt(A, B, opts)
        fallbacks = ([lambda: _qr._gels_qr_attempt(A, B, opts)]
                     if get_option(opts, Option.UseFallbackSolver) else [])
        exc = _qr._gram_exc("gels")
    else:
        first, fallbacks = _qr._gels_qr_attempt(A, B, opts), []
        exc = _singular_exc("gels")
    X, h, _ = bounded_retry(first, fallbacks, dtype=A.dtype,
                            max_retries=max(len(fallbacks), 1))
    return _h.finalize("gels", X, h, opts, exc)


def _finalize_solve(name, F, X, h, opts, make_exc):
    res = _h.finalize(name, (F, X), h, opts, make_exc)
    if _h.error_policy(opts) is ErrorPolicy.Info:
        (F, X), h = res
        return F, X, h
    return res
