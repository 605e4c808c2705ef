"""posv's retry ladder (port of the posv part of
slate_tpu/robust/recovery.py).

posv factors and solves once under ErrorPolicy.Info and resolves the
health at its boundary.  With ``Option.UseFallbackSolver`` (the default)
the reference retries a non-HPD input as Hermitian-indefinite (hesv) and
then as plain LU (gesv); those solvers are not ported yet, so here that
rung raises ``NotImplementedError`` when it is reached (a HPD input never
reaches it).  The bf16 rung (Speculate + Precision = bf16) raises too.
"""

from __future__ import annotations

from ..exceptions import SlateNotPositiveDefiniteError, not_ported
from ..options import (ErrorPolicy, Option, Options, Precision, get_option,
                       resolve_speculate)
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


def _chol_attempt(A, B, opts):
    """One potrf+potrs attempt under Info: an indefinite input NaN-fills
    the factor, which reads as ``nonfinite``."""
    from ..drivers import cholesky as _chol
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    L, fh = _chol.potrf(A, o)
    X = _chol.potrs(L, B, o)
    return (L, X), _h.merge(fh, _h.from_result(X.storage.data))


def _indefinite_fallback():
    raise not_ported("posv's fallback to hesv and gesv for a matrix that is "
                     "not positive definite (Option.UseFallbackSolver; set "
                     "it False to get the Cholesky result and its health)",
                     "queue 1, items 4 (gesv) and 8 (hesv)")


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


def _finalize_solve(name, F, X, h, opts, make_exc):
    res = _h.finalize(name, (F, X), h, opts, make_exc)
    if _h.error_policy(opts) is ErrorPolicy.Info:
        (F, X), h = res
        return F, X, h
    return res
