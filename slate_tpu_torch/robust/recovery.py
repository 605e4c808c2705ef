"""Driver-level graceful degradation: escalate, fall back, retry, bounded
(port of the gesv, posv, hesv, gels, heev and svd parts of
slate_tpu/robust/recovery.py).

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
  With ``Option.UseFallbackSolver`` (the default) a non-HPD input is
  retried as Hermitian-indefinite (hesv, Aasen) and then as plain LU
  (gesv) on the densified matrix.
- hesv: Aasen first (``Option.Speculate``: Cholesky first, Aasen its
  escalation); with ``Option.UseFallbackSolver`` a singular band T falls
  back to densified LU gesv.
- gels (m >= n) takes CholQR or Householder QR per ``select_gels_method``;
  Speculate puts the certified CholQR2 rung first, and with
  ``Option.Precision = bf16`` the bf16 QR rung below it
  (:func:`_gels_bf16_attempt`); ``Option.UseFallbackSolver`` adds
  Householder QR as the last rung.
- heev and svd: a failed a-posteriori certificate (robust/certify.py)
  escalates the METHOD, MethodEig Auto -> DC -> QR and MethodSvd Auto ->
  Bidiag (ScaLAPACK's ladder: divide and conquer falls back to QR
  iteration), each attempt certified again (:func:`heev_with_recovery`,
  :func:`svd_with_recovery`); ``Option.UseFallbackSolver`` off keeps
  the first rung only.
- ``Option.Abft``: the drivers repair a single struck element in place;
  an UNREPAIRED detection (``abft_detected > abft_corrected``, which fails
  ``HealthInfo.ok``) retries the SAME attempt once, before any method
  escalation -- a transient strike will not repeat.
"""

from __future__ import annotations

import torch

from ..exceptions import (SlateNotConvergedError,
                          SlateNotPositiveDefiniteError, SlateSingularError)
from ..obs import events as _obs
from ..options import (ErrorPolicy, MethodEig, MethodGels, MethodLU,
                       MethodSvd, Option, Options, get_option, resolve_abft,
                       resolve_speculate, select_gels_method,
                       select_lu_method)
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
    return (F, X), _h.merge(fh, _h.from_result(X.storage.data, X.grid))


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
    (F, X), h, used = bounded_retry(
        first,
        retry_same + [lambda m=m: _lu_attempt(A, B, opts, m)
                      for m in fb_methods],
        dtype=A.dtype,
        max_retries=max(len(fb_methods) + len(retry_same), 1))
    _obs.note_path("rbt" if speculate else chain[0].name,
                   (["retry_same"] if retry_same else [])
                   + [m.name for m in fb_methods], used, speculate)
    return _finalize_solve("gesv", F, X, h, opts, _singular_exc("gesv"))


def gesv_nopiv_raw(A, B, opts: Options | None = None):
    """gesv_nopiv body: one NoPiv attempt, no escalation and no growth
    demotion: a finite (if catastrophic) NoPiv solve returns, as in the
    reference."""
    (F, X), h = _lu_attempt(A, B, opts, MethodLU.NoPiv)
    _obs.note_path("NoPiv", (), 0, False)
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
    return (L, X), _h.merge(fh, _h.from_result(X.storage.data, X.grid))


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


def posv_with_recovery(A, B, opts: Options | None = None,
                       chol_attempt=None):
    """posv body: the bf16 rung when speculating at Precision = bf16, the
    f32 (or f64/complex) Cholesky attempt, and with UseFallbackSolver the
    Abft retry of the first attempt, then hesv, then gesv, then the
    ErrorPolicy boundary.  The first returned element is the factor object
    of whichever attempt succeeded (TriangularMatrix, HEFactors or
    LUFactors).  ``chol_attempt`` replaces
    :func:`_chol_attempt` (posv's captured one under
    Option.HoldLocalWorkspace)."""
    chol = chol_attempt or _chol_attempt
    speculate = resolve_speculate(opts)   # resolved ONCE, like ErrorPolicy
    low = resolve_precision(opts)         # the one Option.Precision read
    bf16 = speculate and low
    if bf16:
        first_name = "cholesky_bf16"
        first = _chol_bf16_attempt(A, B, opts)
        same = lambda: _chol_bf16_attempt(A, B, opts)      # noqa: E731
        fallbacks, rungs = [lambda: chol(A, B, opts)], ["cholesky"]
    else:
        first_name = "cholesky"
        first = chol(A, B, opts)
        same = lambda: chol(A, B, opts)                    # noqa: E731
        fallbacks, rungs = [], []
    if get_option(opts, Option.UseFallbackSolver):
        fallbacks += [lambda: _hesv_attempt(A, B, opts),
                      lambda: _gesv_attempt(A, B, opts)]
        rungs += ["hesv", "gesv"]
        if resolve_abft(opts):  # the one Option.Abft read here
            fallbacks.insert(0, same)
            rungs.insert(0, "retry_same")
    (F, X), h, used = bounded_retry(first, fallbacks, dtype=A.dtype,
                                    max_retries=max(len(fallbacks), 2))
    _obs.note_path(first_name, rungs, used, bf16)
    return _finalize_solve(
        "posv", F, X, h, opts,
        lambda hh: SlateNotPositiveDefiniteError(
            f"posv: not positive definite and fallback failed "
            f"({hh.describe()})", info=hh.info))


def _hesv_attempt(A, B, opts):
    """The indefinite rung: hesv under Raise; a raise (a singular band T,
    or a matrix hesv cannot take) reads as an unhealthy attempt."""
    from ..drivers import hetrf as _he
    o = _with(opts, ErrorPolicy=ErrorPolicy.Raise)
    try:
        F, X = _he.hesv(A, B, o)
    except Exception:  # noqa: BLE001 -- a failed fallback is just unhealthy
        return (None, None), _h.healthy()._replace(converged=False)
    return (F, X), _h.from_result(X.storage.data, X.grid)


def _gesv_attempt(A, B, opts):
    """The last rung: partial-pivot LU of the densified matrix."""
    from ..core.matrix import Matrix
    from ..core.storage import TileStorage
    from ..drivers import lu as _lu
    Ag = Matrix(TileStorage.from_dense(A.to_dense(), A.nb, A.nb, A.grid))
    o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
    F, fh = _lu.getrf(Ag, o)
    X = _lu.getrs(F, B, o)
    return (F, X), _h.merge(fh, _h.from_result(X.storage.data, X.grid))


# ------------------------------------------------------------------ hesv

def hesv_with_recovery(A, B, opts: Options | None = None):
    """hesv body (drivers/hetrf.py delegates here): Aasen's tridiagonal T
    is factored without pivoting beyond its band, so a singular T poisons
    the solve; with ``Option.UseFallbackSolver`` densified LU gesv
    follows.  ``Option.Speculate = On`` (resolved once here) tries
    Cholesky first, Aasen as its escalation, then gesv with
    UseFallbackSolver.  Returns ``(F, X)`` under Raise/Nan,
    ``(F, X, HealthInfo)`` under Info."""
    from ..drivers import hetrf as _he

    def aasen():
        o = _with(opts, ErrorPolicy=ErrorPolicy.Info)
        F, fh = _he.hetrf(A, o)
        X = _he.hetrs(F, B, o)
        return (F, X), _h.merge(fh, _h.from_result(X.storage.data, X.grid))

    use_fb = get_option(opts, Option.UseFallbackSolver)
    speculate = resolve_speculate(opts)
    if speculate:
        first_name, first = "cholesky", _chol_attempt(A, B, opts)
        fallbacks, rungs = [aasen], ["aasen"]
        if use_fb:
            fallbacks.append(lambda: _gesv_attempt(A, B, opts))
            rungs.append("gesv")
    else:
        first_name, first = "aasen", aasen()
        fallbacks = [lambda: _gesv_attempt(A, B, opts)] if use_fb else []
        rungs = ["gesv"] if use_fb else []
    (F, X), h, used = bounded_retry(first, fallbacks, dtype=A.dtype,
                                    max_retries=max(len(fallbacks), 1))
    _obs.note_path(first_name, rungs, used, speculate)
    return _finalize_solve("hesv", F, X, h, opts, _singular_exc("hesv"))


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
    h = _h.merge(piv, _h.merge(_h.from_result(X.storage.data, X.grid),
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
    fallbacks, rungs = [], []
    if speculate and low:
        first_name = "qr_bf16"
        first = _gels_bf16_attempt(A, B, opts)
        fallbacks = [lambda: _qr._gels_cholqr_attempt(A, B, opts, refine=1,
                                                      certify=True)]
        rungs = ["cholqr2"]
        exc = _qr._gram_exc("gels")
    elif speculate:
        first_name = "cholqr2"
        first = _qr._gels_cholqr_attempt(A, B, opts, refine=1, certify=True)
        exc = _qr._gram_exc("gels")
    elif method is MethodGels.CholQR:
        first_name = "cholqr"
        first = _qr._gels_cholqr_attempt(A, B, opts)
        exc = _qr._gram_exc("gels")
    else:
        # Householder QR directly: no speculation rung, but ErrorPolicy
        # still resolves at this boundary, and bounded_retry with no
        # fallbacks is just the growth demotion
        first_name = "qr"
        first = _qr._gels_qr_attempt(A, B, opts)
        exc = _singular_exc("gels")
    if first_name != "qr" and get_option(opts, Option.UseFallbackSolver):
        fallbacks.append(lambda: _qr._gels_qr_attempt(A, B, opts))
        rungs.append("qr")
    X, h, used = bounded_retry(first, fallbacks, dtype=A.dtype,
                               max_retries=max(len(fallbacks), 1))
    _obs.note_path(first_name, rungs, used, speculate)
    return _h.finalize("gels", X, h, opts, exc)


# ------------------------------------------------------------- heev / svd

# ScaLAPACK's spectral ladder: divide and conquer falls back to QR
# iteration.  Auto tries the library's band eigensolver first.
_EIG_CHAIN = {
    MethodEig.Auto: (MethodEig.Auto, MethodEig.DC, MethodEig.QR),
    MethodEig.DC: (MethodEig.DC, MethodEig.QR),
    MethodEig.QR: (MethodEig.QR,),
}

_SVD_CHAIN = {
    MethodSvd.Auto: (MethodSvd.Auto, MethodSvd.Bidiag),
    MethodSvd.Bidiag: (MethodSvd.Bidiag,),
}


def _notconverged_exc(name):
    return lambda h: SlateNotConvergedError(
        f"{name}: spectral result failed certification and escalation "
        f"was exhausted ({h.describe()})", iters=int(h.iters))


def _spectral_ladder(name, chain, key, attempt, dtype, opts):
    """Walk ``chain`` (method enums) through :func:`bounded_retry`, each
    attempt ``attempt(opts with key = method)`` returning ``(result,
    HealthInfo)``; note the path and resolve the ErrorPolicy."""
    if not get_option(opts, Option.UseFallbackSolver):
        chain = chain[:1]

    def run(m):
        return attempt(_with(opts, **{key: m}))

    result, h, used = bounded_retry(
        run(chain[0]), [lambda m=m: run(m) for m in chain[1:]],
        dtype=dtype, max_retries=len(chain))
    _obs.note_path(chain[0].name, [m.name for m in chain[1:]], used, False)
    return _h.finalize_flat(name, result, h, opts, _notconverged_exc(name))


def heev_with_recovery(A, opts: Options | None = None, *, jobz: bool = True):
    """heev's body with certification-gated MethodEig escalation
    (ref: recovery.py:361): Auto -> DC -> QR.  Returns ``(w, Z)``, under
    Info ``(w, Z, HealthInfo)``."""
    from ..drivers import heev as _heev
    return _spectral_ladder(
        "heev", _EIG_CHAIN[get_option(opts, Option.MethodEig)], "MethodEig",
        lambda o: _heev.heev_info(A, o, jobz=jobz), A.dtype, opts)


def svd_with_recovery(A, opts: Options | None = None, *, jobu: bool = True):
    """svd's body with certification-gated MethodSvd escalation
    (ref: recovery.py:384): Auto -> Bidiag.  Returns ``(s, U, V)``, under
    Info ``(s, U, V, HealthInfo)``."""
    from ..drivers import svd as _svd
    return _spectral_ladder(
        "svd", _SVD_CHAIN[get_option(opts, Option.MethodSvd)], "MethodSvd",
        lambda o: _svd.svd_info(A, o, jobu=jobu), A.dtype, opts)


def _finalize_solve(name, F, X, h, opts, make_exc):
    res = _h.finalize(name, (F, X), h, opts, make_exc)
    if _h.error_policy(opts) is ErrorPolicy.Info:
        (F, X), h = res
        return F, X, h
    return res
