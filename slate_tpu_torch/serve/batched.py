"""Batched solve cores with per-problem escalation (port of
slate_tpu/serve/batched.py).

Every core serves a leading-axis batch of bucket-shaped problems and
returns ``(x, [HealthInfo], [escalated])``: one health record and one flag
a problem.  Ladders, as in the reference (two rungs each):

- ``solve``                NoPiv LU + 2 IR sweeps (growth-gated) -> PartialPiv LU
- ``chol_solve``           Cholesky                              -> PartialPiv LU
- ``least_squares_solve``  CholQR semi-normal equations          -> Householder QR

Two routes compute the fast rung:

- **ragged** (the default for f32 and bf16 on the card, ``CUDA_PLAN`` on
  the batch ops): ONE ragged batched factorization (internal/batched.py)
  whose panel steps are K6, K7 or K8 and in which each problem computes
  only its own tiles;
- **per-problem** (``LIBRARY_PLAN`` on the batch op, and every dtype the
  batched kernels do not take): a loop over the batch through the
  single-problem drivers, the counterpart of the reference's vmapped
  cores, which reach K2, K3 and K5 through their own seams.

Escalation is eager where the reference's is a per-problem ``lax.cond``
under ``vmap`` (both rungs computed, one selected): the fast rung's health
is read in one copy, the safe rung runs on the escalating problems only,
and their results are scattered back, which is what the reference's
select gives.  So each core is split at that one host read
(:func:`batch_program`): its device parts compute the first attempts and
their health as device tensors, its host part reads the health and
escalates; serve/cache.py captures the device parts of the ragged route
as CUDA graphs on the card and replays them for every batch.

Precision rung (``Option.Precision = bf16``, or bf16 operands): one more
rung below the ladders above: factor in bf16 storage with f32 sums (K6-K8
on bf16 under a bf16 plan; a whole-bucket torch factor of the
bf16-rounded operand otherwise), refine with two f32 sweeps against the
ORIGINAL operands, and accept each problem only on an a-posteriori
certificate (robust/certify.py).  Whenever a problem fails its
certificate the f32 route runs on the whole batch, as the reference's
select computes it, so the escalated problems get results bit-identical
to the same batch served with the rung off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.matrix import HermitianMatrix, Matrix
from ..core.storage import TileStorage
from ..drivers import cholesky as _chol
from ..drivers import lu as _lu
from ..drivers import qr as _qr
from ..internal import batched as _bk
from ..internal import chol_kernels as _ck
from ..internal import lu_kernels as _lk
from ..internal import qr_kernels as _qk
from ..internal.getrf import panel_lu
from ..internal.kernels import fits
from ..options import ErrorPolicy, Option, Options, resolve_abft
from ..robust import certify as _cert
from ..robust import health as _h
from ..robust import precision as _prec
from ..tune.plans import resolve_plan
from ..types import Uplo

_TILE = 128

# dtypes the serving boundary takes: f32 (both routes), bf16 (the
# certified precision rung), f64 (the per-problem route only); anything
# else raises SlateUnsupportedDtypeError at the boundary
SERVE_DTYPES = ("float32", "bfloat16", "float64")

# the plan op whose kernel runs each serve op's fast rung as one ragged
# batched factorization
RAGGED_OPS = {
    "solve": "batch_getrf",
    "chol_solve": "batch_potrf",
    "least_squares_solve": "batch_geqrf",
}


def _tile(n: int) -> int:
    """Tile edge of the per-problem drivers' bucket-shaped matrices."""
    return min(int(n), _TILE)


def _info(opts: Options | None) -> dict:
    o = dict(opts or {})
    o[Option.ErrorPolicy] = ErrorPolicy.Info
    return o


def _mat(dense: torch.Tensor, t: int) -> Matrix:
    return Matrix(TileStorage.from_dense(dense, t, t))


def _demote(h: _h.HealthInfo, dtype) -> _h.HealthInfo:
    """The bounded_retry growth gate: catastrophic pivot growth reads as
    not converged, so it escalates and stays visible in the health."""
    return h._replace(converged=h.converged
                      and h.growth <= _h.growth_limit(dtype))


def _demote_batch(h: _h.BatchHealth, dtype) -> _h.BatchHealth:
    """:func:`_demote` of each problem, on the device."""
    return h._replace(converged=h.converged
                      & (h.growth <= _h.growth_limit(dtype)))


# ------------------------------------------------- per-problem cores


def _lu_solve(a: torch.Tensor, b: torch.Tensor, opts: Options | None):
    """The partial-pivot LU rung of one problem: ``(x, HealthInfo)``."""
    t = _tile(a.shape[0])
    o = _info(opts)
    F, fh = _lu.getrf(_mat(a, t), o)
    X = _lu.getrs(F, _mat(b, t), o)
    h = _h.merge(fh, _h.from_result(X.storage.data))
    return X.to_dense(), _demote(h, a.dtype)


def solve_core(a: torch.Tensor, b: torch.Tensor, opts: Options | None = None):
    """General solve A x = b of one bucket-shaped problem: NoPiv LU (the
    serving speculation) plus two sweeps of refinement in the original
    system, demoted on pivot growth; safe rung partial-pivot LU.  Returns
    ``(x, HealthInfo, escalated)``."""
    t = _tile(a.shape[0])
    o = _info(opts)
    F, fh = _lu.getrf_nopiv(_mat(a, t), o)
    x = _lu.getrs(F, _mat(b, t), o).to_dense()
    for _ in range(2):                     # r = b - A x, dx through F
        x = x + _lu.getrs(F, _mat(b - a @ x, t), o).to_dense()
    h = _demote(_h.merge(fh, _h.from_result(x)), a.dtype)
    if _h.acceptable(h, a.dtype):
        return x, h, False
    return (*_lu_solve(a, b, opts), True)


def chol_solve_core(a: torch.Tensor, b: torch.Tensor,
                    opts: Options | None = None):
    """HPD solve of one bucket-shaped problem (full symmetric ``a``):
    Cholesky, whose failure on an indefinite problem reads ``nonfinite``
    and escalates; safe rung partial-pivot LU."""
    t = _tile(a.shape[0])
    o = _info(opts)
    H = HermitianMatrix._from_view(_mat(a, t), Uplo.Lower)
    L, fh = _chol.potrf(H, o)
    X = _chol.potrs(L, _mat(b, t), o)
    h = _demote(_h.merge(fh, _h.from_result(X.storage.data)), a.dtype)
    if _h.acceptable(h, a.dtype):
        return X.to_dense(), h, False
    return (*_lu_solve(a, b, opts), True)


def _qr_solve(a: torch.Tensor, b: torch.Tensor, opts: Options | None):
    """The Householder QR rung of one least-squares problem."""
    t = _tile(a.shape[1])
    X, h = _qr._gels_qr_attempt(_mat(a, t), _mat(b, t), _info(opts))
    return X.to_dense(), _demote(h, a.dtype)


def least_squares_core(a: torch.Tensor, b: torch.Tensor,
                       opts: Options | None = None):
    """Least squares min ||A x - b|| of one bucket-shaped (mb, nb) problem:
    CholQR semi-normal equations, which rank deficiency or squared
    conditioning fails; safe rung Householder QR.  x is (nb, kb)."""
    t = _tile(a.shape[1])
    X, h = _qr._gels_cholqr_attempt(_mat(a, t), _mat(b, t), _info(opts))
    h = _demote(h, a.dtype)
    if _h.acceptable(h, a.dtype):
        return X.to_dense(), h, False
    return (*_qr_solve(a, b, opts), True)


CORES = {
    "solve": solve_core,
    "chol_solve": chol_solve_core,
    "least_squares_solve": least_squares_core,
}

SAFE_RUNGS = {
    "solve": _lu_solve,
    "chol_solve": _lu_solve,
    "least_squares_solve": _qr_solve,
}


def _per_problem(op: str, a, b, opts: Options | None):
    """The per-problem route: each problem of the batch through its core."""
    outs = [CORES[op](a[i], b[i], opts) for i in range(a.shape[0])]
    return (torch.stack([x for x, _, _ in outs]), [h for _, h, _ in outs],
            [e for _, _, e in outs])


# ------------------------------------------------------- ragged route


class RaggedPlan(NamedTuple):
    """A bucket's ragged route: panel width ``nb`` and slab width ``bw``."""
    nb: int
    bw: int


def _ragged_plan(op: str, a: torch.Tensor, opts: Options | None,
                 dtype=None) -> RaggedPlan | None:
    """The routing decision of one bucket, from its shape, dtype and the
    plan of the op's batch kernel, by the reference's rule
    (slate_tpu/serve/batched.py ``_ragged_plan``): the panel width is nb =
    min(plan.nb, bucket), and the bucket goes per problem when the plan is
    not the hand kernel, the bucket is not a multiple of nb, or nb not a
    multiple of max(plan.bw, 8).  Then the kernel's gate: on the card asked
    of the kernel itself, on the CPU its mirror (``batched_width_ok``), so
    that a bucket takes the same route on both devices.  Returns a
    RaggedPlan, or None for the per-problem route.  ``dtype`` overrides the
    plan-key dtype (the precision rung factors in bf16 while ``a`` itself
    stays f32).  The default plan (nb = 128) gives min(128, bucket)."""
    lsq = op == "least_squares_solve"
    n_bucket = int(a.shape[2] if lsq else a.shape[1])
    dtype = _prec.normalize_dtype(a.dtype if dtype is None else dtype)
    if dtype not in (_prec.HIGH, _prec.LOW):
        return None
    if resolve_abft(opts) and op != "chol_solve":
        # only batch_potrf carries the checksum rungs in-batch; the other
        # ops honor Abft through the per-problem drivers
        return None
    plan = resolve_plan(RAGGED_OPS[op], n_bucket, dtype)
    if plan.kernel != "cuda":
        return None
    nb = min(int(plan.nb), n_bucket)
    if n_bucket % nb or nb % max(int(plan.bw), 8):
        return None
    if not _kernel_takes(op, a, nb, plan.bw):
        return None
    return RaggedPlan(nb, plan.bw)


def _kernel_takes(op: str, a: torch.Tensor, nb: int, bw: int) -> bool:
    """The gate of the op's batch kernel (K6, K7 or K8) at panel width nb
    and slab width bw for the bucket ``a``: on the card the kernel's own
    answer, on the CPU its mirror."""
    if op == "least_squares_solve":
        if a.device.type == "cuda":
            return _qk.batched_panel_fits(a.device, a.shape[1], nb, bw)
        return _qk.batched_width_ok(a.shape[1], nb, bw)
    mod, kernel = ((_ck, _ck.CHOL_PANEL_BATCHED) if op == "chol_solve"
                   else (_lk, _lk.LU_PANEL_BATCHED))
    if a.device.type == "cuda":
        return fits(kernel, f"slate_{kernel.name}_fits", a.device, nb, bw)
    return mod.batched_width_ok(nb, bw)


def _escalate(op: str, h1: list, x1, a, b, opts: Options | None):
    """Keep each problem's fast result where its health is acceptable; run
    the op's safe rung on the others only and scatter their results back
    (the reference's per-problem select)."""
    esc = [not _h.acceptable(h, a.dtype) for h in h1]
    if not any(esc):
        return x1, h1, esc
    x, hs = x1.clone(), list(h1)
    for i in (i for i, e in enumerate(esc) if e):
        x[i], hs[i] = SAFE_RUNGS[op](a[i], b[i], opts)
    return x, hs, esc


# Each ragged core is split at its host read: the DEVICE part below (the
# first attempt through K6, K7 or K8, its solves and refinement sweeps, and
# its health as a BatchHealth of device tensors; no host read, no branch
# on a device value) returns ``(x, BatchHealth)``, and the host part
# (_escalate) reads that health once and runs the escalations eagerly.  On
# the card serve/cache.py captures each device part as a CUDA graph.


def _ragged_solve(a, b, sizes, plan: RaggedPlan):
    """solve's fast rung through batch_getrf (K7): ragged NoPiv LU + 2 IR
    sweeps, and its health, on the device."""
    fa = _bk.batch_getrf(a, sizes, nb=plan.nb, bw=plan.bw)
    x = _bk.batch_getrs(fa, b)
    for _ in range(2):                     # r = b - A x, dx through fa
        x = x + _bk.batch_getrs(fa, b - a @ x)
    return x, _demote_batch(_h.batch_merge(_bk.lu_health(a, fa),
                                           _h.batch_from_result(x)), a.dtype)


def _chol_solves(fa: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """L L^T x = rhs with the lower factors ``fa`` [B, n, n]."""
    y = torch.linalg.solve_triangular(fa, rhs, upper=False)
    return torch.linalg.solve_triangular(fa.mT, y, upper=True)


def _ragged_chol(a, b, sizes, plan: RaggedPlan, abft: bool = False):
    """chol_solve's fast rung through batch_potrf (K6), with its in-batch
    checksum rungs under ``abft``, and its health, on the device."""
    fa, counts = _bk.batch_potrf(a, sizes, nb=plan.nb, bw=plan.bw,
                                 abft=abft)
    x = _chol_solves(fa, b)
    h1 = _bk.chol_health(fa)._replace(
        abft_detected=counts.detected, abft_corrected=counts.corrected,
        abft_site=counts.site)
    return x, _demote_batch(_h.batch_merge(h1, _h.batch_from_result(x)),
                            a.dtype)


def _ragged_lstsq(a, b, sizes, plan: RaggedPlan):
    """least_squares_solve's fast rung through batch_gels (K8): ragged
    Householder QR, rank-revealing on |diag R|, and its health, on the
    device."""
    n = a.shape[2]
    x, packed = _bk.batch_gels(a, b, sizes, nb=plan.nb, bw=plan.bw)
    d = torch.diagonal(packed[:, :n, :n], dim1=1, dim2=2)
    return x, _demote_batch(_h.batch_merge(_h.batch_from_pivots(d),
                                           _h.batch_from_result(x)), a.dtype)


def _ragged_part(op: str, plan: RaggedPlan, opts: Options | None):
    """The device part of ``op``'s ragged fast rung: ``fn(a, b, sizes) ->
    (x, BatchHealth)`` on f32 working copies of the packed stacks."""
    abft = resolve_abft(opts)

    def fn(a, b, sizes):
        a, b = _prec.promote(a), _prec.promote(b)
        if op == "solve":
            return _ragged_solve(a, b, sizes, plan)
        if op == "chol_solve":
            return _ragged_chol(a, b, sizes, plan, abft)
        return _ragged_lstsq(a, b, sizes, plan)
    return fn


# ---------------------------------------------------- precision rung


def _fro_batch(v: torch.Tensor) -> torch.Tensor:
    """Per-problem Frobenius norms of a [B, m, n] stack, f32."""
    v = _prec.promote(v)
    return torch.sqrt((v * v).sum(dim=(1, 2)))


def _bf16_chol_attempt(a, b, sizes, plan, opts: Options | None):
    """bf16 Cholesky attempt: factor the demoted bucket (K6 on bf16 under
    a bf16 plan, a whole-bucket ``cholesky_ex`` otherwise, a failed factor
    NaN-filled as XLA's is), solve and 2 IR sweeps in f32 against the
    ORIGINAL operands, certify each problem."""
    al = _prec.demote(a)
    if plan is not None:
        fa = _prec.promote(_bk.batch_potrf(al, sizes, nb=plan.nb,
                                           bw=plan.bw)[0])
    else:
        L, info = torch.linalg.cholesky_ex(_prec.promote(al))
        L = L.masked_fill((info != 0)[:, None, None], float("nan"))
        fa = _prec.promote(_prec.demote(L))     # bf16 factor storage
    x = _chol_solves(fa, b)
    for _ in range(2):                     # f32 IR against the ORIGINAL a
        x = x + _chol_solves(fa, b - a @ x)
    cert = _cert.certify_solve(_fro_batch(a), x, b, b - a @ x, iters=2)
    h1 = _h.batch_merge(_bk.chol_health(fa), cert, _h.batch_from_result(x))
    return x, _demote_batch(h1, a.dtype)


def _bf16_solve_attempt(a, b, sizes, plan, opts: Options | None):
    """bf16 LU attempt: ragged NoPiv batch_getrf (K7 on bf16) of the
    demoted bucket (a whole-bucket partial-pivot ``lu_factor_ex`` when no
    bf16 plan resolves), f32 solves and 2 IR sweeps against the original
    operands, per-problem certificate."""
    al = _prec.demote(a)
    if plan is not None:
        fal = _bk.batch_getrf(al, sizes, nb=plan.nb, bw=plan.bw)

        def getrs(rhs):
            return _bk.batch_getrs(fal, rhs)
        fh = _bk.lu_health(a, _prec.promote(fal))
    else:
        lu, perm = panel_lu(_prec.promote(al))
        fa = _prec.promote(_prec.demote(lu))    # bf16 factor storage

        def getrs(rhs):
            pb = rhs.gather(1, perm[:, :, None].expand_as(rhs))
            y = torch.linalg.solve_triangular(fa, pb, upper=False,
                                              unitriangular=True)
            return torch.linalg.solve_triangular(fa, y, upper=True)
        fh = _bk.lu_health(a, fa)
    x = getrs(b)
    for _ in range(2):                     # f32 IR against the ORIGINAL a
        x = x + getrs(b - a @ x)
    cert = _cert.certify_solve(_fro_batch(a), x, b, b - a @ x, iters=2)
    h1 = _h.batch_merge(fh, cert, _h.batch_from_result(x))
    return x, _demote_batch(h1, a.dtype)


def _bf16_lstsq_attempt(a, b, sizes, plan, opts: Options | None):
    """bf16 least-squares attempt: ragged batch_gels (K8 on bf16) of the
    demoted bucket (a whole-bucket ``torch.linalg.qr`` when no bf16 plan
    resolves), two corrected-semi-normal-equations sweeps through the bf16
    R in f32 against the original operands, per-problem normal-equations
    certificate."""
    n = a.shape[2]
    al = _prec.demote(a)
    if plan is not None:
        x, packed = _bk.batch_gels(al, b, sizes, nb=plan.nb, bw=plan.bw)
        R = _prec.promote(packed[:, :n, :n])
    else:
        q, r = torch.linalg.qr(_prec.promote(al))
        R = _prec.promote(_prec.demote(r))     # bf16 factor storage
        qtb = _prec.promote(_prec.demote(q)).mT @ b
        x = torch.linalg.solve_triangular(R, qtb, upper=True)
    at = a.mT

    def csne(rhs):                         # R^T R dx = A^T rhs (Bjorck)
        z = torch.linalg.solve_triangular(R.mT, at @ rhs, upper=False)
        return torch.linalg.solve_triangular(R, z, upper=True)

    for _ in range(2):                     # f32 CSNE against ORIGINAL a
        x = x + csne(b - a @ x)
    cert = _cert.certify_lstsq(_fro_batch(a), x, b, at @ (b - a @ x))
    d = torch.diagonal(R, dim1=1, dim2=2).abs()
    # a backward-error gate that a rank-collapsed rounding can pass (a huge
    # ||x|| swamps the denominator): fold a conditioning estimate through
    # R's diagonal into growth, so that those problems escalate
    piv = _h.batch_from_pivots(d)._replace(growth=(_fro_batch(a) / torch.clamp(
        d.amin(dim=1), min=torch.finfo(R.dtype).tiny)).double())
    h1 = _h.batch_merge(piv, cert, _h.batch_from_result(x))
    return x, _demote_batch(h1, a.dtype)


BF16_ATTEMPTS = {
    "solve": _bf16_solve_attempt,
    "chol_solve": _bf16_chol_attempt,
    "least_squares_solve": _bf16_lstsq_attempt,
}


class BatchPart(NamedTuple):
    """One device part of a bucket's batch program: ``fn(a, b, sizes) ->
    (x, BatchHealth)`` of the packed stacks, with no host read; ``ragged``
    marks a part whose factor runs through K6, K7 or K8, which
    serve/cache.py captures as a CUDA graph on the card (the whole-bucket
    library factor of a bf16 attempt without a bf16 plan runs eagerly)."""
    fn: object
    ragged: bool


class BatchProgram(NamedTuple):
    """One bucket's batched core, split at its host read: the device
    ``parts`` by name ("f32": the ragged fast rung of the f32 ladder;
    "low": the bf16 attempt of the precision rung) and ``host(a, b, sizes,
    run)``, which gets a part's ``(x, BatchHealth)`` from ``run(name)``,
    reads the health once and runs the escalations eagerly, returning
    ``(x, [HealthInfo], [escalated])``.  ``route`` names the f32 ladder's
    route: "ragged" or "per_problem" (every problem through the
    single-problem drivers, eager on both devices)."""
    parts: dict
    host: object
    route: str


def batch_program(op: str, opts: Options | None, a: torch.Tensor
                  ) -> BatchProgram:
    """The batch program of ``op`` for buckets shaped, typed and placed as
    ``a`` [B, mb, nb].  Routing (the plans and the kernels' gates) is
    decided here, once, from the shape, dtype and device alone.

    bf16 operands take the certified precision rung always (promoted f32
    working copies, results demoted back), and so do f32 operands under
    ``Option.Precision = bf16``: the bf16 attempt ("low") runs first, and
    when a problem fails its certificate the f32 ladder runs on the whole
    batch, as the reference's select computes it, so the escalated
    problems get results bit-identical to the same batch served with the
    rung off.  f64 serves on the per-problem route."""
    if op not in CORES:
        raise ValueError(f"make_batched: unknown op {op!r} (known: "
                         f"{tuple(CORES)})")
    dtype = _prec.normalize_dtype(a.dtype, supported=SERVE_DTYPES)
    low = dtype == _prec.LOW
    bf16_rung = low or (_prec.resolve_precision(opts) and dtype == _prec.HIGH)
    parts = {}
    plan = _ragged_plan(op, a, opts, dtype=_prec.HIGH if low else None)
    if plan is not None:
        parts["f32"] = BatchPart(_ragged_part(op, plan, opts), True)
    if bf16_rung:
        plan_lo = _ragged_plan(op, a, opts, dtype=_prec.LOW)
        attempt = BF16_ATTEMPTS[op]

        def low_fn(a, b, sizes):
            return attempt(_prec.promote(a), _prec.promote(b), sizes,
                           plan_lo, opts)
        parts["low"] = BatchPart(low_fn, plan_lo is not None)

    def f32_route(a, b, sizes, run):
        if plan is None:
            return _per_problem(op, a, b, opts)
        x, h1 = run("f32")
        return _escalate(op, h1.to_list(), x, a, b, opts)

    def host(a, b, sizes, run):
        if low:
            a, b = _prec.promote(a), _prec.promote(b)
        if not bf16_rung:
            return f32_route(a, b, sizes, run)
        x1, h1 = run("low")
        h1 = h1.to_list()
        esc = [not _h.acceptable(h, a.dtype) for h in h1]
        if any(esc):
            x32, h32, _ = f32_route(a, b, sizes, run)
            pick = torch.tensor(esc, device=x1.device)[:, None, None]
            x1 = torch.where(pick, x32, x1)
            h1 = [h32[i] if e else h1[i] for i, e in enumerate(esc)]
        return (_prec.demote(x1) if low else x1), h1, esc

    return BatchProgram(parts, host,
                        "ragged" if plan is not None else "per_problem")


def make_batched(op: str, opts: Options | None = None):
    """The batched core of one op, run eagerly: ``fn(a, b, sizes) -> (x,
    [HealthInfo], [escalated])`` on tensors of one device.

    ``sizes`` [B] int32 holds each problem's live size (n for square
    solves, m + (nb - n) live rows for least squares, 0 for filler slots);
    the ragged route reads it on the device, the per-problem route solves
    the whole padded bucket and ignores it.  ``Option.Precision = bf16``
    (resolved once here) inserts the certified bf16 rung below the f32
    ladder for f32 buckets; bf16 operands take the same rung always.  f64
    serves on the per-problem route; any other dtype raises
    SlateUnsupportedDtypeError.  Under ``Option.Abft = On`` only
    ``chol_solve`` stays on the ragged route (batch_potrf's in-batch
    rungs); the other ops take the per-problem drivers, which carry the
    rungs, as the reference routes them.  serve/cache.py runs the same
    :func:`batch_program` with its device parts replayed from CUDA graphs
    on the card."""
    if op not in CORES:
        raise ValueError(f"make_batched: unknown op {op!r} (known: "
                         f"{tuple(CORES)})")

    def fn(a, b, sizes):
        prog = batch_program(op, opts, a)
        return prog.host(a, b, sizes,
                         lambda name: prog.parts[name].fn(a, b, sizes))

    return fn
