"""The port's mixed-precision solvers against slate_tpu's, on the CPU:
gesv_mixed, posv_mixed and their GMRES-IR variants, with the options they
read (MaxIterations, Tolerance, UseFallbackSolver, Speculate).

The same numpy inputs, from a seed, go through both packages, f64 (and
c128) systems factored in f32 (c64).  Held: the same ``iters`` and
``converged`` (GMRES included, which tests convergence at the start of a
restart cycle, so a converged x costs one more cycle), the same health
flags, and X within 1e-12 relative.  An f32 system would factor in bf16,
which the reference refuses on the CPU (XLA: unsupported dtype); the
port raises SlateUnsupportedDtypeError.  The reference's drivers are
wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``; the
installed JAX no longer exports that name, so the ``ref_drivers``
fixture restores it on the test side only.
"""

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref

import slate_tpu_torch as st
from slate_tpu_torch.drivers import mixed
from slate_tpu_torch.types import lower_precision

RTOL = 1e-12
SOLVERS = ("posv_mixed", "posv_mixed_gmres", "gesv_mixed",
           "gesv_mixed_gmres")


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _problem(seed, n, nrhs=3, dtype=np.float64, kind="spd", scale=None):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    b = rng.standard_normal((n, nrhs))
    if np.issubdtype(dtype, np.complexfloating):
        g = g + 1j * rng.standard_normal((n, n))
        b = b + 1j * rng.standard_normal((n, nrhs))
    if kind == "spd":
        a = g @ g.conj().T + n * np.eye(n)
    elif kind == "orthogonal":
        a = np.linalg.qr(g)[0]
    else:                                   # ill-conditioned general
        u, _, vt = np.linalg.svd(g)
        a = (u * np.logspace(0, -kind, n)) @ vt
    if scale is not None:
        b = b * np.asarray(scale)[None, :]
    return a.astype(dtype), b.astype(dtype)


def _run(fn, a, b, nb, opts=None):
    """(reference MixedResult, port MixedResult) of one solver."""
    herm = fn.startswith("posv")
    cls = "HermitianMatrix" if herm else "Matrix"
    o_r = {getattr(ref.Option, k): v for k, v in (opts or {}).items()}
    o_p = {getattr(st.Option, k): v for k, v in (opts or {}).items()}
    rr = getattr(ref, fn)(getattr(ref, cls).from_numpy(a, nb),
                          ref.Matrix.from_numpy(b, nb), o_r or None)
    rp = getattr(st, fn)(getattr(st, cls).from_numpy(a, nb, device="cpu"),
                         st.Matrix.from_numpy(b, nb, device="cpu"),
                         o_p or None)
    return rr, rp


def _agree(rr, rp, rtol=RTOL):
    assert rp.iters == int(rr.iters)
    assert rp.converged == bool(rr.converged)
    assert rp.health.ok == bool(rr.health.ok)
    assert rp.health.iters == int(rr.health.iters)
    xr, xp = np.asarray(rr.X.to_numpy()), rp.X.to_numpy()
    assert xp.shape == xr.shape
    assert np.abs(xp - xr).max() <= rtol * np.abs(xr).max()


@pytest.mark.parametrize("fn", SOLVERS)
@pytest.mark.parametrize("n,nb", [(64, 16), (70, 16), (33, 8)])
def test_mixed_matches_the_reference(fn, n, nb):
    a, b = _problem(n, n, kind="spd" if fn.startswith("posv")
                    else "orthogonal")
    rr, rp = _run(fn, a, b, nb)
    _agree(rr, rp)
    assert rp.converged and rp.X.dtype == torch.float64


@pytest.mark.parametrize("fn", SOLVERS)
def test_mixed_complex128(fn):
    a, b = _problem(5, 40, dtype=np.complex128,
                    kind="spd" if fn.startswith("posv") else "orthogonal")
    rr, rp = _run(fn, a, b, 8)
    _agree(rr, rp)
    assert rp.X.dtype == torch.complex128


def test_gmres_reports_the_late_stop():
    """GMRES tests convergence at the start of a cycle: a system that
    converges within two cycles reports 30 iterations in both packages
    (the third cycle only finds it converged), and the stop flag is read
    once a cycle plus once before the first."""
    a, b = _problem(6, 48)
    mixed.STOP_READS = 0
    rr, rp = _run("posv_mixed_gmres", a, b, 16)
    assert rp.iters == int(rr.iters) == 30 and rp.converged
    assert mixed.STOP_READS == 4


def test_gmres_late_stop_exhausts_the_iterations_at_n512():
    """An orthogonal A at n = 512: each GMRES cycle gains ~4-5 digits (its
    update goes through the f32 solve), so x converges in the third cycle
    and the start-of-cycle test would find it only in a fourth; at the
    default MaxIterations = 30 both packages report converged=False, and
    with MaxIterations = 60 both stop at 40, converged."""
    a, b = _problem(13, 512, nrhs=2, kind="orthogonal")
    for itmax, conv in ((30, False), (60, True)):
        rr, rp = _run("gesv_mixed_gmres", a, b, 128,
                      {"UseFallbackSolver": False, "MaxIterations": itmax})
        _agree(rr, rp, RTOL if conv else 1e-5)
        assert rp.converged is conv
        assert rp.iters == (30 if itmax == 30 else 40)


def test_refine_reads_its_stop_flag_once_a_step():
    a, b = _problem(7, 48)
    mixed.STOP_READS = 0
    rr, rp = _run("posv_mixed", a, b, 16)
    assert mixed.STOP_READS == rp.iters + 1 == int(rr.iters) + 1


@pytest.mark.parametrize("fn", SOLVERS)
def test_fallback_after_max_iterations(fn):
    """One refinement step (one GMRES cycle) cannot reach a tolerance of
    1e-30: the loop stops unconverged and UseFallbackSolver re-solves in
    f64 (X within 1e-12); without it the result reports converged=False
    and X is the refined f32 solve, which carries the f32 factor's
    rounding (the two packages' f32 factors differ in their last bits),
    so it is held within 1e-5, the f32 tolerance."""
    a, b = _problem(8, 40, kind="spd" if fn.startswith("posv")
                    else "orthogonal")
    for fb in (True, False):
        opts = {"MaxIterations": 1 if "gmres" not in fn else 10,
                "Tolerance": 1e-30, "UseFallbackSolver": fb}
        rr, rp = _run(fn, a, b, 8, opts)
        _agree(rr, rp, RTOL if fb else 1e-5)
        assert rp.converged is fb


@pytest.mark.parametrize("fn", ["gesv_mixed", "gesv_mixed_gmres"])
def test_ill_conditioned_falls_back(fn):
    """cond 1e9: the f32 factor cannot refine to f64 within 30 steps
    (gesv_mixed) or 3 cycles (GMRES); both packages fall back alike.  An
    f64 solve of a system with cond 1e9 is determined to ~1e9 eps, so the
    two X agree within 1e-12 * cond, and each has a backward error under
    1e-14."""
    a, b = _problem(9, 48, kind=9)
    rr, rp = _run(fn, a, b, 16)
    _agree(rr, rp, RTOL * 1e9)
    for x in (rp.X.to_numpy(), np.asarray(rr.X.to_numpy())):
        res = np.abs(b - a @ x).max() / (np.abs(a).sum(1).max()
                                         * np.abs(x).max())
        assert res <= 1e-14


def test_per_column_stop_test():
    """Columns of B scaled 1e-8 .. 1e8 apart: the stop test is per column
    (colNorms), so both packages take the same number of steps."""
    a, b = _problem(10, 48, nrhs=4, kind="orthogonal",
                    scale=[1e-8, 1.0, 1e4, 1e8])
    rr, rp = _run("gesv_mixed", a, b, 16)
    _agree(rr, rp)


def test_gesv_mixed_speculate_takes_the_rbt_factor():
    a, b = _problem(11, 64)
    a = a + 64 * np.eye(64)
    rr, rp = _run("gesv_mixed", a, b, 16, {"Speculate": "on"})
    _agree(rr, rp)
    assert rp.converged


def test_lower_precision_table():
    assert lower_precision(torch.float64) == torch.float32
    assert lower_precision(torch.complex128) == torch.complex64
    assert lower_precision(torch.float32) == torch.bfloat16
    assert lower_precision(torch.int32) == torch.int32


@pytest.mark.parametrize("fn", SOLVERS)
def test_f32_system_raises_unsupported_dtype(fn):
    """An f32 system factors in bf16: the reference's factorizations raise
    on the CPU (XLA has no bf16 Cholesky or LU there), and the port raises
    SlateUnsupportedDtypeError naming bfloat16 rather than factor in f32."""
    a, b = _problem(12, 32, kind="spd")
    a, b = a.astype(np.float32), b.astype(np.float32)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        _run_ref_only(fn, a, b)
    herm = fn.startswith("posv")
    A = (st.HermitianMatrix if herm else st.Matrix).from_numpy(
        a, 8, device="cpu")
    with pytest.raises(st.SlateUnsupportedDtypeError) as e:
        getattr(st, fn)(A, st.Matrix.from_numpy(b, 8, device="cpu"))
    assert e.value.dtype == "bfloat16"


def _run_ref_only(fn, a, b):
    cls = ref.HermitianMatrix if fn.startswith("posv") else ref.Matrix
    return getattr(ref, fn)(cls.from_numpy(a, 8), ref.Matrix.from_numpy(b, 8))
