"""The port's Cholesky solve (slate_tpu_torch.posv/potrf/potrs) against
slate_tpu's, on the CPU.

The reference's public drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only
(the reference package itself is not edited).  The reference ships no
Pallas route by default (its plan resolves to XLA), so each parity test
forces the route it compares with ``plan_override``; the port takes its
kernels by default, and on CPU tensors each kernel runs its plain version.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch.convert import matrix_from_jax

N, NB, NRHS = 384, 128, 4
# f32 parity tolerance: both sides are backward-stable Cholesky solves of the
# same bytes with sums in another order; cond(A) <= ~2 here, so the forward
# difference is a few n eps relative to max|X| (n eps = 4.6e-5).
F32_RTOL = 1e-4


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _problem(seed, n=N, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a0 = rng.standard_normal((n, n)) * 0.1
    a = (a0 @ a0.T + n * 0.01 * np.eye(n) + np.eye(n)).astype(dtype)
    b = rng.standard_normal((n, NRHS)).astype(dtype)
    return a, b


def _ref_posv(a, b, uplo="Lower", opts=None):
    A = ref.SymmetricMatrix.from_numpy(a, NB, getattr(ref.Uplo, uplo))
    B = ref.Matrix.from_numpy(b, NB)
    return A, ref.posv(A, B, opts)


def _port_posv(A_ref, b, opts=None):
    """posv on the very bytes of the reference's matrix (convert.py)."""
    A = matrix_from_jax(A_ref, device="cpu")
    B = st.Matrix.from_numpy(b, NB, device="cpu")
    return st.posv(A, B, opts)


def _close(got, want, rtol):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


FUSED = ("potrf_panel", RefPlan("pallas", NB, 8))
TILE = ("potrf_tile", RefPlan("pallas", NB, 8))


@pytest.mark.parametrize("route,uplo", [("fused", "Lower"),
                                        ("fused", "Upper"),
                                        ("tile", "Lower")])
def test_posv_matches_reference_on_each_pallas_route(ref_drivers, route,
                                                     uplo):
    """fused: the reference's chol_panel_fused (interpret) against the
    port's default K2 route; tile: chol_tile_pallas against the port's K1
    route (the fused panel's plan set to the library)."""
    a, b = _problem(11)
    with ref_override(*(FUSED if route == "fused" else TILE)):
        A, (Lr, Xr) = _ref_posv(a, b, uplo)
    if route == "fused":
        L, X = _port_posv(A, b)
    else:
        with st.plan_override("potrf_panel", st.LIBRARY_PLAN):
            L, X = _port_posv(A, b)
    assert type(L) is st.TriangularMatrix
    assert L._uplo_logical().value == Lr._uplo_logical().value
    _close(L.to_numpy(), Lr.to_numpy(), F32_RTOL)
    _close(X.to_numpy(), Xr.to_numpy(), F32_RTOL)
    x64 = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    _close(X.to_numpy(), x64, F32_RTOL)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_posv_f64_and_complex_take_the_library_route(ref_drivers, dtype):
    a, b = _problem(12, dtype=dtype)
    if np.iscomplexobj(a):
        g = np.random.default_rng(19).standard_normal((N, N)) * 0.05
        a = a + 1j * (g - g.T)                    # Hermitian, still HPD
        b = b + 1j * b[::-1]
    A = ref.HermitianMatrix.from_numpy(a, NB)
    Lr, Xr = ref.posv(A, ref.Matrix.from_numpy(b, NB))
    L, X = _port_posv(A, b)
    assert X.dtype == torch.from_numpy(b).dtype
    np.testing.assert_allclose(L.to_numpy(), Lr.to_numpy(), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(X.to_numpy(), Xr.to_numpy(), rtol=1e-11,
                               atol=1e-12)


def _not_spd(seed):
    a, b = _problem(seed)
    a[200, 200] = -50.0            # leading minor of order 201 fails
    return a, b


def _opts(pkg, **kv):
    return {getattr(pkg.Option, k): v for k, v in kv.items()}


def test_posv_not_spd_reports_the_reference_info(ref_drivers):
    """Under ErrorPolicy.Info both packages report the same 1-based index
    of the first bad pivot; under Raise both raise the typed error."""
    a, b = _not_spd(13)
    info_r = _opts(ref, UseFallbackSolver=False,
                   ErrorPolicy=ref.ErrorPolicy.Info)
    info_p = _opts(st, UseFallbackSolver=False,
                   ErrorPolicy=st.ErrorPolicy.Info)
    with ref_override(*FUSED):
        A, (_, _, hr) = _ref_posv(a, b, opts=info_r)
        with pytest.raises(ref.SlateNotPositiveDefiniteError) as er:
            _ref_posv(a, b, opts=_opts(ref, UseFallbackSolver=False))
    _, _, h = _port_posv(A, b, info_p)
    assert h.info == int(hr.info) == 201
    assert h.nonfinite and not h.ok
    with pytest.raises(st.SlateNotPositiveDefiniteError) as ep:
        _port_posv(A, b, _opts(st, UseFallbackSolver=False))
    assert ep.value.info == er.value.info == 201
    with ref_override(*TILE):
        _, (_, _, hr_tile) = _ref_posv(a, b, opts=info_r)
    with st.plan_override("potrf_panel", st.LIBRARY_PLAN):
        _, _, h_tile = _port_posv(A, b, info_p)
    assert h_tile.info == int(hr_tile.info) == 201


def test_posv_not_spd_with_fallback_solver_returns_hefactors(ref_drivers):
    """With Option.UseFallbackSolver (the default) a matrix that is not
    positive definite takes the reference's next rung, hesv (blocked
    Aasen), where this slice used to raise NotImplementedError: both
    packages return HEFactors.  f32 Aasen solves sit ~2e-4 from the f64
    solution on this matrix (the reference's own: 1.9e-4), and the two
    packages' f32 pivot choices may differ on rounding, so each solve is
    held to 1e-3 of the f64 solution."""
    a, b = _not_spd(14)
    A_ref, (F_ref, X_ref) = _ref_posv(a, b)
    F, X = _port_posv(A_ref, b)
    assert type(F).__name__ == type(F_ref).__name__ == "HEFactors"
    x64 = np.linalg.solve(a.astype(np.float64), b)
    _close(np.asarray(X_ref.to_numpy()), x64, 1e-3)
    _close(X.to_numpy(), x64, 1e-3)


def test_error_policy_nan_poisons_and_potrf_potrs_split():
    a, b = _not_spd(15)
    A = st.SymmetricMatrix.from_numpy(a, NB, device="cpu")
    B = st.Matrix.from_numpy(b, NB, device="cpu")
    L, X = st.posv(A, B, _opts(st, UseFallbackSolver=False,
                               ErrorPolicy=st.ErrorPolicy.Nan))
    assert torch.isnan(L.storage.data).all()
    assert np.isnan(X.to_numpy()).all()
    a, b = _problem(16, n=300)               # ragged last tile
    A = st.HermitianMatrix.from_numpy(a, NB, device="cpu")
    B = st.Matrix.from_numpy(b, NB, device="cpu")
    L = st.potrf(A)
    X = st.potrs(L, B)
    np.testing.assert_allclose(L.to_numpy(), np.linalg.cholesky(a),
                               rtol=0, atol=1e-5)
    _close(X.to_numpy(), np.linalg.solve(a.astype(np.float64), b), F32_RTOL)


@pytest.mark.parametrize("opts,what", [
    ({"Abft": "on"}, "Abft"),
    ({"HoldLocalWorkspace": True}, "HoldLocalWorkspace"),
    ({"Speculate": "on", "Precision": "bf16"}, "bf16"),
    ({"Target": "mesh"}, "mesh"),
])
def test_unported_options_raise_not_implemented(opts, what):
    """The options the port once did not carry raised NotImplementedError
    naming them; Abft, HoldLocalWorkspace (on CPU tensors its eager body),
    the bf16 rung and Target.mesh, ported since, solve instead (mesh on a
    grid without a process group takes the single route, as the
    reference's posv does when its grid has no mesh)."""
    a, b = _problem(17, n=128)
    A = st.SymmetricMatrix.from_numpy(a, 64, device="cpu")
    B = st.Matrix.from_numpy(b, 64, device="cpu")
    if what in ("Abft", "HoldLocalWorkspace", "bf16", "mesh"):
        _, X = st.posv(A, B, _opts(st, **opts))
        _close(X.to_numpy(), np.linalg.solve(a.astype(np.float64), b),
               F32_RTOL)
        return
    with pytest.raises(NotImplementedError, match=what):
        st.posv(A, B, _opts(st, **opts))


def test_fault_sites_raise_not_implemented():
    """Fault injection is ported: a plan arms its site for the block (an
    unknown site still raises, ValueError as in the reference), and a
    persistent input strike fails the factor, read as its health."""
    from slate_tpu_torch.robust import faults
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan("nowhere")
    a, b = _problem(18, n=128)
    A = st.SymmetricMatrix.from_numpy(a, 64, device="cpu")
    # tile (1, 0) of 64: below the diagonal, where potrf reads A
    with faults.inject(faults.FaultPlan("input", kind="nan", tile=(1, 0),
                                        nb=64)):
        _, h = st.potrf(A, _opts(st, ErrorPolicy=st.ErrorPolicy.Info))
    assert h.nonfinite and not h.ok
    _, h = st.potrf(A, _opts(st, ErrorPolicy=st.ErrorPolicy.Info))
    assert h.ok


def _queue3(dtype):
    """The probe matrix: n = 256, A = G G^T + n I with A[200, 200] = -1e4,
    so the leading minor of order 201 is the first that fails."""
    g = np.random.default_rng(0).standard_normal((256, 256))
    a = g @ g.T + 256 * np.eye(256)
    a[200, 200] = -1e4
    return a.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_potrf_info_is_the_first_failing_minor_in_every_dtype(dtype,
                                                             monkeypatch):
    """f32 (K1's plain version), f64 and complex64 (cholesky_ex on each
    tile) report the same info, 201: the LAPACK-style index of the first
    bad diagonal that both docstrings promise.  The reference's XLA route
    NaN-fills a failed tile whole and so reports the tile's first row, 129
    at nb = 128; the frozen reference keeps that.  The serving layer's
    per-problem route runs the same potrf_tile: its Cholesky attempt reads
    201 too before the problem escalates to LU."""
    from slate_tpu_torch.serve import batched as sb
    a = _queue3(dtype)
    A = st.HermitianMatrix.from_numpy(a, 128, device="cpu")
    _, h = st.potrf(A, _opts(st, ErrorPolicy=st.ErrorPolicy.Info))
    assert h.info == 201 and not h.ok
    if dtype is np.complex64:        # the serving boundary takes real dtypes
        return
    seen = []
    real = sb._chol.potrf

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[1].info)
        return out
    monkeypatch.setattr(sb._chol, "potrf", spy)
    b = np.ones((256, 2), dtype)
    with st.plan_override("batch_potrf", st.LIBRARY_PLAN):
        _, hs, esc = sb.make_batched("chol_solve")(
            torch.from_numpy(a)[None], torch.from_numpy(b)[None],
            torch.tensor([256], dtype=torch.int32))
    assert seen == [201] and esc == [True]
