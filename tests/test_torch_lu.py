"""The port's LU solvers (slate_tpu_torch.getrf/getrs/gesv/getri/...) against
slate_tpu's, on the CPU.

The reference's public drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
The reference runs its default plan, XLA everywhere (its Pallas LU panel
is inaccurate on pivoted U, tests/test_torch_lu_kernels.py); the port takes
its kernels by default, and on CPU tensors each kernel runs its plain
version.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu.drivers.lu import LUFactors as RefLUFactors
from slate_tpu.internal import rbt as ref_rbt

import slate_tpu_torch as st
from slate_tpu_torch.convert import (lu_factors_from_jax, matrix_from_jax,
                                     rbt_factors_from_jax)
from slate_tpu_torch.drivers import lu as dl
from slate_tpu_torch.internal import rbt

NB, NRHS = 128, 4
# f32 parity: both sides are blocked LU solves of the same bytes with the
# same pivots and sums in another order.  On the orthogonal and the
# diagonally dominant matrices below (cond <= ~10) the factors and the
# solutions agree to a few n eps of their largest entry (n eps = 6e-5 at
# n = 512); 1e-4 of max|.| holds that with room.
F32_RTOL = 1e-4


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _orthogonal(seed, n):
    """Q of a Gaussian's QR: cond 1, and every column a real pivot choice
    (the chip smoke's matrix, scaled so that entries are O(1))."""
    g = np.random.default_rng(seed).standard_normal((n, n))
    return (np.linalg.qr(g)[0] * np.sqrt(n)).astype(np.float32)


def _dominant(seed, n):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a + 2 * np.sqrt(n) * np.eye(n)).astype(np.float32)


def _rhs(seed, n):
    return np.random.default_rng(seed + 1).standard_normal((n, NRHS)).astype(
        np.float32)


def _close(got, want, rtol=F32_RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _opts(pkg, **kv):
    return {getattr(pkg.Option, k): v for k, v in kv.items()}


def _port(M):
    return matrix_from_jax(M, device="cpu")


@pytest.mark.parametrize("name,n,make", [
    ("getrf", 384, _orthogonal), ("getrf_nopiv", 512, _dominant),
    ("getrf_tntpiv", 512, _orthogonal), ("getrf_tntpiv", 300, _orthogonal),
    ("getrf_nopiv", 300, _dominant)])
def test_getrf_variants_match_reference(ref_drivers, name, n, make):
    """perm exact, the packed factor within F32_RTOL, the same health;
    n = 300 is ragged (a padded K3 panel, a sentinel-padded tournament)."""
    A = ref.Matrix.from_numpy(make(n, n), NB)
    opts_r = _opts(ref, ErrorPolicy=ref.ErrorPolicy.Info)
    opts_p = _opts(st, ErrorPolicy=st.ErrorPolicy.Info)
    Fr, hr = getattr(ref, name)(A, opts_r)
    F, h = getattr(st, name)(_port(A), opts_p)
    assert isinstance(F, st.LUFactors)
    np.testing.assert_array_equal(F.perm.numpy(), np.asarray(Fr.perm))
    _close(F.LU.to_numpy(), Fr.LU.to_numpy())
    assert h.ok and bool(hr.ok) and h.info == int(hr.info) == 0
    assert h.min_pivot_index == int(hr.min_pivot_index)
    np.testing.assert_allclose(h.growth, float(hr.growth), rtol=1e-4)


@pytest.mark.parametrize("method,make", [
    ("CALU", _orthogonal), ("PartialPiv", _orthogonal), ("NoPiv", _dominant),
    ("Auto", _orthogonal)])
def test_gesv_matches_reference(ref_drivers, method, make):
    """The CALU solve against the reference's XLA route: perm exact, X
    within 1e-4 relative (and of the f64 solution)."""
    n = 512
    a, b = make(3, n), _rhs(3, n)
    A = ref.Matrix.from_numpy(a, NB)
    Fr, Xr = ref.gesv(A, ref.Matrix.from_numpy(b, NB),
                      _opts(ref, MethodLU=getattr(ref.MethodLU, method)))
    F, X = st.gesv(_port(A), st.Matrix.from_numpy(b, NB, device="cpu"),
                   _opts(st, MethodLU=getattr(st.MethodLU, method)))
    np.testing.assert_array_equal(F.perm.numpy(), np.asarray(Fr.perm))
    _close(X.to_numpy(), Xr.to_numpy())
    _close(X.to_numpy(), np.linalg.solve(a.astype(np.float64), b))
    if method == "NoPiv":
        np.testing.assert_array_equal(F.perm.numpy(), np.arange(n))


def test_gesv_ladder_escalates_on_a_zero_leading_pivot(ref_drivers):
    """NoPiv meets A[0, 0] = 0: both packages find the attempt unhealthy,
    escalate to PartialPiv and report the same health of the final
    solve; gesv_nopiv returns the raw NoPiv attempt's failure."""
    n = 384
    a, b = _orthogonal(4, n), _rhs(4, n)
    a[0, 0] = 0.0
    A = ref.Matrix.from_numpy(a, NB)
    B = ref.Matrix.from_numpy(b, NB)

    def opts(pkg):
        return {pkg.Option.MethodLU: pkg.MethodLU.NoPiv,
                pkg.Option.ErrorPolicy: pkg.ErrorPolicy.Info}

    Fr, Xr, hr = ref.gesv(A, B, opts(ref))
    F, X, h = st.gesv(_port(A), st.Matrix.from_numpy(b, NB, device="cpu"),
                      opts(st))
    np.testing.assert_array_equal(F.perm.numpy(), np.asarray(Fr.perm))
    assert not np.array_equal(F.perm.numpy(), np.arange(n))    # pivoted
    _close(X.to_numpy(), Xr.to_numpy())
    for field in ("nonfinite", "info", "min_pivot_index", "iters",
                  "converged", "abft_detected"):
        assert getattr(h, field) == getattr(hr, field).item(), field
    np.testing.assert_allclose([h.min_pivot, h.growth],
                               [float(hr.min_pivot), float(hr.growth)],
                               rtol=1e-4)
    _, _, hr_raw = ref.gesv_nopiv(A, B, opts(ref))
    _, _, h_raw = st.gesv_nopiv(_port(A),
                                st.Matrix.from_numpy(b, NB, device="cpu"),
                                opts(st))
    assert not h_raw.ok and not bool(hr_raw.ok)
    assert h_raw.info > 0 and int(hr_raw.info) > 0


def test_singular_matrix_raises_with_the_reference_info(ref_drivers):
    n = 256
    a, b = _orthogonal(5, n), _rhs(5, n)
    a[:, 5] = 0.0                               # column 5: no pivot at all
    A = ref.Matrix.from_numpy(a, NB)
    with pytest.raises(ref.SlateSingularError) as er:
        ref.getrf(A)
    with pytest.raises(st.SlateSingularError) as ep:
        st.getrf(_port(A))
    assert ep.value.info == er.value.info == 6
    # gesv without the ladder: the PartialPiv attempt's info (the CALU rung
    # would meet ties among zero rows, where the NaNs of the two routes
    # spread differently)
    with pytest.raises(ref.SlateSingularError) as er:
        ref.gesv(A, ref.Matrix.from_numpy(b, NB),
                 _opts(ref, UseFallbackSolver=False))
    with pytest.raises(st.SlateSingularError) as ep:
        st.gesv(_port(A), st.Matrix.from_numpy(b, NB, device="cpu"),
                _opts(st, UseFallbackSolver=False))
    assert ep.value.info == er.value.info == 6
    F, X = st.gesv(_port(A), st.Matrix.from_numpy(b, NB, device="cpu"),
                   _opts(st, ErrorPolicy=st.ErrorPolicy.Nan))
    assert np.isnan(X.to_numpy()).all() and np.isnan(F.LU.to_numpy()).all()
    assert isinstance(F, st.LUFactors) and F.perm.dtype == torch.int64


def test_getrf_threshold_pivoting_matches_reference(ref_drivers):
    a = _orthogonal(6, 256)
    A = ref.Matrix.from_numpy(a, NB)
    Fr = ref.getrf(A, _opts(ref, PivotThreshold=0.5))
    F = st.getrf(_port(A), _opts(st, PivotThreshold=0.5))
    np.testing.assert_array_equal(F.perm.numpy(), np.asarray(Fr.perm))
    _close(F.LU.to_numpy(), Fr.LU.to_numpy())


def test_getrf_rbt_draws_the_reference_butterflies_and_solves(ref_drivers):
    """The butterflies are bit for bit the reference's (same numpy seed);
    the transformed factor and the solve agree within F32_RTOL."""
    n = 300                                   # padded to 300 (a multiple of 4)
    a, b = _dominant(7, n), _rhs(7, n)
    for seed, dt, tdt in ((0x5B17, np.float32, torch.float32),
                          (3, np.float64, torch.float64)):
        got = rbt.generate(n, seed=seed, dtype=tdt)
        for (p0, p1), (q0, q1) in zip(got, ref_rbt.generate(n, seed=seed,
                                                             dtype=dt)):
            assert np.array_equal(p0.numpy(), np.asarray(q0))
            assert np.array_equal(p1.numpy(), np.asarray(q1))
    A = ref.Matrix.from_numpy(a, NB)
    Rr = ref.getrf_rbt(A)
    R = st.getrf_rbt(_port(A))
    assert isinstance(R, st.RBTFactors) and R.n == n
    for (p0, p1), (q0, q1) in zip(R.u + R.v, Rr.u + Rr.v):
        assert np.array_equal(p0.numpy(), np.asarray(q0))
        assert np.array_equal(p1.numpy(), np.asarray(q1))
    _close(R.F.LU.to_numpy(), Rr.F.LU.to_numpy())
    Br = ref.Matrix.from_numpy(b, NB)
    Xr = ref.getrs(Rr, Br)
    X = st.getrs(R, st.Matrix.from_numpy(b, NB, device="cpu"))
    _close(X.to_numpy(), Xr.to_numpy())
    _close(X.to_numpy(), np.linalg.solve(a.astype(np.float64), b))
    # the same factors carried across solve the same way
    Xc = st.getrs(rbt_factors_from_jax(Rr, device="cpu"),
                  st.Matrix.from_numpy(b, NB, device="cpu"))
    _close(Xc.to_numpy(), Xr.to_numpy())


def test_rbt_transform_round_trips():
    x = torch.from_numpy(_orthogonal(8, 64).astype(np.float64))
    u = rbt.generate(64, seed=1)
    v = rbt.generate(64, seed=2)
    back = rbt.untransform(rbt.transform(x, u, v), u, v)
    torch.testing.assert_close(back, x, rtol=0, atol=1e-12)
    torch.testing.assert_close(rbt.apply_left_inv(u, rbt.apply_left(u, x)),
                               x, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        rbt.generate(30)


def test_getri_and_getri_oop_match_reference(ref_drivers):
    n = 256
    a = _orthogonal(9, n)
    A = ref.Matrix.from_numpy(a, NB)
    Fr = ref.getrf(A)
    Xr = ref.getri(Fr)
    X = st.getri(lu_factors_from_jax(Fr, device="cpu"))
    _close(X.to_numpy(), Xr.to_numpy())
    Xo, h = st.getriOOP(_port(A), _opts(st, ErrorPolicy=st.ErrorPolicy.Info))
    Xor, hr = ref.getriOOP(A, _opts(ref, ErrorPolicy=ref.ErrorPolicy.Info))
    _close(Xo.to_numpy(), Xor.to_numpy())
    _close(Xo.to_numpy(), np.linalg.inv(a.astype(np.float64)))
    assert h.ok and h.info == int(hr.info) == 0
    # a singular factor: getri reports the reference's info
    lu = Fr.LU.to_numpy().copy()
    lu[7, 7] = 0.0
    Fs = RefLUFactors(ref.Matrix.from_numpy(lu, NB), Fr.perm)
    with pytest.raises(ref.SlateSingularError) as er:
        ref.getri(Fs)
    with pytest.raises(st.SlateSingularError) as ep:
        st.getri(lu_factors_from_jax(Fs, device="cpu"))
    assert ep.value.info == er.value.info == 8


def test_apply_row_perm_moves_only_the_displaced_rows():
    m = torch.arange(40.0).reshape(10, 4)
    perm = torch.tensor([3, 1, 2, 0, 4, 5, 9, 7, 8, 6])
    want = m[perm].clone()
    got = dl._apply_row_perm(m, perm, 4)
    assert got is m and torch.equal(m, want)


@pytest.mark.parametrize("opts,what", [
    ({"Speculate": "on"}, "item 6"),
    ({"Abft": "on"}, "Abft"),
    ({"Target": "mesh"}, "mesh"),
])
def test_unported_gesv_options_raise_not_implemented(opts, what):
    """Speculate (the certified RBT rung), Abft and Target.mesh, ported
    since, solve: mesh on a grid without a process group takes the single
    route, as the reference's gesv does when its grid has no mesh (on a
    grid with a group gesv takes the mesh route, ported with queue 1,
    item 12b: tests/test_torch_dist_lu.py)."""
    a, b = _dominant(10, 128), _rhs(10, 128)
    A = st.Matrix.from_numpy(a, 64, device="cpu")
    B = st.Matrix.from_numpy(b, 64, device="cpu")
    F, X = st.gesv(A, B, _opts(st, **opts))
    assert isinstance(F, st.RBTFactors if what == "item 6"
                      else st.LUFactors)
    _close(X.to_numpy(), np.linalg.solve(a.astype(np.float64), b))
