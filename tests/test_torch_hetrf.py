"""The port's Hermitian-indefinite layer against slate_tpu's, on the CPU:
hetrf (blocked Aasen), hetrs, hesv with its recovery ladder,
certify_ldlt, and posv's fallback to hesv and then gesv.

The same numpy inputs, from a seed, go through both packages.
Tolerances: f64 and c128 factors and solves within 1e-12 relative (the
symmetric permutation equal), f32 and c64 within 1e-5 where the two
packages' f32 pivot choices agree; the health record equal.  Two
reference hesv tests are red in the reference's own suite
(``test_hesv_zero_offdiag_block``; ``test_hesv_singularish`` in earlier
runs), so those cases are held against numpy/scipy instead.  The
reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import slate_tpu as ref
from slate_tpu.robust import certify as ref_certify
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import convert
from slate_tpu_torch.robust import certify, faults

RTOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _indef(seed, n, dtype=np.float64, shift=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    a = (a + a.conj().T) / 2
    if shift:
        a = a - np.mean(np.linalg.eigvalsh(a)) * np.eye(n)
    return a.astype(dtype)


def _rhs(seed, n, k, dtype=np.float64):
    rng = np.random.default_rng(seed + 1000)
    b = rng.standard_normal((n, k))
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal((n, k))
    return b.astype(dtype)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL[dtype] * np.abs(want).max()


def _mats(a, nb, cls="HermitianMatrix", uplo="Lower"):
    return (getattr(ref, cls).from_numpy(a, nb, getattr(ref.Uplo, uplo)),
            getattr(st, cls).from_numpy(a, nb, getattr(st.Uplo, uplo),
                                        device="cpu"))


# ------------------------------------------------------------- hetrf

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("n,nb", [(70, 16), (64, 16), (50, 8), (9, 4),
                                  (16, 16), (5, 8)])
def test_hetrf_matches_the_reference(dtype, n, nb):
    a = _indef(n + nb, n, dtype)
    R, P = _mats(a, nb)
    Fr, F = ref.hetrf(R), st.hetrf(P)
    assert torch.equal(F.piv, torch.from_numpy(np.asarray(Fr.piv)))
    assert F.nb == Fr.nb and F.n == n
    _close(F.L.numpy(), Fr.L, dtype)
    _close(F.Tdiag.numpy(), Fr.Tdiag, dtype)
    _close(F.T_dense().numpy(), Fr.T_dense(), dtype)
    _close(F.Tlu.numpy(), Fr.Tlu, dtype)
    assert torch.equal(F.Tperms, torch.from_numpy(np.asarray(Fr.Tperms)))
    # the factorization itself: P A P^H = L T L^H
    ap = a[F.piv.numpy()][:, F.piv.numpy()]
    rec = F.L.numpy() @ F.T_dense().numpy() @ F.L.numpy().conj().T
    assert np.abs(ap - rec).max() <= 1e-12 * np.abs(a).max() * n
    b = _rhs(n, n, 3, dtype)
    _close(st.hetrs(F, st.Matrix.from_numpy(b, nb, device="cpu"))
           .to_numpy(), ref.hetrs(Fr, ref.Matrix.from_numpy(b, nb))
           .to_numpy(), dtype)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("cls", ["HermitianMatrix", "SymmetricMatrix"])
def test_hesv_structures(cls, uplo):
    a = _indef(3, 45)
    b = _rhs(3, 45, 2)
    R, P = _mats(a, 8, cls, uplo)
    Fr, Xr = ref.hesv(R, ref.Matrix.from_numpy(b, 8))
    F, X = st.hesv(P, st.Matrix.from_numpy(b, 8, device="cpu"))
    assert type(F).__name__ == "HEFactors"
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    x = np.linalg.solve(a, b)
    assert np.abs(X.to_numpy() - x).max() <= 1e-10 * np.abs(x).max()


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_hesv_single_precision(dtype):
    a = _indef(4, 48, dtype)
    b = _rhs(4, 48, 2, dtype)
    R, P = _mats(a, 16)
    Fr, Xr = ref.hesv(R, ref.Matrix.from_numpy(b, 16))
    F, X = st.hesv(P, st.Matrix.from_numpy(b, 16, device="cpu"))
    # two backward-stable f32 solves agree to ~cond(A) eps_f32: held at
    # 1e-5 cond(A) to each other and to the f64 solution
    kappa = np.linalg.cond(a.astype(np.complex128))
    x64 = np.linalg.solve(a.astype(np.complex128), b)
    for x, want in ((X.to_numpy(), np.asarray(Xr.to_numpy())),
                    (X.to_numpy(), x64)):
        assert np.abs(x - want).max() <= 1e-5 * kappa * np.abs(want).max()


def test_hetrf_rejects_complex_symmetric():
    a = _indef(5, 16, np.complex128)
    with pytest.raises(st.SlateValueError):
        st.hetrf(st.SymmetricMatrix.from_numpy(a, 8, device="cpu"))
    with pytest.raises(st.SlateValueError):
        st.hetrf(st.Matrix.from_numpy(a, 8, device="cpu"))


def test_hetrf_mesh_is_not_ported():
    """The mesh Aasen is ported (tests/test_torch_dist_lu.py holds it on
    grids with a process group); Target.mesh on a grid without one takes
    the single route, as the reference's hetrf does where the grid has no
    mesh: the same bits as the default target."""
    P = st.HermitianMatrix.from_numpy(_indef(6, 16), 8, device="cpu")
    F = st.hetrf(P, {st.Option.Target: st.Target.mesh})
    G = st.hetrf(P)
    for x, y in zip(F, G):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# ------------------------------------------------------------- health

def test_certify_ldlt_matches_the_reference():
    a = _indef(7, 40)
    R, P = _mats(a, 8)
    Fr, F = ref.hetrf(R), st.hetrf(P)
    hr = ref_certify.certify_ldlt(a, Fr.L, Fr.T_dense(), Fr.piv)
    h = certify.certify_ldlt(torch.from_numpy(a), F.L, F.T_dense(), F.piv)
    assert h.converged == bool(hr.converged) is True
    # clean ratios sit at rounding level: both far under the tolerance
    tol = certify.tolerance(torch.float64, 40)
    assert h.growth < 1e-2 * tol and float(hr.growth) < 1e-2 * tol
    # a corrupted L fails the certificate in both packages
    Lb = F.L.clone()
    Lb[30, 3] += 1.0
    bad = certify.certify_ldlt(torch.from_numpy(a), Lb, F.T_dense(), F.piv)
    Lr = np.asarray(Fr.L).copy()
    Lr[30, 3] += 1.0
    bad_r = ref_certify.certify_ldlt(a, Lr, Fr.T_dense(), Fr.piv)
    assert bad.converged == bool(bad_r.converged) is False
    assert bad.min_pivot_index == int(bad_r.min_pivot_index)


def test_post_stage1_strike_fails_the_certificate():
    """A bitflip in L (site post_stage1) is finite with a healthy T: the
    certificate catches it in both packages, on the same element."""
    a = _indef(8, 40)
    b = _rhs(8, 40, 2)
    plan = dict(site="post_stage1", kind="bitflip", seed=3)
    o_r = {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info,
           ref.Option.UseFallbackSolver: False}
    o_p = {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
           st.Option.UseFallbackSolver: False}
    R, P = _mats(a, 8)
    with ref_faults.inject(ref_faults.FaultPlan(**plan)):
        _, hr = ref.hetrf(R, o_r)
    with faults.inject(faults.FaultPlan(**plan)):
        _, h = st.hetrf(P, o_p)
        _, _, hs = st.hesv(P, st.Matrix.from_numpy(b, 8, device="cpu"), o_p)
    assert h.ok == bool(hr.ok)
    assert h.converged == bool(hr.converged)
    assert h.min_pivot_index == int(hr.min_pivot_index)
    assert not hs.ok


# ------------------------------------------------------------- recovery

def test_hesv_zero_offdiag_block_against_numpy():
    """Block-diagonal: every pivot contest of the first panel ties at 0;
    pivots stay within the live rows and the solve is right (held against
    numpy: this case is red in the reference's suite)."""
    rng = np.random.default_rng(9)
    a = np.zeros((10, 10))
    a[:6, :6] = _indef(10, 6)
    a[6:, 6:] = _indef(11, 4)
    b = rng.standard_normal((10, 2))
    F, X = st.hesv(st.SymmetricMatrix.from_numpy(a, 4, device="cpu"),
                   st.Matrix.from_numpy(b, 4, device="cpu"))
    assert int(F.piv.max()) < 10 if hasattr(F, "piv") else True
    np.testing.assert_allclose(a @ X.to_numpy(), b, atol=1e-8)


def test_hesv_singularish_against_scipy():
    """A zero leading diagonal entry: held against scipy's ldl and solve
    (red in earlier runs of the reference's suite)."""
    a = _indef(12, 8)
    a[0, 0] = 0.0
    b = _rhs(12, 8, 1)
    F, X = st.hesv(st.SymmetricMatrix.from_numpy(a, 4, device="cpu"),
                   st.Matrix.from_numpy(b, 4, device="cpu"))
    np.testing.assert_allclose(a @ X.to_numpy(), b, atol=1e-8)
    lu, d, perm = scipy.linalg.ldl(a)
    np.testing.assert_allclose(lu @ d @ lu.T, a, atol=1e-12)
    np.testing.assert_allclose(X.to_numpy(), scipy.linalg.solve(a, b),
                               rtol=1e-10, atol=1e-12)


def _singular():
    """An indefinite matrix with a zero row and column: P A P^H = L T L^H
    with L unit lower, so Aasen's T is exactly singular, and so is the
    densified LU of the last rung."""
    a = _indef(13, 12)
    a[7, :] = 0.0
    a[:, 7] = 0.0
    return a


@pytest.mark.parametrize("fb", [True, False])
def test_hesv_singular_t(fb):
    """Aasen's T has a zero pivot: without UseFallbackSolver hesv reports
    it (HEFactors, info > 0); with it the ladder goes on to the densified
    gesv, which fails too (LUFactors, info > 0), as in the reference."""
    a = _singular()
    b = _rhs(13, 12, 2)
    o_r = {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info,
           ref.Option.UseFallbackSolver: fb}
    o_p = {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
           st.Option.UseFallbackSolver: fb}
    R, P = _mats(a, 4)
    Fr, Xr, hr = ref.hesv(R, ref.Matrix.from_numpy(b, 4), o_r)
    F, X, h = st.hesv(P, st.Matrix.from_numpy(b, 4, device="cpu"), o_p)
    assert type(F).__name__ == type(Fr).__name__ == (
        "LUFactors" if fb else "HEFactors")
    assert h.ok == bool(hr.ok) is False
    assert (h.info > 0) == (int(hr.info) > 0)
    with pytest.raises(st.SlateSingularError):
        st.hesv(P, st.Matrix.from_numpy(b, 4, device="cpu"),
                {st.Option.UseFallbackSolver: fb})


@pytest.mark.parametrize("spd", [True, False])
def test_hesv_speculate_tries_cholesky_first(spd):
    a = _indef(14, 40)
    if spd:
        a = a @ a.T + 40 * np.eye(40)
    b = _rhs(14, 40, 2)
    R, P = _mats(a, 8)
    Fr, Xr = ref.hesv(R, ref.Matrix.from_numpy(b, 8),
                      {ref.Option.Speculate: "on"})
    F, X = st.hesv(P, st.Matrix.from_numpy(b, 8, device="cpu"),
                   {st.Option.Speculate: "on"})
    assert type(F).__name__ == type(Fr).__name__ == (
        "TriangularMatrix" if spd else "HEFactors")
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)


def test_posv_indefinite_takes_hesv_then_gesv():
    """posv on an indefinite matrix with UseFallbackSolver: Cholesky
    fails, hesv solves (HEFactors, X as the reference's); on a singular
    matrix the ladder goes on to gesv (LUFactors), which reports the
    singular factor, as in the reference."""
    a = _indef(15, 40)
    b = _rhs(15, 40, 2)
    R, P = _mats(a, 4)
    Fr, Xr = ref.posv(R, ref.Matrix.from_numpy(b, 4))
    F, X = st.posv(P, st.Matrix.from_numpy(b, 4, device="cpu"))
    assert type(F).__name__ == type(Fr).__name__ == "HEFactors"
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    a = _singular()
    b = _rhs(15, 12, 2)
    R, P = _mats(a, 4)
    Fr, _, hr = ref.posv(R, ref.Matrix.from_numpy(b, 4),
                         {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info})
    F, _, h = st.posv(P, st.Matrix.from_numpy(b, 4, device="cpu"),
                      {st.Option.ErrorPolicy: st.ErrorPolicy.Info})
    assert type(F).__name__ == type(Fr).__name__ == "LUFactors"
    assert h.ok == bool(hr.ok) is False


def test_posv_indefinite_without_fallback_raises():
    P = st.HermitianMatrix.from_numpy(_indef(16, 24), 8, device="cpu")
    b = st.Matrix.from_numpy(_rhs(16, 24, 1), 8, device="cpu")
    with pytest.raises(st.SlateNotPositiveDefiniteError):
        st.posv(P, b, {st.Option.UseFallbackSolver: False})


# ------------------------------------------------------------- convert.py

def test_convert_carries_he_factors():
    """A reference HEFactors carried across with convert.py solves in the
    port as the reference's hetrs does."""
    a = _indef(17, 50, np.complex128)
    b = _rhs(17, 50, 3, np.complex128)
    Fr = ref.hetrf(ref.HermitianMatrix.from_numpy(a, 16))
    F = convert.he_factors_from_jax(Fr, device="cpu")
    assert type(F) is st.HEFactors and F.piv.dtype == torch.int64
    got = st.hetrs(F, st.Matrix.from_numpy(b, 16, device="cpu"))
    _close(got.to_numpy(), ref.hetrs(Fr, ref.Matrix.from_numpy(b, 16))
           .to_numpy(), np.complex128)
    _close(got.to_numpy(), np.linalg.solve(a, b), np.float32)
