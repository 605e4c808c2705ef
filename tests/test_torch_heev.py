"""The port's two-stage Hermitian eigensolver against slate_tpu's, on the
CPU: he2hb's stacks and band, hb2st's chase, rolled_apply, heev on the
Auto, DC and QR routes, heev_vals/heevd, hegst/hegv, the public sterf,
steqr and hb2st, certify_eig, and heev's escalation ladder under the
reference's fault plans.

The same numpy inputs, from a seed, go through both packages.  The band,
the stacks and the chased (d, e, Q2) are deterministic functions of A and
are held element by element; eigenvalues directly; eigenvectors only by
residual, orthogonality and |diag(Z_ref^H Z)| = 1 on well-separated
spectra, since the library may return them with another sign or phase.
Tolerances: 1e-10 (relative to the largest magnitude) in f64 and c128,
1e-4 in f32; residual and orthogonality 1e-12 in f64.  Each reference
result is computed once a module.  The reference's drivers are wrapped
in ``@annotate``, which calls ``jax.core.trace_state_clean``; the
installed JAX no longer exports that name, so the ``ref_drivers`` fixture
restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import functools

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu import obs as ref_obs
from slate_tpu.drivers import heev as ref_heev
from slate_tpu.internal import qr as ref_qr
from slate_tpu.robust import certify as ref_certify
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import api, convert, obs
from slate_tpu_torch.drivers import heev as port_heev
from slate_tpu_torch.internal import qr as port_qr
from slate_tpu_torch.robust import certify, faults

TOL = {np.float64: 1e-10, np.complex128: 1e-10, np.float32: 1e-4}
VEC_TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-4}
ROUTES = ("Auto", "DC", "QR")
# (n, nb, dtype, uplo): past one stedc leaf (a merge runs), complex, a
# single block (no panel), ragged f32.  The fault drills run at the first
# case's shape, so that the reference compiles it once.
CASES = [(40, 8, np.float64, "Lower"), (16, 4, np.complex128, "Lower"),
         (12, 16, np.float64, "Upper"), (23, 5, np.float32, "Lower")]
IDS = ["f64-40", "c128-16", "f64-12-one-block", "f32-23"]
N_DRILL, NB_DRILL = CASES[0][:2]


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def herm(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((n, n))
    return ((a + a.conj().T) / 2).astype(dtype)


def _close(got, want, tol):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


def _opts(pkg, route=None, **kw):
    o = {pkg.Option.ErrorPolicy: pkg.ErrorPolicy.Info}
    if route is not None:
        o[pkg.Option.MethodEig] = getattr(pkg.MethodEig, route)
    for k, v in kw.items():
        o[getattr(pkg.Option, k)] = v
    return o


@functools.lru_cache(maxsize=None)
def _ref_heev(case_i, route):
    """The reference's (w, Z, health) of case ``case_i`` on ``route``,
    computed once a module."""
    n, nb, dt, uplo = CASES[case_i]
    a = herm(case_i, n, dt)
    A = ref.HermitianMatrix.from_numpy(a, nb, getattr(ref.Uplo, uplo))
    w, Z, h = convert.spectral_from_jax(ref.heev(A, _opts(ref, route)),
                                        device="cpu")
    return w.numpy(), Z.to_numpy(), h


def _port_heev(case_i, route, **kw):
    n, nb, dt, uplo = CASES[case_i]
    a = herm(case_i, n, dt)
    A = st.HermitianMatrix.from_numpy(a, nb, getattr(st.Uplo, uplo),
                                      device="cpu")
    return a, st.heev(A, _opts(st, route, **kw))


# ---------------------------------------------------------------- stages

@pytest.mark.parametrize("case_i", range(len(CASES)), ids=IDS)
def test_he2hb_stacks_and_band_match_the_reference(case_i):
    n, nb, dt, _ = CASES[case_i]
    a = herm(case_i, n, dt)
    want = ref_heev._he2hb_scan(jnp.asarray(a), nb)
    got = port_heev._he2hb_scan(torch.from_numpy(a), nb)
    for g, w in zip(got, want):
        _close(g, w, TOL[dt])
    _close(port_heev._band_from_stacks(*got[2:], n, nb),
           ref_heev._band_from_stacks(*want[2:], n, nb), TOL[dt])


@pytest.mark.parametrize("case_i", [0, 1, 3], ids=[IDS[0], IDS[1], IDS[3]])
def test_hb2st_chase_matches_the_reference(case_i):
    n, nb, dt, _ = CASES[case_i]
    a = herm(case_i, n, dt)
    band = np.asarray(ref_heev._band_from_stacks(
        *ref_heev._he2hb_scan(jnp.asarray(a), nb)[2:], n, nb))
    d, e, Q = ref_heev._hb2st(jnp.asarray(band), nb, want_q=True)
    pd, pe, pQ = port_heev._hb2st(torch.from_numpy(band.copy()), nb,
                                  want_q=True)
    for g, w in ((pd, d), (pe, e), (pQ, Q)):
        _close(g, w, TOL[dt])
    real = torch.float32 if dt == np.float32 else torch.float64
    assert pd.dtype == pe.dtype == real
    pd2, pe2, none = port_heev._hb2st(torch.from_numpy(band.copy()), nb,
                                      want_q=False)
    assert none is None
    assert torch.equal(pd2, pd) and torch.equal(pe2, pe)


def test_chase_steps_count_the_reference_schedule():
    for n, kd in ((21, 5), (40, 8), (7, 16), (2048, 128)):
        kd_ = max(1, min(kd, n - 1))
        tmax = max(1, -(-(n - 1) // kd_))
        pairs = [(j, t) for j in range(n - 1) for t in range(tmax)
                 if j + 1 + t * kd_ < n]
        assert port_heev._chase_steps(n, kd) == len(pairs)


@pytest.mark.parametrize("case_i", [0, 1], ids=IDS[:2])
def test_rolled_apply_matches_the_reference(case_i):
    n, nb, dt, _ = CASES[case_i]
    a = herm(case_i, n, dt)
    Vs, Ts, Ds, _ = ref_heev._he2hb_scan(jnp.asarray(a), nb)
    N = Ds.shape[0] * nb
    z = herm(case_i + 50, N, dt)[:, :n]
    offs = (np.arange(Ts.shape[0]) + 1) * nb
    want = ref_qr.rolled_apply(Vs, Ts, jnp.asarray(offs), jnp.asarray(z))
    got = port_qr.rolled_apply(torch.from_numpy(np.asarray(Vs).copy()),
                               torch.from_numpy(np.asarray(Ts).copy()),
                               list(offs), torch.from_numpy(z.copy()))
    _close(got, want, TOL[dt])
    # no panel: Z unchanged
    assert torch.equal(port_qr.rolled_apply(
        torch.zeros((0, 0, nb), dtype=got.dtype),
        torch.zeros((0, nb, nb), dtype=got.dtype), [],
        torch.from_numpy(z.copy())), torch.from_numpy(z))


# ---------------------------------------------------------------- drivers

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case_i", range(len(CASES)), ids=IDS)
def test_heev_routes_match_the_reference(case_i, route):
    n, nb, dt, _ = CASES[case_i]
    w_ref, z_ref, h_ref = _ref_heev(case_i, route)
    a, (w, Z, h) = _port_heev(case_i, route)
    _close(w, w_ref, TOL[dt])
    z = Z.to_numpy()
    assert z.shape == (n, n) and Z.mb == nb
    w = w.numpy()
    scale = np.abs(w_ref).max()
    assert np.abs(a @ z - z * w[None, :]).max() <= VEC_TOL[dt] * 10 * scale
    assert np.abs(z.conj().T @ z - np.eye(n)).max() <= VEC_TOL[dt] * 10
    # the same eigenvectors up to sign or phase (a random spectrum)
    assert np.allclose(np.abs(np.diag(z_ref.conj().T @ z)), 1.0,
                       atol=VEC_TOL[dt] * 1e3)
    assert h.ok and h_ref.ok and h.nonfinite == h_ref.nonfinite


@pytest.mark.parametrize("case_i", [0, 1, 2], ids=IDS[:3])
def test_heev_vals_and_heevd_match_the_reference(case_i):
    n, nb, dt, uplo = CASES[case_i]
    a = herm(case_i, n, dt)
    R = ref.HermitianMatrix.from_numpy(a, nb, getattr(ref.Uplo, uplo))
    P = st.HermitianMatrix.from_numpy(a, nb, getattr(st.Uplo, uplo),
                                      device="cpu")
    want = np.asarray(ref.heev_vals(R))
    _close(st.heev_vals(P), want, TOL[dt])
    w, h = st.heev_vals(P, _opts(st))
    assert h.ok
    _close(w, want, TOL[dt])
    w, Z = st.heevd(P)
    _close(w, want, TOL[dt])
    w, Z = st.heev(P, None, jobz=False)
    assert Z is None
    _close(w, want, TOL[dt])


def test_heev_symmetric_matrix_and_complex_symmetric_error():
    a = herm(7, 10)
    w = st.heev_vals(st.SymmetricMatrix.from_numpy(a, 4, device="cpu"))
    _close(w, ref.heev_vals(ref.SymmetricMatrix.from_numpy(a, 4)), 1e-10)
    c = herm(8, 6, np.complex128)
    c = c + c.T
    with pytest.raises(st.SlateValueError):
        st.heev(st.SymmetricMatrix.from_numpy(c, 4, device="cpu"))
    with pytest.raises(st.SlateValueError):
        st.heev(st.Matrix.from_numpy(a, 4, device="cpu"))


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches_the_reference(itype):
    n, nb = 12, 4
    a = herm(20 + itype, n)
    g = np.random.default_rng(30 + itype).standard_normal((n, n))
    b = g @ g.T + n * np.eye(n)
    w_ref, X_ref = ref.hegv(ref.HermitianMatrix.from_numpy(a, nb),
                            ref.HermitianMatrix.from_numpy(b, nb),
                            itype=itype)
    w, X, h = st.hegv(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                      st.HermitianMatrix.from_numpy(b, nb, device="cpu"),
                      _opts(st), itype=itype)
    assert h.ok
    _close(w, w_ref, 1e-10)
    _close(w, scipy.linalg.eigh(a, b, type=itype, eigvals_only=True),
           1e-9)
    x, w = X.to_numpy(), w.numpy()
    lhs = {1: a @ x, 2: a @ (b @ x), 3: b @ (a @ x)}[itype]
    rhs = {1: b @ x * w[None, :], 2: x * w[None, :],
           3: x * w[None, :]}[itype]
    assert np.abs(lhs - rhs).max() <= 1e-9 * np.abs(lhs).max()
    # columns equal to the reference's up to sign
    xr = X_ref.to_numpy()
    assert np.allclose(np.abs(x), np.abs(xr), atol=1e-8 * np.abs(xr).max())
    w2, none = st.hegv(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                       st.HermitianMatrix.from_numpy(b, nb, device="cpu"),
                       itype=itype, jobz=False)
    assert none is None
    _close(w2, w_ref, 1e-10)


def _hpd(seed, n, dtype):
    g = herm(seed, n, dtype) + np.triu(herm(seed + 1, n, dtype), 1)
    return (g @ g.conj().T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_upper_stored_b_matches_scipy(itype, dtype):
    """B stored Upper: potrf returns U with B = U^H U, and hegv/hegst work
    with L = U^H.  Eigenvalues within 1e-12 of scipy's, relative to the
    largest, and the eigenpairs' residual as small."""
    n, nb = 20, 6
    a, b = herm(50 + itype, n, dtype), _hpd(60 + itype, n, dtype)
    want = scipy.linalg.eigh(a, b, type=itype, eigvals_only=True)
    for uplo_a in (st.Uplo.Lower, st.Uplo.Upper):
        w, X = st.hegv(
            st.HermitianMatrix.from_numpy(a, nb, uplo_a, device="cpu"),
            st.HermitianMatrix.from_numpy(b, nb, st.Uplo.Upper,
                                          device="cpu"), itype=itype)
        _close(w, want, 1e-12)
        x, w = X.to_numpy(), w.numpy()
        lhs = {1: a @ x, 2: a @ (b @ x), 3: b @ (a @ x)}[itype]
        rhs = {1: b @ x * w[None, :], 2: x * w[None, :],
               3: x * w[None, :]}[itype]
        assert np.abs(lhs - rhs).max() <= 1e-12 * np.abs(lhs).max()


def test_hegv_upper_b_the_reference_is_wrong_and_the_port_right():
    """The reference's hegst applies the B = L L^H formulas to the upper
    factor U itself, so on an Upper-stored B its eigenvalues miss scipy's
    by more than 1e-3 relative, where the port's are within 1e-12."""
    n, nb = 20, 6
    a, b = herm(70, n), _hpd(71, n, np.float64)
    want = scipy.linalg.eigh(a, b, type=1, eigvals_only=True)
    scale = np.abs(want).max()
    w_ref, _ = ref.hegv(ref.HermitianMatrix.from_numpy(a, nb),
                        ref.HermitianMatrix.from_numpy(b, nb, ref.Uplo.Upper))
    w, _ = st.hegv(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                   st.HermitianMatrix.from_numpy(b, nb, st.Uplo.Upper,
                                                 device="cpu"))
    assert np.abs(np.asarray(w_ref) - want).max() > 1e-3 * scale
    assert np.abs(w.numpy() - want).max() <= 1e-12 * scale


def test_hegst_takes_an_upper_factor_as_its_conjugate_transpose():
    n, nb = 12, 4
    a = herm(42, n, np.complex128)
    b = _hpd(43, n, np.complex128)
    L = np.linalg.cholesky(b)
    for itype in (1, 2, 3):
        lower = st.hegst(
            st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
            st.TriangularMatrix.from_numpy(L, nb, device="cpu"),
            itype=itype).to_numpy()
        upper = st.hegst(
            st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
            st.TriangularMatrix.from_numpy(L.conj().T, nb, st.Uplo.Upper,
                                           device="cpu"),
            itype=itype).to_numpy()
        _close(upper, lower, 1e-12)


def test_hegst_matches_the_reference():
    n, nb = 12, 4
    a = herm(40, n)
    g = np.random.default_rng(41).standard_normal((n, n))
    L = np.linalg.cholesky(g @ g.T + n * np.eye(n))
    for itype in (1, 2):
        want = ref.hegst(ref.HermitianMatrix.from_numpy(a, nb),
                         ref.TriangularMatrix.from_numpy(L, nb),
                         itype=itype).to_numpy()
        got = st.hegst(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                       st.TriangularMatrix.from_numpy(L, nb, device="cpu"),
                       itype=itype)
        assert isinstance(got, st.HermitianMatrix)
        _close(got.to_numpy(), want, 1e-10)
    with pytest.raises(st.SlateValueError):
        st.hegst(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                 st.TriangularMatrix.from_numpy(L, nb, device="cpu"),
                 itype=4)


def test_sterf_steqr_public_match_the_reference():
    rng = np.random.default_rng(17)
    d, e = rng.standard_normal(17), rng.standard_normal(16)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    _close(st.sterf(d, e, device="cpu"), ref.sterf(d, e), 1e-12)
    w, Z = st.steqr(d, e, device="cpu")
    w_ref, _ = ref.steqr(d, e)
    _close(w, w_ref, 1e-12)
    z, w = Z.numpy(), w.numpy()
    assert np.abs(T @ z - z * w[None, :]).max() <= 1e-12 * np.abs(w).max()
    # MethodEig.DC sends steqr to stedc
    w2, Z2, h = st.steqr(d, e, _opts(st, "DC"), device="cpu")
    assert h.ok
    _close(w2, w_ref, 1e-12)
    w3, h3 = st.sterf(torch.from_numpy(d), torch.from_numpy(e), _opts(st))
    assert h3.ok and w3.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.sterf(d, e)


def test_hb2st_public_matches_the_reference():
    n, kd, mb = 18, 3, 6
    a = herm(18, n)
    band = np.where(np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
                    <= kd, a, 0.0)
    d, e, Q = ref.hb2st(ref.HermitianBandMatrix.from_numpy(band, kd, mb))
    HB = st.HermitianBandMatrix.from_numpy(band, kd, mb, device="cpu")
    pd, pe, pQ = st.hb2st(HB)
    for g, w in ((pd, d), (pe, e), (pQ, Q)):
        _close(g, w, 1e-10)
    q = pQ.numpy()
    T = np.diag(pd.numpy()) + np.diag(pe.numpy(), 1) + np.diag(pe.numpy(),
                                                               -1)
    assert np.abs(q @ T @ q.T - band).max() <= 1e-11
    # carried in from the reference's band matrix
    HB2 = convert.matrix_from_jax(
        ref.HermitianBandMatrix.from_numpy(band, kd, mb), device="cpu")
    pd2, pe2, pQ2, h = st.hb2st(HB2, _opts(st))
    assert h.ok and torch.equal(pd2, pd) and torch.equal(pQ2, pQ)
    with pytest.raises(st.SlateValueError):
        st.hb2st(st.Matrix.from_numpy(band, mb, device="cpu"))


# ---------------------------------------------------------------- certify

def _strike(z, where, scale):
    z = np.array(z)
    z[where] *= scale
    return z


@pytest.mark.parametrize("dt", [np.float64, np.complex128, np.float32])
def test_certify_eig_matches_the_reference(dt):
    n = 14
    a = herm(60, n, dt)
    w, z = np.linalg.eigh(a)
    w, z = w.astype(np.real(a[:1]).dtype), z.astype(dt)
    for clean, zz, ww in ((True, z, w),
                          (False, _strike(z, (3, 5), 2.0 ** 20), w),
                          (False, _strike(z, (2, 9), np.nan), w),
                          (False, z, _strike(w, 4, 1.5))):
        want = ref_certify.certify_eig(jnp.asarray(a), jnp.asarray(ww),
                                       jnp.asarray(zz))
        got = certify.certify_eig(torch.from_numpy(a), torch.from_numpy(ww),
                                  torch.from_numpy(zz)).to_list()[0]
        (want,) = convert.health_from_jax(want)
        assert (got.converged, got.nonfinite) == (want.converged,
                                                  want.nonfinite)
        assert got.converged == clean
        if clean:       # rounding-level ratios: the worst column is noise
            assert 0.1 < got.growth / want.growth < 10
        elif not want.nonfinite:
            assert got.min_pivot_index == want.min_pivot_index
            assert np.isclose(got.growth, want.growth, rtol=1e-3)
    assert certify.tolerance(torch.float32, 8192) == pytest.approx(
        ref_certify.tolerance(np.float32, 8192))


# ---------------------------------------------------------------- faults

def _pair(seed, n, nb):
    a = herm(seed, n)
    return (a, ref.HermitianMatrix.from_numpy(a, nb),
            st.HermitianMatrix.from_numpy(a, nb, device="cpu"))


def _plan(pkg_faults, **kw):
    return pkg_faults.FaultPlan(**kw)


@pytest.mark.parametrize("meth,site", [
    ("Auto", "post_stage1"), ("Auto", "post_backtransform"),
    ("QR", "post_chase"), ("DC", "post_secular")])
def test_heev_fault_detected_as_the_reference(meth, site):
    _, R, P = _pair(70, N_DRILL, NB_DRILL)
    outs = []
    for pkg, fl, M in ((ref, ref_faults, R), (st, faults, P)):
        with fl.inject(_plan(fl, site=site, kind="nan", seed=11, count=8)):
            *_, h = pkg.heev(M, _opts(pkg, meth, UseFallbackSolver=False))
        outs.append(bool(h.ok))
    assert outs == [False, False]


def test_heev_fault_raise_and_nan_policies():
    _, _, P = _pair(71, N_DRILL, NB_DRILL)
    plan = faults.FaultPlan(site="post_backtransform", kind="bitflip",
                            seed=5, count=1)
    with faults.inject(plan):
        with pytest.raises(st.SlateNotConvergedError):
            st.heev(P, {st.Option.UseFallbackSolver: False})
    with faults.inject(plan):
        w, Z = st.heev(P, {st.Option.ErrorPolicy: st.ErrorPolicy.Nan,
                           st.Option.UseFallbackSolver: False})
    assert not torch.isfinite(w).any()
    assert not np.isfinite(Z.to_numpy()).any()


def _event(pkg_obs, call):
    with pkg_obs.recording() as evs:
        out = call()
    assert len(evs) == 1
    return out, evs[0]


def test_heev_escalation_recovers_transient_as_the_reference():
    a, R, P = _pair(72, N_DRILL, NB_DRILL)
    res = []
    for pkg, fl, M, o in ((ref, ref_faults, R, ref_obs), (st, faults, P,
                                                           obs)):
        # seed 5 strikes band entry (26, 33), inside the bandwidth (a
        # bitflip of a zero outside it stays zero)
        with fl.inject(fl.FaultPlan(site="post_stage1", kind="bitflip",
                                    seed=5, count=1, transient=True)):
            (w, Z), ev = _event(o, lambda: pkg.heev(
                M, {pkg.Option.UseFallbackSolver: True}))
        res.append((np.asarray(w), ev))
    (w_ref, e_ref), (w, e) = res
    _close(w, w_ref, 1e-10)
    _close(np.sort(w), np.linalg.eigvalsh(a), 1e-8)
    assert e["path"] == e_ref["path"] == "escalated:DC"
    assert e["escalations"] == e_ref["escalations"] == 1
    assert e["op"] == "heev"


def test_heev_escalation_dc_to_qr_persistent_as_the_reference():
    a, R, P = _pair(73, N_DRILL, NB_DRILL)
    res = []
    for pkg, fl, M, o in ((ref, ref_faults, R, ref_obs), (st, faults, P,
                                                           obs)):
        with fl.inject(fl.FaultPlan(site="post_secular", kind="nan",
                                    seed=7, count=8)):
            (w, Z, h), ev = _event(o, lambda: pkg.heev(M, _opts(
                pkg, "DC", UseFallbackSolver=True)))
        res.append((np.asarray(w), bool(h.ok), ev))
    (w_ref, ok_ref, e_ref), (w, ok, e) = res
    assert ok and ok_ref
    _close(w, w_ref, 1e-10)
    _close(np.sort(w), np.linalg.eigvalsh(a), 1e-8)
    assert e["path"] == e_ref["path"] == "escalated:QR"


def test_heev_direct_path_and_spans():
    _, _, P = _pair(74, N_DRILL, NB_DRILL)
    with obs.recording() as evs, obs.record_spans() as rec:
        st.heev(P)
    (e,) = evs
    assert e["op"] == "heev" and e["path"] == "direct:Auto"
    assert e["escalations"] == 0
    names = [s["name"] for s in rec.spans]
    for part in ("he2hb", "stage2", "backtransform", "certify"):
        assert f"slate.heev/{part}" in names


# ---------------------------------------------------------------- api

def test_api_eig_verbs_match_the_drivers():
    a = herm(80, 16)
    P = st.HermitianMatrix.from_numpy(a, 4, device="cpu")
    w, Z = api.eig(P)
    w2, Z2 = st.heev(P)
    assert torch.equal(w, w2) and torch.equal(Z.to_dense(), Z2.to_dense())
    assert torch.equal(api.eig_vals(P), st.heev_vals(P))
    _close(api.eig_vals(P), ref.api.eig_vals(
        ref.HermitianMatrix.from_numpy(a, 4)), 1e-10)
