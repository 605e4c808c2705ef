"""The port's two-stage SVD against slate_tpu's, on the CPU: ge2tb's
stacks and band (m > n, m = n and the single-block branch), tb2bd's chase,
svd on the Auto and Bidiag routes (m > n, m < n, complex, f32), svd_vals,
the public bdsqr and tb2bd, certify_svd, svd's escalation ladder under the
reference's fault plans, and the API's svd verbs.

The same numpy inputs, from a seed, go through both packages.  The band,
the stacks and the chased (d, e, U2, V2) are deterministic functions of A
and are held element by element; singular values directly; singular
vectors only by residual, orthogonality and |diag(U_ref^H U)| = 1, since
the library may return them with another sign or phase.  Tolerances:
1e-10 (relative to the largest magnitude) in f64 and c128, 1e-4 in f32;
residual and orthogonality 1e-12 in f64.  Each reference result is
computed once a module.  The reference's drivers are wrapped in
``@annotate``, which calls ``jax.core.trace_state_clean``; the installed
JAX no longer exports that name, so the ``ref_drivers`` fixture restores
it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu import obs as ref_obs
from slate_tpu.drivers import svd as ref_svd
from slate_tpu.internal import qr as ref_qr
from slate_tpu.robust import certify as ref_certify
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import api, convert, obs
from slate_tpu_torch.drivers import svd as port_svd
from slate_tpu_torch.internal import qr as port_qr
from slate_tpu_torch.robust import certify, faults

TOL = {np.float64: 1e-10, np.complex128: 1e-10, np.float32: 1e-4}
VEC_TOL = {np.float64: 1e-12, np.complex128: 1e-12, np.float32: 1e-4}
# (m, n, nb, dtype): tall ragged, wide (m < n: A^H), one block column,
# square complex, f32.  The fault drills run at the first case's shape, so
# that the reference compiles it once.
CASES = [(19, 13, 4, np.float64), (13, 20, 5, np.float64),
         (30, 7, 8, np.float64), (16, 16, 4, np.complex128),
         (40, 24, 8, np.float32)]
IDS = ["f64-19x13", "f64-13x20", "f64-30x7-one-block", "c128-16",
       "f32-40x24-cholqr-panels"]
M_DRILL, N_DRILL, NB_DRILL = CASES[0][:3]


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _mat(seed, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


def _close(got, want, tol):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


def _opts(pkg, route=None, **kw):
    o = {pkg.Option.ErrorPolicy: pkg.ErrorPolicy.Info}
    if route is not None:
        o[pkg.Option.MethodSvd] = getattr(pkg.MethodSvd, route)
    for k, v in kw.items():
        o[getattr(pkg.Option, k)] = v
    return o


@functools.lru_cache(maxsize=None)
def _ref_svd(case_i, route):
    m, n, nb, dt = CASES[case_i]
    a = _mat(case_i, m, n, dt)
    s, U, V, h = convert.spectral_from_jax(
        ref.svd(ref.Matrix.from_numpy(a, nb, nb), _opts(ref, route)),
        device="cpu")
    return s.numpy(), U.to_numpy(), V.to_numpy(), h


# ---------------------------------------------------------------- stages

@pytest.mark.parametrize("case_i", [0, 2, 3, 4],
                         ids=[IDS[0], IDS[2], IDS[3], IDS[4]])
def test_ge2tb_stacks_and_band_match_the_reference(case_i):
    m, n, nb, dt = CASES[case_i]
    a = _mat(case_i, m, n, dt)
    want = ref_svd._ge2tb_scan(jnp.asarray(a), nb)
    got = port_svd._ge2tb_scan(torch.from_numpy(a), nb)
    for g, w in zip(got, want):
        _close(g, w, TOL[dt])
    _close(port_svd._band_upper_from_stacks(*got[4:], n, nb),
           ref_svd._band_upper_from_stacks(*want[4:], n, nb), TOL[dt])


@pytest.mark.parametrize("case_i", [0, 3, 4], ids=[IDS[0], IDS[3], IDS[4]])
def test_tb2bd_chase_matches_the_reference(case_i):
    m, n, nb, dt = CASES[case_i]
    a = _mat(case_i, m, n, dt)
    band = np.asarray(ref_svd._band_upper_from_stacks(
        *ref_svd._ge2tb_scan(jnp.asarray(a), nb)[4:], n, nb))
    want = ref_svd._tb2bd(jnp.asarray(band), nb, want_uv=True)
    got = port_svd._tb2bd(torch.from_numpy(band.copy()), nb, want_uv=True)
    for g, w in zip(got, want):
        _close(g, w, TOL[dt])
    assert not got[0].is_complex() and not got[1].is_complex()
    d, e, none_u, none_v = port_svd._tb2bd(torch.from_numpy(band.copy()),
                                           nb, want_uv=False)
    assert none_u is None and none_v is None
    assert torch.equal(d, got[0]) and torch.equal(e, got[1])


def test_rolled_apply_on_ge2tb_panels_matches_the_reference():
    m, n, nb, dt = CASES[0]
    a = _mat(0, m, n, dt)
    Vqs, Tqs, Vls, Tls, _, _ = ref_svd._ge2tb_scan(jnp.asarray(a), nb)
    z = _mat(7, Vqs.shape[1], n)
    K = Tqs.shape[0]
    for V, T, offs, rows in ((Vqs, Tqs, np.arange(K) * nb, Vqs.shape[1]),
                             (Vls, Tls, (np.arange(K) + 1) * nb, K * nb)):
        want = ref_qr.rolled_apply(V, T, jnp.asarray(offs),
                                   jnp.asarray(z[:rows]))
        got = port_qr.rolled_apply(torch.from_numpy(np.asarray(V).copy()),
                                   torch.from_numpy(np.asarray(T).copy()),
                                   list(offs), torch.from_numpy(z[:rows]))
        _close(got, want, 1e-10)


# ---------------------------------------------------------------- drivers

@pytest.mark.parametrize("route", ["Auto", "Bidiag"])
@pytest.mark.parametrize("case_i", range(len(CASES)), ids=IDS)
def test_svd_routes_match_the_reference(case_i, route):
    m, n, nb, dt = CASES[case_i]
    s_ref, u_ref, v_ref, h_ref = _ref_svd(case_i, route)
    a = _mat(case_i, m, n, dt)
    s, U, V, h = st.svd(st.Matrix.from_numpy(a, nb, nb, device="cpu"),
                        _opts(st, route))
    _close(s, s_ref, TOL[dt])
    u, v, s = U.to_numpy(), V.to_numpy(), s.numpy()
    r = min(m, n)
    assert u.shape == u_ref.shape == (m, r) and v.shape == v_ref.shape \
        == (n, r)
    scale = s_ref.max()
    assert np.abs(u * s[None, :] @ v.conj().T - a).max() <= \
        VEC_TOL[dt] * 10 * scale
    assert np.abs(u.conj().T @ u - np.eye(r)).max() <= VEC_TOL[dt] * 10
    assert np.abs(v.conj().T @ v - np.eye(r)).max() <= VEC_TOL[dt] * 10
    assert np.allclose(np.abs(np.diag(u_ref.conj().T @ u)), 1.0,
                       atol=VEC_TOL[dt] * 1e3)
    assert h.ok and h_ref.ok and h.nonfinite == h_ref.nonfinite


@pytest.mark.parametrize("case_i", [0, 1, 3], ids=[IDS[0], IDS[1], IDS[3]])
def test_svd_vals_match_the_reference(case_i):
    m, n, nb, dt = CASES[case_i]
    a = _mat(case_i, m, n, dt)
    want = np.asarray(ref.svd_vals(ref.Matrix.from_numpy(a, nb, nb)))
    P = st.Matrix.from_numpy(a, nb, nb, device="cpu")
    _close(st.svd_vals(P), want, TOL[dt])
    s, h = st.svd_vals(P, _opts(st))
    assert h.ok
    _close(s, want, TOL[dt])
    s, U, V = st.svd(P, None, jobu=False)
    assert U is None and V is None
    _close(s, want, TOL[dt])
    with pytest.raises(st.SlateValueError):
        st.svd(st.HermitianMatrix.from_numpy(a[:n, :n] if m >= n else
                                             a[:m, :m], nb, device="cpu"))


def test_bdsqr_tb2bd_public_match_the_reference():
    n = 12
    rng = np.random.default_rng(12)
    d, e = rng.standard_normal(n), rng.standard_normal(n - 1)
    s_ref, _, _ = ref.bdsqr(d, e)
    s, U, Vh = st.bdsqr(d, e, device="cpu")
    _close(s, s_ref, 1e-12)
    B = np.diag(d) + np.diag(e, 1)
    assert np.abs(U.numpy() * s.numpy()[None, :] @ Vh.numpy() - B).max() \
        <= 1e-12 * s_ref.max()
    kd, mb = 3, 4
    bu = np.triu(np.tril(rng.standard_normal((n, n)), kd))
    d2, e2, U2, V2 = ref.tb2bd(ref.TriangularBandMatrix.from_numpy(
        bu, kd, mb, ref.Uplo.Upper))
    TB = st.TriangularBandMatrix.from_numpy(bu, kd, mb, st.Uplo.Upper,
                                            device="cpu")
    got = st.tb2bd(TB)
    for g, w in zip(got, (d2, e2, U2, V2)):
        _close(g, w, 1e-10)
    pd, pe, pu, pv = (x.numpy() for x in got)
    B2 = np.diag(pd) + np.diag(pe, 1)
    assert np.abs(pu @ B2 @ pv.T - bu).max() <= 1e-11
    TB2 = convert.matrix_from_jax(ref.TriangularBandMatrix.from_numpy(
        bu, kd, mb, ref.Uplo.Upper), device="cpu")
    *again, h = st.tb2bd(TB2, _opts(st))
    assert h.ok and all(torch.equal(x, y) for x, y in zip(again, got))
    with pytest.raises(st.SlateValueError):
        st.tb2bd(st.Matrix.from_numpy(bu, mb, device="cpu"))


@pytest.mark.parametrize("dt", [np.float64, np.complex128, np.float32])
def test_certify_svd_matches_the_reference(dt):
    m, n = 15, 11
    a = _mat(90, m, n, dt)
    u, s, vh = np.linalg.svd(a, full_matrices=False)
    s = s.astype(np.real(a[:1]).dtype)
    v = vh.conj().T.copy()
    bad_u = u.copy()
    bad_u[4, 2] *= 2.0 ** 20
    nan_v = v.copy()
    nan_v[1, 3] = np.nan
    bad_s = s.copy()
    bad_s[5] *= 1.5
    for clean, uu, ss, vv in ((True, u, s, v), (False, bad_u, s, v),
                              (False, u, s, nan_v), (False, u, bad_s, v)):
        want = ref_certify.certify_svd(jnp.asarray(a), jnp.asarray(ss),
                                       jnp.asarray(uu), jnp.asarray(vv))
        got = certify.certify_svd(
            torch.from_numpy(a), torch.from_numpy(ss), torch.from_numpy(uu),
            torch.from_numpy(vv)).to_list()[0]
        (want,) = convert.health_from_jax(want)
        assert (got.converged, got.nonfinite) == (want.converged,
                                                  want.nonfinite)
        assert got.converged == clean
        if clean:
            assert 0.1 < got.growth / want.growth < 10
        elif not want.nonfinite:
            assert got.min_pivot_index == want.min_pivot_index
            assert np.isclose(got.growth, want.growth, rtol=1e-3)


# ---------------------------------------------------------------- faults

@pytest.mark.parametrize("meth,site", [
    ("Auto", "post_stage1"), ("Auto", "post_backtransform"),
    ("Bidiag", "post_chase")])
def test_svd_fault_detected_as_the_reference(meth, site):
    a = _mat(100, M_DRILL, N_DRILL)
    oks = []
    for pkg, fl, kw in ((ref, ref_faults, {}), (st, faults,
                                                 {"device": "cpu"})):
        A = pkg.Matrix.from_numpy(a, NB_DRILL, **kw)
        with fl.inject(fl.FaultPlan(site=site, kind="nan", seed=13,
                                    count=4)):
            *_, h = pkg.svd(A, _opts(pkg, meth, UseFallbackSolver=False))
        oks.append(bool(h.ok))
    assert oks == [False, False]


def test_svd_escalation_recovers_transient_as_the_reference():
    a = _mat(101, M_DRILL, N_DRILL)
    res = []
    for pkg, fl, o, kw in ((ref, ref_faults, ref_obs, {}),
                           (st, faults, obs, {"device": "cpu"})):
        A = pkg.Matrix.from_numpy(a, NB_DRILL, **kw)
        # seed 2 strikes band entry (10, 11), inside the upper band (a
        # bitflip of a zero outside it stays zero)
        with fl.inject(fl.FaultPlan(site="post_stage1", kind="bitflip",
                                    seed=2, count=1, transient=True)):
            with o.recording() as evs:
                s, U, V = pkg.svd(A, {pkg.Option.UseFallbackSolver: True})
        res.append((np.asarray(s), evs))
        with fl.inject(fl.FaultPlan(site="post_stage1", kind="nan",
                                    seed=17, count=4)):
            with pytest.raises(pkg.SlateNotConvergedError):
                pkg.svd(A, {pkg.Option.UseFallbackSolver: False})
    (s_ref, e_ref), (s, e) = res
    _close(s, s_ref, 1e-10)
    _close(s, np.linalg.svd(a, compute_uv=False), 1e-8)
    assert len(e) == len(e_ref) == 1
    assert e[0]["path"] == e_ref[0]["path"] == "escalated:Bidiag"
    assert e[0]["op"] == "svd" and e[0]["escalations"] == 1


def test_svd_direct_path_and_spans():
    A = st.Matrix.from_numpy(_mat(102, 12, 8), 4, device="cpu")
    with obs.recording() as evs, obs.record_spans() as rec:
        st.svd(A)
    (e,) = evs
    assert e["op"] == "svd" and e["path"] == "direct:Auto"
    names = [s["name"] for s in rec.spans]
    for part in ("ge2tb", "stage2", "backtransform", "certify"):
        assert f"slate.svd/{part}" in names


# ---------------------------------------------------------------- api

def test_api_svd_verbs_match_the_drivers():
    a = _mat(103, 14, 10)
    P = st.Matrix.from_numpy(a, 4, device="cpu")
    s, U, V = api.svd(P)
    s2, U2, V2 = st.svd(P)
    assert torch.equal(s, s2) and torch.equal(U.to_dense(), U2.to_dense())
    assert torch.equal(api.svd_vals(P), st.svd_vals(P))
    _close(api.svd_vals(P), ref.api.svd_vals(ref.Matrix.from_numpy(a, 4)),
           1e-10)
