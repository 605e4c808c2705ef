"""The port's divide and conquer tridiagonal eigensolver against
slate_tpu's, on the CPU: the cases of the reference's stedc tests at n <=
64 (random, odd size, near-diagonal, exact diagonal, glued Wilkinson,
clusters, zero diagonal, single, f32, tiny scale; sizes shared where the
cases allow, so that the reference compiles few shapes), _secular_roots
on the reference's inputs, the Givens chain's waves against the sequential
chain, heev's DC route through stedc, and the post_secular fault.

The same numpy inputs, from a seed, go through both packages.
Eigenvalues are held directly, 1e-10 relative in f64 and 1e-4 in f32;
eigenvectors by residual and orthogonality (1e-12 in f64, scaled by the
spectrum), never element by element (the leaves' eigenvectors may differ
by sign).  Each reference result is computed once a module.  The
reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref
from slate_tpu.drivers import stedc as ref_stedc
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch.drivers import stedc as port_stedc
from slate_tpu_torch.robust import faults


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _glued(k=3):
    w21 = np.abs(np.arange(-10, 11)).astype(float)
    d = np.concatenate([w21] * k)
    e = np.ones(len(d) - 1)
    for i in range(1, k):
        e[21 * i - 1] = 1e-8
    return d, e


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "random":
        return rng.standard_normal(64), rng.standard_normal(63)
    if name == "odd":
        return rng.standard_normal(63), rng.standard_normal(62)
    if name == "near_diagonal":
        return np.ones(64), np.full(63, 1e-14)
    if name == "exact_diagonal":
        return np.arange(64.0), np.zeros(63)
    if name == "glued_wilkinson":
        return _glued()
    if name == "clusters":
        return np.repeat(np.arange(4.0), 16), 1e-13 * np.ones(63)
    if name == "zero_diagonal":
        return np.zeros(32), np.ones(31)
    if name == "leaf":
        return rng.standard_normal(17), rng.standard_normal(16)
    if name == "float32":
        return (rng.standard_normal(64).astype(np.float32),
                rng.standard_normal(63).astype(np.float32))
    assert name == "tiny_scale"
    return rng.standard_normal(64) * 1e-15, rng.standard_normal(63) * 1e-15


CASES = ["random", "odd", "near_diagonal", "exact_diagonal",
         "glued_wilkinson", "clusters", "zero_diagonal", "leaf", "float32",
         "tiny_scale"]


@functools.lru_cache(maxsize=None)
def _ref(name):
    d, e = _case(name)
    w, Z, h = ref.stedc(d, e, opts={ref.Option.ErrorPolicy:
                                    ref.ErrorPolicy.Info})
    return np.asarray(w), np.asarray(Z), bool(h.ok)


@pytest.mark.parametrize("name", CASES)
def test_stedc_matches_the_reference(name):
    d, e = _case(name)
    w_ref, z_ref, ok_ref = _ref(name)
    w, Z, h = st.stedc(d, e, opts={st.Option.ErrorPolicy:
                                   st.ErrorPolicy.Info}, device="cpu")
    assert h.ok and ok_ref
    n = len(d)
    f32 = d.dtype == np.float32
    T = np.diag(d.astype(float)) + np.diag(e.astype(float), 1) \
        + np.diag(e.astype(float), -1)
    wr = np.linalg.eigvalsh(T)
    scale = max(float(np.abs(wr).max()), 1e-300)
    w, z = w.numpy().astype(float), Z.numpy().astype(float)
    assert w.dtype == w_ref.dtype or f32
    tol = 1e-4 if f32 else 1e-10
    assert np.abs(w - w_ref).max() <= tol * max(scale, 1.0 if f32 else
                                                scale)
    assert np.abs(w - wr).max() <= tol * scale
    vtol = 1e-4 if f32 else 1e-12
    assert np.abs(z.T @ z - np.eye(n)).max() <= vtol * 10
    assert np.abs(T @ z - z * w[None, :]).max() <= vtol * 10 * scale


def test_stedc_single():
    w, Z = st.stedc(np.array([3.0]), np.zeros(0), device="cpu")
    assert float(w[0]) == 3.0 and Z.shape == (1, 1)
    w_ref, _ = ref.stedc(np.array([3.0]), np.zeros(0))
    assert float(w[0]) == float(np.asarray(w_ref)[0])


def test_secular_roots_match_the_reference():
    """The bisection alone, on the inputs of a merge: ascending poles, a
    deflated tail (z = 0), rho > 0."""
    rng = np.random.default_rng(5)
    n, na = 40, 33
    cd = np.sort(rng.standard_normal(n))
    cz = rng.standard_normal(n)
    cz[na:] = 0.0
    cz /= np.linalg.norm(cz)
    cd = np.concatenate([cd[:na], np.sort(cd[na:])])
    rho = 1.7
    want_d, want_up = ref_stedc._secular_roots(
        jnp.asarray(cd), jnp.asarray(cz * cz), jnp.asarray(rho),
        jnp.asarray(na))
    got_d, got_up = port_stedc._secular_roots(
        torch.from_numpy(cd), torch.from_numpy(cz * cz),
        torch.tensor(rho, dtype=torch.float64), torch.tensor(na))
    assert np.array_equal(got_up.numpy(), np.asarray(want_up))
    want_d = np.asarray(want_d)
    live = np.arange(n) < na
    assert np.allclose(got_d.numpy()[live], want_d[live], rtol=1e-10,
                       atol=0)
    # chunked rows give the rows' values unchanged
    old = port_stedc._CHUNK_ELEMS
    try:
        port_stedc._CHUNK_ELEMS = 3 * n
        chunked, _ = port_stedc._secular_roots(
            torch.from_numpy(cd), torch.from_numpy(cz * cz),
            torch.tensor(rho, dtype=torch.float64), torch.tensor(na))
    finally:
        port_stedc._CHUNK_ELEMS = old
    assert torch.equal(chunked, got_d)


def _sequential_chain(cd, cz, tol):
    """The reference's Givens deflation chain, one step after another."""
    zv = cz.copy()
    cs = np.tile([1.0, 0.0], (len(cd), 1))
    for i in range(1, len(cd)):
        zp, zi = zv[i - 1], zv[i]
        if (cd[i] - cd[i - 1]) <= tol and zp != 0 and zi != 0:
            r = np.sqrt(zp * zp + zi * zi)
            zv[i - 1], zv[i] = 0.0, r
            cs[i] = (zi / r, zp / r)
    return zv, cs


def test_chain_waves_equal_the_sequential_chain():
    cd = np.array([0.0, 0.0, 0.0, 1.0, 2.0, 2.0, 3.0, 4.0, 4.0, 4.0, 4.0,
                   5.0])
    cz = np.array([0.3, -0.2, 0.1, 0.5, 0.2, 0.4, 0.3, 0.1, 0.2, -0.3,
                   0.0, 0.4])
    want_z, want_cs = _sequential_chain(cd, cz, 1e-12)
    close = np.zeros(len(cd), bool)
    close[1:] = (cd[1:] - cd[:-1] <= 1e-12) & (cz[:-1] != 0) & (cz[1:] != 0)
    waves = port_stedc._chain_waves(torch.from_numpy(close))
    assert [w.tolist() for w in waves] == [[1, 5, 8], [2, 9]]
    z = cz.copy()
    cs = np.tile([1.0, 0.0], (len(cd), 1))
    for i in waves:
        i = i.numpy()
        zp, zi = z[i - 1], z[i]
        r = np.sqrt(zp * zp + zi * zi)
        z[i - 1], z[i] = 0.0, r
        cs[i, 0], cs[i, 1] = zi / r, zp / r
    assert np.array_equal(z, want_z) and np.array_equal(cs, want_cs)


def test_heev_dc_uses_stedc():
    n, nb = 40, 8
    rng = np.random.default_rng(9)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    calls = []
    real = port_stedc._stedc_device

    def spy(d, e, grid=None):
        calls.append(d.shape[0])
        return real(d, e, grid)
    port_stedc._stedc_device = spy
    try:
        w, Z = st.heev(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                       {st.Option.MethodEig: st.MethodEig.DC})
    finally:
        port_stedc._stedc_device = real
    assert calls == [n]
    z, w = Z.to_numpy(), w.numpy()
    assert np.abs(np.sort(w) - np.linalg.eigvalsh(a)).max() < 1e-10
    assert np.abs(a @ z - z * w[None, :]).max() < 1e-10


def test_stedc_fault_detected_and_raises_as_the_reference():
    rng = np.random.default_rng(36)
    d, e = rng.standard_normal(64), rng.standard_normal(63)
    got = []
    for pkg, fl, kw in ((ref, ref_faults, {}), (st, faults,
                                                 {"device": "cpu"})):
        plan = fl.FaultPlan(site="post_secular", kind="nan", seed=2,
                            count=8)
        with fl.inject(plan):
            w, Z, h = pkg.stedc(d, e, opts={pkg.Option.ErrorPolicy:
                                            pkg.ErrorPolicy.Info}, **kw)
        got.append((bool(h.ok), bool(h.converged)))
        with fl.inject(plan):
            with pytest.raises(pkg.SlateNotConvergedError):
                pkg.stedc(d, e, **kw)
    assert got[0] == got[1] == (False, False)


def test_stedc_on_a_tensor_stays_on_its_device_and_host_data_needs_one():
    d = torch.linspace(-1, 1, 40, dtype=torch.float64)
    e = torch.full((39,), 0.3, dtype=torch.float64)
    w, Z = st.stedc(d, e)
    assert w.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.stedc(d.numpy(), e.numpy())
    # a grid without a process group takes the serial route, the same
    # bits (the row-distributed merges: tests/test_torch_dist_spectral.py)
    w2, Z2 = st.stedc(d, e, types.SimpleNamespace(size=2, group=None))
    assert torch.equal(w2, w) and torch.equal(Z2, Z)
