"""Shared inputs and checks of the port's mixed-precision tests
(tests/test_torch_mixed*.py), which hold gesv_mixed, posv_mixed and their
GMRES-IR variants against slate_tpu's on the CPU.  ``ref_drivers``
restores ``jax.core.trace_state_clean``, which the reference's
``@annotate``d drivers call and the installed JAX no longer exports, on
the test side only; each test file imports it, as an autouse fixture.
"""

import numpy as np
import pytest

import jax
import slate_tpu as ref

import slate_tpu_torch as st

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


def _run_ref_only(fn, a, b):
    cls = ref.HermitianMatrix if fn.startswith("posv") else ref.Matrix
    return getattr(ref, fn)(cls.from_numpy(a, 8), ref.Matrix.from_numpy(b, 8))
