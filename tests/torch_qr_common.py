"""Shared inputs and checks of the port's QR tests (tests/test_torch_qr*.py),
which hold the QR and least-squares drivers and the rest of BLAS-3 against
slate_tpu on the CPU: tolerances, Gaussian inputs, CPU matrices, option
tables. ``ref_drivers`` restores ``jax.core.trace_state_clean``, which the
reference's ``@annotate``d drivers call and the installed JAX no longer
exports, on the test side only.
"""

import numpy as np
import pytest

import jax
import slate_tpu as ref

import slate_tpu_torch as st
from slate_tpu_torch.convert import matrix_from_jax


# f32 parity: both sides are blocked Householder (or CholQR) solves of the
# same bytes, sums in another order; on the Gaussian matrices below
# (cond <= ~10) factors and solutions agree to a few n eps of their
# largest entry, which 1e-4 of max|.| holds with room.
F32_RTOL = 1e-4


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _gauss(seed, m, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _close(got, want, rtol=F32_RTOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _cpu(a, nb, nb2=None):
    return st.Matrix.from_numpy(a, nb, nb2, device="cpu")


def _opts(pkg, **kv):
    return {getattr(pkg.Option, k): v for k, v in kv.items()}


def _gram_breaker(seed, m=120, n=40):
    """f64 A with eight columns within 1e-9 of others: cond(A) ~ 1e9, so
    A^H A (cond ~ 1e18, past 1/eps) fails Cholesky, while Householder QR
    solves it to ~1e-7."""
    a = _gauss(seed, m, n, np.float64)
    noise = _gauss(seed + 1, m, 8, np.float64)
    a[:, 30:38] = a[:, 2:10] + 1e-9 * noise
    return a


def _pair(a, nb=16, cls="Matrix", **kw):
    """The same matrix in both packages (f64 or complex128)."""
    R = getattr(ref, cls).from_numpy(a, nb, **kw)
    return R, matrix_from_jax(R, device="cpu")


def _cplx(seed, m, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
