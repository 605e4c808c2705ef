"""Shared inputs and checks of the port's band tests
(tests/test_torch_band*.py), which hold the band layer against slate_tpu
on the CPU: RTOL, the random and band matrices, the right-hand sides.
``ref_drivers`` restores ``jax.core.trace_state_clean``, which the
reference's ``@annotate``d drivers call and the installed JAX no longer
exports, on the test side only; each test file imports it, as an autouse
fixture.
"""

import numpy as np
import pytest

import jax


RTOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}


@pytest.fixture(autouse=True)
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _rand(seed, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * rng.standard_normal((m, n))
    return a.astype(dtype)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL[dtype] * np.abs(want).max()


def _hpd_band(seed, n, kd, dtype):
    """Hermitian band, diagonally dominant (cond ~ 10), so an f32 solve is
    determined to ~1e-6 and the 1e-5 tolerance means something."""
    a = _rand(seed, n, n, dtype)
    h = np.tril(np.triu(a, -kd))
    return (h + h.conj().T + 6 * (2 * kd + 1) * np.eye(n)).astype(dtype)


def _gen_band(seed, n, kl, ku, dtype):
    """General band; callers add a diagonal for a well-conditioned one."""
    return np.tril(np.triu(_rand(seed, n, n, dtype), -kl), ku)


def _rhs(seed, n, k, dtype):
    return _rand(seed + 100, n, k, dtype)
