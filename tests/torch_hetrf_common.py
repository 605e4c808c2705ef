"""Shared inputs and checks of the port's Hermitian-indefinite tests
(tests/test_torch_hetrf*.py), which hold the port against slate_tpu on the
CPU.  ``ref_drivers`` restores ``jax.core.trace_state_clean``, which the
reference's ``@annotate``d drivers call and the installed JAX no longer
exports, on the test side only; each test file imports it, as an autouse
fixture.
"""

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref

import slate_tpu_torch as st

#: the shapes of the hetrf parity test (float64 in test_torch_hetrf.py,
#: complex128 in test_torch_hetrf_complex.py)
SHAPES = [(70, 16), (64, 16), (50, 8), (9, 4), (16, 16), (5, 8)]

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


def _singular():
    """An indefinite matrix with a zero row and column: P A P^H = L T L^H
    with L unit lower, so Aasen's T is exactly singular, and so is the
    densified LU of the last rung."""
    a = _indef(13, 12)
    a[7, :] = 0.0
    a[:, 7] = 0.0
    return a


def check_hetrf_matches_the_reference(dtype, n, nb):
    """hetrf and hetrs of one Hermitian indefinite matrix in both
    packages: pivots, L, T and its LU equal, P A P^H = L T L^H, the solve
    of three right-hand sides."""
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
