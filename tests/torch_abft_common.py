"""Shared inputs and checks of the port's checksum tests
(tests/test_torch_abft*.py), which hold the Huang-Abraham rungs against
slate_tpu on the CPU: tolerances, matrices, the info and count readers.
``ref_drivers`` restores ``jax.core.trace_state_clean``, which the
reference's ``@annotate``d drivers call and the installed JAX no longer
exports, on the test side only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import slate_tpu as ref

from slate_tpu.robust import abft as ref_abft
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st

from slate_tpu_torch.robust import abft, faults


N, NB = 96, 32


RTOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _info(pkg, **kv):
    o = {pkg.Option.ErrorPolicy: "info", pkg.Option.Abft: "on"}
    o.update({getattr(pkg.Option, k): v for k, v in kv.items()})
    return o


def _counts(h):
    return int(h.abft_detected), int(h.abft_corrected), int(h.abft_site)


def _close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= RTOL[dtype] * scale


def _dense(seed, n=N, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n, 2))
    return a.astype(dtype), b.astype(dtype)


def _hpd(seed, n=N, dtype=np.float64):
    a, b = _dense(seed, n, np.float64)
    return (a @ a.T / n + n * np.eye(n)).astype(dtype), b.astype(dtype)


def _pair_sum_check(x, er, ec, **kw):
    got = abft.sum_check(torch.from_numpy(x.copy()), torch.from_numpy(er),
                         torch.from_numpy(ec), **kw)
    want = ref_abft.sum_check(jnp.asarray(x), jnp.asarray(er),
                              jnp.asarray(ec), **kw)
    return got, want


def _gesv_pair(a, b, method, plans=(), **kw):
    """gesv in both packages on the same bytes under the same fault plans;
    returns ((F, X, h) of the port, (F, X, h) of the reference)."""
    with faults.inject(*[faults.FaultPlan(**p) for p in plans]):
        got = st.gesv(st.Matrix.from_numpy(a, NB, device="cpu"),
                      st.Matrix.from_numpy(b, NB, device="cpu"),
                      _info(st, MethodLU=getattr(st.MethodLU, method), **kw))
    with ref_faults.inject(*[ref_faults.FaultPlan(**p) for p in plans]):
        want = ref.gesv(ref.Matrix.from_numpy(a, NB, NB),
                        ref.Matrix.from_numpy(b, NB, NB),
                        _info(ref, MethodLU=getattr(ref.MethodLU, method),
                              **kw))
    return got, want


METHODS = ["NoPiv", "PartialPiv", "CALU"]


# a strike in the L part of the first panel's last tile: global tile
# (N // NB - 1, 0), as tests/test_abft.py plants it
PANEL_TILE = (N // NB - 1, 0)


def _posv_pair(a, b, plans=(), dtype=np.float64, **kw):
    with faults.inject(*[faults.FaultPlan(**p) for p in plans]):
        got = st.posv(st.HermitianMatrix.from_numpy(a, NB, device="cpu"),
                      st.Matrix.from_numpy(b, NB, device="cpu"),
                      _info(st, **kw))
    with ref_faults.inject(*[ref_faults.FaultPlan(**p) for p in plans]):
        want = ref.posv(ref.HermitianMatrix.from_numpy(a, NB),
                        ref.Matrix.from_numpy(b, NB, NB), _info(ref, **kw))
    return got, want


def _spd_stack(seed, n, sizes):
    rng = np.random.default_rng(seed)
    out = np.zeros((len(sizes), n, n))
    for i, s in enumerate(sizes):
        g = rng.standard_normal((s, s))
        out[i] = np.eye(n)
        out[i, :s, :s] = g @ g.T / max(s, 1) + np.eye(s)
    return out.astype(np.float32)
