"""The port's hesv recovery ladder and posv's fallback to hesv and then
gesv, against slate_tpu's on the CPU (split from test_torch_hetrf.py;
shared inputs in torch_hetrf_common.py).

Two reference hesv tests are red in the reference's own suite
(``test_hesv_zero_offdiag_block``; ``test_hesv_singularish`` in earlier
runs), so those cases are held against numpy/scipy instead.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import scipy.linalg

import slate_tpu as ref

import slate_tpu_torch as st

from torch_hetrf_common import (  # noqa: F401  (ref_drivers: autouse)
    _close, _indef, _mats, _rhs, _singular, ref_drivers)


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
