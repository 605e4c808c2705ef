"""The port's triangular and Hermitian band drivers against slate_tpu's on
the CPU (split from test_torch_band.py; shared inputs in
torch_band_common.py): tbsm on every side, op, diag and uplo, hbmm, and
reference band matrices and factors carried across with convert.py.

Tolerances as in test_torch_band.py: f64 and c128 within 1e-12 relative,
f32 and c64 within 1e-5.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref

import slate_tpu_torch as st
from slate_tpu_torch import convert

from torch_band_common import (  # noqa: F401  (ref_drivers: autouse)
    _close, _gen_band, _hpd_band, _rand, _rhs, ref_drivers)


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("diag", ["NonUnit", "Unit"])
@pytest.mark.parametrize("op", ["N", "T", "H"])
@pytest.mark.parametrize("side", ["Left", "Right"])
def test_tbsm(dtype, uplo, diag, op, side):
    n, kd, nb = 45, 4, 8
    a = _rand(6, n, n, dtype)
    t = (np.tril(np.triu(a, -kd)) if uplo == "Lower"
         else np.triu(np.tril(a, kd))) + 4 * np.eye(n, dtype=dtype)
    b = _rhs(6, n, 3, dtype)
    if side == "Right":
        b = b.T.copy()

    def view(M):
        return M if op == "N" else getattr(M, op)
    R = view(ref.TriangularBandMatrix.from_numpy(
        t, kd, nb, getattr(ref.Uplo, uplo), getattr(ref.Diag, diag)))
    P = view(st.TriangularBandMatrix.from_numpy(
        t, kd, nb, getattr(st.Uplo, uplo), getattr(st.Diag, diag),
        device="cpu"))
    want = ref.tbsm(getattr(ref.Side, side), 1.5, R,
                    ref.Matrix.from_numpy(b, nb))
    got = st.tbsm(getattr(st.Side, side), 1.5, P,
                  st.Matrix.from_numpy(b, nb, device="cpu"))
    _close(got.to_numpy(), want.to_numpy(), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
@pytest.mark.parametrize("side", ["Left", "Right"])
def test_hbmm(dtype, side):
    n, kd = 38, 5
    a = _hpd_band(10, n, kd, dtype)
    b = _rhs(10, n, 3, dtype)
    if side == "Right":
        b = b.T.copy()
    c = _rand(11, *b.shape, dtype)
    alpha = 1.5 - 0.5j if np.issubdtype(dtype, np.complexfloating) else 1.5
    want = ref.hbmm(getattr(ref.Side, side), alpha,
                    ref.HermitianBandMatrix.from_numpy(a, kd, 8),
                    ref.Matrix.from_numpy(b, 8), 0.25,
                    ref.Matrix.from_numpy(c, 8))
    got = st.hbmm(getattr(st.Side, side), alpha,
                  st.HermitianBandMatrix.from_numpy(a, kd, 8, device="cpu"),
                  st.Matrix.from_numpy(b, 8, device="cpu"), 0.25,
                  st.Matrix.from_numpy(c, 8, device="cpu"))
    _close(got.to_numpy(), want.to_numpy(), dtype)


def test_convert_carries_band_matrices_and_factors():
    """A reference HermitianBandMatrix, BandMatrix and their factors,
    carried across with convert.py, solve in the port as the reference
    solves them."""
    a = _hpd_band(13, 50, 4, np.float64)
    g = _gen_band(14, 50, 3, 2, np.float64) + np.eye(50)
    b = _rhs(13, 50, 2, np.float64)
    Hr = ref.HermitianBandMatrix.from_numpy(a, 4, 16)
    Gr = ref.BandMatrix.from_numpy(g, 3, 2, 16).T
    Hp = convert.matrix_from_jax(Hr, device="cpu")
    Gp = convert.matrix_from_jax(Gr, device="cpu")
    assert type(Hp) is st.HermitianBandMatrix and Hp.kd == 4
    assert type(Gp) is st.BandMatrix and (Gp.kl, Gp.ku) == (3, 2)
    assert Gp.op is st.Op.Trans
    assert np.array_equal(Hp.to_numpy(), np.asarray(Hr.to_numpy()))
    assert np.array_equal(Gp.to_numpy(), np.asarray(Gr.to_numpy()))
    Fr, Xr = ref.pbsv(Hr, ref.Matrix.from_numpy(b, 16))
    F = convert.pb_factors_from_jax(Fr, device="cpu")
    _close(st.pbtrs(F, torch.from_numpy(b)).numpy(), Xr.to_numpy(),
           np.float64)
    Gfr = ref.gbtrf(Gr)
    Gf = convert.gb_factors_from_jax(Gfr, device="cpu")
    _close(st.gbtrs(Gf, torch.from_numpy(b)).numpy(),
           np.asarray(ref.gbtrs(Gfr, b)), np.float64)
    _close(st.gbsv(Gp, st.Matrix.from_numpy(b, 16, device="cpu"))[1]
           .to_numpy(), np.linalg.solve(g.T, b), np.float64)
    tb = convert.matrix_from_jax(ref.TriangularBandMatrix.from_numpy(
        np.tril(g), 3, 16, ref.Uplo.Lower, ref.Diag.Unit), device="cpu")
    assert type(tb) is st.TriangularBandMatrix
    assert (tb.kd, tb.uplo, tb.diag) == (3, st.Uplo.Lower, st.Diag.Unit)
