"""The port's general band drivers against slate_tpu's on the CPU (split
from test_torch_band.py; shared inputs in torch_band_common.py): gbsv,
gbtrf of a transposed band, a singular band and pivot growth, gbmm.

Tolerances as in test_torch_band.py: gbtrf's block permutations equal;
f64 and c128 solves and products within 1e-12 relative, f32 and c64
within 1e-5; the health record equal.
"""

import numpy as np
import pytest

import slate_tpu as ref

import slate_tpu_torch as st

from torch_band_common import (  # noqa: F401  (ref_drivers: autouse)
    _close, _gen_band, _rand, _rhs, RTOL, ref_drivers)


@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("n,kl,ku,nb", [(70, 4, 3, 16), (64, 10, 2, 16),
                                        (33, 1, 6, 8), (40, 0, 3, 8)])
def test_gbsv(dtype, n, kl, ku, nb):
    a = (_gen_band(n + kl, n, kl, ku, dtype)
         + 3 * (kl + ku + 1) * np.eye(n, dtype=dtype))
    b = _rhs(n, n, 3, dtype)
    Fr, Xr = ref.gbsv(ref.BandMatrix.from_numpy(a, kl, ku, nb),
                      ref.Matrix.from_numpy(b, nb))
    F, X = st.gbsv(st.BandMatrix.from_numpy(a, kl, ku, nb, device="cpu"),
                   st.Matrix.from_numpy(b, nb, device="cpu"))
    assert np.array_equal(F.perms.numpy(), np.asarray(Fr.perms))
    assert (F.kl, F.ku, F.n, F.w) == (Fr.kl, Fr.ku, Fr.n, Fr.w)
    _close(F.LU_band.numpy(), Fr.LU_band, dtype)
    _close(X.to_numpy(), Xr.to_numpy(), dtype)


@pytest.mark.parametrize("op", ["T", "H"])
def test_gbtrf_of_a_transposed_band(op):
    a = _gen_band(4, 50, 3, 5, np.complex128) + np.eye(50)
    b = _rhs(4, 50, 2, np.complex128)
    R = getattr(ref.BandMatrix.from_numpy(a, 3, 5, 8), op)
    P = getattr(st.BandMatrix.from_numpy(a, 3, 5, 8, device="cpu"), op)
    Fr, F = ref.gbtrf(R), st.gbtrf(P)
    assert (F.kl, F.ku) == (Fr.kl, Fr.ku) == (5, 3)
    assert np.array_equal(F.perms.numpy(), np.asarray(Fr.perms))
    _close(st.gbtrs(F, st.Matrix.from_numpy(b, 8, device="cpu")).to_numpy(),
           ref.gbtrs(Fr, ref.Matrix.from_numpy(b, 8)).to_numpy(),
           np.complex128)


def test_gbtrf_singular_and_growth():
    a = _gen_band(5, 40, 2, 2, np.float64)
    a[:, 17] = 0.0
    o_r = {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info}
    o_p = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    _, hr = ref.gbtrf(ref.BandMatrix.from_numpy(a, 2, 2, 8), o_r)
    _, h = st.gbtrf(st.BandMatrix.from_numpy(a, 2, 2, 8, device="cpu"), o_p)
    assert h.info == int(hr.info) == 18 and not h.ok
    assert abs(h.growth - float(hr.growth)) <= 1e-12 * float(hr.growth)
    with pytest.raises(st.SlateSingularError):
        st.gbsv(st.BandMatrix.from_numpy(a, 2, 2, 8, device="cpu"),
                st.Matrix.from_numpy(_rhs(5, 40, 1, np.float64), 8,
                                     device="cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("op", ["N", "T", "H"])
def test_gbmm(dtype, op):
    n, kl, ku = 41, 3, 6
    a = _gen_band(7, n, kl, ku, dtype)
    b = _rhs(7, n, 4, dtype)
    c = _rand(8, n, 4, dtype)

    def view(M):
        return M if op == "N" else getattr(M, op)
    for beta, C in ((0.0, None), (-0.5, c)):
        want = ref.gbmm(2.0, view(ref.BandMatrix.from_numpy(a, kl, ku, 8)),
                        ref.Matrix.from_numpy(b, 8), beta,
                        None if C is None else ref.Matrix.from_numpy(C, 8))
        got = st.gbmm(2.0, view(st.BandMatrix.from_numpy(a, kl, ku, 8,
                                                         device="cpu")),
                      st.Matrix.from_numpy(b, 8, device="cpu"), beta,
                      None if C is None else st.Matrix.from_numpy(
                          C, 8, device="cpu"))
        _close(got.to_numpy(), want.to_numpy(), dtype)


def test_gbmm_rectangular_band():
    a = _gen_band(9, 30, 2, 3, np.float64)[:, :22]
    b = _rhs(9, 22, 3, np.float64)
    want = ref.gbmm(1.0, ref.BandMatrix.from_numpy(a, 2, 3, 8),
                    ref.Matrix.from_numpy(b, 8))
    got = st.gbmm(1.0, st.BandMatrix.from_numpy(a, 2, 3, 8, device="cpu"),
                  st.Matrix.from_numpy(b, 8, device="cpu"))
    _close(got.to_numpy(), want.to_numpy(), np.float64)
