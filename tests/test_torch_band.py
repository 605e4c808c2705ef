"""The port's band layer against slate_tpu's, on the CPU: the packed-band
kernels of internal/band.py and the drivers pbtrf/pbtrs/pbsv,
gbtrf/gbtrs/gbsv, tbsm, gbmm and hbmm.  This file holds the packing,
pbsv and pbtrf and the fault sites; gbsv, gbtrf and gbmm are in
test_torch_band_gb.py, tbsm, hbmm and convert.py in test_torch_band_tb.py,
the shared inputs in torch_band_common.py.

The same numpy inputs, from a seed, go through both packages.
Tolerances: the packing conversions bit-equal; gbtrf's block
permutations equal; f64 and c128 solves and products within 1e-12
relative, f32 and c64 within 1e-5; the health record (info of a
non-positive-definite or singular band) equal.  Reference band matrices
and factors carried across with convert.py solve in the port.  The
reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref
from slate_tpu.internal import band as ref_band
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st

from slate_tpu_torch.internal import band as port_band
from slate_tpu_torch.robust import faults

from torch_band_common import (  # noqa: F401  (ref_drivers: autouse)
    _close, _hpd_band, _rand, _rhs, RTOL, ref_drivers)


@pytest.mark.parametrize("kl,ku", [(0, 0), (3, 2), (5, 0), (0, 4)])
def test_packing_bit_equal(kl, ku):
    a = _rand(1, 23, 19, np.complex128)
    want = np.asarray(ref_band.dense_to_banded(a, kl, ku))
    got = port_band.dense_to_banded(torch.from_numpy(a), kl, ku)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        port_band.banded_to_dense(got, kl, ku, 23, 19).numpy(),
        np.asarray(ref_band.banded_to_dense(want, kl, ku, 23, 19)))
    sq = torch.from_numpy(a[:19, :19].copy())
    p = port_band.dense_to_banded(sq, kl, ku)
    pr = ref_band.dense_to_banded(a[:19, :19], kl, ku)
    for conj in (False, True):
        assert np.array_equal(
            port_band.band_transpose(p, kl, ku, 19, conj).numpy(),
            np.asarray(ref_band.band_transpose(pr, kl, ku, 19, conj)))
    lp = port_band.dense_to_banded(sq, kl, 0)
    assert np.allclose(port_band.hermitian_band_expand(lp, kl, 19).numpy(),
                       np.asarray(ref_band.hermitian_band_expand(
                           np.asarray(lp), kl, 19)), rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", list(RTOL))
@pytest.mark.parametrize("n,kd,nb", [(70, 5, 16), (64, 20, 16), (33, 2, 8),
                                     (40, 1, 4)])
def test_pbsv(dtype, n, kd, nb):
    a = _hpd_band(n + kd, n, kd, dtype)
    b = _rhs(n, n, 3, dtype)
    Fr, Xr = ref.pbsv(ref.HermitianBandMatrix.from_numpy(a, kd, nb),
                      ref.Matrix.from_numpy(b, nb))
    A = st.HermitianBandMatrix.from_numpy(a, kd, nb, device="cpu")
    F, X = st.pbsv(A, st.Matrix.from_numpy(b, nb, device="cpu"))
    assert (F.kd, F.n, F.w) == (Fr.kd, Fr.n, Fr.w)
    _close(F.L_band.numpy(), Fr.L_band, dtype)
    _close(X.to_numpy(), Xr.to_numpy(), dtype)
    # a raw tensor right-hand side returns a tensor
    x = st.pbtrs(F, torch.from_numpy(b))
    assert isinstance(x, torch.Tensor)
    _close(x.numpy(), Xr.to_numpy(), dtype)


def test_pbtrf_transposed_hermitian_band():
    a = _hpd_band(2, 40, 3, np.complex128)
    Fr = ref.pbtrf(ref.HermitianBandMatrix.from_numpy(a, 3, 8).T)
    F = st.pbtrf(st.HermitianBandMatrix.from_numpy(a, 3, 8,
                                                   device="cpu").T)
    _close(F.L_band.numpy(), Fr.L_band, np.complex128)


@pytest.mark.parametrize("policy", ["Raise", "Info", "Nan"])
def test_pbtrf_not_positive_definite(policy):
    a = _hpd_band(3, 48, 4, np.float64)
    a[29, 29] = -100.0
    R = ref.HermitianBandMatrix.from_numpy(a, 4, 8)
    P = st.HermitianBandMatrix.from_numpy(a, 4, 8, device="cpu")
    o_r = {ref.Option.ErrorPolicy: getattr(ref.ErrorPolicy, policy)}
    o_p = {st.Option.ErrorPolicy: getattr(st.ErrorPolicy, policy)}
    if policy == "Raise":
        with pytest.raises(ref.SlateNotPositiveDefiniteError) as er:
            ref.pbtrf(R, o_r)
        with pytest.raises(st.SlateNotPositiveDefiniteError) as ep:
            st.pbtrf(P, o_p)
        assert ep.value.info == er.value.info > 0
    elif policy == "Info":
        _, hr = ref.pbtrf(R, o_r)
        _, h = st.pbtrf(P, o_p)
        assert h.info == int(hr.info) > 0 and h.nonfinite and not h.ok
        b = _rhs(3, 48, 2, np.float64)
        _, _, h2 = st.pbsv(P, st.Matrix.from_numpy(b, 8, device="cpu"), o_p)
        _, _, hr2 = ref.pbsv(R, ref.Matrix.from_numpy(b, 8), o_r)
        assert h2.info == int(hr2.info) and not h2.ok
    else:
        F = st.pbtrf(P, o_p)
        assert torch.isnan(F.L_band).all()


@pytest.mark.parametrize("site", ["input", "solve"])
def test_fault_sites_strike_the_same_element(site):
    """A persistent bitflip at the band drivers' sites: the same element of
    the same packed array is struck in both packages, so the corrupted
    results agree."""
    a = _hpd_band(12, 40, 3, np.float64)
    b = _rhs(12, 40, 2, np.float64)
    plan = dict(site=site, kind="bitflip", seed=5)
    with ref_faults.inject(ref_faults.FaultPlan(**plan)):
        _, Xr, hr = ref.pbsv(ref.HermitianBandMatrix.from_numpy(a, 3, 8),
                             ref.Matrix.from_numpy(b, 8),
                             {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info})
    with faults.inject(faults.FaultPlan(**plan)):
        _, X, h = st.pbsv(st.HermitianBandMatrix.from_numpy(a, 3, 8,
                                                            device="cpu"),
                          st.Matrix.from_numpy(b, 8, device="cpu"),
                          {st.Option.ErrorPolicy: st.ErrorPolicy.Info})
    x, xr = X.to_numpy(), np.asarray(Xr.to_numpy())
    assert not np.allclose(x, np.linalg.solve(a, b))
    np.testing.assert_allclose(x, xr, rtol=1e-12, atol=0, equal_nan=True)
    assert (h.ok, h.info, h.nonfinite) == (bool(hr.ok), int(hr.info),
                                           bool(hr.nonfinite))
