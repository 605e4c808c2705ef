"""The port's band layer against slate_tpu's, on the CPU: the packed-band
kernels of internal/band.py and the drivers pbtrf/pbtrs/pbsv,
gbtrf/gbtrs/gbsv, tbsm, gbmm and hbmm.

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

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu.internal import band as ref_band
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import convert
from slate_tpu_torch.internal import band as port_band
from slate_tpu_torch.robust import faults

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


# ------------------------------------------------------------- packing

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


# ------------------------------------------------------------- pb chain

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


# ------------------------------------------------------------- gb chain

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


# ------------------------------------------------------------- tbsm

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


# ------------------------------------------------------------- gbmm / hbmm

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


# ------------------------------------------------------------- fault sites

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


# ------------------------------------------------------------- convert.py

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
