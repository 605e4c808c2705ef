"""The port's QR and least-squares drivers (geqrf, gelqf, unmqr, unmlq,
qr_multiply, cholqr, gels_cholqr, gels_qr, gels) and the rest of BLAS-3,
against slate_tpu's on the CPU.  cholqr and the gels family are in
test_torch_qr_gels.py, the shared inputs in torch_qr_common.py.

The reference's public drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
The reference's default plan sends every panel to XLA
(``householder_panel_blocked``: CholQR2 reconstruction on tall panels),
whose R may differ from a Householder panel's in the sign of a row; R is
compared up to those signs (as tests/test_pallas.py does), solutions
directly, and one shape against the reference forced onto its Pallas
panel, whose signs K5 shares.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch.convert import lq_factors_from_jax, qr_factors_from_jax
from slate_tpu_torch.drivers import qr as dq

from torch_qr_common import (
    _close, _cplx, _cpu, _gauss, _opts, _pair, F32_RTOL, ref_drivers)


@pytest.mark.parametrize("m,n,nb,dtype,rtol", [
    (200, 80, 32, np.float32, F32_RTOL), (96, 40, 16, np.float64, 1e-12),
    (48, 32, 16, np.complex64, F32_RTOL)])
def test_geqrf_matches_reference(ref_drivers, m, n, nb, dtype, rtol):
    """|R| against the reference's, and the port's own Q R = A and
    Q^H Q = I; f32 takes K5 (a narrow last panel at n = 80: its T is
    zero-padded), f64 and complex64 the blocked panel."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((m, n))
    if np.iscomplexobj(np.zeros(1, dtype)):
        a = a + 1j * rng.standard_normal((m, n))
    a = a.astype(dtype)
    Fr = ref.geqrf(ref.Matrix.from_numpy(a, nb))
    F = st.geqrf(_cpu(a, nb))
    assert isinstance(F, st.QRFactors) and F.T.shape == (-(-n // nb), nb, nb)
    r = np.triu(F.QR.to_numpy()[:n])
    _close(np.abs(r), np.abs(np.triu(Fr.QR.to_numpy()[:n])), rtol)
    q = st.qr_multiply(F).to_numpy()
    _close(q @ r, a, rtol)
    np.testing.assert_allclose(q.conj().T @ q, np.eye(n), atol=10 * rtol)
    if n % nb:
        w = n % nb
        np.testing.assert_array_equal(F.T[-1].numpy()[w:], 0)
        np.testing.assert_array_equal(F.T[-1].numpy()[:, w:], 0)


def test_geqrf_matches_the_reference_on_its_pallas_plan(ref_drivers):
    """The reference forced onto its Pallas Householder panel (interpret
    mode), whose signs are K5's: packed factor and T stack directly."""
    m, n, nb = 384, 256, 128
    a = _gauss(2, m, n)
    with ref_override("geqrf_panel", RefPlan(kernel="pallas", nb=nb, bw=8)):
        Fr = ref.geqrf(ref.Matrix.from_numpy(a, nb))
    F = st.geqrf(_cpu(a, nb))
    _close(F.QR.to_numpy(), Fr.QR.to_numpy())
    _close(F.T.numpy(), np.asarray(Fr.T))


@pytest.mark.parametrize("side,op", [("l", "n"), ("l", "c"), ("r", "n"),
                                     ("r", "t")])
def test_unmqr_on_the_references_factors(ref_drivers, side, op):
    """The reference's QRFactors carried across byte for byte
    (qr_factors_from_jax), then Q or Q^H applied from either side by both
    packages."""
    m, n, nb = 120, 72, 32
    Fr = ref.geqrf(ref.Matrix.from_numpy(_gauss(3, m, n), nb))
    F = qr_factors_from_jax(Fr, device="cpu")
    np.testing.assert_array_equal(F.T.numpy(), np.asarray(Fr.T))
    np.testing.assert_array_equal(F.QR.to_numpy(), Fr.QR.to_numpy())
    c = _gauss(4, m, 5) if side == "l" else _gauss(4, 5, m)
    want = ref.unmqr(side, op, Fr, ref.Matrix.from_numpy(c, nb)).to_numpy()
    got = st.unmqr(side, op, F, _cpu(c, nb)).to_numpy()
    _close(got, want)


def test_gelqf_unmlq_and_qr_multiply(ref_drivers):
    m, n, nb = 48, 100, 32
    a = _gauss(5, m, n)
    Fr = ref.gelqf(ref.Matrix.from_numpy(a, nb))
    F = st.gelqf(_cpu(a, nb))
    assert isinstance(F, st.LQFactors)
    _close(np.abs(np.triu(F.F.QR.to_numpy()[:m])),
           np.abs(np.triu(Fr.F.QR.to_numpy()[:m])))
    Fc = lq_factors_from_jax(Fr, device="cpu")
    c = _gauss(6, n, 3)
    for op in ("n", "c"):
        _close(st.unmlq("l", op, Fc, _cpu(c, nb)).to_numpy(),
               ref.unmlq("l", op, Fr, ref.Matrix.from_numpy(c, nb))
               .to_numpy())
    q = st.qr_multiply(F.F).to_numpy()                  # [n, m], thin
    np.testing.assert_allclose(q.T @ q, np.eye(m), atol=1e-5)
    with pytest.raises(st.SlateError, match="undefined for complex"):
        st.unmqr("l", "t", st.geqrf(_cpu(a.astype(np.complex64), nb)),
                 _cpu(np.zeros((m, 2), np.complex64), nb))


def test_info_return_shapes_and_unported_rungs():
    a, b = _gauss(15, 96, 24), _gauss(16, 96, 2)
    info = _opts(st, ErrorPolicy=st.ErrorPolicy.Info)
    for meth in (st.MethodGels.CholQR, st.MethodGels.QR):
        X, h = st.gels(_cpu(a, 32), _cpu(b, 32),
                       {**info, st.Option.MethodGels: meth})
        assert isinstance(h, st.HealthInfo) and h.ok and X.n == 2
    X, h = st.gels(_cpu(a.T.copy(), 32), _cpu(b[:24], 32), info)
    assert h.ok and (X.m, X.n) == (96, 2)
    (Q, R), h = st.cholqr(_cpu(a, 32), info)
    assert h.ok and (Q.m, Q.n, R.m) == (96, 24, 24)
    X, h = st.gels_cholqr(_cpu(a, 32), _cpu(b, 32), info)
    assert h.ok
    # the speculative rungs are ported: the certified CholQR2 rung records
    # its one refinement sweep, the bf16 QR rung its two
    X, h = st.gels(_cpu(a, 32), _cpu(b, 32),
                   {**info, st.Option.Speculate: st.Speculate.On})
    assert h.ok and h.iters == 1
    X, h = st.gels(_cpu(a, 32), _cpu(b, 32),
                   {**info, st.Option.Speculate: st.Speculate.On,
                    st.Option.Precision: st.Precision.Bf16})
    assert h.ok and h.iters == 2
    # the certified attempt (robust/certify.certify_lstsq) is ported: a
    # well-conditioned A passes, with the refinement recorded as iters
    X, h = dq._gels_cholqr_attempt(_cpu(a, 32), _cpu(b, 32), None, refine=1,
                                   certify=True)
    assert h.ok and h.iters == 1
    # Target.mesh on a grid without a process group takes the single
    # route, as the reference's geqrf does when its grid has no mesh (on a
    # grid with a group geqrf is CAQR, ported with queue 1, item 12b:
    # tests/test_torch_dist_qr.py)
    F_mesh = st.geqrf(_cpu(a, 32), _opts(st, Target=st.Target.mesh))
    assert torch.equal(F_mesh.QR.to_dense(),
                       st.geqrf(_cpu(a, 32)).QR.to_dense())
    with pytest.raises(ValueError, match="MethodGels"):
        st.gels(_cpu(a, 32), _cpu(b, 32), _opts(st, MethodGels="qr"))


def test_hemm_is_gemm_for_every_method():
    """On one device every MethodHemm value is gemm of the expanded A, on
    either side: the same bytes, C's tiling, and the literal beta = 0
    skip (a NaN in C never reaches the product)."""
    H = st.HermitianMatrix.from_numpy(_cplx(46, 32, 32), 16,
                                      uplo=st.Uplo.Lower, device="cpu")
    B = st.Matrix.from_numpy(_cplx(47, 32, 20), 16, device="cpu")
    R = st.Matrix.from_numpy(_cplx(48, 20, 32), 16, device="cpu")
    alpha = 0.7 - 0.2j
    for side, x, want in (("l", B, st.gemm(alpha, H, B)),
                          ("r", R, st.gemm(alpha, R, H))):
        nan = st.Matrix.from_numpy(np.full((want.m, want.n), np.nan + 0j),
                                   16, device="cpu")
        for meth in st.MethodHemm:
            o = _opts(st, MethodHemm=meth)
            got = st.hemm(side, alpha, H, x, 0.0, None, o)
            assert (got.mb, got.nb) == (want.mb, want.nb)
            assert torch.equal(got.to_dense(), want.to_dense())
            assert torch.equal(
                st.hemm(side, alpha, H, x, 0.0, nan, o).to_dense(),
                want.to_dense())
        assert torch.equal(st.hemmA(side, alpha, H, x).to_dense(),
                           want.to_dense())
    with pytest.raises(ValueError, match="MethodHemm"):
        st.hemm("l", 1.0, H, B, 0.0, None, _opts(st, MethodHemm="hemmA"))


def test_gemm_family_matches_reference(ref_drivers):
    Ar, A = _pair(_gauss(20, 40, 24, np.float64))
    Br, B = _pair(_gauss(21, 24, 36, np.float64))
    Cr, C = _pair(_gauss(22, 40, 36, np.float64))
    for args in ((1.0, 0.0), (-2.0, 0.5)):
        want = ref.gemm(args[0], Ar, Br, args[1], Cr).to_numpy()
        for fn in (st.gemm, st.gemmA, st.gemmC):
            np.testing.assert_allclose(
                fn(args[0], A, B, args[1], C).to_numpy(), want, atol=1e-12)
    np.testing.assert_allclose(st.gemm(1.5, A, B).to_numpy(),
                               ref.gemm(1.5, Ar, Br).to_numpy(), atol=1e-12)
    At = A.transpose()
    np.testing.assert_allclose(
        st.gemm(1.0, At, C).to_numpy(),
        ref.gemm(1.0, Ar.transpose(), Cr).to_numpy(), atol=1e-12)
    # the literal beta = 0 skips C: 0 * NaN is never formed
    nan = st.Matrix.from_numpy(np.full((40, 36), np.nan), 16, device="cpu")
    assert np.isfinite(st.gemm(1.0, A, B, 0.0, nan).to_numpy()).all()
    with pytest.raises(ValueError, match="MethodGemm"):
        st.gemm(1.0, A, B, 0.0, None, _opts(st, MethodGemm="gemmA"))


def test_trmm_rank_k_and_hemm_match_reference(ref_drivers):
    a = _cplx(23, 32, 32)
    Tr, T = _pair(a, cls="TriangularMatrix", uplo=ref.Uplo.Upper,
                  diag=ref.Diag.Unit)
    Br, B = _pair(_cplx(24, 32, 20))
    Rr, R = _pair(_cplx(25, 20, 32))
    for side, (xr, x) in (("l", (Br, B)), ("r", (Rr, R))):
        np.testing.assert_allclose(
            st.trmm(side, 0.5, T, x).to_numpy(),
            ref.trmm(side, 0.5, Tr, xr).to_numpy(), atol=1e-12)
    Kr, K = _pair(_cplx(26, 32, 12))
    Lr, L = _pair(_cplx(27, 32, 12))
    alpha = 0.7 - 0.2j
    for cls, fn, args in (("HermitianMatrix", "herk", (1.5,)),
                          ("SymmetricMatrix", "syrk", (1.5,)),
                          ("HermitianMatrix", "her2k", (alpha, "B")),
                          ("SymmetricMatrix", "syr2k", (alpha, "B"))):
        Cr, C = _pair(_cplx(28, 32, 32), cls=cls, uplo=ref.Uplo.Lower)
        if args[-1] == "B":
            want = getattr(ref, fn)(args[0], Kr, Lr, 0.5, Cr)
            got = getattr(st, fn)(args[0], K, L, 0.5, C)
        else:
            want = getattr(ref, fn)(args[0], Kr, 0.5, Cr)
            got = getattr(st, fn)(args[0], K, 0.5, C)
        assert type(got).__name__ == cls
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   atol=1e-11)
    Hr, H = _pair(_cplx(29, 32, 32), cls="HermitianMatrix",
                  uplo=ref.Uplo.Lower)
    for side, (xr, x) in (("l", (Br, B)), ("r", (Rr, R))):
        for meth in ("Auto", "hemmA", "hemmC"):
            o = _opts(ref, MethodHemm=getattr(ref.MethodHemm, meth))
            want = ref.hemm(side, alpha, Hr, xr, 0.0, None, o).to_numpy()
            got = st.hemm(side, alpha, H, x, 0.0, None, _opts(
                st, MethodHemm=getattr(st.MethodHemm, meth))).to_numpy()
            np.testing.assert_allclose(got, want, atol=1e-11)
        np.testing.assert_allclose(
            st.hemmA(side, alpha, H, x).to_numpy(),
            ref.hemmA(side, alpha, Hr, xr).to_numpy(), atol=1e-11)
    Sr, S = _pair(_gauss(30, 32, 32, np.float64), cls="SymmetricMatrix")
    Er, E = _pair(_gauss(31, 32, 8, np.float64))
    np.testing.assert_allclose(st.symm("l", 2.0, S, E).to_numpy(),
                               ref.symm("l", 2.0, Sr, Er).to_numpy(),
                               atol=1e-12)


def test_zeros_with_dense_and_general_match_reference():
    a = _gauss(32, 40, 24, np.float64)
    Z = st.Matrix.zeros(40, 24, 16, device="cpu")
    assert Z.dtype == torch.float32 and not Z.to_numpy().any()
    Rr, R = _pair(a)
    d = _gauss(33, 24, 40, np.float64)
    got = R.transpose().with_dense(torch.from_numpy(d))
    want = Rr.transpose().with_dense(d)
    assert got.op is st.Op.Trans
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got.storage.data.numpy(),
                                  np.asarray(want.storage.data))
    Tr, T = _pair(_gauss(34, 32, 32, np.float64), cls="TriangularMatrix",
                  uplo=ref.Uplo.Lower, diag=ref.Diag.Unit)
    G = T.general()
    assert type(G) is st.Matrix
    np.testing.assert_array_equal(G.to_numpy(), Tr.general().to_numpy())
    with pytest.raises(st.SlateError, match="with_dense"):
        R.with_dense(torch.zeros((40, 24), device="meta"))
