"""The port's Householder QR kernel K5 and the panel routines of
internal/qr.py, against the reference on the CPU.

On the CPU the K5 wrapper runs its plain PyTorch version; that is held
against ``slate_tpu``'s Pallas kernel run as the reference's own tests run
it (``interpret=True``) and against its XLA panel (``householder_panel`` +
``build_t``), on the same numpy inputs, with the tolerances of
tests/test_pallas.py (packed 1e-5, T 1e-4).  The CUDA kernel itself runs
only on the card (tests/test_torch_cuda.py).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from slate_tpu.internal import qr as rq
from slate_tpu.internal.pallas_qr import qr_panel_pallas

from slate_tpu_torch.internal import qr as iq
from slate_tpu_torch.internal import qr_kernels as qk
from slate_tpu_torch.tune.plans import LIBRARY_PLAN, TilePlan, plan_override


def _gauss(seed, m, n, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(dtype)


def _special(seed, m, w):
    """A Gaussian panel with one exactly-zero column (mu = 0: tau = 0, the
    column kept) and alpha = -0.0 in column 0 (beta = -mu, as the
    reference's ``alpha >= 0`` test gives, not copysign's +mu)."""
    a = _gauss(seed, m, w)
    a[:, 5] = 0.0
    a[0, 0] = -0.0
    return a


def _check_panel(a, packed, T):
    """packed and T against the reference's Householder panel and T
    (test_pallas.py's tolerances), and Q R = A through the compact WY."""
    m, w = a.shape
    ref_packed, taus = rq.householder_panel(jnp.asarray(a))
    np.testing.assert_allclose(packed, np.asarray(ref_packed), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(T, np.asarray(rq.build_t(ref_packed, taus)),
                               rtol=1e-4, atol=1e-5)
    V = np.asarray(rq.unit_lower(jnp.asarray(packed)))
    Q = np.eye(m, dtype=np.float32) - V @ T @ V.T
    R = np.concatenate([np.triu(packed[:w]), np.zeros((m - w, w),
                                                       np.float32)])
    np.testing.assert_allclose(Q @ R, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,w,make", [
    (256, 128, _gauss), (512, 128, _gauss), (300, 40, _gauss),
    (1000, 128, _gauss), (200, 48, _special), (128, 128, _gauss),
    (129, 128, _gauss), (136, 8, _gauss)])
def test_k5_plain_matches_the_pallas_kernel_and_the_xla_panel(m, w, make):
    """(256, 128) and (512, 128) as test_pallas.py; a narrow panel, a
    ragged mm (1000 is no multiple of the slab or of 8 rows per warp), a
    panel with a zero column and alpha = -0.0, and the cluster kernel's
    edges the card checks: mm = w, one row past it, and one slab."""
    a = make(m + w, m, w)
    packed, T = qk.qr_panel(torch.from_numpy(a))
    packed, T = packed.numpy(), T.numpy()
    _check_panel(a, packed, T)
    pp, pt = qr_panel_pallas(jnp.asarray(a), interpret=True)
    np.testing.assert_allclose(packed, np.asarray(pp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T, np.asarray(pt), rtol=1e-4, atol=1e-5)
    if make is _special:
        # the zero column is left as it was, with tau = 0, and R[0, 0] =
        # beta = -||a[:, 0]|| for alpha = -0.0
        np.testing.assert_array_equal(np.abs(packed[:, 5]), 0.0)
        assert T[5, 5] == 0.0
        assert packed[0, 0] == pytest.approx(-np.linalg.norm(a[:, 0]),
                                             rel=1e-6)


@pytest.mark.parametrize("bw", [1, 3, 5, 8, 64])
def test_k5_plain_slab_width_changes_only_the_rounding(bw):
    """Every slab width (one column, ragged last slabs, the default and
    widest the kernel takes, and one slab for the whole panel) gives the
    same panel to the reference's tolerances."""
    a = _gauss(40 + bw, 320, 64)
    packed, T = qk.qr_panel_plain(torch.from_numpy(a), bw)
    _check_panel(a, packed.numpy(), T.numpy())


def test_k5_wrapper_runs_the_plain_version_on_the_cpu():
    a = torch.from_numpy(_gauss(7, 96, 32))
    before = qk.QR_PANEL.launches
    got = qk.qr_panel(a.T.contiguous().T, bw=8)      # a column-major view
    want = qk.qr_panel_plain(a, 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert qk.QR_PANEL.launches == before           # no launch off the card
    with pytest.raises(ValueError, match="mm >= w"):
        qk.qr_panel(torch.zeros((8, 16)))
    with pytest.raises(ValueError, match="real"):
        qk.qr_panel_plain(torch.zeros((8, 4), dtype=torch.complex64))


def test_geqrf_panel_routing(monkeypatch):
    """The gate on CPU tensors: real f32, mm * w <= 2^20 and the "cuda"
    plan send a panel to K5's plain version, at the plan's slab width
    and with no limit of the kernel's (those are asked of the kernel on
    the card); everything else takes householder_panel_blocked."""
    taken = []
    monkeypatch.setattr(iq, "qr_panel",
                        lambda a, bw: taken.append(("k5", bw)) or
                        qk.qr_panel(a, bw))
    real_blocked = iq.householder_panel_blocked
    monkeypatch.setattr(iq, "householder_panel_blocked",
                        lambda a, base_w=32: taken.append(("blocked",)) or
                        real_blocked(a, base_w))

    def route(a, plan=None):
        taken.clear()
        if plan is None:
            iq.geqrf_panel(a)
        else:
            with plan_override("geqrf_panel", plan):
                iq.geqrf_panel(a)
        return taken[0]

    a = torch.from_numpy(_gauss(1, 256, 64))
    assert route(a) == ("k5", 8)
    assert route(a, TilePlan(bw=4)) == ("k5", 4)
    assert route(a, TilePlan(bw=16)) == ("k5", 16)
    assert route(a, LIBRARY_PLAN) == ("blocked",)
    assert route(a.double()) == ("blocked",)
    assert route(torch.from_numpy(_gauss(2, 320, 130))) == ("k5", 8)
    # the size cap: 8192 x 128 is the largest K5 panel, one row more is not
    assert iq._qr_panel_ok(torch.zeros((8192, 128)))
    assert not iq._qr_panel_ok(torch.zeros((8193, 128)))
    assert not iq._qr_panel_ok(torch.zeros((64, 65)))      # mm < w


def test_panel_qr_cholqr_and_blocked_panel_match_the_reference():
    """CholQR2 reconstruction on a tall panel, and the recursive scan on a
    short one (mm < 2 w) and on a tall one with a zero column (the Gram
    Cholesky breaks down in both packages), each against the
    reference's."""
    a = _gauss(3, 256, 64)
    pp, pt, ok = iq.panel_qr_cholqr(torch.from_numpy(a))
    rp, rt, rok = rq.panel_qr_cholqr(jnp.asarray(a))
    assert ok and bool(rok)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=1e-4,
                               atol=1e-5)
    short = _gauss(4, 96, 64)
    deficient = _gauss(5, 256, 64)
    deficient[:, 10] = 0.0
    for x in (short, deficient):
        got = iq.householder_panel_blocked(torch.from_numpy(x))
        want = rq.householder_panel_blocked(jnp.asarray(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4)
    assert not iq.panel_qr_cholqr(torch.from_numpy(deficient))[2]


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_householder_panel_build_t_and_vec_match_the_reference(dtype):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((40, 24))
    if dtype is np.complex64:
        a = a + 1j * rng.standard_normal((40, 24))
    a = a.astype(dtype)
    tol = 1e-12 if dtype is np.float64 else 2e-5
    packed, taus = iq.householder_panel(torch.from_numpy(a))
    rp, rt = rq.householder_panel(jnp.asarray(a))
    np.testing.assert_allclose(packed.numpy(), np.asarray(rp), atol=tol)
    np.testing.assert_allclose(taus.numpy(), np.asarray(rt), atol=tol)
    np.testing.assert_allclose(iq.build_t(packed, taus).numpy(),
                               np.asarray(rq.build_t(rp, rt)), atol=tol)
    for x in (a[:, 0], np.zeros(12, dtype)):
        v, tau, beta = iq.householder_vec(torch.from_numpy(x.copy()))
        rv, rtau, rbeta = rq.householder_vec(jnp.asarray(x))
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=tol)
        np.testing.assert_allclose([tau.item(), beta.item()],
                                   [complex(rtau), complex(rbeta)], atol=tol)


@pytest.mark.parametrize("conj_trans", [False, True])
def test_apply_q_left_and_right_match_the_reference(conj_trans):
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((64, 16))
         + 1j * rng.standard_normal((64, 16))).astype(np.complex64)
    packed, taus = rq.householder_panel(jnp.asarray(a))
    T = rq.build_t(packed, taus)
    pk, Tt = torch.from_numpy(np.array(packed)), torch.from_numpy(
        np.array(T))
    c = (rng.standard_normal((64, 5))
         + 1j * rng.standard_normal((64, 5))).astype(np.complex64)
    np.testing.assert_allclose(
        iq.apply_q_left(pk, Tt, torch.from_numpy(c), conj_trans).numpy(),
        np.asarray(rq.apply_q_left(packed, T, jnp.asarray(c), conj_trans)),
        atol=2e-5)
    np.testing.assert_allclose(
        iq.apply_q_right(pk, Tt, torch.from_numpy(c.T.copy()),
                         conj_trans).numpy(),
        np.asarray(rq.apply_q_right(packed, T, jnp.asarray(c.T),
                                    conj_trans)), atol=2e-5)
