"""The port's checksum rungs on gesv (NoPiv, PartialPiv, CALU: clean,
single, double and transient double strikes) and on gemm and trsm
(no false detection) against slate_tpu's on the CPU (split from
test_torch_abft.py; shared inputs in torch_abft_common.py).

Counts, ``abft_site``, the escalation path and the strike positions are
held EXACT, solutions within 1e-5 relative in f32 and complex64 and
1e-12 in f64 and complex128.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref

import slate_tpu_torch as st

from slate_tpu_torch.robust import abft

from torch_abft_common import (
    _close, _counts, _dense, _gesv_pair, METHODS, NB, PANEL_TILE, ref_drivers)


@pytest.mark.parametrize("method", METHODS)
def test_gesv_abft_clean_zero_counters(ref_drivers, method):
    a, b = _dense(10)
    (_, X, h), (_, Xr, hr) = _gesv_pair(a, b, method)
    assert _counts(h) == _counts(hr) == (0, 0, -1) and h.ok
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", METHODS)
def test_gesv_single_bitflip_located_and_corrected(ref_drivers, method,
                                                   dtype):
    """One bitflip in the first panel's last tile: located at that tile,
    repaired in place, no escalation, the solution the clean one."""
    a, b = _dense(11, dtype=dtype)
    plan = dict(site="post_panel", kind="bitflip", seed=5,
                tile=PANEL_TILE, nb=NB)
    (_, X, h), (_, Xr, hr) = _gesv_pair(a, b, method, [plan])
    assert _counts(h) == _counts(hr) == (1, 1, int(abft.site_code(
        *PANEL_TILE)))
    assert h.ok
    _close(X.to_numpy(), Xr.to_numpy(), dtype)


@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
@pytest.mark.parametrize("method", METHODS)
def test_gesv_double_strike_detected_not_corrected(ref_drivers, method,
                                                   kind):
    """Two struck elements: detected, refused, a health failure, at the
    reference's first site.  A bitflip pair stays finite and is exactly
    one refused event in both.  A refused NaN or Inf spreads through the
    rest of the factorization, and on the pivoted routes how far depends
    on the pivot search over a NaN column (LAPACK's and the tournament's
    plain version skip it, XLA's argmax takes it), so there the later
    events may differ in number; NoPiv's counts are held whole."""
    a, b = _dense(12)
    plan = dict(site="post_panel", kind=kind, seed=5, count=2,
                tile=PANEL_TILE, nb=NB)
    (_, _, h), (_, _, hr) = _gesv_pair(a, b, method, [plan],
                                       UseFallbackSolver=False)
    if kind == "bitflip" or method == "NoPiv":
        assert _counts(h) == _counts(hr)
    assert h.abft_site == int(hr.abft_site)
    assert h.abft_corrected == int(hr.abft_corrected) == 0
    det, cor, _ = _counts(h)
    assert det >= 1 and cor < det and not h.ok
    if kind == "bitflip":
        assert (det, cor) == (1, 0)


@pytest.mark.parametrize("method", METHODS)
def test_gesv_transient_double_strike_saved_by_retry_rung(ref_drivers,
                                                          method):
    """The failed repair retries the SAME method once (the transient strike
    is spent, the retry clean) below any method escalation: clean counts,
    a healthy solve, the same factor type as the reference's."""
    a, b = _dense(13)
    plan = dict(site="post_panel", kind="bitflip", seed=5, count=2,
                transient=True, tile=PANEL_TILE, nb=NB)
    (_, _, h0), (_, _, h0r) = _gesv_pair(a, b, method, [plan],
                                         UseFallbackSolver=False)
    assert not h0.ok and _counts(h0) == _counts(h0r)
    (F, X, h), (Fr, Xr, hr) = _gesv_pair(a, b, method, [plan],
                                         UseFallbackSolver=True)
    if method == "CALU":           # no rung below CALU: nothing retries
        assert not h.ok and _counts(h) == _counts(hr)
        return
    assert h.ok and _counts(h) == _counts(hr) == (0, 0, -1)
    np.testing.assert_array_equal(F.perm.numpy(), np.asarray(Fr.perm))
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)


def test_gemm_trsm_abft_clean_no_false_positive(ref_drivers):
    """Checked gemm and trsm (left and right, lower and upper, a ragged
    n) leave a clean result bit for bit as the unchecked call gives it,
    and agree with the reference's checked calls."""
    rng = np.random.default_rng(30)
    on = {st.Option.Abft: st.Abft.On}
    a, b = rng.standard_normal((72, 60)), rng.standard_normal((60, 84))
    A, B = (st.Matrix.from_numpy(x, 32, device="cpu") for x in (a, b))
    C = st.gemm(1.0, A, B, opts=on)
    assert torch.equal(C.storage.data, st.gemm(1.0, A, B).storage.data)
    Cr = ref.gemm(1.0, ref.Matrix.from_numpy(a, 32),
                  ref.Matrix.from_numpy(b, 32), opts={ref.Option.Abft: "on"})
    _close(C.to_numpy(), Cr.to_numpy(), np.float64)
    n, nrhs = 100, 5
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    rhs = rng.standard_normal((n, nrhs))
    for side, Lm, Lr, r in (
            ("l", st.TriangularMatrix.from_numpy(L, 32, device="cpu"),
             ref.TriangularMatrix.from_numpy(L, 32), rhs),
            ("r", st.TriangularMatrix.from_numpy(L, 32,
                                                 device="cpu").transpose(),
             ref.TriangularMatrix.from_numpy(L, 32).T, rhs.T.copy())):
        Bm = st.Matrix.from_numpy(r, 32, device="cpu")
        X = st.trsm(side, 1.0, Lm, Bm, opts=on)
        assert torch.equal(X.storage.data,
                           st.trsm(side, 1.0, Lm, Bm).storage.data)
        Xr = ref.trsm(side, 1.0, Lr, ref.Matrix.from_numpy(r, 32, 32),
                      opts={ref.Option.Abft: "on"})
        _close(X.to_numpy(), Xr.to_numpy(), np.float64)
