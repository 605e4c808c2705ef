"""The port's CholQR and least-squares drivers (cholqr, gels_cholqr,
gels_qr, gels down both MethodGels branches and m < n, the CholQR -> QR
fallback on an f64 A whose Gram fails Cholesky, the refinement sweep)
against slate_tpu's on the CPU (split from test_torch_qr.py; shared
inputs in torch_qr_common.py).

Solutions are compared directly, R up to the sign of a row where the
reference's default plan takes XLA's CholQR2 panel (test_torch_qr.py
says why).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

import slate_tpu as ref

import slate_tpu_torch as st

from slate_tpu_torch.drivers import qr as dq

from torch_qr_common import (
    _close, _cpu, _gauss, _gram_breaker, _opts, ref_drivers)


def test_cholqr_matches_reference(ref_drivers):
    """CholQR's Q and R are unique (R with a positive diagonal)."""
    m, n, nb = 200, 64, 32
    a = _gauss(7, m, n)
    Qr, Rr = ref.cholqr(ref.Matrix.from_numpy(a, nb))
    Q, R = st.cholqr(_cpu(a, nb))
    _close(Q.to_numpy(), Qr.to_numpy())
    _close(R.to_numpy(), Rr.to_numpy())
    for meth in ("GemmA", "GemmC"):
        _, R2 = st.cholqr(_cpu(a, nb), _opts(
            st, MethodCholQR=getattr(st.MethodCholQR, meth)))
        _close(R2.to_numpy(), R.to_numpy())


@pytest.mark.parametrize("m,n,method", [
    (300, 64, "Auto"), (200, 96, "Auto"), (300, 64, "QR"),
    (200, 96, "CholQR"), (40, 100, "Auto")])
def test_gels_matches_reference(ref_drivers, m, n, method):
    """gels down both select_gels_method branches (300 x 64: CholQR by
    default; 200 x 96: QR), each forced the other way, and the m < n
    minimum-norm branch through gelqf; X against the reference's and the
    f64 least-squares (or minimum-norm) solution."""
    nb = 32
    a, b = _gauss(8, m, n), _gauss(9, m, 3)
    Xr = ref.gels(ref.Matrix.from_numpy(a, nb), ref.Matrix.from_numpy(b, nb),
                  _opts(ref, MethodGels=getattr(ref.MethodGels, method)))
    X = st.gels(_cpu(a, nb), _cpu(b, nb),
                _opts(st, MethodGels=getattr(st.MethodGels, method)))
    assert (X.m, X.n) == (n, 3)
    _close(X.to_numpy(), Xr.to_numpy())
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    _close(X.to_numpy(), x64)


def test_gels_cholqr_and_gels_qr_match_reference(ref_drivers):
    m, n, nb = 160, 48, 32
    a, b = _gauss(10, m, n), _gauss(11, m, 2)
    for name in ("gels_cholqr", "gels_qr"):
        Xr = getattr(ref, name)(ref.Matrix.from_numpy(a, nb),
                                ref.Matrix.from_numpy(b, nb))
        X = getattr(st, name)(_cpu(a, nb), _cpu(b, nb))
        _close(X.to_numpy(), Xr.to_numpy())
    with pytest.raises(st.SlateError, match="m >= n"):
        st.gels_qr(_cpu(a.T.copy(), nb), _cpu(b[:n], nb))


def test_gels_fallback_from_cholqr_to_qr(ref_drivers):
    """m >= 3 n picks CholQR; its Gram matrix fails Cholesky, and the
    UseFallbackSolver rung (the default) retries by Householder QR in both
    packages; with the rung off, the failed attempt's health comes back."""
    nb = 16
    a, b = _gram_breaker(12), _gauss(14, 120, 2, np.float64)
    Xr, hr = ref.gels(ref.Matrix.from_numpy(a, nb),
                      ref.Matrix.from_numpy(b, nb),
                      _opts(ref, ErrorPolicy=ref.ErrorPolicy.Info))
    X, h = st.gels(_cpu(a, nb), _cpu(b, nb),
                   _opts(st, ErrorPolicy=st.ErrorPolicy.Info))
    assert h.ok and bool(hr.ok)
    _close(X.to_numpy(), Xr.to_numpy(), 1e-5)
    x64 = np.linalg.lstsq(a, b, rcond=None)[0]
    _close(X.to_numpy(), x64, 1e-5)
    no_fb = _opts(st, ErrorPolicy=st.ErrorPolicy.Info,
                  UseFallbackSolver=False)
    _, h1 = st.gels(_cpu(a, nb), _cpu(b, nb), no_fb)
    _, hr1 = ref.gels(ref.Matrix.from_numpy(a, nb),
                      ref.Matrix.from_numpy(b, nb),
                      _opts(ref, ErrorPolicy=ref.ErrorPolicy.Info,
                            UseFallbackSolver=False))
    assert not h1.ok and not bool(hr1.ok)
    assert (h1.info > 0) == (int(hr1.info) > 0)
    with pytest.raises(st.SlateNotPositiveDefiniteError, match="Gram"):
        st.gels(_cpu(a, nb), _cpu(b, nb),
                _opts(st, UseFallbackSolver=False))


def test_gels_cholqr_refinement_sweep():
    """One corrected semi-normal-equations sweep (the speculative rung's
    refine) moves X toward the f64 solution, not away."""
    a, b = _gauss(17, 200, 40), _gauss(18, 200, 2)
    x64 = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                          rcond=None)[0]
    X0, _ = dq._gels_cholqr_attempt(_cpu(a, 32), _cpu(b, 32), None)
    X1, h = dq._gels_cholqr_attempt(_cpu(a, 32), _cpu(b, 32), None,
                                    refine=1)
    assert h.ok
    e0 = np.abs(X0.to_numpy() - x64).max()
    e1 = np.abs(X1.to_numpy() - x64).max()
    assert e1 <= 2 * e0 and e1 < 1e-5
