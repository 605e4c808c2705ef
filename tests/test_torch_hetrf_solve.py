"""The port's hesv on every structure and precision, certify_ldlt, the
post_stage1 fault site and convert.py's HEFactors, against slate_tpu's on
the CPU (split from test_torch_hetrf.py; shared inputs in
torch_hetrf_common.py).

Tolerances: f64 and c128 solves within 1e-12 relative, f32 and c64 within
1e-5 where the two packages' f32 pivot choices agree; the health record
equal.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref
from slate_tpu.robust import certify as ref_certify
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import convert
from slate_tpu_torch.robust import certify, faults

from torch_hetrf_common import (  # noqa: F401  (ref_drivers: autouse)
    _close, _indef, _mats, _rhs, ref_drivers)


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("cls", ["HermitianMatrix", "SymmetricMatrix"])
def test_hesv_structures(cls, uplo):
    a = _indef(3, 45)
    b = _rhs(3, 45, 2)
    R, P = _mats(a, 8, cls, uplo)
    Fr, Xr = ref.hesv(R, ref.Matrix.from_numpy(b, 8))
    F, X = st.hesv(P, st.Matrix.from_numpy(b, 8, device="cpu"))
    assert type(F).__name__ == "HEFactors"
    _close(X.to_numpy(), Xr.to_numpy(), np.float64)
    x = np.linalg.solve(a, b)
    assert np.abs(X.to_numpy() - x).max() <= 1e-10 * np.abs(x).max()


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_hesv_single_precision(dtype):
    a = _indef(4, 48, dtype)
    b = _rhs(4, 48, 2, dtype)
    R, P = _mats(a, 16)
    Fr, Xr = ref.hesv(R, ref.Matrix.from_numpy(b, 16))
    F, X = st.hesv(P, st.Matrix.from_numpy(b, 16, device="cpu"))
    # two backward-stable f32 solves agree to ~cond(A) eps_f32: held at
    # 1e-5 cond(A) to each other and to the f64 solution
    kappa = np.linalg.cond(a.astype(np.complex128))
    x64 = np.linalg.solve(a.astype(np.complex128), b)
    for x, want in ((X.to_numpy(), np.asarray(Xr.to_numpy())),
                    (X.to_numpy(), x64)):
        assert np.abs(x - want).max() <= 1e-5 * kappa * np.abs(want).max()


# ------------------------------------------------------------- health

def test_certify_ldlt_matches_the_reference():
    a = _indef(7, 40)
    R, P = _mats(a, 8)
    Fr, F = ref.hetrf(R), st.hetrf(P)
    hr = ref_certify.certify_ldlt(a, Fr.L, Fr.T_dense(), Fr.piv)
    h = certify.certify_ldlt(torch.from_numpy(a), F.L, F.T_dense(), F.piv)
    assert h.converged == bool(hr.converged) is True
    # clean ratios sit at rounding level: both far under the tolerance
    tol = certify.tolerance(torch.float64, 40)
    assert h.growth < 1e-2 * tol and float(hr.growth) < 1e-2 * tol
    # a corrupted L fails the certificate in both packages
    Lb = F.L.clone()
    Lb[30, 3] += 1.0
    bad = certify.certify_ldlt(torch.from_numpy(a), Lb, F.T_dense(), F.piv)
    Lr = np.asarray(Fr.L).copy()
    Lr[30, 3] += 1.0
    bad_r = ref_certify.certify_ldlt(a, Lr, Fr.T_dense(), Fr.piv)
    assert bad.converged == bool(bad_r.converged) is False
    assert bad.min_pivot_index == int(bad_r.min_pivot_index)


def test_post_stage1_strike_fails_the_certificate():
    """A bitflip in L (site post_stage1) is finite with a healthy T: the
    certificate catches it in both packages, on the same element."""
    a = _indef(8, 40)
    b = _rhs(8, 40, 2)
    plan = dict(site="post_stage1", kind="bitflip", seed=3)
    o_r = {ref.Option.ErrorPolicy: ref.ErrorPolicy.Info,
           ref.Option.UseFallbackSolver: False}
    o_p = {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
           st.Option.UseFallbackSolver: False}
    R, P = _mats(a, 8)
    with ref_faults.inject(ref_faults.FaultPlan(**plan)):
        _, hr = ref.hetrf(R, o_r)
    with faults.inject(faults.FaultPlan(**plan)):
        _, h = st.hetrf(P, o_p)
        _, _, hs = st.hesv(P, st.Matrix.from_numpy(b, 8, device="cpu"), o_p)
    assert h.ok == bool(hr.ok)
    assert h.converged == bool(hr.converged)
    assert h.min_pivot_index == int(hr.min_pivot_index)
    assert not hs.ok


# ------------------------------------------------------------- convert.py

def test_convert_carries_he_factors():
    """A reference HEFactors carried across with convert.py solves in the
    port as the reference's hetrs does."""
    a = _indef(17, 50, np.complex128)
    b = _rhs(17, 50, 3, np.complex128)
    Fr = ref.hetrf(ref.HermitianMatrix.from_numpy(a, 16))
    F = convert.he_factors_from_jax(Fr, device="cpu")
    assert type(F) is st.HEFactors and F.piv.dtype == torch.int64
    got = st.hetrs(F, st.Matrix.from_numpy(b, 16, device="cpu"))
    _close(got.to_numpy(), ref.hetrs(Fr, ref.Matrix.from_numpy(b, 16))
           .to_numpy(), np.complex128)
    _close(got.to_numpy(), np.linalg.solve(a, b), np.float32)
