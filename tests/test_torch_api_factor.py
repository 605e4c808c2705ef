"""The port's simplified API against slate_tpu's on the CPU (split from
test_torch_api.py; shared cases in torch_api_common.py): the factor and
QR-factor verbs, the spectral verbs reaching heev and svd, and the batch
verbs.

As in test_torch_api.py: the port must reach the same driver as the
reference and agree within 1e-12 relative in f64; the batch verbs are
bit-equal to the port's own ``make_batched`` and within 1e-4 (f32) of
the reference's, with the same escalation flags; the spectral values
within 1e-9 relative.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu as ref
from slate_tpu import api as ref_api
from slate_tpu.serve import batched as ref_batched

import slate_tpu_torch as st
from slate_tpu_torch import api
from slate_tpu_torch.serve import batched

from torch_api_common import (  # noqa: F401  (ref_drivers: autouse)
    _agree, _agree_arrays, _call_both, _g, _m, _stack, A_TALL, FACTOR_CASES,
    RTOL, SPECTRAL_CASES, UP_TO_SIGNS, ref_drivers)


@pytest.mark.parametrize("case", FACTOR_CASES,
                         ids=[c[0] for c in FACTOR_CASES])
def test_factor_verb_reaches_the_same_driver(monkeypatch, case):
    _, prefix, verb, makers = case
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, makers,
                                             prefix)
    assert calls_p and calls_p[0] == calls_r[0]
    _agree(got, want, signs=verb in UP_TO_SIGNS)


@pytest.mark.parametrize("verb", ["qr_factor", "lq_factor"])
def test_qr_factor_verbs_reach_the_same_driver(monkeypatch, verb):
    """qr_factor/lq_factor: the same driver; R (up to signs, see above)
    agrees."""
    a = A_TALL if verb == "qr_factor" else A_TALL.T.copy()
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, [_g(a)])
    assert calls_p and calls_p[0] == calls_r[0]
    fr = want.F if verb == "lq_factor" else want
    fp = got.F if verb == "lq_factor" else got
    k = min(a.shape)
    rr = np.triu(np.asarray(fr.QR.to_numpy())[:k, :k])
    rp = np.triu(fp.QR.to_numpy()[:k, :k])
    _agree_arrays(np.abs(rp), np.abs(rr))


@pytest.mark.parametrize("case", SPECTRAL_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in SPECTRAL_CASES])
def test_spectral_verbs_reach_the_reference_driver(monkeypatch, case):
    verb, kind, mod, driver = case
    calls_p, calls_r = [], []
    for api_mod, calls in ((api, calls_p), (ref_api, calls_r)):
        m = getattr(api_mod, mod)
        fn = getattr(m, driver)

        def wrapped(*a, __fn=fn, __calls=calls, **k):
            __calls.append(driver)
            return __fn(*a, **k)
        monkeypatch.setattr(m, driver, wrapped)
    got = getattr(api, verb)(_m(kind)(st))
    want = getattr(ref_api, verb)(_m(kind)(ref))
    assert calls_p == calls_r == [driver]
    vals = got if verb.endswith("_vals") else got[0]
    wvals = want if verb.endswith("_vals") else want[0]
    assert np.abs(np.sort(vals.numpy()) - np.sort(np.asarray(wvals))).max() \
        <= RTOL * np.abs(np.asarray(wvals)).max() * 1e3


@pytest.mark.parametrize("verb,op", [
    ("batch_solve", "solve"), ("batch_chol_solve", "chol_solve"),
    ("batch_least_squares_solve", "least_squares_solve")])
def test_batch_verbs(verb, op):
    """Bit-equal to make_batched on the same stack (every size full), and
    the reference's batch verb's results within 1e-4 (f32) with the same
    escalation flags."""
    a, b = _stack(11, 3, 32, 2, op)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x, hs, esc = getattr(api, verb)(ta, tb)
    sizes = torch.full((3,), a.shape[1], dtype=torch.int32)
    x2, hs2, esc2 = batched.make_batched(op)(ta, tb, sizes)
    assert torch.equal(x, x2) and hs == hs2 and esc == esc2
    xr, hr, escr = getattr(ref_api, verb)(a, b)
    assert list(np.asarray(escr)) == esc
    xr = np.asarray(xr)
    assert np.abs(x.numpy() - xr).max() <= 1e-4 * np.abs(xr).max()
    assert all(h.ok for h in hs)


def test_batch_full_sizes():
    a = torch.zeros((4, 6, 3))
    s = api._full_sizes(a, 6)
    r = ref_api._full_sizes(np.zeros((4, 6, 3)), 6)
    assert s.dtype == torch.int32 and s.tolist() == np.asarray(r).tolist()
    assert ref_batched.make_batched and batched.make_batched
