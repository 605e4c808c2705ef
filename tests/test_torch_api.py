"""The port's simplified API against slate_tpu's, on the CPU: every verb of
``api.__all__``, on each matrix structure it dispatches on. The factor,
QR-factor, spectral and batch verbs are in test_torch_api_factor.py, the
shared cases in torch_api_common.py.

Each case calls one verb in both packages on the same numpy inputs, with
every driver module the API dispatches to wrapped so that the calls it
makes are recorded: the port must reach the same driver (module and
function) as the reference, and its result must agree, within 1e-12
relative in f64.  The batch verbs are bit-equal to the port's own
``make_batched`` on the same stack and agree with the reference's within
1e-4 (f32), with the same escalation flags.  The spectral verbs reach
heev and svd as the reference's do (values within 1e-9 relative; their
mesh target raises, citing queue 1, item 12).  The reference's drivers
are wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``;
the installed JAX no longer exports that name, so the ``ref_drivers``
fixture restores it on the test side only.
"""

import pytest
import torch

import slate_tpu as ref
from slate_tpu import api as ref_api

import slate_tpu_torch as st
from slate_tpu_torch import api

from torch_api_common import (  # noqa: F401  (ref_drivers: autouse)
    _agree, _args, _call_both, A_GEN, A_SPD, AUX_CASES, B, CASES, NB,
    ref_drivers)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_verb_reaches_the_same_driver(monkeypatch, case):
    _, verb, makers = case
    got, want, calls_p, calls_r = _call_both(monkeypatch, verb, makers)
    assert calls_p and calls_p[0] == calls_r[0]
    _agree(got, want)


@pytest.mark.parametrize("case", AUX_CASES, ids=[c[0] for c in AUX_CASES])
def test_aux_verbs_are_the_aux_drivers(case):
    _, verb, makers = case
    from slate_tpu.drivers import auxiliary as ref_aux
    from slate_tpu_torch.drivers import auxiliary as port_aux
    assert getattr(api, verb) is getattr(port_aux, verb)
    assert getattr(ref_api, verb) is getattr(ref_aux, verb)
    _agree(getattr(api, verb)(*_args(makers, st)),
           getattr(ref_api, verb)(*_args(makers, ref)))


def test_api_all_is_the_reference_all():
    assert api.__all__ == ref_api.__all__
    assert all(callable(getattr(api, name)) for name in api.__all__)


@pytest.mark.parametrize("verb", ["eig", "eig_vals", "svd", "svd_vals"])
def test_spectral_verbs_take_the_single_route_without_a_group(verb):
    """Target.mesh on a grid without a process group takes the single
    route, as the reference's verbs do where the grid has no mesh, so it
    gives the single route's bits (held against the reference below; the
    mesh routes on grids with a group in
    tests/test_torch_dist_spectral.py)."""
    A = (st.HermitianMatrix.from_numpy(A_SPD, NB, device="cpu")
         if verb.startswith("eig") else
         st.Matrix.from_numpy(A_GEN, NB, device="cpu"))
    got = getattr(api, verb)(A, {st.Option.Target: st.Target.mesh})
    want = getattr(api, verb)(A)
    got, want = (got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = (x.to_dense() if hasattr(x, "to_dense") else x
                for x in (g, w))
        assert torch.equal(g, w)


def test_operand_errors_match():
    with pytest.raises(st.SlateValueError):
        api.triangular_multiply(1.0, st.Matrix.from_numpy(
            A_GEN, NB, device="cpu"), st.Matrix.from_numpy(B, NB,
                                                           device="cpu"))
    with pytest.raises(st.SlateValueError):
        api.rank_k_update(1.0, st.Matrix.from_numpy(B, NB, device="cpu"),
                          1.0, st.Matrix.from_numpy(A_GEN, NB,
                                                    device="cpu"))
