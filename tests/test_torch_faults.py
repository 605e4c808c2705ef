"""The port's fault injector (slate_tpu_torch.robust.faults) against
slate_tpu's, on the CPU: plan validation, strike positions bit for bit
(the same seed strikes the same elements, whole-array and tile-confined,
on 2D, 3D and 4D arrays), payloads, persistent against transient plans,
the host-side sites and the seeded Poisson workload.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from slate_tpu.robust import faults as ref_faults

import slate_tpu_torch as st
from slate_tpu_torch import robust
from slate_tpu_torch.robust import faults


@pytest.mark.parametrize("kw", [
    dict(site="nowhere"),
    dict(site="input", kind="zero"),
    dict(site="input", tile=(1,)),
    dict(site="input", tile=(-1, 0)),
    dict(site="input", tile=(0.5, 0)),
    dict(site="serve_device_fail", device=-1),
])
def test_plan_validation_matches_the_reference(kw):
    with pytest.raises(ValueError) as got:
        faults.FaultPlan(**kw)
    with pytest.raises(ValueError) as want:
        ref_faults.FaultPlan(**kw)
    assert str(got.value) == str(want.value)


def test_site_tables_and_exports():
    assert faults.SITES == ref_faults.SITES
    assert faults.HOST_SITES == ref_faults.HOST_SITES
    assert faults.KINDS == ref_faults.KINDS
    assert robust.FaultPlan is faults.FaultPlan
    assert robust.inject is faults.inject
    assert robust.maybe_corrupt is faults.maybe_corrupt


@pytest.mark.parametrize("shape,kw", [
    ((40, 24), dict(seed=3, count=5)),
    ((40, 24), dict(seed=8, count=3, tile=(1, 2), nb=8)),
    ((40, 20), dict(seed=1, count=2, tile=(4, 2), nb=8)),   # ragged tile
    ((3, 16, 8), dict(seed=5, count=4, tile=(2, 0))),
    ((2, 3, 8, 8), dict(seed=6, count=3, tile=(1, 2))),
    ((2, 3, 8, 8), dict(seed=6, tile=(2, 0))),              # a miss
    ((40, 24), dict(seed=6, tile=(5, 0), nb=8)),            # a miss
])
@pytest.mark.parametrize("kind", ["nan", "inf", "bitflip"])
def test_strike_positions_and_payloads_bit_for_bit(shape, kw, kind):
    """The port draws strike positions with the reference's host numpy
    call, so the same plan strikes the same elements; payloads agree in
    f32 and f64 to the bit."""
    rng = np.random.default_rng(11)
    for dtype in (np.float32, np.float64):
        x = rng.standard_normal(shape).astype(dtype)
        plan = dict(site="input", kind=kind, **kw)
        got = faults.corrupt(torch.from_numpy(x), faults.FaultPlan(**plan))
        want = np.asarray(ref_faults.corrupt(jnp.asarray(x),
                                             ref_faults.FaultPlan(**plan)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_corrupt_leaves_its_input_and_integer_arrays_alone():
    x = torch.ones(8, 8)
    y = faults.corrupt(x, faults.FaultPlan("input", kind="nan"))
    assert torch.isnan(y).sum() == 1 and torch.equal(x, torch.ones(8, 8))
    ints = torch.arange(16)
    assert faults.corrupt(ints, faults.FaultPlan("input")) is ints
    with pytest.raises(ValueError, match="nb > 0"):
        faults.corrupt(x, faults.FaultPlan("input", tile=(0, 0)))


def test_persistent_and_transient_plans():
    """A persistent plan re-fires at every call of its site; a transient
    one fires once per inject() activation, and a new activation arms it
    again.  Outside inject, and at other sites, nothing is struck."""
    x = torch.ones(6, 6)
    assert faults.maybe_corrupt("input", x) is x
    with faults.inject(faults.FaultPlan("post_panel", kind="inf")):
        assert faults.active("post_panel") is not None
        for _ in range(3):
            assert torch.isinf(faults.maybe_corrupt("post_panel", x)).any()
        assert faults.maybe_corrupt("input", x) is x
    assert faults.active("post_panel") is None
    plan = faults.FaultPlan("post_panel", kind="nan", transient=True)
    for _ in range(2):
        with faults.inject(plan):
            assert torch.isnan(faults.maybe_corrupt("post_panel", x)).any()
            assert faults.maybe_corrupt("post_panel", x) is x
    with faults.inject(plan):
        # an empty or integer array neither fires nor spends the strike
        assert faults.maybe_corrupt("post_panel", torch.ones(0)).numel() == 0
        faults.maybe_corrupt("post_panel", torch.arange(4))
        assert torch.isnan(faults.maybe_corrupt("post_panel", x)).any()


def test_host_fire_matches_the_reference():
    """Host-side sites: a device-confined plan fires only for its member,
    a transient one once per activation; trace sites never host-fire."""
    for mod in (faults, ref_faults):
        plan = mod.FaultPlan("serve_device_fail", transient=True, device=1)
        with mod.inject(plan):
            seq = [mod.host_fire("serve_device_fail", 0) is not None,
                   mod.host_fire("serve_device_fail", 1) is not None,
                   mod.host_fire("serve_device_fail", 1) is not None,
                   mod.host_fire("input") is not None]
        assert seq == [False, True, False, False]


def test_poisson_workload_matches_the_reference():
    got = faults.poisson_workload(5, 9, 100.0, (8, 12), nrhs=2)
    want = ref_faults.poisson_workload(5, 9, 100.0, (8, 12), nrhs=2)
    assert [(t, op) for t, op, _, _ in got] == [(t, op)
                                                for t, op, _, _ in want]
    for (_, _, a, b), (_, _, ar, br) in zip(got, want):
        np.testing.assert_array_equal(a, ar)
        np.testing.assert_array_equal(b, br)


def test_post_rbt_site_strikes_the_transformed_matrix():
    """getrf_rbt's post_rbt site sees the butterfly-transformed padded
    matrix: a NaN there fails the NoPiv factor (and the input untouched)."""
    n = 24
    a = (np.random.default_rng(3).standard_normal((n, n))
         + n * np.eye(n)).astype(np.float32)
    A = st.Matrix.from_numpy(a, 8, device="cpu")
    info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
    _, h = st.getrf_rbt(A, info)
    assert h.ok
    with faults.inject(faults.FaultPlan("post_rbt", kind="nan")):
        _, h = st.getrf_rbt(A, info)
    assert h.nonfinite and not h.ok
    np.testing.assert_array_equal(A.to_numpy(), a)
