"""The port's device pool and online retune (slate_tpu_torch.serve) on the
CPU, mirroring tests/test_serve_pool.py.

A K-member pool is K members on the CPU device: they share the cache's
callables and keep separate health, so the failover machinery runs as it
does on K cards.  Chaos comes from seeded ``robust.faults`` plans with
``device=i`` targeting.  The guarantees are the reference's: a killed
member's batch fails over with no ticket lost and results bit-identical
to a no-fault run, the member is quarantined and readmitted by a clean
canary, a wedged member fails over on the dispatch deadline, one survivor
keeps serving and none raises a typed overload error, the governor keeps
per-member tails, and a bimodal stream makes exactly one ladder hot swap.
Where the reference pins "no retrace", the port pins zero captures.  The
metrics-CLI and compare tests wait for the port's obs metrics (ROADMAP.md
queue 1, item 10).
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from slate_tpu_torch import serve
from slate_tpu_torch.exceptions import SlateServeError
from slate_tpu_torch.obs import events as obs
from slate_tpu_torch.obs import sentinel, slo
from slate_tpu_torch.robust import faults


def _rng():
    return np.random.default_rng(177)


def _mk_solve(rng, n, k=2, dtype=np.float32):
    a = rng.standard_normal((n, n)).astype(dtype)
    a += np.eye(n, dtype=dtype) * (4 + np.sqrt(n))
    return a, rng.standard_normal((n, k)).astype(dtype)


def _check_solve(a, b, res, tol=1e-3):
    assert np.allclose(res.x.numpy(), np.linalg.solve(
        a.astype(np.float64), b.astype(np.float64)), rtol=tol, atol=tol)


def _pool_server(members=2, strike_limit=1, canary_interval_s=30.0,
                 dispatch_timeout_s=None, cache=None, admission=None):
    pool = serve.DevicePool(
        ["cpu"] * members,
        serve.PoolConfig(strike_limit=strike_limit,
                         canary_interval_s=canary_interval_s,
                         dispatch_timeout_s=dispatch_timeout_s))
    return serve.Server(cache=cache or serve.ExecutableCache(),
                        admission=admission, pool=pool)


def _device_events(recs, event=None):
    out = [e for e in recs if e.get("kind") == "serve_device"]
    if event is not None:
        out = [e for e in out if e.get("event") == event]
    return out


def _batch_events(recs):
    return [e for e in recs if e.get("kind") == "serve_batch"]


def _serve_once(srv, reqs):
    tickets = [srv.submit(op, a, b) for op, a, b in reqs]
    results = srv.drain()
    return [results[int(t)] for t in tickets]


# --------------------------------------------------------- pool basics


def test_pool_defaults_to_one_cuda_member():
    pool = serve.DevicePool()
    assert pool.size() == 1 and pool.members()[0]["device"] == "cuda:0"
    assert pool.healthy_count() == 1 and not pool.degraded()


def test_default_server_is_single_member():
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache())
    assert srv.pool.size() == 1 and srv.device == torch.device("cpu")
    assert srv.pool.stats()["failovers"] == 0


def test_pool_config_validates():
    with pytest.raises(ValueError, match="strike_limit"):
        serve.PoolConfig(strike_limit=0)
    with pytest.raises(ValueError, match="canary_interval_s"):
        serve.PoolConfig(canary_interval_s=0.0)
    with pytest.raises(ValueError, match="device"):
        faults.FaultPlan("serve_device_fail", device=-1)
    with pytest.raises(ValueError, match="at least one"):
        serve.DevicePool([])


def test_round_robin_spreads_groups_across_members():
    """Two groups in one flush land on two distinct members."""
    rng = _rng()
    srv = _pool_server(members=2)
    with obs.recording() as recs:
        for n in (16, 48):          # buckets 32 and 64: two groups
            for _ in range(2):
                srv.submit("solve", *_mk_solve(rng, n))
        srv.drain()
    assert {e["device_id"] for e in _batch_events(recs)} == {0, 1}
    assert all(e["failovers"] == 0 for e in _batch_events(recs))


# -------------------------------------------------- kill-a-device drill


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_kill_a_device_drill(kind):
    """Kill member 0 (a non-finite lie, or an exception at dispatch): the
    SAME packed batch fails over to member 1 with no ticket lost, results
    bit-identical to the no-fault run, quarantine, and canary
    readmission."""
    rng = _rng()
    reqs = [("solve", *_mk_solve(rng, 12)) for _ in range(4)]
    cache = serve.ExecutableCache()
    base = _serve_once(_pool_server(members=2, cache=cache), reqs)

    srv = _pool_server(members=2, cache=cache)
    plan = faults.FaultPlan("serve_device_fail", kind=kind,
                            transient=True, device=0)
    with obs.recording() as recs:
        with faults.inject(plan):
            got = _serve_once(srv, reqs)

    assert len(got) == len(reqs)
    for (op, a, b), res, ref in zip(reqs, base, got):
        assert res is not None and ref is not None
        _check_solve(a, b, res)
        assert torch.equal(res.x.view(torch.int32), ref.x.view(torch.int32))
        assert res.health.ok and not res.escalated

    st = srv.pool.stats()
    assert st["failovers"] == 1 and st["quarantines"] == 1
    fo = _device_events(recs, "failover")
    assert [e["device_id"] for e in fo] == [0]
    assert fo[0]["reason"] == ("nonfinite" if kind == "nan"
                               else "exception")
    assert _device_events(recs, "quarantine")[0]["device_id"] == 0
    batches = _batch_events(recs)
    assert batches and batches[0]["device_id"] == 1
    assert batches[0]["failovers"] == 1
    assert srv.pool.healthy_count() == 1 and srv.pool.degraded()

    with obs.recording() as recs2:
        assert srv.pool.probe(0)             # the canary solve is clean
    assert srv.pool.healthy_count() == 2 and not srv.pool.degraded()
    assert srv.pool.stats()["readmissions"] == 1
    readmit = _device_events(recs2, "readmit")
    assert readmit and readmit[0]["device_id"] == 0
    assert readmit[0]["quarantined_ms"] is not None

    reqs2 = [("solve", *_mk_solve(rng, 12)) for _ in range(2)]
    for (op, a, b), res in zip(reqs2, _serve_once(srv, reqs2)):
        _check_solve(a, b, res)


def test_targeted_chaos_plan_is_not_eaten_by_other_members():
    plan = faults.FaultPlan("serve_device_fail", transient=True, device=1)
    with faults.inject(plan):
        assert faults.host_fire("serve_device_fail", device=0) is None
        assert faults.host_fire("serve_device_fail", device=1) is plan
        assert faults.host_fire("serve_device_fail", device=1) is None
    assert faults.host_fire("serve_device_fail", device=1) is None


def test_warm_pool_makes_no_captures_per_device():
    """Warnings as errors: after one warm pass, repeated flushes on a
    two-member pool build nothing and capture nothing on any member."""
    rng = _rng()
    srv = _pool_server(members=2)
    reqs = [("solve", *_mk_solve(rng, 16)) for _ in range(3)]
    _serve_once(srv, reqs)                       # warm every member
    captures0 = sentinel.total()
    with warnings.catch_warnings():
        warnings.simplefilter("error", sentinel.SlateRetraceWarning)
        with obs.recording() as recs:
            for _ in range(4):
                reqs = [("solve", *_mk_solve(rng, 16)) for _ in range(3)]
                for (op, a, b), res in zip(reqs, _serve_once(srv, reqs)):
                    _check_solve(a, b, res)
    assert sentinel.total() == captures0
    assert all(e["captures"] == 0 and not e["compiled"]
               for e in _batch_events(recs))


def test_wedged_member_deadline_failover():
    """serve_device_slow past the dispatch deadline reads as a wedged
    device: the pool moves on to a survivor, and the late result of the
    thread left behind is dropped."""
    rng = _rng()
    srv = _pool_server(members=2, dispatch_timeout_s=0.25)
    a, b = _mk_solve(rng, 12)
    _serve_once(srv, [("solve", a, b)])          # warm; rotation now at 1
    plan = faults.FaultPlan("serve_device_slow", transient=True,
                            device=1, delay_s=1.5)
    with obs.recording() as recs:
        with faults.inject(plan):
            (res,) = _serve_once(srv, [("solve", a, b)])
    _check_solve(a, b, res)
    fo = _device_events(recs, "failover")
    assert fo and fo[0]["reason"] == "deadline" and fo[0]["device_id"] == 1
    assert srv.pool.stats()["failovers"] == 1
    time.sleep(1.5)                              # let the thread drain
    assert not [t for t in threading.enumerate()
                if t.name.startswith("slate-serve-dispatch")]


def test_canary_flake_refuses_readmission():
    rng = _rng()
    srv = _pool_server(members=2)
    reqs = [("solve", *_mk_solve(rng, 12)) for _ in range(2)]
    kill = faults.FaultPlan("serve_device_fail", kind="inf", device=0)
    flake = faults.FaultPlan("serve_canary_flake", device=0)
    with obs.recording() as recs:
        with faults.inject(kill, flake):
            got = _serve_once(srv, reqs)         # member 0 dies
            assert srv.pool.healthy_count() == 1
            assert not srv.pool.probe(0)         # the canary flakes
            assert srv.pool.healthy_count() == 1
    for (op, a, b), res in zip(reqs, got):
        _check_solve(a, b, res)
    pf = _device_events(recs, "probe_fail")
    assert pf and pf[0]["device_id"] == 0 and pf[0]["reason"] == "flake"
    assert srv.pool.probe(0)                     # plan gone: clean probe
    assert srv.pool.healthy_count() == 2


def test_pool_exhausted_raises_typed_overload():
    """Every member dead: a typed error on the drain and on every ticket;
    clean canaries bring the pool back."""
    rng = _rng()
    srv = _pool_server(members=2)
    a, b = _mk_solve(rng, 12)
    with faults.inject(faults.FaultPlan("serve_device_fail", kind="inf")):
        t = srv.submit("solve", a, b)
        with pytest.raises(SlateServeError, match="no healthy device"):
            srv.drain()
        assert isinstance(t.error(), SlateServeError)
        assert srv.pool.healthy_count() == 0
    assert srv.pool.probe(0) and srv.pool.probe(1)
    (res,) = _serve_once(srv, [("solve", a, b)])
    _check_solve(a, b, res)


def test_degraded_single_survivor_keeps_serving():
    rng = _rng()
    srv = _pool_server(members=3)
    kill = faults.FaultPlan("serve_device_fail", kind="inf", device=0)
    reqs = [("solve", *_mk_solve(rng, 12)) for _ in range(2)]
    with faults.inject(kill):
        for (op, a, b), res in zip(reqs, _serve_once(srv, reqs)):
            _check_solve(a, b, res)
    assert srv.pool.healthy_count() == 2
    info = srv.health_info()
    assert info["pool"]["devices"] == 3 and info["pool"]["healthy"] == 2
    assert not info["degraded"]


def test_background_loop_kill_drill_zero_lost_tickets():
    rng = _rng()
    srv = _pool_server(members=2, admission=serve.AdmissionConfig(
        flush_occupancy=4, max_batch_delay_ms=10.0))
    srv.start()
    try:
        probs = [_mk_solve(rng, 12) for _ in range(12)]
        plan = faults.FaultPlan("serve_device_fail", transient=True,
                                device=0)
        with faults.inject(plan):
            tickets = [(a, b, srv.submit("solve", a, b)) for a, b in probs]
            for a, b, t in tickets:
                _check_solve(a, b, t.result(timeout=60.0))
    finally:
        srv.shutdown()
    assert srv.pool.stats()["failovers"] >= 1


# ------------------------------------------------ per-device SLO truth


def test_governor_files_per_device_tails():
    gov = slo.LatencyGovernor(budget_ms=100.0)
    for _ in range(20):
        gov.observe(10.0, device=0)
        gov.observe(400.0, device=1)
    assert gov.p99_ms(0) < 100.0 < gov.p99_ms(1)
    assert gov.overloaded(1) and not gov.overloaded(0)
    assert gov.overload_fraction() == 0.5
    assert set(gov.device_p99s()) == {0, 1}


def test_overload_fraction_scales_capacity_not_halves():
    q = serve.AdmissionQueue(serve.AdmissionConfig(max_queue=64,
                                                   slo_budget_ms=100.0))
    for dev in range(4):
        for _ in range(10):
            q.governor.observe(400.0 if dev == 0 else 10.0, device=dev)
    assert q.governor.overload_fraction() == 0.25
    assert q.capacity() == int(64 * (1 - 0.25 / 2))    # 56, not 32
    q2 = serve.AdmissionQueue(serve.AdmissionConfig(max_queue=64,
                                                    slo_budget_ms=100.0))
    for _ in range(10):
        q2.governor.observe(400.0)
    assert q2.governor.overload_fraction() == 1.0
    assert q2.capacity() == 32


def test_pooled_server_files_latencies_per_member():
    rng = _rng()
    srv = _pool_server(members=2)
    for _ in range(3):
        reqs = [("solve", *_mk_solve(rng, n)) for n in (8, 24)
                for _ in range(2)]
        _serve_once(srv, reqs)
    p99s = srv.health_info()["slo_device_p99_ms"]
    assert set(p99s) == {0, 1} and all(v > 0 for v in p99s.values())


# ---------------------------------------------------- online retuning


def _bimodal_reqs(rng, count, k=2):
    """Sizes 40/96: the geometric ladder buckets them at 64/128; the
    fitted ladder serves 96 at a 96 rung."""
    return [("solve", *_mk_solve(rng, 40 if i % 2 == 0 else 96, k))
            for i in range(count)]


def test_online_retune_hot_swap_drill():
    """A bimodal stream makes EXACTLY one hot swap; later flushes bucket
    on the fitted ladder and padding waste drops."""
    rng = _rng()
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache(),
                       admission=serve.AdmissionConfig(
                           retune_interval_s=1e9, retune_min_samples=16,
                           retune_margin=0.02))
    with obs.recording() as recs:
        pre = _bimodal_reqs(rng, 16)
        for (op, a, b), res in zip(pre, _serve_once(srv, pre)):
            _check_solve(a, b, res)
        pre_batches = _batch_events(recs)
        assert all(e["ladder"] == "geometric" for e in pre_batches)
        assert {tuple(e["bucket"]) for e in pre_batches} == \
            {(64, 2), (128, 2)}
        info = srv.retune_now("float32")
        assert info is not None and info["new"] == [64, 96]
        assert info["waste_fitted"] < info["waste_live"]
        assert srv.retune_now("float32") is None   # exactly one swap
        post = _bimodal_reqs(rng, 16)
        for (op, a, b), res in zip(post, _serve_once(srv, post)):
            _check_solve(a, b, res)
    assert len([e for e in recs if e.get("kind") == "serve_retune"]) == 1
    post_batches = _batch_events(recs)[len(pre_batches):]
    assert all(e["ladder"] == "retuned" for e in post_batches)
    assert {tuple(e["bucket"]) for e in post_batches} == {(64, 2), (96, 2)}
    assert np.mean([e["padding_waste"] for e in post_batches]) < \
        np.mean([e["padding_waste"] for e in pre_batches])


def test_retune_warms_the_fitted_rungs_before_the_swap():
    """The fitted rungs' callables are built before the swap, at the
    flush occupancy's batch, so that flush is a cache hit."""
    rng = _rng()
    cache = serve.ExecutableCache()
    srv = serve.Server(device="cpu", cache=cache,
                       admission=serve.AdmissionConfig(
                           retune_interval_s=1e9, retune_min_samples=16,
                           retune_margin=0.02, flush_occupancy=8))
    _serve_once(srv, _bimodal_reqs(rng, 16))
    assert srv.retune_now("float32") is not None
    with obs.recording() as recs:
        _serve_once(srv, _bimodal_reqs(rng, 16))
    assert all(not e["compiled"] for e in _batch_events(recs))


def test_background_retune_tick_swaps_once():
    rng = _rng()
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache(),
                       admission=serve.AdmissionConfig(
                           flush_occupancy=4, max_batch_delay_ms=5.0,
                           retune_interval_s=0.05, retune_min_samples=16,
                           retune_margin=0.02))
    srv.start()
    try:
        with obs.recording() as recs:
            reqs = _bimodal_reqs(rng, 24)
            tickets = [(a, b, srv.submit(op, a, b)) for op, a, b in reqs]
            for a, b, t in tickets:
                _check_solve(a, b, t.result(timeout=120.0))
            deadline = time.perf_counter() + 30.0
            while (srv.health_info()["retunes"] < 1
                   and time.perf_counter() < deadline):
                time.sleep(0.02)
            assert srv.health_info()["retunes"] == 1
            reqs2 = _bimodal_reqs(rng, 8)
            tickets = [(a, b, srv.submit(op, a, b)) for op, a, b in reqs2]
            for a, b, t in tickets:
                _check_solve(a, b, t.result(timeout=120.0))
    finally:
        srv.shutdown()
    assert len([e for e in recs if e.get("kind") == "serve_retune"]) == 1
    assert _batch_events(recs)[-1]["ladder"] == "retuned"


def test_retune_respects_margin_hysteresis():
    rng = _rng()
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache(),
                       admission=serve.AdmissionConfig(
                           retune_interval_s=1e9, retune_min_samples=8,
                           retune_margin=0.05))
    _serve_once(srv, [("solve", *_mk_solve(rng, 32)) for _ in range(8)])
    assert srv.retune_now("float32") is None    # 32 sits on a rung
    assert srv.health_info()["retunes"] == 0
