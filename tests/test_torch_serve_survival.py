"""The port's serving survival layer (slate_tpu_torch.serve) on the CPU,
mirroring tests/test_serve_survival.py: the background flush loop, its
watchdog, admission control and deadline shedding, poison quarantine on
both paths, sticky errors, the chaos sites and ``health_info``.

The guarantees are the reference's: every admitted ticket settles exactly
once (none lost, none answered twice), a wedged flush fails its requests
with a typed error and the wedged server refuses new work, a shed request
carries a typed error and a ``serve_shed`` record, a poison is retried in
exactly one fresh batch and then quarantined, and a failed background
flush is re-raised by the next ``drain()``.  Where the reference counts
retraces, the port counts CUDA-graph captures, and the CPU makes none.
The metrics-CLI and compare tests of the reference wait for the port's
obs metrics (ROADMAP.md queue 1, item 10).
"""

import threading
import time

import numpy as np
import pytest

from slate_tpu_torch import serve
from slate_tpu_torch.exceptions import (SlateServeError,
                                        SlateServeOverloadError,
                                        SlateServeTimeoutError)
from slate_tpu_torch.obs import events as obs
from slate_tpu_torch.obs import slo
from slate_tpu_torch.robust import faults


def _rng():
    return np.random.default_rng(77)


def _mk_solve(rng, n, k=2, dtype=np.float32):
    a = rng.standard_normal((n, n)).astype(dtype)
    a += np.eye(n, dtype=dtype) * 4
    return a, rng.standard_normal((n, k)).astype(dtype)


def _poison_solve(n=8, k=2, dtype=np.float32):
    """A singular system: it escalates AND stays unhealthy, so it exhausts
    the escalation ladder."""
    return np.zeros((n, n), dtype), np.ones((n, k), dtype)


def _check_solve(a, b, res, tol=1e-3):
    assert np.allclose(res.x.numpy(), np.linalg.solve(
        a.astype(np.float64), b.astype(np.float64)), atol=tol)


def _server(**kw):
    return serve.Server(device="cpu", cache=serve.ExecutableCache(), **kw)


def _serve_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("slate-serve-")]


def _shed_events(recs):
    return [e for e in recs if e.get("kind") == "serve_shed"]


# ------------------------------------------------------ background loop


def test_background_loop_delivers_correct_results():
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(flush_occupancy=4,
                                                  max_batch_delay_ms=10.0))
    srv.start()
    assert srv.running()
    try:
        probs = [_mk_solve(rng, n) for n in (8, 8, 12, 12, 20, 20)]
        tickets = [srv.submit("solve", a, b) for a, b in probs]
        for (a, b), t in zip(probs, tickets):
            _check_solve(a, b, t.result(timeout=120.0))
            assert t.done() and t.error() is None
    finally:
        srv.shutdown()
    assert not srv.running()


def test_start_is_idempotent():
    srv = _server()
    srv.start()
    try:
        before = _serve_threads()
        srv.start()                      # no second pair of threads
        assert _serve_threads() == before
    finally:
        srv.shutdown()


def test_concurrent_submit_under_live_loop_accounts_every_request():
    """4 threads submit under the live loop: every ticket settles exactly
    once with a correct result, ticket ids are unique, and a late duplicate
    delivery is refused (first write wins)."""
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(
        max_queue=1024, flush_occupancy=6, max_batch_delay_ms=2.0))
    probs = [_mk_solve(rng, n) for n in (8, 12, 20, 28)]
    srv.serve_batch([("solve", a, b) for a, b in probs])  # warm buckets
    srv.start()
    done, errs = [], []
    lock = threading.Lock()

    def pound(wid):
        try:
            local = []
            for i in range(8):
                a, b = probs[(wid + i) % len(probs)]
                local.append((a, b, srv.submit("solve", a, b)))
            for a, b, t in local:
                _check_solve(a, b, t.result(timeout=120.0))
                with lock:
                    done.append(t)
        except Exception as e:          # surfaced below, not swallowed
            with lock:
                errs.append(e)

    threads = [threading.Thread(target=pound, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180.0)
    srv.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert errs == []
    assert len(done) == 32
    assert len({t.tid for t in done}) == 32          # no double admission
    assert all(not t.deliver("late") for t in done)


def test_shutdown_drains_queued_requests():
    rng = _rng()
    # an occupancy watermark out of reach: the requests wait in the queue
    # until shutdown's drain settles them
    srv = _server(admission=serve.AdmissionConfig(
        flush_occupancy=1000, max_batch_delay_ms=60_000.0))
    srv.start()
    a, b = _mk_solve(rng, 8)
    tickets = [srv.submit("solve", a, b) for _ in range(3)]
    srv.shutdown(drain=True)
    for t in tickets:
        _check_solve(a, b, t.result(timeout=1.0))


def test_shutdown_without_drain_fails_loudly():
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(
        flush_occupancy=1000, max_batch_delay_ms=60_000.0))
    srv.start()
    a, b = _mk_solve(rng, 8)
    with obs.recording() as recs:
        tickets = [srv.submit("solve", a, b) for _ in range(3)]
        srv.shutdown(drain=False)
    for t in tickets:
        with pytest.raises(SlateServeTimeoutError) as ei:
            t.result(timeout=1.0)
        assert ei.value.reason == "shutdown"
    assert len(_shed_events(recs)) == 3
    assert srv.queue.stats()["shed"] >= 3


def test_shutdown_never_leaks_daemon_threads():
    srv = _server()
    assert _serve_threads() == []
    srv.start()
    assert len(_serve_threads()) == 2        # flush loop + watchdog
    srv.shutdown()
    assert _serve_threads() == []
    a, b = _mk_solve(_rng(), 8)
    with pytest.raises(SlateServeTimeoutError) as ei:
        srv.submit("solve", a, b)
    assert ei.value.reason == "shutdown"


def test_warm_server_async_path_makes_no_captures():
    """The background path reuses the synchronous path's callables: a
    server warmed through serve_batch builds nothing and captures nothing
    when the same workload arrives through the live loop (the occupancy
    watermark equals the workload, so the loop flushes one batch with the
    warm pass's group sizes)."""
    rng = _rng()
    probs = [_mk_solve(rng, n) for n in (8, 8, 20, 20)]
    srv = _server(admission=serve.AdmissionConfig(
        flush_occupancy=4, max_batch_delay_ms=60_000.0))
    srv.serve_batch([("solve", a, b) for a, b in probs])   # warm
    srv.start()
    try:
        with obs.recording() as recs:
            tickets = [srv.submit("solve", a, b) for a, b in probs]
            for (a, b), t in zip(probs, tickets):
                _check_solve(a, b, t.result(timeout=120.0))
        evs = [e for e in recs if e.get("kind") == "serve_batch"]
        assert evs and all(not e["compiled"] for e in evs)
        assert all(e["captures"] == 0 for e in evs)
        assert srv.health_info()["captures"] == 0
    finally:
        srv.shutdown()


# ------------------------------------------------- watchdog / wedging


def test_watchdog_fails_wedged_flush_with_typed_error():
    """A capture stall far past the watchdog's budget: every pending
    ticket fails with SlateServeTimeoutError, the server reports wedged,
    and new submits are refused."""
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(
        flush_occupancy=1, max_batch_delay_ms=1.0, watchdog_timeout_s=0.2))
    srv.start()
    a, b = _mk_solve(rng, 8)
    try:
        with obs.recording() as recs:
            with faults.inject(faults.FaultPlan(
                    "serve_compile_stall", transient=True, delay_s=2.0)):
                t = srv.submit("solve", a, b)
                with pytest.raises(SlateServeTimeoutError) as ei:
                    t.result(timeout=30.0)
        assert ei.value.reason == "watchdog"
        assert srv.wedged() is not None
        assert srv.health_info()["wedged"] is not None
        with pytest.raises(SlateServeTimeoutError) as ei2:
            srv.submit("solve", a, b)
        assert ei2.value.reason == "wedged"
        assert any(e["reason"] == "watchdog" for e in _shed_events(recs))
    finally:
        # the wedged flush thread sleeps through the stall; wait it out so
        # its late (dropped) delivery cannot leak into the next test
        zombies = _serve_threads()
        srv.shutdown()
        for z in zombies:
            z.join(120.0)
        assert _serve_threads() == []


# ------------------------------------------- admission control policies


def test_overflow_reject_is_typed():
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(max_queue=4,
                                                  overflow="reject"))
    a, b = _mk_solve(rng, 8)
    with obs.recording() as recs:
        for _ in range(4):
            srv.submit("solve", a, b)
        with pytest.raises(SlateServeOverloadError) as ei:
            srv.submit("solve", a, b)
    assert ei.value.policy == "reject"
    (shed,) = _shed_events(recs)
    assert shed["reason"] == "overflow_reject"
    for res in srv.drain():
        _check_solve(a, b, res)


def test_overflow_shed_oldest_fails_victim_ticket():
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(max_queue=4,
                                                  overflow="shed_oldest"))
    a, b = _mk_solve(rng, 8)
    with obs.recording() as recs:
        tickets = [srv.submit("solve", a, b) for _ in range(5)]
    victim, survivors = tickets[0], tickets[1:]
    assert victim.done()
    with pytest.raises(SlateServeOverloadError) as ei:
        victim.result(timeout=0.1)
    assert ei.value.policy == "shed_oldest"
    (shed,) = _shed_events(recs)
    assert shed["reason"] == "overflow_shed_oldest"
    srv.drain()
    for t in survivors:
        _check_solve(a, b, t.result(timeout=1.0))


def test_deadline_shed_at_admission_uses_governor_estimate():
    """A deadline tighter than the rolling service estimate is shed at
    submit and never occupies a queue slot."""
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(slo_budget_ms=100.0))
    for _ in range(16):
        srv.queue.governor.observe(50.0)     # rolling p50 = 50 ms
    a, b = _mk_solve(rng, 8)
    with obs.recording() as recs:
        with pytest.raises(SlateServeTimeoutError) as ei:
            srv.submit("solve", a, b, deadline_ms=1.0)
    assert ei.value.reason == "deadline"
    assert srv.queue.depth() == 0
    (shed,) = _shed_events(recs)
    assert shed["reason"] == "deadline"
    t = srv.submit("solve", a, b, deadline_ms=10_000.0)
    srv.drain()
    _check_solve(a, b, t.result(timeout=1.0))


def test_deadline_expiry_in_queue_sheds_at_flush():
    rng = _rng()
    srv = _server()
    a, b = _mk_solve(rng, 8)
    t = srv.submit("solve", a, b, deadline_ms=1.0)
    time.sleep(0.02)
    with obs.recording() as recs:
        assert srv.drain() == []
    with pytest.raises(SlateServeTimeoutError) as ei:
        t.result(timeout=0.1)
    assert ei.value.reason == "deadline"
    (shed,) = _shed_events(recs)
    assert shed["reason"] == "deadline" and shed["age_ms"] > 0


def test_two_x_overload_shed_keeps_admitted_p99_in_budget():
    """Twice the queue's capacity offered under shed_oldest: exactly half
    is shed, typed and recorded, and the admitted requests' rolling p99
    stays within the declared budget."""
    rng = _rng()
    budget_ms = 60_000.0                 # generous: CPU boxes vary
    srv = _server(admission=serve.AdmissionConfig(
        max_queue=8, overflow="shed_oldest", slo_budget_ms=budget_ms))
    a, b = _mk_solve(rng, 8)
    srv.serve_batch([("solve", a, b)])   # warm: steady-state latencies
    with obs.recording() as recs:
        tickets = [srv.submit("solve", a, b) for _ in range(16)]
        srv.drain()
    shed = [t for t in tickets if t.error() is not None]
    served = [t for t in tickets if t.error() is None]
    assert len(shed) == 8 and len(served) == 8
    assert all(isinstance(t.error(), SlateServeOverloadError)
               for t in shed)
    for t in served:
        _check_solve(a, b, t.result(timeout=1.0))
    assert len(_shed_events(recs)) == 8
    batches = [e for e in recs if e.get("kind") == "serve_batch"]
    assert sum(e["problems"] for e in batches) == 8
    assert srv.queue.governor.p99_ms() <= budget_ms


def test_slo_backpressure_halves_capacity():
    gov = slo.LatencyGovernor(budget_ms=10.0, window=8)
    q = serve.AdmissionQueue(serve.AdmissionConfig(max_queue=8), gov)
    assert q.capacity() == 8
    for _ in range(8):
        gov.observe(50.0)                # p99 over the 10 ms budget
    assert gov.overloaded() and q.capacity() == 4
    gov2 = slo.LatencyGovernor(budget_ms=None)
    for _ in range(8):
        gov2.observe(1e9)
    assert not gov2.overloaded()         # no budget, no backpressure


# --------------------------------------------------- poison quarantine


def test_poison_quarantined_after_exactly_one_fresh_batch_retry():
    """A singular system rides the original batch, one fresh-batch retry,
    then a batch of its own: three serve_batch records and one
    serve_quarantine, its neighbours correct throughout."""
    rng = _rng()
    good_a, good_b = _mk_solve(rng, 8)
    bad_a, bad_b = _poison_solve(8)
    srv = _server()
    with obs.recording() as recs:
        res = srv.serve_batch([("solve", good_a, good_b),
                               ("solve", bad_a, bad_b),
                               ("solve", good_a, good_b)])
    batches = [e for e in recs if e.get("kind") == "serve_batch"]
    (quar,) = [e for e in recs if e.get("kind") == "serve_quarantine"]
    assert [e["problems"] for e in batches] == [3, 1, 1]
    assert quar["reason"] == "escalation_exhausted"
    assert quar["retries"] == 1 and not quar["ok"]
    _check_solve(good_a, good_b, res[0])
    _check_solve(good_a, good_b, res[2])
    assert res[0].health.ok and res[2].health.ok
    assert res[1].escalated and not res[1].health.ok
    assert srv.health_info()["quarantined"] == 1


def test_poison_quarantine_on_background_path():
    rng = _rng()
    good_a, good_b = _mk_solve(rng, 8)
    bad_a, bad_b = _poison_solve(8)
    srv = _server(admission=serve.AdmissionConfig(flush_occupancy=3,
                                                  max_batch_delay_ms=10.0))
    srv.start()
    try:
        with obs.recording() as recs:
            tg1 = srv.submit("solve", good_a, good_b)
            tp = srv.submit("solve", bad_a, bad_b)
            tg2 = srv.submit("solve", good_a, good_b)
            _check_solve(good_a, good_b, tg1.result(timeout=120.0))
            _check_solve(good_a, good_b, tg2.result(timeout=120.0))
            poisoned = tp.result(timeout=120.0)
        assert poisoned.escalated and not poisoned.health.ok
        assert [e["kind"] for e in recs].count("serve_quarantine") == 1
    finally:
        srv.shutdown()


# -------------------------------------------------------- sticky errors


def test_failed_background_flush_is_sticky_on_empty_drain(monkeypatch):
    """A flush that dies in the loop does not evaporate: the ticket holds
    the typed error, and the next drain() re-raises it on an empty queue,
    once."""
    rng = _rng()
    srv = _server(admission=serve.AdmissionConfig(flush_occupancy=1,
                                                  max_batch_delay_ms=1.0))

    def boom(*args, **kwargs):
        raise RuntimeError("injected flush failure")

    monkeypatch.setattr(srv, "_run_group", boom)
    srv.start()
    a, b = _mk_solve(rng, 8)
    try:
        t = srv.submit("solve", a, b)
        with pytest.raises(SlateServeError):
            t.result(timeout=30.0)
        assert srv.queue.depth() == 0
        # the ticket settles inside the flush; the server's sticky error
        # lands when the flush returns
        deadline = time.perf_counter() + 10.0
        while srv._flush_error is None and time.perf_counter() < deadline:
            time.sleep(0.005)
        with pytest.raises(SlateServeError, match="injected"):
            srv.drain()
        assert srv.drain() == []         # raised once
    finally:
        srv.shutdown()


def test_sync_drain_group_failure_lands_on_tickets(monkeypatch):
    rng = _rng()
    srv = _server()

    def boom(*args, **kwargs):
        raise RuntimeError("injected group failure")

    monkeypatch.setattr(srv, "_run_group", boom)
    a, b = _mk_solve(rng, 8)
    t = srv.submit("solve", a, b)
    with pytest.raises(SlateServeError, match="injected"):
        srv.drain()
    assert isinstance(t.error(), SlateServeError)


# --------------------------------------------------------- chaos harness


def test_chaos_flush_delay_ages_the_batch():
    rng = _rng()
    srv = _server()
    a, b = _mk_solve(rng, 8)
    srv.serve_batch([("solve", a, b)])   # warm
    srv.submit("solve", a, b)
    with obs.recording() as recs:
        with faults.inject(faults.FaultPlan("serve_flush_delay",
                                            delay_s=0.05)):
            (res,) = srv.drain()
    _check_solve(a, b, res)
    (ev,) = [e for e in recs if e.get("kind") == "serve_batch"]
    assert all(age >= 50.0 for age in ev["age_at_flush_ms"])


def test_chaos_cache_evict_forces_rebuild_but_serves():
    rng = _rng()
    cache = serve.ExecutableCache()
    srv = serve.Server(device="cpu", cache=cache)
    a, b = _mk_solve(rng, 8)
    srv.serve_batch([("solve", a, b)])   # warm
    assert cache.stats()["entries"] == 1
    with obs.recording() as recs:
        with faults.inject(faults.FaultPlan("serve_cache_evict",
                                            transient=True)):
            (res,) = srv.serve_batch([("solve", a, b)])
    _check_solve(a, b, res)
    (ev,) = [e for e in recs if e.get("kind") == "serve_batch"]
    assert ev["compiled"]                # the eviction forced the rebuild
    assert cache.stats()["entries"] == 1


def test_host_fire_transient_consumes_once_per_activation():
    plan = faults.FaultPlan("serve_compile_stall", transient=True,
                            delay_s=0.1)
    assert faults.host_fire("serve_compile_stall") is None  # inactive
    with faults.inject(plan):
        assert faults.host_fire("serve_compile_stall") is plan
        assert faults.host_fire("serve_compile_stall") is None  # spent
    with faults.inject(plan):            # a fresh activation strikes again
        assert faults.host_fire("serve_compile_stall") is plan
    persistent = faults.FaultPlan("serve_flush_delay", delay_s=0.1)
    with faults.inject(persistent):
        assert faults.host_fire("serve_flush_delay") is persistent
        assert faults.host_fire("serve_flush_delay") is persistent
    with faults.inject(faults.FaultPlan("input")):
        assert faults.host_fire("input") is None     # a device site


def test_poisson_workload_round_trips_the_server():
    w = faults.poisson_workload(42, 12, 200.0, (8, 16))
    srv = _server()
    results = srv.serve_batch([(op, a, b) for _, op, a, b in w[:6]])
    assert len(results) == 6 and all(r.health.ok for r in results)


def test_health_info_reports_front_door_state():
    srv = _server(admission=serve.AdmissionConfig(slo_budget_ms=250.0))
    info = srv.health_info()
    assert info["queue"]["depth"] == 0 and not info["queue"]["closed"]
    assert info["running"] is False and info["wedged"] is None
    assert info["quarantined"] == 0 and info["retunes"] == 0
    assert info["slo_budget_ms"] == 250.0 and info["slo_p99_ms"] is None
    assert info["pool"] == {"devices": 1, "healthy": 1, "failovers": 0,
                            "quarantines": 0, "readmissions": 0}
    assert not info["degraded"] and info["captures"] == 0
    assert info["inflight"] == 0 and info["slo_device_p99_ms"] == {}
