"""The port's serving layer (slate_tpu_torch.serve) against slate_tpu.serve on
the CPU: bucket ladders and packing, ``make_batched`` on both routes with
escalation flags, the bf16 rung's escalation, ``Server.serve_batch`` on a
mixed stream with its poison retry and quarantine, ``submit`` validation,
the cache and the admission queue's overflow policies.

The reference's ragged route runs only under a Pallas plan, so it is
forced onto one (``plan_override(op, TilePlan("pallas", nb, 8))``) where
the port's ragged route is held against it; its default plan (the vmapped
XLA cores) faces the port's per-problem route (``LIBRARY_PLAN``).  The
reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the installed JAX no longer exports that
name, so the ``ref_drivers`` fixture restores it on the test side only.
Sizes are small (buckets 32-64, nb 32, B <= 4): each reference batch is
one XLA compile.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

import jax
from slate_tpu import serve as ref_serve
from slate_tpu.tune import TilePlan as RefPlan
from slate_tpu.tune import plan_override as ref_override

import slate_tpu_torch as st
from slate_tpu_torch import serve
from slate_tpu_torch.convert import health_from_jax
from slate_tpu_torch.serve import batched as sb

# f32 parity: both sides factor the same bytes with the same algorithm,
# sums in another order (and the reference's Pallas panels invert U by a
# series); on the well-conditioned problems below the solutions agree to
# a few 1e-6 of their largest entry, held at 1e-4.
F32_RTOL = 1e-4
RAGGED_OPS = ("batch_getrf", "batch_potrf", "batch_geqrf")


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


@contextlib.contextmanager
def ref_ragged(nb=32):
    """The reference forced onto its ragged Pallas route."""
    with contextlib.ExitStack() as stack:
        for op in RAGGED_OPS:
            stack.enter_context(ref_override(op, RefPlan("pallas", nb, 8)))
        yield


@contextlib.contextmanager
def per_problem():
    """The port on its per-problem route."""
    with contextlib.ExitStack() as stack:
        for op in RAGGED_OPS:
            stack.enter_context(st.plan_override(op, st.LIBRARY_PLAN))
        yield


def _close(got, want, rtol=F32_RTOL):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rtol * max(np.abs(want[fin]).max(
                                   initial=0.0), 1.0))


def _same_health(h, w, rtol=1e-3):
    """Field for field: flags and indices exactly, pivots and growth to
    ``rtol`` (f32 values of sums in another order)."""
    assert (h.ok, h.nonfinite, h.info, h.iters, h.converged) == \
        (w.ok, w.nonfinite, w.info, w.iters, w.converged)
    for a, b in ((h.min_pivot, w.min_pivot), (h.growth, w.growth)):
        if np.isfinite(b):
            np.testing.assert_allclose(a, b, rtol=rtol)
        else:
            assert not np.isfinite(a)


def _problem(rng, op, n, kind="good"):
    """One request's (a, b): solve A = G / sqrt(n) + 4 I (a zero leading
    pivot when ``kind`` is "bad"), chol_solve A = G G^T / n + I (symmetric
    indefinite when "bad"), least squares a Gaussian [2n, n] (an exactly
    zero column when "bad")."""
    g = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((2 * n if op == "least_squares_solve" else n,
                             2)).astype(np.float32)
    if op == "solve":
        a = g / np.float32(np.sqrt(n)) + 4 * np.eye(n, dtype=np.float32)
        if kind == "bad":
            a[0, 0] = 0.0
    elif op == "chol_solve":
        a = g @ g.T / n + np.eye(n, dtype=np.float32)
        if kind == "bad":
            a -= 3 * np.eye(n, dtype=np.float32)
    else:
        a = rng.standard_normal((2 * n, n)).astype(np.float32)
        if kind == "bad":
            a[:, 1] = 0.0
    return a.astype(np.float32), b


def _stack(rng, op, sizes, bad=None):
    """A packed bucket of ``sizes`` (0 = filler) through the port's own
    packers, as numpy arrays for both packages."""
    nb = 64
    mb = 128 if op == "least_squares_solve" else nb
    a = np.zeros((len(sizes), mb, nb), np.float32)
    b = np.zeros((len(sizes), mb, 2), np.float32)
    live = []
    for i, s in enumerate(sizes):
        if not s:
            a[i, :nb, :nb] = np.eye(nb, dtype=np.float32)
            live.append(0)
            continue
        ai, bi = _problem(rng, op, s, "bad" if i == bad else "good")
        if op == "least_squares_solve":
            a[i] = serve.pad_tall(torch.from_numpy(ai), mb, nb).numpy()
            live.append(ai.shape[0] + nb - s)
        else:
            a[i] = serve.pad_square(torch.from_numpy(ai), nb).numpy()
            live.append(s)
        b[i] = serve.pad_rows(torch.from_numpy(bi), mb, 2).numpy()
    return a, b, np.asarray(live, np.int32)


def _port(op, a, b, sizes, opts=None):
    fn = sb.make_batched(op, opts)
    return fn(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(sizes))


def _ref(op, a, b, sizes, opts=None):
    x, h, esc = jax.jit(ref_serve.make_batched(op, opts))(a, b, sizes)
    return np.asarray(x), health_from_jax(h), np.asarray(esc).tolist()


# ------------------------------------------------------ ladder, packing


def test_ladder_and_packing_match_the_reference():
    lad, rlad = serve.geometric_ladder(), ref_serve.geometric_ladder()
    assert lad == rlad and serve.default_ladder("bf16") == rlad
    for n in (1, 31, 32, 33, 4000, 8192, 9000, 20000):
        assert lad.bucket_for(n) == rlad.bucket_for(n)
        assert serve.solve_buckets(lad, n, 3) == \
            ref_serve.solve_buckets(rlad, n, 3)
        assert serve.least_squares_buckets(lad, 2 * n, n, 5) == \
            ref_serve.least_squares_buckets(rlad, 2 * n, n, 5)
    assert [serve.next_pow2(k) for k in (0, 1, 3, 8, 9)] == \
        [ref_serve.next_pow2(k) for k in (0, 1, 3, 8, 9)]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 5)).astype(np.float32)
    t = rng.standard_normal((9, 4)).astype(np.float32)
    for got, want in (
            (serve.pad_square(torch.from_numpy(a), 8),
             ref_serve.pad_square(a, 8)),
            (serve.pad_rows(torch.from_numpy(t), 16, 8),
             ref_serve.pad_rows(t, 16, 8)),
            (serve.pad_tall(torch.from_numpy(t), 16, 8),
             ref_serve.pad_tall(t, 16, 8))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for bad in (lambda: serve.pad_square(torch.from_numpy(t), 16),
                lambda: serve.pad_square(torch.from_numpy(a), 4),
                lambda: serve.pad_tall(torch.from_numpy(t), 9, 8),
                lambda: serve.pad_tall(torch.from_numpy(t.T.copy()), 16, 16),
                lambda: lad.bucket_for(0)):
        with pytest.raises(ValueError):
            bad()
    from slate_tpu.serve.bucket import padded_fraction
    assert serve.padded_fraction(30, 40) == padded_fraction(30, 40)
    assert serve.padded_fraction(1, 0) == 0.0


# ------------------------------------------------------- make_batched


@pytest.mark.parametrize("op,bad", [("solve", 1), ("chol_solve", 2),
                                    ("least_squares_solve", 1)])
@pytest.mark.parametrize("route", ["ragged", "per_problem"])
def test_make_batched_matches_the_reference(ref_drivers, op, bad, route):
    """A bucket-64 batch of four (sizes 64, 40, 17 and a filler slot, one
    planted failure: a zero leading pivot, an indefinite matrix, a zero
    column) on the port's ragged route against the reference forced onto
    its Pallas plan, and on the port's per-problem route against the
    reference's default vmapped cores: x, health and the escalation flags
    (the planted failure escalates, the healthy problems do not)."""
    rng = np.random.default_rng(10 + len(op))
    a, b, sizes = _stack(rng, op, [64, 40, 17, 0], bad=bad)
    if route == "ragged":
        x, h, esc = _port(op, a, b, sizes)
        with ref_ragged():
            rx, rh, resc = _ref(op, a, b, sizes)
    else:
        with per_problem():
            x, h, esc = _port(op, a, b, sizes)
        rx, rh, resc = _ref(op, a, b, sizes)
    assert esc == resc and esc[bad] and not any(esc[:bad] + esc[bad + 1:])
    for i in range(4):
        if not (op == "least_squares_solve" and i == bad):
            _close(x[i], rx[i])          # (the zero column's x is R^-1 junk)
        _same_health(h[i], rh[i])


def test_bf16_rung_escalation_is_bit_identical_to_the_f32_route():
    """Option.Precision = bf16 on both routes: the bf16 attempt runs K6-K8
    on bf16 storage (ragged) or the whole-bucket factor (per-problem), a
    problem whose certificate fails gets exactly the f32 route's bits and
    health, the others pass their certificate (two refinement sweeps
    recorded for the solves); bf16 operands come back bf16."""
    rng = np.random.default_rng(20)
    low = {st.Option.Precision: st.Precision.Bf16}
    for op, bad in (("solve", 1), ("chol_solve", 2),
                    ("least_squares_solve", 0)):
        a, b, sizes = _stack(rng, op, [64, 40, 17, 0], bad=bad)
        for ctx in (contextlib.nullcontext, per_problem):
            with ctx():
                x32, h32, _ = _port(op, a, b, sizes)
                x, h, esc = _port(op, a, b, sizes, low)
            # the planted failure fails its certificate, except a zero
            # pivot on the per-problem route, whose bf16 attempt is a
            # pivoted LU
            assert esc[bad] == (ctx is not per_problem or op != "solve")
            for i in range(4):
                if esc[i]:
                    assert torch.equal(x[i].view(torch.int32),
                                       x32[i].view(torch.int32))
                    assert h[i] == h32[i]
                else:
                    assert h[i].ok and h[i].iters == 2 * (op != "least_"
                                                          "squares_solve")
    fn = sb.make_batched("solve")
    xb, hb, _ = fn(torch.from_numpy(a[:, :64]).bfloat16(),
                   torch.from_numpy(b[:, :64]).bfloat16(),
                   torch.from_numpy(sizes))
    assert xb.dtype == torch.bfloat16 and len(hb) == 4
    with pytest.raises(st.SlateUnsupportedDtypeError):
        fn(torch.zeros(1, 32, 32, dtype=torch.float16),
           torch.zeros(1, 32, 2, dtype=torch.float16),
           torch.ones(1, dtype=torch.int32))


# ------------------------------------------------------------- Server


def test_server_stream_matches_the_reference(ref_drivers):
    """A mixed stream of 10 requests (three ops, buckets 32 and 64, an
    escalating solve) through Server.serve_batch on the port's CPU route
    and the reference's Server on its Pallas plan: x, health and
    escalated per request; the zero-column least-squares request is
    poison (escalated and still unhealthy), retried once in a batch of
    poisons and then quarantined, and comes back with health.ok False on
    both."""
    rng = np.random.default_rng(30)
    reqs = []
    for op in ("solve", "chol_solve", "least_squares_solve"):
        for n in (20, 40, 64):
            reqs.append((op, *_problem(rng, op, n)))
    reqs[1] = ("solve", *_problem(rng, "solve", 40, "bad"))
    reqs.append(("least_squares_solve",
                 *_problem(rng, "least_squares_solve", 24, "bad")))
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache())
    got = srv.serve_batch(reqs)
    with ref_ragged():
        want = ref_serve.Server(cache=ref_serve.ExecutableCache()) \
            .serve_batch(reqs)
    assert len(got) == len(want) == len(reqs)
    for (op, _, _), g, w in zip(reqs, got, want):
        assert g.escalated == bool(w.escalated)
        assert tuple(g.x.shape) == w.x.shape
        if g.health.ok:
            _close(g.x, w.x)
        _same_health(g.health, health_from_jax(
            type(w.health)(*(np.asarray(f)[None] for f in w.health)))[0])
    assert got[1].escalated and got[1].health.ok
    assert got[-1].escalated and not got[-1].health.ok
    assert srv.health_info()["quarantined"] == 1
    recs = srv.batch_records
    assert [r["quarantine"] for r in recs].count(True) == 1
    assert [r["retry"] for r in recs][-2:] == [1, 2]
    assert sum(r["problems"] for r in recs) == len(reqs) + 2
    assert all(0 <= r["padding_waste"] < 1 for r in recs)


def test_submit_validation_and_unported_parts():
    srv = serve.Server(device="cpu")
    sq = np.eye(4, dtype=np.float32)
    rhs = np.ones((4, 1), np.float32)
    cases = [(("cholesky", sq, rhs), "unknown op"),
             (("solve", np.ones(4, np.float32), rhs), "2-D"),
             (("solve", sq, rhs.astype(np.float64)), "dtypes differ"),
             (("least_squares_solve", np.ones((3, 4), np.float32),
               np.ones((3, 1), np.float32)), "m >= n"),
             (("solve", np.ones((4, 3), np.float32), rhs), "square"),
             (("solve", sq, np.ones((5, 1), np.float32)), "row mismatch")]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            srv.submit(*args)
    assert srv.drain() == []
    t = srv.submit("solve", torch.from_numpy(sq), torch.from_numpy(rhs))
    assert int(t) == 0
    (res,) = srv.drain()
    assert t.result(timeout=0).x is res.x
    np.testing.assert_allclose(res.x.numpy(), rhs)
    assert res.health.ok and not res.escalated
    # the background front door runs: start, a ticket settled by the
    # flush loop, shutdown with no serving thread left behind
    srv.start()
    assert srv.running()
    t = srv.submit("solve", torch.from_numpy(sq), torch.from_numpy(rhs))
    np.testing.assert_allclose(t.result(timeout=60).x.numpy(), rhs)
    srv.shutdown()
    assert not srv.running()
    assert not [th for th in threading.enumerate()
                if th.name.startswith("slate-serve-")]
    # Abft is ported: only chol_solve keeps the ragged route under it
    abft = {st.Option.Abft: st.Abft.On}
    assert sb._ragged_plan("solve", torch.zeros(2, 64, 64), abft) is None
    assert sb._ragged_plan("chol_solve", torch.zeros(2, 64, 64),
                           abft) is not None
    with pytest.raises(ValueError, match="unknown op"):
        sb.make_batched("cholesky")


def test_a_failed_batch_fails_its_tickets_and_raises_at_drain(monkeypatch):
    """An exception inside one group lands as a typed SlateServeError on
    that group's tickets and is raised by drain after the other groups
    were served."""
    srv = serve.Server(device="cpu", cache=serve.ExecutableCache())
    ok = srv.submit("solve", np.eye(4, dtype=np.float32),
                    np.ones((4, 1), np.float32))
    bad = srv.submit("chol_solve", np.eye(4, dtype=np.float32),
                     np.ones((4, 1), np.float32))
    real = sb.make_batched

    def broken(op, opts=None):
        if op == "chol_solve":
            def fn(a, b, sizes):
                raise RuntimeError("device lost")
            return fn
        return real(op, opts)
    monkeypatch.setattr(serve.cache._batched, "make_batched", broken)
    with pytest.raises(st.SlateError, match="device lost"):
        srv.drain()
    assert ok.result(timeout=0).health.ok
    with pytest.raises(serve.SlateServeError, match="chol_solve"):
        bad.result(timeout=0)


def test_cache_keys_and_stats():
    c = serve.ExecutableCache()
    f1, hit1 = c.get_or_compile("solve", (64, 2), "float32", 4)
    f2, hit2 = c.get_or_compile("solve", (64, 2), torch.float32, 4)
    assert (hit1, hit2) == (False, True) and f1 is f2
    _, hit = c.get_or_compile("solve", (64, 2), "float32", 4,
                              {st.Option.Precision: st.Precision.Bf16})
    assert not hit
    _, hit = c.get_or_compile("solve", (64, 2), "float32", 4, device="cpu")
    assert not hit
    s = c.stats()
    assert (s["entries"], s["hits"], s["misses"]) == (3, 1, 3)
    c.clear()
    assert c.stats()["entries"] == 0 and serve.default_cache() is \
        serve.default_cache()
    assert serve.options_fingerprint(
        {st.Option.Precision: st.Precision.Bf16,
         st.Option.ErrorPolicy: st.ErrorPolicy.Info}) == \
        serve.options_fingerprint(
        {st.Option.ErrorPolicy: st.ErrorPolicy.Info,
         st.Option.Precision: st.Precision.Bf16})


# -------------------------------------------------- admission control


def _sq():
    return np.eye(4, dtype=np.float32), np.ones((4, 1), np.float32)


def test_admission_overflow_policies():
    """reject raises typed; shed_oldest fails the oldest ticket and admits
    the newcomer; block gives up after its timeout; a deadline the rolling
    service estimate cannot meet is shed at admission, and one that passed
    while queued at drain."""
    cfg = serve.AdmissionConfig(max_queue=2, overflow="reject")
    srv = serve.Server(device="cpu", admission=cfg)
    srv.submit("solve", *_sq())
    srv.submit("solve", *_sq())
    with pytest.raises(serve.SlateServeOverloadError) as e:
        srv.submit("solve", *_sq())
    assert e.value.policy == "reject"
    assert len(srv.drain()) == 2
    srv = serve.Server(device="cpu", admission=serve.AdmissionConfig(
        max_queue=2, overflow="shed_oldest"))
    first = srv.submit("solve", *_sq())
    srv.submit("solve", *_sq())
    srv.submit("solve", *_sq())
    with pytest.raises(serve.SlateServeOverloadError, match="shed"):
        first.result(timeout=0)
    assert len(srv.drain()) == 2 and srv.queue.stats()["shed"] == 1
    srv = serve.Server(device="cpu", admission=serve.AdmissionConfig(
        max_queue=1, overflow="block", block_timeout_s=0.05))
    srv.submit("solve", *_sq())
    t0 = time.perf_counter()
    with pytest.raises(serve.SlateServeOverloadError) as e:
        srv.submit("solve", *_sq())
    assert e.value.policy == "block" and time.perf_counter() - t0 >= 0.04
    srv.drain()
    srv.queue.governor.observe(500.0)              # a slow service estimate
    with pytest.raises(serve.SlateServeTimeoutError) as e:
        srv.submit("solve", *_sq(), deadline_ms=10.0)
    assert e.value.reason == "deadline"
    srv = serve.Server(device="cpu")
    late = srv.submit("solve", *_sq(), deadline_ms=1.0)
    time.sleep(0.01)
    assert srv.drain() == []
    with pytest.raises(serve.SlateServeTimeoutError, match="expired"):
        late.result(timeout=0)
    with pytest.raises(ValueError, match="overflow policy"):
        serve.AdmissionConfig(overflow="drop")


def test_block_policy_admits_when_a_drain_frees_space():
    """A submitter blocked on a full queue is admitted once another thread
    drains it; SLO backpressure halves capacity while the rolling p99 is
    over budget."""
    srv = serve.Server(device="cpu", admission=serve.AdmissionConfig(
        max_queue=1, overflow="block", block_timeout_s=5.0))
    srv.submit("solve", *_sq())
    out = []
    t = threading.Thread(target=lambda: out.append(srv.submit(
        "solve", *_sq())))
    t.start()
    time.sleep(0.05)
    assert len(srv.drain()) == 1
    t.join(5.0)
    assert not t.is_alive() and len(out) == 1
    assert len(srv.drain()) == 1
    q = serve.AdmissionQueue(serve.AdmissionConfig(max_queue=8,
                                                   slo_budget_ms=10.0))
    assert q.capacity() == 8
    for _ in range(4):
        q.governor.observe(50.0)
    assert q.governor.overloaded() and q.capacity() == 4
