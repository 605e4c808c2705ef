"""The port's serving events, capture sentinel, ladder fitter and captured
programs, against slate_tpu on the CPU.

- ``serve_ladder_from_sizes`` and ``ladder_waste`` give the reference's
  ladder and waste from the same seeded sizes, exactly;
- a seeded 12-request stream through ``Server.start()`` agrees with the
  reference's background server to 1e-5 of each solution's largest entry;
- every ``serve_*`` record the port emits carries the reference's keys,
  ``retraces`` renamed ``captures``;
- the sink (ring, collectors, the JSONL path, timing) and the capture
  sentinel behave as the reference's;
- the programs the card captures (serve/cache.py ``BucketGraphs`` and
  posv's ``Option.HoldLocalWorkspace``), run here with a stand-in for the
  CUDA graph that replays the function on its static inputs, give the
  eager path's bits: the device parts read nothing but those inputs.

The reference's drivers are wrapped in ``@annotate``, which calls
``jax.core.trace_state_clean``; the ``ref_drivers`` fixture restores it.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import json
import warnings

import numpy as np
import pytest
import torch

import jax
from slate_tpu import obs as ref_obs
from slate_tpu import serve as ref_serve
from slate_tpu import posv as ref_posv
from slate_tpu import HermitianMatrix as RefHermitian
from slate_tpu import Matrix as RefMatrix
from slate_tpu import Option as RefOption
from slate_tpu.robust import faults as ref_faults
from slate_tpu.tune import autotune as ref_autotune

import slate_tpu_torch as st
from slate_tpu_torch import serve
from slate_tpu_torch.drivers import cholesky as chol
from slate_tpu_torch.internal import graphs
from slate_tpu_torch.obs import events, sentinel
from slate_tpu_torch.robust import faults
from slate_tpu_torch.robust.recovery import posv_with_recovery
from slate_tpu_torch.serve import batched as sb
from slate_tpu_torch.serve import cache as sc
from slate_tpu_torch.tune import autotune


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _mk_solve(rng, n, k=2):
    a = rng.standard_normal((n, n)).astype(np.float32)
    a += np.eye(n, dtype=np.float32) * (4 + np.sqrt(n))
    return a, rng.standard_normal((n, k)).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


# ------------------------------------------------------- ladder fitter


@pytest.mark.parametrize("seed,count,max_rungs", [
    (0, 40, 8), (1, 200, 8), (2, 500, 4), (3, 12, 8), (4, 300, 2)])
def test_ladder_fitter_matches_the_reference(seed, count, max_rungs):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in np.concatenate([
        rng.integers(1, 300, count // 2),
        rng.lognormal(6.0, 0.8, count - count // 2).astype(int) + 1])]
    got = autotune.serve_ladder_from_sizes(sizes, max_rungs=max_rungs)
    want = ref_autotune.serve_ladder_from_sizes(sizes, max_rungs=max_rungs)
    assert got == want
    for lad, rlad in ((serve.BucketLadder(got, "retuned"),
                       ref_serve.BucketLadder(want, "retuned")),
                      (serve.geometric_ladder(),
                       ref_serve.geometric_ladder())):
        assert autotune.ladder_waste(sizes, lad) == \
            ref_autotune.ladder_waste(sizes, rlad)
    with pytest.raises(ValueError, match="no positive sizes"):
        autotune.serve_ladder_from_sizes([0, -3])


# ------------------------------------------- the stream, background path


def test_background_stream_matches_the_reference(ref_drivers):
    """Twelve seeded requests (three ops, buckets 32 and 64) through the
    background loop of both packages: each solution within 1e-5 of its
    largest entry, the same health flags and escalations."""
    rng = np.random.default_rng(12)
    reqs = []
    for i in range(12):
        n = (12, 20, 40, 60)[i % 4]
        if i % 3 == 0:
            reqs.append(("solve", *_mk_solve(rng, n)))
        elif i % 3 == 1:
            g = rng.standard_normal((n, n)).astype(np.float32)
            reqs.append(("chol_solve", g @ g.T / n + np.eye(
                n, dtype=np.float32), rng.standard_normal(
                    (n, 2)).astype(np.float32)))
        else:
            reqs.append(("least_squares_solve",
                         rng.standard_normal((2 * n, n)).astype(np.float32),
                         rng.standard_normal((2 * n, 2)).astype(np.float32)))

    def run(srv):
        srv.start()
        try:
            tickets = [srv.submit(op, a, b) for op, a, b in reqs]
            return [t.result(timeout=300.0) for t in tickets]
        finally:
            srv.shutdown()

    cfg = dict(flush_occupancy=12, max_batch_delay_ms=50.0)
    got = run(serve.Server(device="cpu", cache=serve.ExecutableCache(),
                           admission=serve.AdmissionConfig(**cfg)))
    want = run(ref_serve.Server(cache=ref_serve.ExecutableCache(),
                                admission=ref_serve.AdmissionConfig(**cfg)))
    for g, w in zip(got, want):
        wx = np.asarray(w.x)
        assert g.x.shape == wx.shape
        np.testing.assert_allclose(g.x.numpy(), wx, rtol=0,
                                   atol=1e-5 * np.abs(wx).max())
        assert (g.health.ok, g.escalated) == (bool(w.health.ok),
                                              bool(w.escalated))


# ----------------------------------------------------------- the events


def _keys(recs, kind, event=None):
    return [set(e) for e in recs if e.get("kind") == kind
            and (event is None or e.get("event") == event)]


def _drive_events(pkg, server_kw, pool, faults_mod):
    """Every serve_* kind from one package: a shed at admission, a batch,
    a quarantine, a failover with quarantine and readmission, and a
    retune."""
    rng = np.random.default_rng(5)
    admission = pkg.AdmissionConfig(max_queue=2, overflow="reject",
                                    retune_interval_s=1e9,
                                    retune_min_samples=8,
                                    retune_margin=0.02)
    srv = pkg.Server(cache=pkg.ExecutableCache(), admission=admission,
                     pool=pool, **server_kw)
    obs_mod = events if pkg is serve else ref_obs
    with obs_mod.recording() as recs:
        a, b = _mk_solve(rng, 8)
        srv.submit("solve", a, b)
        srv.submit("solve", np.zeros((8, 8), np.float32),
                   np.ones((8, 2), np.float32))        # poison
        with pytest.raises(pkg.SlateServeOverloadError):
            srv.submit("solve", a, b)
        srv.drain()
        with faults_mod.inject(faults_mod.FaultPlan(
                "serve_device_fail", kind="inf", transient=True)):
            srv.serve_batch([("solve", a, b)])
        assert srv.pool.probe(0) and srv.pool.probe(1)
        for i in range(8):
            srv.serve_batch([("solve", *_mk_solve(rng, 40 if i % 2
                                                  else 96))])
        assert srv.retune_now("float32") is not None
    return recs


def test_serve_events_carry_the_reference_keys(ref_drivers):
    got = _drive_events(serve, {}, serve.DevicePool(
        ["cpu", "cpu"], serve.PoolConfig(strike_limit=1)), faults)
    want = _drive_events(ref_serve, {}, ref_serve.DevicePool(
        [jax.local_devices()[0]] * 2, ref_serve.PoolConfig(strike_limit=1)),
        ref_faults)
    for kind, event in (("serve_batch", None), ("serve_shed", None),
                        ("serve_quarantine", None),
                        ("serve_device", "failover"),
                        ("serve_device", "quarantine"),
                        ("serve_device", "readmit"),
                        ("serve_retune", None)):
        g, w = _keys(got, kind, event), _keys(want, kind, event)
        assert g and len(g) == len(w), (kind, event)
        for gk, wk in zip(g, w):
            if kind == "serve_batch":
                wk = (wk - {"retraces"}) | {"captures"}
            assert gk == wk, (kind, event, gk ^ wk)
    assert all(e["captures"] == 0 for e in got
               if e.get("kind") == "serve_batch")
    assert all(e["schema"] == "slate-obs-v1" for e in got)
    assert not any(isinstance(v, torch.Tensor) for e in got
                   for v in e.values())


def test_event_sink_ring_path_and_timing(tmp_path):
    path = tmp_path / "events.jsonl"
    events.clear()
    events.emit_serve_retune({"op": "ladder"})     # recording off: dropped
    assert events.recent() == [] and not events.enabled()
    events.enable(str(path))
    try:
        assert events.enabled()
        events.emit_serve_shed({"op": "solve", "reason": "deadline"})
        with events.recording() as recs:
            events.emit_serve_device({"event": "readmit", "device_id": 0})
        assert [e["kind"] for e in recs] == ["serve_device"]
    finally:
        events.disable()
        events.configure(path="")
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["serve_shed", "serve_device"]
    assert [e["kind"] for e in events.recent(2)] == [
        "serve_shed", "serve_device"]
    events.clear()
    assert events.recent() == []
    assert not events.timing_enabled()
    with events.timing():
        assert events.timing_enabled()
        srv = serve.Server(device="cpu", cache=serve.ExecutableCache())
        with events.recording() as recs:
            srv.serve_batch([("solve", *_mk_solve(
                np.random.default_rng(0), 8))])
        (ev,) = [e for e in recs if e["kind"] == "serve_batch"]
        assert ev["device_ms"] is not None and ev["mfu"] is None
    assert not events.timing_enabled()


def test_capture_sentinel_counts_and_warns(monkeypatch):
    sentinel.reset()
    monkeypatch.setenv("SLATE_OBS_RETRACE_LIMIT", "2")
    for _ in range(2):
        sentinel.record_trace("serve.solve", "float32:b1:32x2:f32")
    with sentinel.suppressed():
        sentinel.record_trace("serve.solve", "float32:b1:32x2:f32")
    assert sentinel.stats() == {"serve.solve": {
        "traces": 2, "signatures": 1, "max_per_signature": 2}}
    with pytest.warns(sentinel.SlateRetraceWarning, match="captured 3x"):
        sentinel.record_trace("serve.solve", "float32:b1:32x2:f32")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sentinel.record_trace("serve.solve", "float32:b1:32x2:f32")
    assert sentinel.total() == 4
    sentinel.reset()
    assert sentinel.total() == 0


# ---------------------------------------- captured programs, CPU stand-in


class _Replay:
    """A CPU stand-in for graphs.Captured: it runs the function once at
    "capture" and again at every call on its static inputs only, which is
    what a replay does, and hands out copies of the outputs."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, list(inputs)
        fn(*self.inputs)                    # the warm-up pass
        self.outputs = tuple(fn(*self.inputs))
        self.launches = {}

    def __call__(self, *args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.outputs = tuple(self.fn(*self.inputs))
        return tuple(o.clone() for o in self.outputs)


@pytest.fixture
def replay(monkeypatch):
    monkeypatch.setattr(sc, "Captured", _Replay)
    monkeypatch.setattr(graphs, "Captured", _Replay)


@pytest.mark.parametrize("op", ["solve", "chol_solve",
                                "least_squares_solve"])
@pytest.mark.parametrize("low", [False, True])
def test_bucket_graphs_give_the_eager_bits(replay, op, low):
    """BucketGraphs (the card's captured program) against make_batched on
    two different batches of one bucket, f32 and the bf16 rung: equal
    bits, health and flags, and the second batch does not see the
    first's."""
    opts = {st.Option.Precision: st.Precision.Bf16} if low else None
    rng = np.random.default_rng(40)
    shape = (128, 64, 2) if op == "least_squares_solve" else (64, 2)
    exe = sc.BucketGraphs(op, shape, "float32", 4, opts,
                          torch.device("cpu"))
    assert exe.route == "ragged"
    assert set(exe.graphs) == ({"f32", "low"} if low else {"f32"})
    eager = sb.make_batched(op, opts)
    escalated = []
    for sizes in ([64, 40, 17, 0], [30, 64, 0, 0]):
        srv = serve.Server(device="cpu")
        members = []
        for s in sizes:
            if s:
                if op == "least_squares_solve":
                    a = rng.standard_normal((2 * s, s)).astype(np.float32)
                    b = rng.standard_normal((2 * s, 2)).astype(np.float32)
                else:
                    a, b = _mk_solve(rng, s)
                    if op == "chol_solve":
                        a = a @ a.T / s
                    if s == 40:
                        a[0, 0] = 0.0 if op == "solve" else -1.0
                members.append((len(members), serve.Request(
                    op, torch.from_numpy(a), torch.from_numpy(b))))
        a_pad, b_pad, sz, _ = srv._pack(op, "float32", shape, 4, members)
        x, h, esc = exe(a_pad, b_pad, sz)
        wx, wh, wesc = eager(a_pad, b_pad, sz)
        assert torch.equal(_bits(x), _bits(wx))
        assert h == wh and esc == wesc
        escalated += esc
    assert any(escalated) or op == "least_squares_solve"


def test_bucket_graphs_run_eagerly_while_a_fault_plan_is_armed(replay):
    """A strike's positions come from the host and a transient one fires
    once: while a plan is armed at a device site the parts run eagerly,
    and the strike lands (Abft's in-batch rungs see it)."""
    abft = {st.Option.Abft: st.Abft.On}
    exe = sc.BucketGraphs("chol_solve", (64, 2), "float32", 2, abft,
                          torch.device("cpu"))
    g = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (64, 64)).astype(np.float32))
    a = torch.stack([g @ g.T / 64 + torch.eye(64), torch.eye(64)])
    b = torch.ones(2, 64, 2)
    sizes = torch.tensor([64, 0], dtype=torch.int32)
    calls = []
    real = exe.graphs["f32"]
    exe.graphs["f32"] = lambda *args: calls.append(1) or real(*args)
    _, h, _ = exe(a, b, sizes)
    assert calls == [1] and h[0].abft_detected == 0
    with faults.inject(faults.FaultPlan("post_panel", kind="bitflip",
                                        tile=(0, 0))):
        _, h, _ = exe(a, b, sizes)
    assert calls == [1] and h[0].abft_detected == 1


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_held_workspace_attempt_gives_the_eager_bits(replay, uplo):
    """posv's captured Cholesky attempt (Option.HoldLocalWorkspace on the
    card) against the eager attempt: equal factor and solution bits and
    health, on two right-hand sides through one capture."""
    rng = np.random.default_rng(41)
    n, nb = 200, 64
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T / n + np.eye(n, dtype=np.float32)
    A = st.HermitianMatrix.from_numpy(a, nb, getattr(st.Uplo, uplo),
                                      device="cpu")
    chol._HELD.clear()
    for k in range(2):
        b = rng.standard_normal((n, 3)).astype(np.float32)
        B = st.Matrix.from_numpy(b, nb, device="cpu")
        info = {st.Option.ErrorPolicy: st.ErrorPolicy.Info}
        L, X, h = posv_with_recovery(A, B, info,
                                     chol_attempt=chol._held_attempt)
        wL, wX, wh = st.posv(A, B, info)
        assert torch.equal(_bits(X.to_dense()), _bits(wX.to_dense()))
        assert torch.equal(_bits(L.to_dense()), _bits(wL.to_dense()))
        assert h == wh and h.ok
    assert len(chol._HELD) == 1
    chol._HELD.clear()


def test_hold_local_workspace_matches_the_reference(ref_drivers):
    """posv under Option.HoldLocalWorkspace against the reference's one
    jitted factor+solve program."""
    rng = np.random.default_rng(42)
    n, nb = 160, 64
    g = rng.standard_normal((n, n)).astype(np.float32)
    a = g @ g.T / n + np.eye(n, dtype=np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    _, X = st.posv(st.HermitianMatrix.from_numpy(a, nb, device="cpu"),
                   st.Matrix.from_numpy(b, nb, device="cpu"),
                   {st.Option.HoldLocalWorkspace: True})
    _, RX = ref_posv(RefHermitian.from_numpy(a, nb),
                     RefMatrix.from_numpy(b, nb),
                     {RefOption.HoldLocalWorkspace: True})
    want = RX.to_numpy()
    np.testing.assert_allclose(X.to_numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_captured_kernel_launches_go_to_the_tally():
    """A launch made while a graph is captured only enqueues: it is
    tallied, not counted, and each replay adds the tally to ``replayed``."""
    from slate_tpu_torch.internal import kernels
    k = kernels.CudaKernel("probe", "tri_inv.cu", {})
    k.call = lambda *args: None
    k.launch("slate_probe")
    with kernels.capture_tally() as tally:
        k.launch("slate_probe")
        k.launch("slate_probe")
    assert k.launches == 1 and tally == {k: 2}
    for _ in range(3):
        kernels.add_replay(tally)
    assert k.replayed == 6
