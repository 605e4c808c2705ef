"""The port's driver telemetry (slate_tpu_torch.obs, util/trace.py) against
slate_tpu.obs on the CPU: one event per outermost driver call with the
reference's fields, spans with the reference's names and nesting, the
Chrome and JSONL exports, the same kernel work and bits with obs on and
off, frames kept per thread, and the metrics, compare and SLO command
lines on the reference's fixtures.  Every test runs with the port's plan
cache pointed at a missing ``tmp_path`` file (the default plans).

Tolerances: event fields are compared exactly (op, shapes, dtype, path,
escalations, policy, speculate, abft, status, the health's keys and its
flags and integer fields); the health's min_pivot and growth are f32
values of sums taken in another order and are not compared; the obs-on
and obs-off solutions are compared bit for bit.  The reference's drivers
are wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``;
the installed JAX no longer exports that name, so the ``ref_drivers``
fixture restores it on the test side only.  A reference serving record
counts ``retraces`` where the port's counts ``captures``; the Prometheus
text names its module, which differs only in the package's name.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import json
import threading

import numpy as np
import pytest
import torch

import jax
import slate_tpu as ref
from slate_tpu import obs as ref_obs
from slate_tpu import serve as ref_serve
from slate_tpu.obs import metrics as ref_metrics
from slate_tpu.obs import slo as ref_slo

import slate_tpu_torch as st
from slate_tpu_torch import obs, serve
from slate_tpu_torch.internal import (chol_kernels, lu_kernels, qr_kernels,
                                      tri_inv)
from slate_tpu_torch.obs import __main__ as obs_cli
from slate_tpu_torch.obs import compare as obs_compare
from slate_tpu_torch.obs import events, metrics, slo
from slate_tpu_torch.robust import faults
from slate_tpu_torch.util.trace import annotate, span

NB = 32
FIELDS = ("op", "shapes", "dtype", "path", "escalations", "policy",
          "speculate", "abft", "status")
HEALTH_EXACT = ("ok", "info", "nonfinite", "iters", "converged",
                "abft_detected", "abft_corrected", "abft_site")


@pytest.fixture(autouse=True)
def empty_plans(tmp_path, monkeypatch):
    """The port's plan cache pointed at a missing file: default plans."""
    from slate_tpu_torch.tune import plans
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(tmp_path / "p.json"))
    plans.reload()
    yield
    plans.reload()


@pytest.fixture
def ref_drivers(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _spd(rng, n):
    g = rng.standard_normal((n, n)).astype(np.float32)
    return (g @ g.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _sym_indef(rng, n):
    g = rng.standard_normal((n, n)).astype(np.float32)
    d = np.where(np.arange(n) % 2 == 0, 4.0, -4.0).astype(np.float32)
    return ((g + g.T) / 4 + np.diag(d)).astype(np.float32)


def _case(name, rng):
    """(ref call, port call) on the same numpy inputs."""
    n = 64
    b = rng.standard_normal((n, 2)).astype(np.float32)
    if name == "posv":
        a = _spd(rng, n)
        return (lambda: ref.posv(ref.HermitianMatrix.from_numpy(a, NB),
                                 ref.Matrix.from_numpy(b, NB)),
                lambda: st.posv(st.HermitianMatrix.from_numpy(
                    a, NB, device="cpu"), st.Matrix.from_numpy(
                        b, NB, device="cpu")))
    if name == "posv_indefinite_error":
        # the first leading minor fails: both packages report info 1 (past
        # a tile's first row the reference reports that row, the port the
        # failing column)
        a = _spd(rng, n)
        a[0, 0] = -a[0, 0]
        ro = {ref.Option.UseFallbackSolver: False}
        po = {st.Option.UseFallbackSolver: False}
        return (lambda: ref.posv(ref.HermitianMatrix.from_numpy(a, NB),
                                 ref.Matrix.from_numpy(b, NB), ro),
                lambda: st.posv(st.HermitianMatrix.from_numpy(
                    a, NB, device="cpu"), st.Matrix.from_numpy(
                        b, NB, device="cpu"), po))
    if name.startswith("gesv"):
        a = _spd(rng, n) / n
        method = {"gesv_calu": "CALU", "gesv_nopiv_escalation": "NoPiv",
                  "gesv_info": "PartialPiv"}[name]
        if name == "gesv_nopiv_escalation":
            a[0, 0] = 0.0                   # NoPiv fails, PartialPiv solves
        ro = {ref.Option.MethodLU: getattr(ref.MethodLU, method)}
        po = {st.Option.MethodLU: getattr(st.MethodLU, method)}
        if name == "gesv_info":
            ro[ref.Option.ErrorPolicy] = ref.ErrorPolicy.Info
            po[st.Option.ErrorPolicy] = st.ErrorPolicy.Info
        return (lambda: ref.gesv(ref.Matrix.from_numpy(a, NB),
                                 ref.Matrix.from_numpy(b, NB), ro),
                lambda: st.gesv(st.Matrix.from_numpy(a, NB, device="cpu"),
                                st.Matrix.from_numpy(b, NB, device="cpu"),
                                po))
    if name.startswith("gels"):
        m = 3 * n if name == "gels_cholqr" else 2 * n
        a = rng.standard_normal((m, n)).astype(np.float32)
        bb = rng.standard_normal((m, 2)).astype(np.float32)
        return (lambda: ref.gels(ref.Matrix.from_numpy(a, NB),
                                 ref.Matrix.from_numpy(bb, NB)),
                lambda: st.gels(st.Matrix.from_numpy(a, NB, device="cpu"),
                                st.Matrix.from_numpy(bb, NB, device="cpu")))
    assert name == "hesv"
    a = _sym_indef(rng, n)
    return (lambda: ref.hesv(ref.HermitianMatrix.from_numpy(a, NB),
                             ref.Matrix.from_numpy(b, NB)),
            lambda: st.hesv(st.HermitianMatrix.from_numpy(a, NB,
                                                          device="cpu"),
                            st.Matrix.from_numpy(b, NB, device="cpu")))


def _run(pkg_obs, call):
    with pkg_obs.recording() as evs, pkg_obs.record_spans() as rec:
        try:
            call()
        except Exception as e:            # noqa: BLE001 -- status checked
            err = type(e).__name__
        else:
            err = None
    return evs, rec.spans, err


CASES = ["posv", "posv_indefinite_error", "gesv_calu",
         "gesv_nopiv_escalation", "gesv_info", "gels_qr", "gels_cholqr",
         "hesv"]


@pytest.mark.parametrize("name", CASES)
def test_one_event_per_call_with_the_reference_fields(ref_drivers, name):
    rcall, pcall = _case(name, np.random.default_rng(3))
    r_evs, r_spans, r_err = _run(ref_obs, rcall)
    p_evs, p_spans, p_err = _run(obs, pcall)
    assert r_err == p_err
    assert len(r_evs) == len(p_evs) == 1
    (want,), (got,) = r_evs, p_evs
    assert set(got) == set(want)
    assert {k: got[k] for k in FIELDS} == {k: want[k] for k in FIELDS}
    if want["health"] is None:
        assert got["health"] is None
    else:
        assert set(got["health"]) == set(want["health"])
        assert {k: got["health"][k] for k in HEALTH_EXACT} == \
            {k: want["health"][k] for k in HEALTH_EXACT}
    assert got["traced"] is False and got["device_ms"] is None
    assert all(isinstance(v, (str, int, float, bool, list, dict,
                              type(None))) for v in got.values())
    # the spans: the reference's names and nesting, innermost first
    assert [(s["name"], s["depth"]) for s in p_spans] == \
        [(s["name"], s["depth"]) for s in r_spans]


def test_event_paths_and_plans_on_the_main_drivers():
    rng = np.random.default_rng(4)
    _, pcall = _case("gesv_nopiv_escalation", rng)
    (e,), _, _ = _run(obs, pcall)
    assert e["path"] == "escalated:PartialPiv" and e["escalations"] == 1
    _, pcall = _case("posv", rng)
    with obs.timing():
        (e,), _, _ = _run(obs, pcall)
    assert e["path"] == "direct:cholesky" and e["policy"] == "Raise"
    assert e["device_ms"] is not None and e["device_ms"] <= e["dur_ms"]
    # posv's panels resolve potrf_panel; a cache miss is the kernel
    assert e["plans"] and all(
        p["op"] == "potrf_panel" and p["source"] == "default"
        and p["kernel"] == "cuda" and p["dist"] is None for p in e["plans"])
    assert len({p["n"] for p in e["plans"]}) == len(e["plans"])


# ---- the same work and bits with obs on or off ---------------------------


PLAIN = [(chol_kernels, "chol_panel_plain"), (tri_inv, "upper_tri_inv_plain"),
         (lu_kernels, "lu_panel_plain"), (lu_kernels, "lu_select_plain"),
         (qr_kernels, "qr_panel_plain")]


@pytest.mark.parametrize("name", ["posv", "gesv_calu", "gels_qr",
                                  "gesv_nopiv_escalation"])
def test_obs_changes_no_kernel_work_and_no_bits(monkeypatch, name):
    """The kernels' plain versions (what their wrappers run on CPU
    tensors) are called as often, and the solution is bit-equal, with
    events, spans and timing on as with all of them off."""
    tally = {}
    for mod, fn in PLAIN:
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            tally[_fn] = tally.get(_fn, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)

    def solve(on):
        tally.clear()
        _, pcall = _case(name, np.random.default_rng(9))
        if on:
            with obs.recording() as evs, obs.record_spans(), obs.timing():
                out = pcall()
            assert len(evs) == 1
        else:
            out = pcall()
        x = out[1] if isinstance(out, tuple) else out
        return dict(tally), x.to_dense()

    off_tally, x_off = solve(False)
    on_tally, x_on = solve(True)
    assert on_tally == off_tally and sum(off_tally.values()) > 0
    assert torch.equal(x_on.view(torch.int32), x_off.view(torch.int32))


def test_disabled_boundaries_keep_no_frames():
    assert not events.enabled()
    tok = events.boundary_enter("slate.posv", ())
    assert tok is None and events._outer() is None
    events.boundary_exit(tok)

    @annotate("slate.boom")
    def boom():
        raise ValueError("x")

    with pytest.raises(ValueError):
        boom()
    assert getattr(events._TLS, "depth", 0) == 0
    with obs.recording() as evs:
        with pytest.raises(ValueError):
            boom()
    assert [e["status"] for e in evs] == ["error:ValueError"]
    assert events._outer() is None and events._TLS.depth == 0


def test_nested_calls_collapse_and_frames_stay_per_thread():
    """A nested driver call notes into the outermost frame only; a driver
    called on another thread while a frame is open emits its own event
    and notes nothing into this thread's frame."""
    seen = []

    @annotate("slate.inner")
    def inner():
        events.note_path("inner", (), 0, False)

    @annotate("slate.worker")
    def worker():
        events.note_path("worker", (), 0, False)

    @annotate("slate.outer")
    def outer():
        inner()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        seen.append(events._outer().notes.get("path"))

    with obs.recording() as evs:
        outer()
    assert seen == ["direct:inner"]
    assert sorted(e["op"] for e in evs) == ["outer", "worker"]
    by = {e["op"]: e for e in evs}
    assert by["worker"]["path"] == "direct:worker"
    assert by["outer"]["path"] == "direct:inner"


def test_health_holding_tensors_is_recorded_as_none():
    h = st.HealthInfo(nonfinite=torch.tensor(False), info=0, min_pivot=1.0,
                      min_pivot_index=0, growth=1.0, iters=0, converged=True)
    with obs.recording() as evs:
        tok = events.boundary_enter("slate.x", ())
        events.note_health("x", h, "Raise")
        events.boundary_exit(tok)
    assert evs[0]["health"] is None and evs[0]["policy"] == "Raise"


def test_plan_notes_dedupe_and_cap():
    with obs.recording() as evs:
        tok = events.boundary_enter("slate.x", ())
        for n in range(20):
            for _ in range(3):
                events.note_plan("potrf_panel", n, "float32", "cuda", 128,
                                 "default", None)
        events.boundary_exit(tok)
    assert len(evs[0]["plans"]) == events._MAX_PLANS_PER_EVENT


# ---- spans and their exports ---------------------------------------------


def test_chrome_and_jsonl_exports_match_the_reference(ref_drivers,
                                                      tmp_path):
    rcall, pcall = _case("gesv_calu", np.random.default_rng(5))
    with ref_obs.record_spans() as rrec:
        rcall()
    with obs.record_spans() as prec:
        with span("slate.user_phase"):
            pcall()
    names = [s["name"] for s in prec.spans]
    assert names[-1] == "slate.user_phase" and names[-2] == "slate.gesv"
    assert [(s["name"], s["depth"] + 1) for s in rrec.spans] == \
        [(s["name"], s["depth"]) for s in prec.spans[:-1]]
    for rec, tag in ((rrec, "ref"), (prec, "port")):
        rec.export_chrome_trace(str(tmp_path / f"{tag}.json"))
        rec.export_jsonl(str(tmp_path / f"{tag}.jsonl"))
    rc = json.loads((tmp_path / "ref.json").read_text())
    pc = json.loads((tmp_path / "port.json").read_text())
    assert set(pc) == set(rc)
    assert len(pc["traceEvents"]) == len(prec.spans)
    for got, want in zip(pc["traceEvents"], rc["traceEvents"]):
        assert set(got) == set(want) and got["ph"] == "X"
        assert set(got["args"]) == set(want["args"])
        assert got["args"]["traced"] is False and got["dur"] >= 0
    lines = [json.loads(ln) for ln in
             (tmp_path / "port.jsonl").read_text().splitlines()]
    want = json.loads((tmp_path / "ref.jsonl").read_text().splitlines()[0])
    assert all(set(ln) == set(want) and ln["kind"] == "span"
               and ln["schema"] == "slate-obs-v1" for ln in lines)
    # the spans feed the metrics CLI's span count
    assert metrics.summarize([str(tmp_path / "port.jsonl")])["counts"][
        "spans"] == len(lines)


def test_span_opens_a_profiler_range_only_under_a_profiler():
    with torch.profiler.profile() as prof:
        with span("slate.probe"):
            torch.ones(4).sum()
    assert "slate.probe" in {e.key for e in prof.key_averages()}


# ---- the metrics, compare and SLO command lines --------------------------


def _round(tmp_path, name, values):
    p = tmp_path / name
    p.write_text("".join(
        json.dumps({"schema": "slate-bench-v1", "metric": m, "value": v,
                    "unit": "GFLOP/s", "chip": "cpu"}) + "\n"
        for m, v in values.items()))
    return str(p)


def test_compare_classifies_and_gates(tmp_path):
    old = _round(tmp_path, "old.jsonl",
                 {"gemm": 100.0, "potrf": 100.0, "gone": 1.0})
    new = _round(tmp_path, "new.jsonl",
                 {"gemm": 120.0, "potrf": 97.0, "fresh": 2.0})
    r = obs_compare.compare(old, new)
    by = {row["metric"]: row for row in r["rows"]}
    assert by["gemm"]["class"] == "improved" and not by["gemm"]["gated"]
    assert by["potrf"]["class"] == "flat"
    assert r["only_old"] == ["gone"] and r["only_new"] == ["fresh"]
    assert r["regressions"] == []
    worse = _round(tmp_path, "worse.jsonl", {"gemm": 80.0, "potrf": 99.0})
    r = obs_compare.compare(old, worse)
    (bad,) = r["regressions"]
    assert bad["metric"] == "gemm" and bad["gated"]
    assert bad["delta_pct"] == -20.0
    from slate_tpu.obs import compare as ref_compare
    assert r == ref_compare.compare(old, worse)
    assert obs_compare.render_compare(r) == ref_compare.render_compare(r)


def test_compare_gate_threshold_is_the_ci_knob(tmp_path, capsys):
    old = _round(tmp_path, "old.jsonl", {"gemm": 100.0})
    new = _round(tmp_path, "new.jsonl", {"gemm": 94.0})
    assert obs_compare.compare(old, new)["rows"][0]["class"] == "regressed"
    assert not obs_compare.compare(old, new)["regressions"]
    assert obs_compare.compare(old, new, gate=5.0)["regressions"]
    assert obs_cli.main(["--compare", old, new]) == 0
    assert obs_cli.main(["--compare", old, new, "--gate", "5"]) == 1
    assert obs_cli.main(["--compare", old, old, "--json"]) == 0
    assert "[GATED]" in capsys.readouterr().out


@pytest.mark.parametrize("metric,direction,noise", [
    ("serve_survival_shed_per_1k", "lower", 20.0),
    ("serve_survival_quar_per_1k", "lower", 20.0),
    ("serve_survival_problems_per_s", "higher", 20.0),
    ("serve_mixed_problems_per_s", "higher", 15.0),
    ("serve_pool_problems_per_s", "higher", 20.0),
    ("serve_pool_failover_recovery_ms", "lower", 20.0),
    ("gemm_n4096_gflops_per_chip", "higher", 5.0),
    ("abft_overhead_pct", "lower", 5.0),
])
def test_compare_classifies_survival_and_pool_metrics(metric, direction,
                                                      noise):
    assert obs_compare.direction(metric) == direction
    assert obs_compare.noise_pct(metric) == noise


def _rng():
    return np.random.default_rng(77)


def _mk_solve(rng, n, k=2):
    a = rng.standard_normal((n, n)).astype(np.float32)
    a += np.eye(n, dtype=np.float32) * (4 + np.sqrt(n))
    return a, rng.standard_normal((n, k)).astype(np.float32)


def _write(tmp_path, name, recs):
    path = tmp_path / name
    path.write_text("".join(json.dumps(e) + "\n" for e in recs))
    return str(path)


def _shed_stream(pkg, kw):
    """The reference's shed/quarantine fixture: 4 solves into a queue of
    2 (shed_oldest), then a poison that sheds one more and quarantines."""
    rng = _rng()
    good_a, good_b = _mk_solve(rng, 8)
    bad_a = np.zeros((8, 8), np.float32)
    bad_b = np.ones((8, 2), np.float32)
    cfg = pkg.AdmissionConfig(max_queue=2, overflow="shed_oldest")
    srv = pkg.Server(cache=pkg.ExecutableCache(), admission=cfg, **kw)
    pkg_obs = obs if pkg is serve else ref_obs
    with pkg_obs.recording() as recs:
        for _ in range(4):
            srv.submit("solve", good_a, good_b)
        srv.submit("solve", bad_a, bad_b)
        srv.drain()
    return recs


def _serve_rows(summary):
    """The serving table with the captures column under either name."""
    out = {}
    for key, row in summary["serve"].items():
        row = dict(row)
        if "retraces" in row:
            row["captures"] = row.pop("retraces")
        out[key] = row
    return out


def test_cli_serving_table_renders_shed_and_quarantine_columns(
        ref_drivers, tmp_path, capsys):
    recs = _shed_stream(serve, {"device": "cpu"})
    path = _write(tmp_path, "events.jsonl", recs)
    row = obs.summarize([path])["serve"]["solve/float32"]
    assert row["shed"] == 3 and row["quarantined"] == 1
    assert row["problems"] == 4
    assert row["shed_per_1k"] == round(1000.0 * 3 / 7, 2)
    assert row["quar_per_1k"] == 250.0
    assert row["captures"] == 0
    assert obs_cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "shed/1k" in out and "quar/1k" in out and "captures" in out
    assert "428.57" in out and " 250 " in out
    # the reference's records of the same stream summarize alike in both
    # packages' metrics
    ref_path = _write(tmp_path, "ref.jsonl", _shed_stream(ref_serve, {}))
    want = ref_metrics.summarize([ref_path])
    got = metrics.summarize([ref_path])
    assert _serve_rows(got) == _serve_rows(want)
    assert got["counts"] == want["counts"]
    for key in ("shed", "quarantined", "problems", "shed_per_1k",
                "quar_per_1k", "batches", "escalated"):
        assert row[key] == got["serve"]["solve/float32"][key], key


def _pool_server(pkg, members=2, **kw):
    devs = (["cpu"] * members if pkg is serve
            else [jax.local_devices()[0]] * members)
    pool = pkg.DevicePool(devs, pkg.PoolConfig(strike_limit=1))
    extra = {"device": "cpu"} if pkg is serve else {}
    return pkg.Server(cache=pkg.ExecutableCache(), pool=pool, **extra, **kw)


def _serve_once(srv, reqs):
    tickets = [srv.submit(op, a, b) for op, a, b in reqs]
    results = srv.drain()
    return [results[int(t)] for t in tickets]


def test_slo_budgets_target_device_rows(tmp_path, capsys):
    rng = _rng()
    srv = _pool_server(serve)
    with obs.recording() as recs:
        for _ in range(3):
            _serve_once(srv, [("solve", *_mk_solve(rng, n)) for n in (8, 24)
                              for _ in range(2)])
    stats = slo.aggregate(recs)
    dev_rows = [k for k in stats if k.startswith("device:")]
    assert set(dev_rows) == {"device:0", "device:1"}
    assert sum(stats[k]["problems"] for k in dev_rows) == 12
    assert all(v["ok"] for v in slo.evaluate(stats, {
        "device:0": {"latency_p99_ms": 1e9},
        "device:1": {"problems": 1}}))
    assert not slo.evaluate(stats, {"device:0": {
        "latency_p99_ms": 1e-9}})[0]["ok"]
    assert slo.latency_budget_ms({"*": {"latency_p99_ms": 250}}) == 250.0
    assert slo.latency_budget_ms({"*": {}}) is None
    # the CLI: budgets that pass exit 0, a failing one 1, a bad file 2
    path = _write(tmp_path, "events.jsonl", recs)
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"*": {"latency_p99_ms": 1e9, "problems": 1,
                                      "captures": 0}}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"*": {"wa_pps": 1e12}}))
    junk = tmp_path / "junk.json"
    junk.write_text("[1, 2]")
    assert obs_cli.main(["--slo", str(good), path]) == 0
    assert "3/3 budget check(s) passed" in capsys.readouterr().out
    assert obs_cli.main(["--slo", str(bad), path]) == 1
    assert obs_cli.main(["--slo", str(junk), path]) == 2
    assert obs_cli.main(["--slo", str(good), "--json", path]) == 0
    capsys.readouterr()
    assert obs_cli.main(["--prom", path]) == 0
    assert 'slate_serve_problems{op="*",dtype=""} 12' in \
        capsys.readouterr().out


def _bimodal_reqs(rng, count, k=2):
    return [("solve", *_mk_solve(rng, 40 if i % 2 == 0 else 96, k))
            for i in range(count)]


def test_cli_serving_table_renders_pool_columns(tmp_path, capsys):
    rng = _rng()
    srv = _pool_server(serve, admission=serve.AdmissionConfig(
        retune_interval_s=1e9, retune_min_samples=16, retune_margin=0.02))
    kill = faults.FaultPlan("serve_device_fail", kind="inf",
                            transient=True, device=0)
    with obs.recording() as recs:
        with faults.inject(kill):
            _serve_once(srv, _bimodal_reqs(rng, 16))
        assert srv.retune_now("float32") is not None
    path = _write(tmp_path, "events.jsonl", recs)
    table = obs.summarize([path])["serve"]
    row = table["solve/float32"]
    assert row["dev"] >= 1 and row["failovers"] == 1
    assert table["ladder/float32"]["retunes"] == 1
    assert obs_cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "dev" in out and "failovers" in out and "retunes" in out
    assert "ladder/float32" in out


def test_metrics_cli_renders_events_plans_and_json(tmp_path, capsys):
    rng = np.random.default_rng(6)
    recs = []
    for name in ("posv", "gesv_calu", "gels_qr"):
        _, pcall = _case(name, rng)
        evs, _, _ = _run(obs, pcall)
        recs += evs
    path = _write(tmp_path, "events.jsonl", recs + [{"schema": "x"}])
    with open(path, "a") as fh:
        fh.write('{"truncated": \n')
    assert obs_cli.main([path]) == 0
    out = capsys.readouterr().out
    assert "per-op events" in out and "plan usage" in out
    assert "potrf_panel kernel=cuda nb=128 source=default" in out
    assert "malformed=1" in out
    assert obs_cli.main(["--json", path]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary["ops"]) == {"posv", "gesv", "gels"}
    assert summary["counts"]["unknown"] == 1
    assert summary == json.loads(json.dumps(ref_metrics.summarize([path])))
    assert obs_cli.main([str(tmp_path / "missing.jsonl")]) == 2


def test_prometheus_text_equals_the_reference(tmp_path):
    recs = _shed_stream(serve, {"device": "cpu"})
    stats = slo.aggregate(recs)
    got = slo.export_prometheus(stats)
    assert got.replace("slate_tpu_torch.obs.slo", "slate_tpu.obs.slo") == \
        ref_slo.export_prometheus(stats)
    assert "slate_serve_shed_per_1k" in got
    ref_stats = ref_slo.aggregate(recs)
    for key, row in stats.items():
        ref_row = dict(ref_stats[key])
        ref_row["captures"] = ref_row.pop("retraces")
        assert row == ref_row, key
    verdicts = slo.evaluate(stats, {"*": {"shed_per_1k": 500},
                                    "nothing": {"wa_pps": 1}})
    assert [v["ok"] for v in verdicts] == [True, False]
    text = slo.render_verdicts(verdicts)
    assert "no-data" in text and "1/2 budget check(s) passed" in text


def test_checkpoint_records_reach_the_durability_table(tmp_path, capsys):
    with obs.recording() as recs:
        obs.emit_checkpoint("checkpoint_save", {
            "op": "potrf", "step": 3, "bytes": 4096, "verify": "ok",
            "wall_ms": 1.5})
        obs.emit_checkpoint("checkpoint_restore", {
            "op": "potrf", "step": 3, "bytes": 4096, "verify": "torn",
            "wall_ms": 0.5})
    path = _write(tmp_path, "ck.jsonl", recs)
    table = obs.summarize([path])["checkpoint"]
    assert table["potrf/checkpoint_restore"]["refusals"] == "torn=1"
    assert obs_cli.main([path]) == 0
    assert "durability" in capsys.readouterr().out
