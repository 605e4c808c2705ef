"""The port's plan cache and tuner (slate_tpu_torch.tune) against
slate_tpu.tune on the CPU: the schema on the reference's own accepted and
rejected cases, plan keys, record/reload round trips, nearest-n lookup
and its tie rule, the source and distance of every resolution over a
grid of sizes for one cache translated between the packages, the
candidate sweep, ``tune_op`` on the CPU, the serving ladder fit and the
CLI.

Kernel names translate "pallas" <-> "cuda", "xla" <-> "torch" ("ring"
stays); the port's TilePlan is (kernel, bw, nb), the reference's
(kernel, nb, bw).  The one stated departure: a cache miss resolves to
the hand kernel for float32 (and bfloat16 on the batch ops) in the port,
to XLA in the reference.  Every test points both packages' cache
variables at files under ``tmp_path``.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import json
import os

import numpy as np
import pytest

from slate_tpu import tune as ref_tune
from slate_tpu.robust.precision import normalize_dtype
from slate_tpu.serve import bucket as ref_bucket
from slate_tpu.tune import autotune as ref_autotune
from slate_tpu.tune import plans as ref_plans

from slate_tpu_torch.serve import bucket
from slate_tpu_torch.tune import autotune, plans
from slate_tpu_torch.tune.__main__ import main as tune_cli

TO_PORT = {"pallas": "cuda", "xla": "torch", "ring": "ring"}
TO_REF = {v: k for k, v in TO_PORT.items()}


@pytest.fixture(autouse=True)
def cache(tmp_path, monkeypatch):
    """Fresh cache files for both packages, for every test."""
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(port))
    monkeypatch.setenv("SLATE_TUNE_CACHE", str(ref))
    monkeypatch.delenv("SLATE_PALLAS", raising=False)
    plans.reload()
    ref_tune.reload()
    yield port, ref
    plans.reload()
    ref_tune.reload()


def _port_plan(rp):
    return plans.TilePlan(TO_PORT[rp.kernel], rp.bw, rp.nb)


def _translate(obj):
    """A reference cache object with its kernel names in the port's."""
    out = json.loads(json.dumps(obj))
    for ops in out.get("chips", {}).values():
        for entries in ops.values():
            for ent in entries.values():
                ent["kernel"] = TO_PORT.get(ent["kernel"], ent["kernel"])
    return out


# ---- schema -------------------------------------------------------------


def _good_cache():
    return {"version": 1, "chips": {"cpu": {
        "potrf_tile": {"n=512,dtype=float32":
                       {"kernel": "pallas", "nb": 512, "bw": 8,
                        "gflops": 123.4}}}}}


REF_CASES = [
    (lambda o: None, True),
    (lambda o: o.update(chips={}), True),
    (lambda o: o.update(version=99), False),
    (lambda o: o.update(extra=1), False),
    (lambda o: o.pop("chips"), False),
    (lambda o: o["chips"].update(cpu={"bogus_op": {}}), False),
    (lambda o: o["chips"]["cpu"]["potrf_tile"].update(
        {"n=1,dtype=f32": {"kernel": "magic", "nb": 1, "bw": 1}}), False),
    (lambda o: o["chips"]["cpu"]["potrf_tile"].update(
        {"n=1,dtype=f32": {"kernel": "xla", "nb": -4, "bw": 1}}), False),
    (lambda o: o["chips"]["cpu"]["potrf_tile"].update(
        {"badkey": {"kernel": "xla", "nb": 1, "bw": 1}}), False),
    (lambda o: o["chips"]["cpu"]["potrf_tile"]["n=512,dtype=float32"]
     .update(gflops="fast"), False),
    (lambda o: o["chips"]["cpu"].update(serve_bucket={
        "n=96,dtype=float32": {"kernel": "xla", "nb": 512, "bw": 8}}),
     True),
]


@pytest.mark.parametrize("mutate,ok", REF_CASES, ids=[
    "good", "no-chips-entries", "version", "extra-key", "no-chips",
    "bad-op", "bad-kernel", "bad-nb", "bad-entry-key", "bad-gflops",
    "pseudo-op"])
def test_schema_matches_the_reference(mutate, ok):
    """Each of the reference's schema cases, translated, is accepted or
    rejected by the port as the reference treats the original; and each
    package rejects the other's kernel names (why the files are kept
    apart)."""
    want = _good_cache()
    mutate(want)
    got = _translate(want)

    def verdict(validate, obj):
        try:
            validate(obj)
        except ValueError:
            return False
        return True

    assert verdict(ref_plans.validate_cache, want) is ok
    assert verdict(plans.validate_cache, got) is ok
    if ok and want["chips"].get("cpu"):
        assert not verdict(plans.validate_cache, want)
        assert not verdict(ref_plans.validate_cache, got)


@pytest.mark.parametrize("dtype", ["float32", "f32", "bf16", "bfloat16",
                                   np.float64, "complex64"])
def test_plan_key_matches_the_reference(dtype):
    for n in (1, 128, 20480):
        assert plans.plan_key(n, dtype) == ref_plans.plan_key(n, dtype)


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("SLATE_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.delenv("SLATE_TUNE_CACHE", raising=False)
    assert plans.cache_path().endswith(
        os.path.join(".cache", "slate_tpu_torch", "plans.json"))
    assert plans.cache_path() != ref_plans.cache_path()


def test_record_reload_resolve_roundtrip(cache):
    port, ref = cache
    plans.record_plan("potrf_panel", 1024, "float32",
                      plans.TilePlan("cuda", 16, 256), gflops=42.0)
    ref_plans.record_plan("potrf_panel", 1024, "float32",
                          ref_plans.TilePlan("pallas", 256, 16),
                          gflops=42.0)
    on_disk = json.loads(port.read_text())
    plans.validate_cache(on_disk)
    assert on_disk == _translate(json.loads(ref.read_text()))
    ent = on_disk["chips"]["cpu"]["potrf_panel"]["n=1024,dtype=float32"]
    assert ent == {"kernel": "cuda", "nb": 256, "bw": 16, "gflops": 42.0}
    plans.reload()
    assert plans.resolve_plan("potrf_panel", 1024) == \
        plans.TilePlan("cuda", 16, 256)
    assert plans.resolution("potrf_panel", 1024)["source"] == "exact"


def test_corrupt_cache_warns_and_falls_back(cache):
    port, _ = cache
    port.write_text('{"version": 1, "chips": {"cpu": {"potrf_tile": '
                    '{"n=128,dtype=float32": {"kernel": "pallas", "nb": 1, '
                    '"bw": 1}}}}}\n')
    with pytest.warns(UserWarning, match="ignoring bad plan cache"):
        assert plans.resolve_plan("potrf_tile", 128) == plans.CUDA_PLAN
    assert plans.resolution("potrf_tile", 128)["source"] == "default"


def test_resolution_is_memoized_until_reload(cache, monkeypatch):
    """A resolution reads the disk once per (op, n, dtype, path): later
    calls are dict hits, with no file stat."""
    plans.record_plan("lu_select", 4096, "float32",
                      plans.TilePlan("torch", 8, 512))
    assert plans.resolve_plan("lu_select", 4096).kernel == "torch"
    calls = []
    with monkeypatch.context() as m:
        m.setattr(os.path, "exists", lambda p: calls.append(p) or True)
        for _ in range(100):
            assert plans.resolve_plan("lu_select", 4096).kernel == "torch"
    assert calls == []
    plans.record_plan("lu_select", 4096, "float32", plans.CUDA_PLAN)
    assert plans.resolve_plan("lu_select", 4096) == plans.CUDA_PLAN


# ---- lookup -------------------------------------------------------------


def _ref_source(op, n, dtype):
    found = ref_plans._lookup(op, n, normalize_dtype(dtype))
    if found is None:
        return None
    plan, dist = found
    return _port_plan(plan), ("exact" if dist == 0.0 else "nearest"), dist


def test_nearest_n_tie_keeps_the_first_key_of_the_file(cache):
    """n = 512 lies as far from 256 as from 1024 (|log2| = 1): both
    packages keep the first key of the sorted file, "n=1024"."""
    for pkg, near, far in ((ref_plans, ref_plans.TilePlan("pallas", 256, 8),
                            ref_plans.TilePlan("xla", 1024, 16)),
                           (plans, plans.TilePlan("cuda", 8, 256),
                            plans.TilePlan("torch", 16, 1024))):
        pkg.record_plan("getrf_panel", 256, "float32", near)
        pkg.record_plan("getrf_panel", 1024, "float32", far)
    port, ref = cache
    assert list(json.loads(port.read_text())["chips"]["cpu"][
        "getrf_panel"]) == ["n=1024,dtype=float32", "n=256,dtype=float32"]
    got = plans.resolution("getrf_panel", 512)
    want = _ref_source("getrf_panel", 512, "float32")
    assert (plans.TilePlan(got["kernel"], got["bw"], got["nb"]),
            got["source"], got["dist"]) == want
    assert got["kernel"] == "torch" and got["dist"] == 1.0
    # strictly nearer sizes win on both sides
    assert plans.resolve_plan("getrf_panel", 300).kernel == "cuda"
    assert plans.resolve_plan("getrf_panel", 900).kernel == "torch"


GRID = (1, 64, 100, 128, 200, 256, 300, 511, 512, 700, 1024, 2048, 5000,
        8192, 20480, 65536)


def test_source_and_dist_match_the_reference_over_a_grid(cache):
    """One cache written by the reference, translated into the port's
    file: every (op, n, dtype) of a grid resolves to the same plan, source
    and distance on both sides; a miss is the stated departure."""
    rp = ref_plans.TilePlan
    entries = [("potrf_panel", 1024, "float32", rp("pallas", 128, 8)),
               ("potrf_panel", 8192, "float32", rp("xla", 512, 8)),
               ("potrf_panel", 20480, "float32", rp("pallas", 128, 16)),
               ("potrf_panel", 512, "float64", rp("xla", 512, 8)),
               ("lu_select", 128, "float32", rp("pallas", 128, 8)),
               ("lu_select", 512, "float32", rp("xla", 512, 8)),
               ("batch_getrf", 512, "bfloat16", rp("pallas", 128, 8)),
               ("batch_getrf", 4096, "float32", rp("xla", 512, 8))]
    for op, n, dt, plan in entries:
        ref_plans.record_plan(op, n, dt, plan)
    port, ref = cache
    port.write_text(json.dumps(_translate(json.loads(ref.read_text())),
                               indent=1, sort_keys=True))
    plans.reload()
    checked = 0
    for op in plans.OPS:
        for dt in ("float32", "bfloat16", "float64"):
            for n in GRID:
                got = plans.resolution(op, n, dt)
                want = _ref_source(op, n, dt)
                if want is None:
                    assert got["source"] == "default"
                    assert got["dist"] is None
                    assert ref_plans.resolve_plan(op, n, dt) == \
                        ref_plans.XLA_PLAN
                    assert plans.resolve_plan(op, n, dt) == \
                        plans.default_plan(op, dt)
                    continue
                plan, source, dist = want
                assert (plans.TilePlan(got["kernel"], got["bw"], got["nb"]),
                        got["source"], got["dist"]) == (plan, source, dist)
                checked += 1
    # five (op, dtype) pairs hold entries: every grid size resolves there
    assert checked == 5 * len(GRID)


def test_miss_defaults_are_the_kernels_for_f32(cache):
    for op in plans.OPS:
        assert plans.resolve_plan(op, 512) == plans.CUDA_PLAN
        assert plans.resolve_plan(op, 512, "float64") == plans.LIBRARY_PLAN
        want = (plans.CUDA_PLAN if op in plans.BATCH_OPS
                else plans.LIBRARY_PLAN)
        assert plans.resolve_plan(op, 512, "bfloat16") == want
    assert plans.lookahead_depth(4096) == 0
    assert plans.ooc_panel_width(4096) == 256
    assert plans.ooc_panel_width(100) == 100
    plans.record_plan(plans.DIST_LOOKAHEAD_OP, 4096, "float32",
                      plans.TilePlan("ring", 5, 512))
    plans.record_plan(plans.OOC_PANEL_OP, 4096, "float32",
                      plans.TilePlan("torch", 8, 1024))
    assert plans.lookahead_depth(4096) == 2
    assert plans.ooc_panel_width(4096) == 1024
    with pytest.raises(ValueError, match="unknown op"):
        plans.resolve_plan("serve_bucket", 64)


# ---- the tuner ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_candidates_match_the_reference(dtype):
    """On the CPU every kernel gate passes (the plain versions take any
    shape), so the candidate sweep is the reference's, translated."""
    for op in plans.OPS:
        for n in (64, 128, 256, 384, 512, 1024, 2048):
            want = {(TO_PORT[p.kernel], p.nb, p.bw)
                    for p in ref_autotune.candidates(op, n, dtype)}
            got = [(p.kernel, p.nb, p.bw)
                   for p in autotune.candidates(op, n, dtype, device="cpu")]
            assert len(got) == len(set(got))
            assert set(got) == want, (op, n)


def test_tuner_needs_a_device_without_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.candidates("potrf_tile", 128)


@pytest.mark.parametrize("op", plans.OPS)
def test_measure_runs_every_candidate_on_the_cpu(op):
    for plan in autotune.candidates(op, 128, "float32", device="cpu"):
        assert autotune.measure(op, plan, 128, iters=1, device="cpu") > 0


def test_tune_op_writes_a_valid_cache(cache):
    port, _ = cache
    seen = []
    plan, gflops = autotune.tune_op("potrf_tile", 128, "float32", iters=1,
                                    device="cpu",
                                    report=lambda p, g: seen.append((p, g)))
    assert gflops > 0 and plan in [p for p, _ in seen]
    assert len(seen) == len(autotune.candidates("potrf_tile", 128,
                                                device="cpu"))
    obj = json.loads(port.read_text())
    plans.validate_cache(obj)
    ent = obj["chips"]["cpu"]["potrf_tile"]["n=128,dtype=float32"]
    assert (ent["kernel"], ent["nb"], ent["bw"]) == \
        (plan.kernel, plan.nb, plan.bw)
    assert plans.resolve_plan("potrf_tile", 128) == plan


def test_tune_all_reports_every_candidate(cache):
    port, _ = cache
    seen = []
    out = autotune.tune_all(ns=(128,), ops=("lu_select", "batch_geqrf"),
                            dtype="bfloat16", iters=1, device="cpu",
                            report=lambda *r: seen.append(r))
    assert set(out) == {("lu_select", 128), ("batch_geqrf", 128)}
    assert [r[:2] for r in seen] == [("lu_select", 128)] + \
        [("batch_geqrf", 128)] * 2
    plans.validate_cache(json.loads(port.read_text()))


# ---- serving ladder -----------------------------------------------------


SIZES = [24, 24, 40, 90, 90, 200, 17, 130, 130, 700, 513]


@pytest.mark.parametrize("max_rungs", [2, 3, 8])
def test_serve_ladder_matches_the_reference(cache, max_rungs):
    got = autotune.tune_serve_buckets(SIZES, max_rungs=max_rungs)
    want = ref_autotune.tune_serve_buckets(SIZES, max_rungs=max_rungs)
    assert got == want
    assert plans.serve_buckets("float32") == got[0] == \
        ref_tune.serve_buckets("float32")
    lad = bucket.default_ladder("float32")
    assert lad.source == "tuned" and lad.rungs == got[0]
    assert ref_bucket.default_ladder("float32").rungs == lad.rungs
    assert plans.serve_buckets("bfloat16") is None
    assert bucket.default_ladder("bfloat16").source == "geometric"


# ---- CLI ----------------------------------------------------------------


def _lines(capsys):
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_cli_sweep_lines_and_exit_codes(cache, capsys):
    port, _ = cache
    assert tune_cli(["--op", "lu_select", "--n", "128", "--iters", "1",
                     "--device", "cpu"]) == 0
    lines = _lines(capsys)
    cands, (winner,) = lines[:-1], lines[-1:]
    assert len(cands) == 3
    assert all(set(c) == {"op", "n", "chip", "kernel", "nb", "bw", "gflops"}
               for c in cands)
    assert set(winner) == {"op", "n", "chip", "winner", "nb", "bw",
                           "persisted"}
    assert winner["persisted"] is True and winner["chip"] == "cpu"
    assert plans.resolve_plan("lu_select", 128).kernel == winner["winner"]
    before = port.read_text()
    assert tune_cli(["--op", "potrf_tile", "--n", "128", "--iters", "1",
                     "--device", "cpu", "--dry-run"]) == 0
    assert _lines(capsys)[-1]["persisted"] is False
    assert port.read_text() == before
    # no GPU and no --device: exit 2 before any measurement
    assert tune_cli(["--op", "potrf_tile", "--n", "128"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_serve_hist_matches_the_reference(cache, tmp_path, capsys):
    from slate_tpu.tune.__main__ import main as ref_cli
    hist = tmp_path / "hist.jsonl"
    hist.write_text("\n".join(["17", '{"n": 48}', '{"size": 48}',
                               "100", "100", "130"]) + "\n")
    assert tune_cli(["--serve-hist", str(hist), "--hist-rungs", "3"]) == 0
    got = _lines(capsys)
    assert ref_cli(["--serve-hist", str(hist), "--hist-rungs", "3"]) == 0
    assert got == _lines(capsys)
    assert tuple(got[-1]["rungs"]) == plans.serve_buckets("float32")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"rows": 3}\n')
    with pytest.raises(ValueError, match="n/size"):
        tune_cli(["--serve-hist", str(bad)])
