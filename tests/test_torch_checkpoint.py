"""The port's durable factorizations on the CPU: every case of the
reference's tests/test_checkpoint.py, ported, plus the cross-package
cases.

The contract, as the reference states it: ``potrf_ooc``/``getrf_ooc``
match their in-core drivers and keep the host TileMap authoritative; a run
killed right after any panel-step checkpoint resumes bit-identical to the
uninterrupted run, in both dtypes; every torn, stale or corrupted snapshot
is refused with a typed ``SlateCheckpointError`` naming its rung; save and
restore are observable as ``checkpoint_save``/``checkpoint_restore``
events.  Across packages the payload format is shared byte for byte (each
package's ``read_payload`` and ``gather_locals`` read the other's), and
each package's fingerprint refuses the other's: the remaining steps would
run other kernels.  Tolerances: 1e-10 in f64 and 1e-4 in f32 against the
in-core factor, as the reference's file holds them.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import hashlib
import json

import numpy as np
import pytest

import jax
import slate_tpu as ref
from slate_tpu.exceptions import SlateCheckpointError as RefCheckpointError
from slate_tpu.robust import checkpoint as ref_ckpt

import slate_tpu_torch as st
from slate_tpu_torch import obs
from slate_tpu_torch.exceptions import SlateCheckpointError
from slate_tpu_torch.robust import checkpoint as ckpt
from slate_tpu_torch.robust import faults
from slate_tpu_torch.robust.checkpoint import (MANIFEST_NAME, PAYLOAD_NAME,
                                               CheckpointManager,
                                               SimulatedPreemption)

N, NB = 24, 8
NSTEPS = -(-N // NB)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _plan_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SLATE_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)


def _spd(rng, n=N, dtype=np.float64):
    a = rng.standard_normal((n, n)).astype(dtype)
    return a @ a.T + n * np.eye(n, dtype=dtype)


def _gen(rng, n=N, dtype=np.float64):
    return rng.standard_normal((n, n)).astype(dtype)


def potrf_ooc(*args, **kw):
    return st.potrf_ooc(*args, **kw, **CPU)


def getrf_ooc(*args, **kw):
    return st.getrf_ooc(*args, **kw, **CPU)


# ------------------------------------------------- out-of-core drivers


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_potrf_ooc_matches_incore(rng, dtype):
    spd = _spd(rng, dtype=dtype)
    L = st.potrf(st.HermitianMatrix.from_numpy(spd, NB, **CPU))
    Lo = potrf_ooc(spd, nb=NB)
    assert isinstance(Lo, np.ndarray) and Lo.dtype == dtype
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(np.tril(L.to_numpy()), Lo, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_getrf_ooc_factors_correctly(rng, dtype):
    a = _gen(rng, dtype=dtype)
    F = getrf_ooc(a, nb=NB)
    assert isinstance(F, st.OocLUFactors)
    L = np.tril(F.LU, -1) + np.eye(N, dtype=dtype)
    U = np.triu(F.LU)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(a[F.perm], L @ U, atol=tol)


def test_getrf_ooc_rectangular_and_ragged(rng):
    a = rng.standard_normal((24, 16))
    F = getrf_ooc(a, nb=7)                       # ragged panel width
    kmax = 16
    L = np.tril(F.LU[:, :kmax], -1) + np.eye(24, kmax)
    U = np.triu(F.LU[:kmax])
    np.testing.assert_allclose(a[F.perm], L @ U, atol=1e-10)


def test_ooc_error_policy_info_and_raise(rng):
    spd = _spd(rng)
    r, h = potrf_ooc(spd, nb=NB, opts={st.Option.ErrorPolicy:
                                       st.ErrorPolicy.Info})
    assert h.ok
    with pytest.raises(st.SlateNotPositiveDefiniteError):
        potrf_ooc(-spd, nb=NB)
    with pytest.raises(st.SlateSingularError):
        getrf_ooc(np.zeros((N, N)), nb=NB)


def test_ooc_copy_stall_is_correct_merely_late(rng):
    """The ooc_copy_stall chaos site stalls the host<->device copies; the
    result is unchanged (the TileMap drains pending writebacks before any
    dependent read)."""
    a = _gen(rng)
    base = getrf_ooc(a, nb=NB)
    with faults.inject(faults.FaultPlan(site="ooc_copy_stall",
                                        delay_s=0.005)):
        stalled = getrf_ooc(a, nb=NB)
    assert np.array_equal(base.LU, stalled.LU)
    assert np.array_equal(base.perm, stalled.perm)


def test_tilemap_residency_and_roundtrip(rng):
    a = rng.standard_normal((N, N))
    tm = st.TileMap(a, NB, NB, **CPU)
    assert tm.residency(0, 0) == "host"
    dev = tm.fetch(0, N, 0, NB)
    assert tm.residency(0, 0) == "device"
    tm.store(0, N, 0, NB, dev.numpy() * 2.0)
    assert tm.residency(0, 0) == "dirty"
    tm.drain()
    assert tm.residency(0, 0) == "host"
    expect = a.copy()
    expect[:, :NB] *= 2.0
    np.testing.assert_array_equal(tm.to_dense(), expect)


# ----------------------------------------- kill-at-every-step resume


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_potrf_ooc_resume_bit_identical_every_step(rng, tmp_path, dtype):
    spd = _spd(rng, dtype=dtype)
    base = potrf_ooc(spd, nb=NB)
    for kill in range(NSTEPS):
        d = tmp_path / f"k{kill}"
        cm = CheckpointManager(d, every=1, abort_after_step=kill)
        with pytest.raises(SimulatedPreemption):
            potrf_ooc(spd, nb=NB, checkpoint=cm)
        res = potrf_ooc(None, checkpoint=CheckpointManager(d), resume=True)
        assert np.array_equal(res, base), f"step {kill} not bit-identical"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_getrf_ooc_resume_bit_identical_every_step(rng, tmp_path, dtype):
    a = _gen(rng, dtype=dtype)
    base = getrf_ooc(a, nb=NB)
    for kill in range(NSTEPS):
        d = tmp_path / f"k{kill}"
        cm = CheckpointManager(d, every=1, abort_after_step=kill)
        with pytest.raises(SimulatedPreemption):
            getrf_ooc(a, nb=NB, checkpoint=cm)
        res = getrf_ooc(None, checkpoint=CheckpointManager(d), resume=True)
        assert np.array_equal(res.LU, base.LU), f"step {kill}"
        assert np.array_equal(res.perm, base.perm), f"step {kill}"


def test_checkpointing_on_vs_off_bit_identical(rng, tmp_path):
    """Snapshotting never perturbs the numerics: checkpointing at every
    step gives the bytes of the checkpoint-free run."""
    spd, a = _spd(rng), _gen(rng)
    on = potrf_ooc(spd, nb=NB,
                   checkpoint=CheckpointManager(tmp_path / "p", every=1))
    assert np.array_equal(on, potrf_ooc(spd, nb=NB))
    Fon = getrf_ooc(a, nb=NB,
                    checkpoint=CheckpointManager(tmp_path / "g", every=2))
    Foff = getrf_ooc(a, nb=NB)
    assert np.array_equal(Fon.LU, Foff.LU)
    assert np.array_equal(Fon.perm, Foff.perm)


def test_resume_without_checkpoint_refuses_missing(tmp_path):
    cm = CheckpointManager(tmp_path)
    assert not cm.has_checkpoint()
    with pytest.raises(SlateCheckpointError) as ei:
        potrf_ooc(None, checkpoint=cm, resume=True)
    assert ei.value.reason == "missing"


# ------------------------------------------------- refusal ladder


def _saved_manager(rng, tmp_path, kill=1):
    """A directory holding the step-``kill`` snapshot of a getrf_ooc run."""
    a = _gen(rng)
    cm = CheckpointManager(tmp_path, every=1, abort_after_step=kill)
    with pytest.raises(SimulatedPreemption):
        getrf_ooc(a, nb=NB, checkpoint=cm)
    return a


def test_torn_write_refused(rng, tmp_path):
    """ckpt_torn_write truncates the payload while the manifest digest
    describes the full bytes: the size rung refuses."""
    a = _gen(rng)
    cm = CheckpointManager(tmp_path, every=1, abort_after_step=0)
    with faults.inject(faults.FaultPlan(site="ckpt_torn_write")):
        with pytest.raises(SimulatedPreemption):
            getrf_ooc(a, nb=NB, checkpoint=cm)
    with pytest.raises(SlateCheckpointError) as ei:
        getrf_ooc(None, checkpoint=CheckpointManager(tmp_path), resume=True)
    assert ei.value.reason == "torn"


def test_stale_read_refused(rng, tmp_path):
    """ckpt_stale_read republishes the manifest against the previous
    payload bytes: the digest rung passes, the step/seq rung refuses."""
    a = _gen(rng)
    cm = CheckpointManager(tmp_path, every=1)
    fp = ckpt.ooc_fingerprint("getrf_ooc", N, N, NB, "float64")
    cm.save("getrf_ooc", 0, a, NB, NB, fp)
    with faults.inject(faults.FaultPlan(site="ckpt_stale_read")):
        cm.save("getrf_ooc", 1, a, NB, NB, fp)   # manifest says step 1,
    with pytest.raises(SlateCheckpointError) as ei:  # payload is step 0
        getrf_ooc(None, checkpoint=CheckpointManager(tmp_path), resume=True)
    assert ei.value.reason == "stale"


def test_truncated_payload_refused_torn(rng, tmp_path):
    _saved_manager(rng, tmp_path)
    p = tmp_path / PAYLOAD_NAME
    blob = p.read_bytes()
    p.write_bytes(blob[: len(blob) // 3])
    with pytest.raises(SlateCheckpointError) as ei:
        CheckpointManager(tmp_path).load()
    assert ei.value.reason == "torn"


def test_flipped_byte_refused_corrupt(rng, tmp_path):
    _saved_manager(rng, tmp_path)
    p = tmp_path / PAYLOAD_NAME
    blob = bytearray(p.read_bytes())
    blob[-1] ^= 0xFF
    p.write_bytes(bytes(blob))
    with pytest.raises(SlateCheckpointError) as ei:
        CheckpointManager(tmp_path).load()
    assert ei.value.reason == "corrupt"


def test_garbled_manifest_refused_corrupt(rng, tmp_path):
    _saved_manager(rng, tmp_path)
    (tmp_path / MANIFEST_NAME).write_text("{not json")
    with pytest.raises(SlateCheckpointError) as ei:
        CheckpointManager(tmp_path).load()
    assert ei.value.reason == "corrupt"


def test_abft_mismatch_refused(rng, tmp_path):
    """A payload whose digest was re-stamped to hide a flipped matrix byte
    fails the checksum rung."""
    _saved_manager(rng, tmp_path)
    p = tmp_path / PAYLOAD_NAME
    blob = bytearray(p.read_bytes())
    hlen = int.from_bytes(blob[8:16], "little")
    blob[16 + hlen] ^= 0x01                 # first byte of local_0_0
    p.write_bytes(bytes(blob))
    mpath = tmp_path / MANIFEST_NAME
    manifest = json.loads(mpath.read_text())
    manifest["sha256"] = hashlib.sha256(bytes(blob)).hexdigest()
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(SlateCheckpointError) as ei:
        CheckpointManager(tmp_path).load()
    assert ei.value.reason == "abft"


def test_wrong_op_refused_fingerprint(rng, tmp_path):
    _saved_manager(rng, tmp_path)           # holds a getrf_ooc snapshot
    with pytest.raises(SlateCheckpointError) as ei:
        potrf_ooc(None, checkpoint=CheckpointManager(tmp_path), resume=True)
    assert ei.value.reason == "fingerprint"


def test_changed_plan_refused_fingerprint(rng, tmp_path):
    """A resuming run whose plan resolution differs from the writing run's
    (a forced override here, a retuned cache in production) cannot be
    bit-identical, so the fingerprint rung refuses."""
    from slate_tpu_torch.tune import TilePlan, plan_override
    _saved_manager(rng, tmp_path)
    with plan_override("getrf_panel", TilePlan(kernel="cuda", nb=NB, bw=16)):
        with pytest.raises(SlateCheckpointError) as ei:
            getrf_ooc(None, checkpoint=CheckpointManager(tmp_path),
                      resume=True)
    assert ei.value.reason == "fingerprint"


def test_ensure_fingerprint_direct():
    ck = ckpt.Checkpoint("op", 0, np.zeros((2, 2)), {},
                         {"fingerprint": {"a": 1}})
    ckpt.ensure_fingerprint(ck, {"a": 1})   # match: no raise
    with pytest.raises(SlateCheckpointError) as ei:
        ckpt.ensure_fingerprint(ck, {"a": 2})
    assert ei.value.reason == "fingerprint"
    assert ei.value.step == 0


def test_checkpoint_cadence(tmp_path):
    cm = CheckpointManager(tmp_path, every=3)
    assert [s for s in range(7) if cm.should_save(s)] == [0, 3, 6]


# ------------------------------------------------- observability


def test_checkpoint_events_and_metrics_cli(rng, tmp_path, capsys):
    """Save and restore each emit one event (op, step, bytes, verify,
    wall_ms); the metrics pipeline routes them into the durability table
    and the CLI renders it."""
    a = _gen(rng)
    d = tmp_path / "ck"
    with obs.recording() as recs:
        cm = CheckpointManager(d, every=1, abort_after_step=2)
        with pytest.raises(SimulatedPreemption):
            getrf_ooc(a, nb=NB, checkpoint=cm)
        getrf_ooc(None, checkpoint=CheckpointManager(d), resume=True)
    evs = [e for e in recs if e.get("kind") in ("checkpoint_save",
                                                "checkpoint_restore")]
    saves = [e for e in evs if e["kind"] == "checkpoint_save"]
    restores = [e for e in evs if e["kind"] == "checkpoint_restore"]
    # the resumed run re-snapshots step 2 before finishing it
    assert [e["step"] for e in saves] == [0, 1, 2, 2]
    assert len(restores) == 1 and restores[0]["verify"] == "ok"
    for e in evs:
        assert e["op"] == "getrf_ooc"
        assert e["bytes"] > 0 and e["wall_ms"] >= 0

    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(e) + "\n" for e in recs))
    summary = obs.summarize([str(path)])
    assert summary["counts"]["checkpoint"] == len(evs)
    row = summary["checkpoint"]["getrf_ooc/checkpoint_save"]
    assert row["count"] == 4 and row["ok"] == 4 and row["refused"] == 0
    assert row["bytes"] > 0 and row["wall_p50_ms"] is not None
    from slate_tpu_torch.obs.__main__ import main as obs_main
    assert obs_main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "durability" in out
    assert "getrf_ooc/checkpoint_save" in out
    assert "getrf_ooc/checkpoint_restore" in out


def test_refusal_emits_typed_restore_event(rng, tmp_path):
    _saved_manager(rng, tmp_path)
    p = tmp_path / PAYLOAD_NAME
    p.write_bytes(p.read_bytes()[:10])
    with obs.recording() as recs:
        with pytest.raises(SlateCheckpointError):
            CheckpointManager(tmp_path).load(op="getrf_ooc")
    (ev,) = [e for e in recs if e.get("kind") == "checkpoint_restore"]
    assert ev["verify"] == "torn"


def test_scalapack_layout_is_the_payload_format(rng, tmp_path):
    """The snapshot's matrix bytes are the compat/scalapack scatter of the
    host state."""
    from slate_tpu_torch.compat.scalapack import scatter_locals
    a = _gen(rng)
    cm = CheckpointManager(tmp_path)
    fp = ckpt.ooc_fingerprint("getrf_ooc", N, N, NB, "float64")
    cm.save("getrf_ooc", 0, a, NB, NB, fp)
    ck = cm.load(op="getrf_ooc")
    assert ck.step == 0
    np.testing.assert_array_equal(ck.matrix, a)
    desc, locals_ = scatter_locals(a, NB, NB, 1, 1)
    assert tuple(ck.meta["desc"]) == desc
    assert list(ck.meta["desc"])[4:6] == [NB, NB]


# ------------------------------------------------- across the packages


@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_payload_format_is_shared_byte_for_byte(rng, tmp_path, direction):
    """Each package's structural ladder reads the other's payload: equal
    header keys, array names and bytes, and equal gathered matrices; the
    raw payload bytes agree apart from the fingerprint and seq."""
    a = _gen(rng)
    perm = rng.permutation(N).astype(np.int64)
    extras = {"perm": perm, "amax": np.asarray(1.5, np.float64)}
    writer, reader = ((ckpt, ref_ckpt) if direction == "port->ref"
                      else (ref_ckpt, ckpt))
    fp = {"op": "getrf_ooc", "probe": True}
    writer.CheckpointManager(tmp_path).save("getrf_ooc", 1, a, NB, NB, fp,
                                            extras=extras)
    header, arrays = reader.read_payload(str(tmp_path / PAYLOAD_NAME))
    assert header["schema"] == ckpt.SCHEMA == ref_ckpt.SCHEMA
    assert ckpt.MAGIC == ref_ckpt.MAGIC
    assert sorted(arrays) == ["abft_col", "abft_row", "local_0_0", "x_amax",
                              "x_perm"]
    from slate_tpu.compat.scalapack import gather_locals as ref_gather
    from slate_tpu_torch.compat.scalapack import gather_locals
    for gather in (ref_gather, gather_locals):
        back = gather(header["desc"], {(0, 0): arrays["local_0_0"]}, 1, 1)
        assert back.tobytes() == a.tobytes()
    assert arrays["x_perm"].tobytes() == perm.tobytes()
    ck = reader.CheckpointManager(tmp_path).load(op="getrf_ooc")
    assert ck.step == 1 and ck.matrix.tobytes() == a.tobytes()
    # the other writer's payload of the same state is the same bytes
    other = tmp_path / "other"
    reader.CheckpointManager(other).save("getrf_ooc", 1, a, NB, NB, fp,
                                         extras=extras)
    assert ((tmp_path / PAYLOAD_NAME).read_bytes()
            == (other / PAYLOAD_NAME).read_bytes())


def test_each_package_refuses_the_others_fingerprint(rng, tmp_path):
    """A resume across packages passes every structural rung and is
    refused on ``fingerprint``: the port's plan names kernel "cuda" (K1
    for an f32 tile), the reference's "xla"."""
    spd = _spd(rng, dtype=np.float32)
    pd, rd = tmp_path / "port", tmp_path / "ref"
    with pytest.raises(SimulatedPreemption):
        potrf_ooc(spd, nb=NB, checkpoint=CheckpointManager(
            pd, every=1, abort_after_step=1))
    with pytest.raises(ref_ckpt.SimulatedPreemption):
        ref.potrf_ooc(spd, nb=NB, checkpoint=ref_ckpt.CheckpointManager(
            rd, every=1, abort_after_step=1))
    port_fp = ckpt.ooc_fingerprint("potrf_ooc", N, N, NB, "float32")
    ref_fp = ref_ckpt.ooc_fingerprint("potrf_ooc", N, N, NB, "float32")
    assert port_fp["plan"]["kernel"] == "cuda"
    assert port_fp["plan"]["kernel"] != ref_fp["plan"]["kernel"]
    with pytest.raises(SlateCheckpointError) as ei:
        potrf_ooc(None, checkpoint=CheckpointManager(rd), resume=True)
    assert ei.value.reason == "fingerprint"
    with pytest.raises(RefCheckpointError) as ei2:
        ref.potrf_ooc(None, checkpoint=ref_ckpt.CheckpointManager(pd),
                      resume=True)
    assert ei2.value.reason == "fingerprint"
    # the structural rungs of each package pass on the other's payload
    assert CheckpointManager(rd).load(op="potrf_ooc").step == 1
    assert ref_ckpt.CheckpointManager(pd).load(op="potrf_ooc").step == 1
