"""Durable factorization checkpoints: atomic panel-boundary snapshots
with checksum-verified resume (port of slate_tpu/robust/checkpoint.py).

A preempted long factorization should cost the tail of the run, not the
whole run, and a resumed run must never be a silent wrong answer.  The
out-of-core drivers (drivers/cholesky.py ``potrf_ooc``, drivers/lu.py
``getrf_ooc``) snapshot the host tile map here at panel-step boundaries;
:meth:`CheckpointManager.load` verifies the snapshot before any step runs
and refuses with a typed :class:`~slate_tpu_torch.exceptions.
SlateCheckpointError` when it cannot be trusted.  A checkpoint stores the
exact host bytes entering step k and each step is a pure function of
those bytes, so a resumed run is bit-identical to the uninterrupted one.

The on-disk format is the reference's byte for byte (``MAGIC``,
``SCHEMA``, the header keys, the array names), so either package's
structural ladder reads the other's payload.  The fingerprint differs:
it names this package's plan (kernel "cuda" or "torch"), so a resume
across packages is refused with reason ``fingerprint``, as it should be:
the remaining steps would run other kernels.

Snapshot contents: the panel-step index k, the host tile map in the
canonical ScaLAPACK layout (compat/scalapack.py ``scatter_locals``), row
and column checksums of the matrix state, the options and plan
fingerprint of the writing run, and per-op extras (the LU row
permutation, the input amax).

Write protocol, atomic write-then-rename twice:

1. the payload (magic + length-prefixed JSON header + raw array bytes)
   is written to a temp file, fsync'd, and ``os.replace``'d into place;
2. then the manifest (step, seq, payload name, byte size, SHA-256), the
   same way.

A crash between any two points leaves either the previous checkpoint
intact or a manifest/payload pair that verification refuses.  The
verification ladder on load, each rung a distinct refusal ``reason``:

``missing``      no manifest in the directory
``corrupt``      manifest unparsable, or payload digest != manifest
``torn``         payload absent/truncated/size-mismatched (torn write)
``stale``        manifest and payload disagree on step/seq
``abft``         the matrix fails its stored row/column checksums
``fingerprint``  the resuming run resolved different options or plan
                 decisions than the writing run (:func:`ensure_fingerprint`)

Chaos sites (robust/faults.py ``CKPT_SITES``, consumed via
``host_fire``): ``ckpt_torn_write`` truncates the payload after the
manifest digest was computed; ``ckpt_stale_read`` makes the manifest
writer re-read stale payload bytes.  Both surface as refusals.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import numpy as np

from ..compat.scalapack import gather_locals, scatter_locals
from ..exceptions import SlateCheckpointError, slate_error
from ..obs import events as _obs_events
from ..util.trace import span
from . import faults

#: on-disk format tag; bump on any layout change
MAGIC = b"SLCKPT01"
MANIFEST_NAME = "MANIFEST.json"
PAYLOAD_NAME = "payload.bin"
SCHEMA = "slate-ckpt-v1"


class SimulatedPreemption(Exception):
    """Chaos-harness kill switch: raised by
    :meth:`CheckpointManager.save` right after the checkpoint for
    ``abort_after_step`` lands, a preemption at the worst honest moment
    (snapshot durable, all later work lost).  The kill-at-every-step
    resume tests and the smoke's drill drive it; production runs never
    see it (``abort_after_step=None``)."""


def _atomic_write(path: str, parts, limit: int | None = None) -> None:
    """write-then-rename: the file at ``path`` is either the old bytes
    or the complete new bytes (the concatenated ``parts``, cut at
    ``limit`` bytes when given), never a prefix."""
    tmp = path + ".tmp"
    left = limit
    with open(tmp, "wb") as f:
        for part in parts:
            if left is not None:
                part = part[:left]
                left -= len(part)
            f.write(part)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_payload(path: str, header: dict, arrays: dict) -> tuple:
    """Serialize ``header`` + named numpy arrays to ``path`` atomically:
    MAGIC, the header's length (8 bytes, little-endian), the JSON header,
    then each array's raw bytes, written and hashed part by part (the
    reference's bytes, without assembling them in one buffer).

    Returns ``(sha256_hex, nbytes)`` of the INTENDED payload: under the
    ``ckpt_torn_write`` chaos plan the file on disk is truncated midway
    while the digest still describes the full bytes, exactly the skew a
    crash between write and fsync leaves behind."""
    specs, raws = [], []
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        order = "F" if arr.flags.f_contiguous and not arr.flags.c_contiguous \
            else "C"
        raw = arr.tobytes(order=order)
        specs.append({"name": name, "dtype": arr.dtype.name,
                      "shape": list(arr.shape), "order": order,
                      "nbytes": len(raw)})
        raws.append(raw)
    head = dict(header)
    head["arrays"] = specs
    hb = json.dumps(head, sort_keys=True).encode()
    parts = [MAGIC, len(hb).to_bytes(8, "little"), hb, *raws]
    digest = hashlib.sha256()
    for part in parts:
        digest.update(part)
    size = sum(len(part) for part in parts)
    plan = faults.host_fire("ckpt_torn_write")
    _atomic_write(path, parts, size // 2 if plan is not None else None)
    return digest.hexdigest(), size


def read_payload(path: str) -> tuple:
    """Deserialize ``(header, {name: array})`` from ``path``, refusing
    structurally-torn files (bad magic, truncated header or body)."""
    step = -1
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise SlateCheckpointError(
            f"checkpoint payload unreadable: {e}", reason="torn") from e
    if len(blob) < len(MAGIC) + 8 or blob[: len(MAGIC)] != MAGIC:
        raise SlateCheckpointError(
            "checkpoint payload torn: bad magic/short file", reason="torn")
    hlen = int.from_bytes(blob[len(MAGIC): len(MAGIC) + 8], "little")
    off = len(MAGIC) + 8
    if len(blob) < off + hlen:
        raise SlateCheckpointError(
            "checkpoint payload torn: truncated header", reason="torn")
    try:
        header = json.loads(blob[off: off + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SlateCheckpointError(
            f"checkpoint payload corrupt: unparsable header ({e})",
            reason="corrupt") from e
    step = int(header.get("step", -1))
    off += hlen
    arrays = {}
    for spec in header.get("arrays", ()):
        nb_ = int(spec["nbytes"])
        if len(blob) < off + nb_:
            raise SlateCheckpointError(
                f"checkpoint payload torn: array {spec['name']!r} "
                f"truncated", reason="torn", step=step)
        arrays[spec["name"]] = np.frombuffer(
            blob[off: off + nb_], dtype=np.dtype(spec["dtype"])).reshape(
            spec["shape"], order=spec.get("order", "C")).copy()
        off += nb_
    return header, arrays


def write_manifest(directory: str, manifest: dict) -> None:
    """Publish the manifest atomically (the commit point of a save)."""
    blob = json.dumps(manifest, sort_keys=True).encode()
    _atomic_write(os.path.join(directory, MANIFEST_NAME), [blob])


def read_manifest(directory: str) -> dict:
    """Read the manifest; typed refusal when absent or unparsable."""
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        raise SlateCheckpointError(
            f"no checkpoint manifest in {directory!r}", reason="missing")
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SlateCheckpointError(
            f"checkpoint manifest corrupt: {e}", reason="corrupt") from e


class Checkpoint:
    """One verified snapshot: the dense host matrix state entering panel
    step ``step``, plus per-op ``extras`` (e.g. the LU permutation) and
    the full payload ``meta`` header."""

    def __init__(self, op: str, step: int, matrix: np.ndarray,
                 extras: dict, meta: dict):
        self.op = op
        self.step = step
        self.matrix = matrix
        self.extras = extras
        self.meta = meta

    def __repr__(self):
        return (f"Checkpoint(op={self.op!r}, step={self.step}, "
                f"matrix {self.matrix.shape} {self.matrix.dtype})")


def _fp_norm(fp) -> str:
    return json.dumps(fp, sort_keys=True, default=str)


def ensure_fingerprint(ck: Checkpoint, current: dict) -> None:
    """The semantic verification rung: refuse resume when the current
    run's resolved options / plan decisions differ from the writing
    run's — continuing under different kernels or numerics could not be
    bit-identical, so it must not be silent."""
    stored = ck.meta.get("fingerprint")
    if _fp_norm(stored) != _fp_norm(current):
        raise SlateCheckpointError(
            f"checkpoint fingerprint mismatch: stored {stored!r} vs "
            f"current {current!r}", reason="fingerprint", step=ck.step)


def ooc_fingerprint(op: str, m: int, n: int, nb: int,
                    dtype_name: str) -> dict:
    """The resolved-options/plan-decision fingerprint an OOC driver
    stamps into every snapshot: problem geometry, dtype, streaming panel
    width, and this package's plan decision the per-step kernels will
    dispatch on (kernel "cuda" for K1 on an f32 tile, "torch" for the
    library).  Any difference between the writing and resuming run —
    a retuned plan cache, a different panel width, a different dtype —
    changes the bytes the remaining steps would produce, so
    :func:`ensure_fingerprint` refuses instead of resuming."""
    from ..tune.plans import resolve_plan
    tile_op = "potrf_tile" if "potrf" in op else "getrf_panel"
    plan = resolve_plan(tile_op, int(nb), str(dtype_name))
    return {"op": op, "m": int(m), "n": int(n), "nb": int(nb),
            "dtype": str(dtype_name),
            "plan": {"op": tile_op, "kernel": plan.kernel,
                     "nb": int(plan.nb), "bw": int(plan.bw)}}


class CheckpointManager:
    """Panel-boundary checkpointing for the out-of-core drivers.

    ``every`` sets the cadence (save at steps k with k % every == 0);
    ``abort_after_step`` arms the chaos kill switch (see
    :class:`SimulatedPreemption`).  One manager owns one directory; the
    monotonic ``_seq`` counter (lock-guarded — a background flush or
    observer thread may save concurrently with a reader) orders saves so
    a stale manifest/payload skew is detectable.
    """

    def __init__(self, directory, every: int = 1,
                 abort_after_step: int | None = None):
        self.directory = str(directory)
        self.every = max(1, int(every))
        self.abort_after_step = abort_after_step
        self._seq = 0
        self._lock = threading.Lock()
        os.makedirs(self.directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step % self.every == 0

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.directory, MANIFEST_NAME))

    # ---- save ----
    def save(self, op: str, step: int, matrix: np.ndarray,
             mb: int, nb: int, fingerprint: dict,
             extras: dict | None = None) -> None:
        """Snapshot the host state entering panel step ``step``.

        ``matrix`` is the authoritative host array (TileMap.host_array);
        it is serialized in the canonical ScaLAPACK layout with row and
        column checksums computed over the dense state.  Emits one
        ``checkpoint_save`` obs event (step, bytes, verify, wall ms).
        """
        t0 = time.perf_counter()
        matrix = np.asarray(matrix)
        slate_error(matrix.ndim == 2, "checkpoint: 2D matrix state")
        with span("slate.checkpoint_save"):
            desc, locals_ = scatter_locals(matrix, mb, nb, 1, 1)
            arrays = {"local_0_0": locals_[(0, 0)]}
            # ABFT rung: row/column checksums of the dense state in wide
            # precision — recomputed bitwise on load (same np.sum
            # reduction order)
            cdt = (np.complex128 if np.iscomplexobj(matrix)
                   else np.float64)
            arrays["abft_row"] = np.sum(matrix, axis=1, dtype=cdt)
            arrays["abft_col"] = np.sum(matrix, axis=0, dtype=cdt)
            for name, arr in (extras or {}).items():
                arrays["x_" + name] = np.asarray(arr)
            with self._lock:
                self._seq += 1
                seq = self._seq
            header = {
                "schema": SCHEMA, "op": op, "step": int(step), "seq": seq,
                "desc": [int(x) for x in desc],
                "m": int(matrix.shape[0]), "n": int(matrix.shape[1]),
                "mb": int(mb), "nb": int(nb),
                "dtype": matrix.dtype.name,
                "fingerprint": fingerprint,
            }
            ppath = os.path.join(self.directory, PAYLOAD_NAME)
            stale = faults.host_fire("ckpt_stale_read")
            if stale is not None and os.path.exists(ppath):
                # chaos: manifest republished against a stale read of the
                # previous payload — digest/size describe the OLD bytes,
                # so load() passes the digest rung and refuses on skew
                with open(ppath, "rb") as f:
                    old = f.read()
                digest, size = hashlib.sha256(old).hexdigest(), len(old)
            else:
                digest, size = write_payload(ppath, header, arrays)
            manifest = {
                "schema": SCHEMA, "seq": seq, "op": op, "step": int(step),
                "payload": PAYLOAD_NAME, "sha256": digest, "size": size,
                "written_at": time.time(),
            }
            write_manifest(self.directory, manifest)
        _obs_events.emit_checkpoint("checkpoint_save", {
            "op": op, "step": int(step), "bytes": size, "verify": "ok",
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        if self.abort_after_step is not None \
                and step == self.abort_after_step:
            raise SimulatedPreemption(
                f"chaos: simulated preemption after checkpoint at "
                f"step {step}")

    # ---- load / verify ----
    def _refuse(self, op, t0, exc: SlateCheckpointError):
        _obs_events.emit_checkpoint("checkpoint_restore", {
            "op": op, "step": exc.step, "bytes": 0, "verify": exc.reason,
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        raise exc

    def load(self, op: str | None = None) -> Checkpoint:
        """Verify and deserialize the latest checkpoint.

        Runs the full structural ladder (manifest -> size -> digest ->
        skew -> ABFT checksums) BEFORE returning; any failed rung raises
        :class:`SlateCheckpointError` with the rung's ``reason``.  The
        semantic ``fingerprint`` rung is the caller's (the factorization holds
        the current resolution): pass the result to
        :func:`ensure_fingerprint`.  Emits one ``checkpoint_restore``
        event either way (verify = "ok" or the refusal reason).
        """
        t0 = time.perf_counter()
        try:
            with span("slate.checkpoint_restore"):
                manifest = read_manifest(self.directory)
                step = int(manifest.get("step", -1))
                ppath = os.path.join(self.directory,
                                     str(manifest.get("payload",
                                                      PAYLOAD_NAME)))
                if not os.path.exists(ppath):
                    raise SlateCheckpointError(
                        "checkpoint payload missing (torn save)",
                        reason="torn", step=step)
                size = os.path.getsize(ppath)
                if size != int(manifest.get("size", -1)):
                    raise SlateCheckpointError(
                        f"checkpoint payload torn: {size} bytes on disk "
                        f"!= {manifest.get('size')} in manifest",
                        reason="torn", step=step)
                with open(ppath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != manifest.get("sha256"):
                    raise SlateCheckpointError(
                        "checkpoint payload corrupt: SHA-256 mismatch",
                        reason="corrupt", step=step)
                header, arrays = read_payload(ppath)
                if (int(header.get("step", -2)) != step
                        or int(header.get("seq", -2))
                        != int(manifest.get("seq", -1))):
                    raise SlateCheckpointError(
                        f"checkpoint stale: manifest step/seq "
                        f"({step}/{manifest.get('seq')}) != payload "
                        f"({header.get('step')}/{header.get('seq')})",
                        reason="stale", step=step)
                if op is not None and header.get("op") != op:
                    raise SlateCheckpointError(
                        f"checkpoint holds op {header.get('op')!r}, "
                        f"resume requested {op!r}",
                        reason="fingerprint", step=step)
                matrix = gather_locals(
                    header["desc"], {(0, 0): arrays["local_0_0"]}, 1, 1)
                cdt = (np.complex128 if np.iscomplexobj(matrix)
                       else np.float64)
                row = np.sum(matrix, axis=1, dtype=cdt)
                col = np.sum(matrix, axis=0, dtype=cdt)
                if (not np.array_equal(row, arrays["abft_row"])
                        or not np.array_equal(col, arrays["abft_col"])):
                    raise SlateCheckpointError(
                        "checkpoint ABFT checksum mismatch: matrix state "
                        "does not reproduce its stored row/column sums",
                        reason="abft", step=step)
                extras = {name[2:]: arr for name, arr in arrays.items()
                          if name.startswith("x_")}
        except SlateCheckpointError as e:
            self._refuse(op or "?", t0, e)
        _obs_events.emit_checkpoint("checkpoint_restore", {
            "op": header.get("op"), "step": step, "bytes": size,
            "verify": "ok",
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        return Checkpoint(header.get("op"), step, matrix, extras, header)
