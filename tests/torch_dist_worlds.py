"""Spawned gloo worlds for the distributed tests of slate_tpu_torch.

:func:`run_world` starts ``size`` CPU processes (``python -c``), one rank
each, that rendezvous through a ``file://`` path (no fixed port:
pytest-xdist runs several workers at once), run ``fn(*args)`` under a
60 s collective timeout, and each return what ``fn`` returned.  The
parent waits with a deadline, kills any survivor and raises with the
child's traceback, so a deadlocked collective fails its test instead of
hanging the suite.

This module imports no JAX: the children import only torch, the port and
the module that defines ``fn`` (which must not import JAX either).
"""

from __future__ import annotations

import concurrent.futures
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback

COLLECTIVE_TIMEOUT_S = 60
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def child_main(rank: int, job: str) -> None:
    """A child's body: read the job, join the world, run, write back."""
    with open(job, "rb") as fh:
        size, init_file, out_dir, module, name, args = pickle.load(fh)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            fn = getattr(importlib.import_module(module), name)
            out = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except Exception:                           # noqa: BLE001
        out = ("error", traceback.format_exc())
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(path + ".tmp", path)


def run_world(size: int, fn, args=(), *, tmp_dir: str,
              deadline_s: float = 120.0) -> list:
    """Run ``fn(*args)`` on every rank of a ``size``-rank gloo world;
    returns the ranks' results in rank order."""
    os.makedirs(tmp_dir, exist_ok=True)
    job = os.path.join(tmp_dir, "job.pkl")
    with open(job, "wb") as fh:
        pickle.dump((size, os.path.join(tmp_dir, "rendezvous"), tmp_dir,
                     fn.__module__, fn.__name__, args), fh)
    mod_dir = os.path.dirname(os.path.abspath(
        sys.modules[fn.__module__].__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, HERE, mod_dir] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    code = ("import sys, torch_dist_worlds as w; "
            "w.child_main(int(sys.argv[1]), sys.argv[2])")
    logs = [open(os.path.join(tmp_dir, f"rank{r}.log"), "wb")
            for r in range(size)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), job],
                              env=env, cwd=tmp_dir, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(size)]
    end = time.monotonic() + deadline_s
    hung = []
    for r, p in enumerate(procs):
        try:
            p.wait(max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            hung.append(r)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(5)
    for fh in logs:
        fh.close()
    results, errors = [], []
    for r in range(size):
        path = os.path.join(tmp_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            with open(os.path.join(tmp_dir, f"rank{r}.log"), "rb") as fh:
                tail = fh.read()[-4000:].decode(errors="replace")
            errors.append(f"rank {r}: no result (exit code "
                          f"{procs[r].returncode}):\n{tail}")
            results.append(None)
            continue
        with open(path, "rb") as fh:
            status, val = pickle.load(fh)
        if status == "error":
            errors.append(f"rank {r}:\n{val}")
            results.append(None)
        else:
            results.append(val)
    if hung or errors:
        raise RuntimeError(
            f"gloo world of {size}: ranks {hung} still running after "
            f"{deadline_s} s; " + "\n".join(errors))
    return results


def start_worlds(grids, fn, tmp_dir_of) -> concurrent.futures.Future:
    """Run ``fn(p, q)`` in one world per grid, one world after another, on
    a background thread (the children's waits release the GIL, so the
    parent can compute the reference meanwhile).  The future's result is
    {(p, q): the ranks' results}; ``tmp_dir_of(p, q)`` names each world's
    directory."""
    def run_all():
        return {(p, q): run_world(p * q, fn, (p, q),
                                  tmp_dir=tmp_dir_of(p, q))
                for p, q in grids}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = pool.submit(run_all)
    pool.shutdown(wait=False)
    return fut
