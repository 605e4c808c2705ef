"""Shared setup for the examples (port of examples/_common.py).

The reference re-executes each example on an 8-device virtual CPU mesh.
The port runs SPMD, one process a rank, as SLATE's examples run under
mpirun: start an example with torchrun (``--device cpu`` over gloo, NCCL
on cards) or in a process that has initialised a ``torch.distributed``
group, and :func:`grid` builds the grid the world allows.  Nothing is
re-executed and no flag is set."""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..core.grid import Grid, join_world, world
from ..core.storage import resolve_device


def rng():
    return np.random.default_rng(1234)


def say(msg: str) -> None:
    """Print on rank 0 (every rank computes the same result)."""
    if world()[1] == 0:
        print(msg, flush=True)


def report(name: str, resid: float, tol: float = 1e-10):
    status = "PASS" if resid < tol else "FAIL"
    say(f"{name:<34s} resid {resid:9.2e}  {status}")
    if resid >= tol:
        raise SystemExit(f"{name} failed: {resid} >= {tol}")


def grid(p: int, q: int, device) -> Grid | None:
    """The grid the world allows for an example written for p x q: p x q
    where the world has the ranks, else 2 x 2, else 1 x 1 (over the
    world's group where there is one; the serial grid without one).  None
    on a rank past the grid's members, which sits the example out."""
    size, _ = world()
    dev = "cpu" if torch.device(device).type == "cpu" else None
    if size == 1 and not dist.is_initialized():
        return Grid(1, 1, device=torch.device(device))
    for pp, qq in ((p, q), (2, 2), (1, 1)):
        if pp * qq <= size:
            g = Grid(pp, qq, group=dist.group.WORLD,
                     device=dev)
            return g if g.member else None
    raise AssertionError("unreachable: a 1 x 1 grid fits every world")


@contextlib.contextmanager
def session(argv=None):
    """The device of ``--device`` (cuda unless given, raising without a
    GPU, or cpu: the kernels' plain versions), inside the world torchrun
    announced (joined here and left on exit) or the one already
    initialised."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_known_args(argv)[0].device)
    joined = join_world(device)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        yield device
    finally:
        if joined:
            dist.destroy_process_group()
