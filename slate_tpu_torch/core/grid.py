"""Process grid: the 2D block-cyclic tile -> rank map over a
``torch.distributed`` process group (port of slate_tpu/core/grid.py).

The program runs SPMD, one process (rank) per device, as SLATE's MPI
ranks do: every rank builds the same ``Grid`` and holds only its own
tiles.  Where the reference's grid carries a ``jax.sharding.Mesh`` of
devices, this one carries a process group of at least p*q ranks; grid
coordinate (r, c) is group rank ``r + c*p`` under ``GridOrder.Col`` and
``r*q + c`` under ``GridOrder.Row`` (ref: MatrixStorage.hh:555-568).

``Grid(1, 1)`` without a group is the serial grid (the reference's
``mesh is None``): every matrix lies whole on one device.  ``Grid(1, 1,
group=...)`` is a real one-rank mesh, and any larger grid needs a group
(an initialised default group is taken when none is given).

The row and column subgroups, along which the distributed kernels
broadcast and reduce, are built once by :meth:`Grid.__init__`, on every
rank of the default group in the same order: ``dist.new_group`` is
collective, and a rank that skipped one would leave the others waiting,
so every rank of the default group builds the grid.  A rank of the group
past the grid's p*q members (a 2 x 2 grid in a world of 8) takes part in
that and holds nothing: its ``member`` is False, and placing a matrix on
its grid raises.
"""

from __future__ import annotations

import math
import os

import torch

from ..exceptions import slate_error
from ..options import GridOrder

# Axis names of the distributed kernels: 'p' indexes grid rows, 'q' grid
# columns (ref: grid.py:33-34).
AXIS_P = "p"
AXIS_Q = "q"


def _dist():
    import torch.distributed as dist
    return dist


class Grid:
    """A p x q process grid over a ``torch.distributed`` group.

    ``device`` is the device this rank's tiles live on: ``cuda:<local
    rank>`` (``LOCAL_RANK`` when a launcher exports it, else the global
    rank, modulo the visible cards) unless the caller passes one,
    ``"cpu"`` included.  On the serial grid it is
    None and the entry points resolve their own ``device=``."""

    def __init__(self, p: int = 1, q: int = 1, *, group=None,
                 order: GridOrder = GridOrder.Col, device=None):
        slate_error(p >= 1 and q >= 1, "grid dims must be >= 1")
        self.p = p
        self.q = q
        self.order = order
        self.size = p * q
        self.group = None
        self.rank = 0
        self.coords = (0, 0)
        self.member = True
        self.device = torch.device(device) if device is not None else None
        # point-to-point state of comm/collectives.py: each subgroup's ring
        # sends in issue order, and the sends in flight with their tensors
        # (kept alive until collectives.flush waits on them)
        self.ring_sends: dict = {}
        self.inflight: list = []
        if self.size == 1 and group is None:
            return
        dist = _dist()
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        have = (dist.get_world_size(group) if group is not None else 1)
        slate_error(have >= self.size, f"need {self.size} ranks, have {have}")
        self.group = group
        self.rank = dist.get_rank(group)
        # global ranks of the grid's members, and its subgroups (the whole
        # grid, each grid row, each grid column), built on every rank of
        # the default group in the same order
        self._global = [dist.get_global_rank(group, r)
                        if group is not dist.group.WORLD else r
                        for r in range(self.size)]
        self.grid_group = group if have == self.size \
            else dist.new_group(self._global)
        # the grid members (as group ranks) in grid_group's rank order: a
        # new group numbers its members by ascending global rank
        self.member_order = (list(range(self.size)) if have == self.size
                             else sorted(range(self.size),
                                         key=self._global.__getitem__))
        self.row_groups = [dist.new_group(
            [self._global[self.coord_rank(r, c)] for c in range(q)])
            for r in range(p)]
        self.col_groups = [dist.new_group(
            [self._global[self.coord_rank(r, c)] for r in range(p)])
            for c in range(q)]
        self.member = 0 <= self.rank < self.size
        if not self.member:
            return
        self.coords = self.rank_coords(self.rank)
        if self.device is None:
            n_cards = torch.cuda.device_count()
            if n_cards == 0:
                raise RuntimeError(
                    "slate_tpu_torch: no CUDA device is available; pass "
                    "device='cpu' to the Grid to run on the CPU")
            # the local rank a launcher such as torchrun exports, else the
            # global one: ranks of one host take its cards in turn
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            self.device = torch.device("cuda", local % n_cards)

    # ---- rank <-> coordinate maps ----

    def coord_rank(self, r: int, c: int) -> int:
        """Group rank of grid coordinate (r, c) under this grid's order."""
        return r + c * self.p if self.order is GridOrder.Col \
            else r * self.q + c

    def rank_coords(self, rank: int) -> tuple[int, int]:
        """Grid coordinate (r, c) of a group rank."""
        if self.order is GridOrder.Col:
            return rank % self.p, rank // self.p
        return rank // self.q, rank % self.q

    def global_rank(self, r: int, c: int) -> int:
        """Rank in the default group of grid coordinate (r, c): the root
        that ``torch.distributed``'s collectives name."""
        return self._global[self.coord_rank(r, c)]

    def axis_group(self, axis: str):
        """This rank's subgroup along ``axis``: along 'q' the ranks of its
        grid row, along 'p' those of its grid column."""
        r, c = self.coords
        return self.row_groups[r] if axis == AXIS_Q else self.col_groups[c]

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (ref: lax.axis_index)."""
        return self.coords[0] if axis == AXIS_P else self.coords[1]

    def axis_size(self, axis: str) -> int:
        return self.p if axis == AXIS_P else self.q

    def axis_rank(self, axis: str, index: int) -> int:
        """Global rank of the member at ``index`` along ``axis`` of this
        rank's subgroup."""
        r, c = self.coords
        return self.global_rank(index, c) if axis == AXIS_P \
            else self.global_rank(r, index)

    # ---- tile -> coordinate maps (ref: MatrixStorage.hh:555-568) ----

    def tile_coords(self, i: int, j: int) -> tuple[int, int]:
        """2D block-cyclic owner coordinate of tile (i, j)."""
        return (i % self.p, j % self.q)

    def tile_rank(self, i: int, j: int) -> int:
        """Linear rank of tile (i, j)'s owner under this grid's GridOrder
        (ref: grid.py:82)."""
        return self.coord_rank(*self.tile_coords(i, j))

    def __repr__(self):
        mesh = "" if self.group is None else f", rank {self.rank}"
        return f"Grid(p={self.p}, q={self.q}, order={self.order.value}{mesh})"


def make_grid(n_ranks: int | None = None, *, group=None,
              device=None) -> Grid:
    """A near-square p x q grid over ``n_ranks`` ranks of ``group`` (the
    default group when initialised): the serial grid for one rank
    without a group (ref: grid.py:110)."""
    dist = _dist()
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    n = n_ranks if n_ranks is not None else (
        dist.get_world_size(group) if group is not None else 1)
    if n == 1 and group is None:
        return Grid(1, 1)
    p = int(math.sqrt(n))
    while n % p != 0:
        p -= 1
    return Grid(p, n // p, group=group, device=device)


def join_world(device) -> bool:
    """Join the ``torch.distributed`` world that torchrun announces
    (``WORLD_SIZE`` and the rest in the environment): NCCL when ``device``
    is a card, whose index is then ``LOCAL_RANK``, gloo on CPUs.  Returns
    True when this call joined it; False when a group was already
    initialised or no launcher announced one (a world of one rank)."""
    dist = _dist()
    if (not dist.is_available() or dist.is_initialized()
            or "WORLD_SIZE" not in os.environ):
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def world() -> tuple[int, int]:
    """(size, rank) of the initialised ``torch.distributed`` world, (1, 0)
    without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
