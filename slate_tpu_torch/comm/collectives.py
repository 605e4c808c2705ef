"""Grid collectives over ``torch.distributed`` (port of
slate_tpu/comm/collectives.py; ref: BaseMatrix.hh:1923-2492 listBcast /
listReduce, internal_comm.cc:17-123).

The reference expresses every broadcast as a masked ``psum`` along a mesh
axis, traced inside ``shard_map``, with a data-dependent root.  Here the
program runs SPMD in Python, so the root is a plain int and each
collective is the ``torch.distributed`` call on the grid's row
(axis 'q') or column (axis 'p') subgroup (core/grid.py):

reference                      | here
------------------------------ | -------------------------------------------
``bcast_along`` (masked psum)  | ``dist.broadcast`` from the owner's rank
``ring_bcast_along``           | ``size - 1`` hops of ``isend``/``irecv``,
  (``size - 1`` ppermutes)     |   sent in issue order; returns a
                               |   :class:`Pending` handle that the caller
                               |   waits on later (lookahead)
``reduce_along`` (psum)        | ``all_reduce`` (SUM)
``reduce_scatter_along``       | ``reduce_scatter`` (list form)
``allgather_along``            | ``all_gather`` (list form), concatenated
``pargmax`` (MAXLOC)           | two all-gathers, lowest index on ties
``ppermute_shift``             | ``isend``/``irecv`` to the shifted member

Broadcasts move the owner's exact bytes, as the reference's masked psum
does (x + 0 = x, up to the sign of a zero), so every route that only
broadcasts is bit-exact against it; sums of true partials (gemmA's
reduce-scatter, the checksum counters) differ from XLA's psum in their
reduction order only.  Complex tensors travel as their real views, so
that no backend's complex support matters.  A collective over an axis of
size 1 is issued all the same (a one-rank group).
"""

from __future__ import annotations

import collections

import torch

from ..core.grid import AXIS_P, AXIS_Q, Grid

def _dist():
    import torch.distributed as dist
    return dist


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The tensor a backend sends for ``x`` (contiguous): its real view
    when complex, so the bytes are the same."""
    return torch.view_as_real(x) if x.is_complex() else x


def _empty(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(x.shape), dtype=x.dtype, device=x.device)


def bcast_along(x: torch.Tensor, root: int, axis: str,
                grid: Grid) -> torch.Tensor:
    """Broadcast ``x`` from the member at index ``root`` along ``axis``:
    every member returns the root's bytes in a new tensor.  Non-roots
    pass a tensor of the same shape and dtype, whose values are unused."""
    buf = (x.clone(memory_format=torch.contiguous_format)
           if grid.axis_index(axis) == root else _empty(x))
    _dist().broadcast(_wire(buf), src=grid.axis_rank(axis, root),
                      group=grid.axis_group(axis))
    return buf


def bcast_from_col(x, root_col: int, grid: Grid) -> torch.Tensor:
    """Broadcast along the q axis, from the tile column's owner to its
    whole grid row (ref: gemmC.cc:83-115)."""
    return bcast_along(x, root_col, AXIS_Q, grid)


def bcast_from_row(x, root_row: int, grid: Grid) -> torch.Tensor:
    """Broadcast along the p axis, from the tile row's owner to its whole
    grid column."""
    return bcast_along(x, root_row, AXIS_P, grid)


class Pending:
    """A ring broadcast in flight: :meth:`wait` returns the root's bytes.

    A member's receive from its predecessor is posted when the ring is
    issued; its own send to its successor (the root's payload, or the
    bytes it forwards) joins its subgroup's send queue.  The queue leaves
    in issue order: an entry goes out once it and every entry before it
    have their bytes, so a member that is the root of a later ring and
    forwards an earlier one still sends the earlier first.  Every member
    issues its rings in the same program order, so each pair of
    neighbours carries a subgroup's ring messages in the order the
    receiver posted for them, whatever the backend's matching (NCCL's
    point-to-point ignores tags)."""

    def __init__(self, buf, work=None, grid=None, group=None, entry=None):
        self._buf, self._work = buf, work
        self._grid, self._group, self._entry = grid, group, entry

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._entry is not None:
                self._entry[1] = None          # its bytes are here
                _send_ready(self._grid, self._group)
        return self._buf


def _send_ready(grid: Grid, group, block: bool = False) -> None:
    """Send the head of ``group``'s queue while its bytes are there (a
    root's at once, a forwarder's once its receive completed; with
    ``block``, waiting for them).  A sent tensor is kept with its send in
    ``grid.inflight`` until :func:`flush` waits on it."""
    queue = grid.ring_sends.get(group)
    while queue:
        buf, recv, dst = queue[0]
        if recv is not None:
            if not (block or recv.is_completed()):
                return
            recv.wait()
        queue.popleft()
        grid.inflight.append((_dist().isend(_wire(buf), dst, group=group),
                              buf))


def ring_bcast_along(x: torch.Tensor, root: int, axis: str,
                     grid: Grid) -> Pending:
    """Ring broadcast of ``x`` from the member at index ``root`` along
    ``axis``: ``size - 1`` neighbour hops, i -> i + 1 (ref: ring_bcast_along,
    collectives.py:113-153).  Same contract as :func:`bcast_along`,
    returned as a :class:`Pending` handle, so that a pipeline can issue
    step k+la's broadcast and go on computing step k before it waits."""
    size = grid.axis_size(axis)
    me = grid.axis_index(axis)
    group = grid.axis_group(axis)
    dist = (me - root) % size
    succ = grid.axis_rank(axis, (me + 1) % size)
    queue = grid.ring_sends.setdefault(group, collections.deque())
    if dist == 0:
        buf = x.clone(memory_format=torch.contiguous_format)
        if size > 1:
            queue.append([buf, None, succ])
            _send_ready(grid, group)
        return Pending(buf)
    buf = _empty(x)
    work = _dist().irecv(_wire(buf), grid.axis_rank(axis, (me - 1) % size),
                         group=group)
    entry = None
    if dist < size - 1:
        entry = [buf, work, succ]
        queue.append(entry)
    return Pending(buf, work, grid, group, entry)


def ring_bcast_from_col(x, root_col: int, grid: Grid) -> Pending:
    """Ring variant of :func:`bcast_from_col`."""
    return ring_bcast_along(x, root_col, AXIS_Q, grid)


def ring_bcast_from_row(x, root_row: int, grid: Grid) -> Pending:
    """Ring variant of :func:`bcast_from_row`."""
    return ring_bcast_along(x, root_row, AXIS_P, grid)


def flush(grid: Grid) -> None:
    """Send what the ring queues still hold and wait for every ring send
    of ``grid`` (the end of a kernel); each send's tensor was kept alive
    until then."""
    for group in list(grid.ring_sends):
        _send_ready(grid, group, block=True)
    while grid.inflight:
        grid.inflight.pop(0)[0].wait()


def reduce_along(x: torch.Tensor, axis: str, grid: Grid,
                 op: str = "sum") -> torch.Tensor:
    """All-reduce along ``axis`` (``op`` "sum", "max" or "min"), result on
    every member, in a new tensor (ref: ReduceList, psum / pmax)."""
    dist = _dist()
    buf = x.clone(memory_format=torch.contiguous_format)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(_wire(buf) if op == "sum" else buf, op=red,
                    group=grid.axis_group(axis))
    return buf


def reduce_grid(x: torch.Tensor, grid: Grid, op: str = "sum"):
    """All-reduce over the whole grid (both axes)."""
    dist = _dist()
    buf = x.clone(memory_format=torch.contiguous_format)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(_wire(buf) if op == "sum" else buf, op=red,
                    group=grid.grid_group)
    return buf


def reduce_scatter_along(x: torch.Tensor, axis: str, grid: Grid,
                         tiled_axis: int = 0) -> torch.Tensor:
    """Scatter-reduce along ``axis``: ``x`` is cut into ``size`` equal
    chunks along ``tiled_axis``, and member i returns the sum of every
    member's chunk i (ref: psum_scatter, tiled)."""
    size = grid.axis_size(axis)
    chunks = [_wire(c.contiguous()) for c in x.chunk(size, dim=tiled_axis)]
    out = torch.empty_like(chunks[0])
    _dist().reduce_scatter(out, chunks, group=grid.axis_group(axis))
    return torch.view_as_complex(out) if x.is_complex() else out


def allgather_along(x: torch.Tensor, axis: str, grid: Grid,
                    concat_axis: int | None = 0) -> torch.Tensor:
    """Every member's ``x`` along ``axis``, in axis order: concatenated
    along ``concat_axis`` (tiled), or stacked on a new leading axis when
    it is None."""
    parts = allgather_list(x, grid.axis_group(axis),
                           grid.axis_size(axis))
    return (torch.stack(parts) if concat_axis is None
            else torch.cat(parts, dim=concat_axis))


def allgather_list(x: torch.Tensor, group, size: int) -> list:
    """``all_gather`` of ``x`` over ``group`` as a list in group order."""
    src = _wire(x.contiguous())
    parts = [torch.empty_like(src) for _ in range(size)]
    _dist().all_gather(parts, src, group=group)
    return [torch.view_as_complex(t) if x.is_complex() else t
            for t in parts]


def allgather_grid(x: torch.Tensor, grid: Grid) -> list:
    """Every grid member's ``x``, indexed by its group rank (so that
    ``out[grid.coord_rank(r, c)]`` is the block of coordinate (r, c))."""
    parts = allgather_list(x, grid.grid_group, grid.size)
    out = [None] * grid.size
    for pos, member in enumerate(grid.member_order):
        out[member] = parts[pos]
    return out


def pargmax(value: torch.Tensor, index: torch.Tensor, axis: str,
            grid: Grid):
    """MPI_Allreduce(MAXLOC) along ``axis`` (ref: collectives.py:86-103):
    per-member candidate magnitudes ``value`` and their global
    ``index``; returns (max value, its index) on every member, ties to the
    lowest index."""
    vals = allgather_along(value, axis, grid, concat_axis=None)
    idxs = allgather_along(index, axis, grid, concat_axis=None)
    best = vals.amax(dim=0)
    big = torch.iinfo(idxs.dtype).max
    cand = torch.where(vals == best[None], idxs, torch.full_like(idxs, big))
    return best, cand.amin(dim=0)


def ppermute_shift(x: torch.Tensor, axis: str, shift: int,
                   grid: Grid) -> torch.Tensor:
    """Cyclic shift along ``axis``: member i's ``x`` goes to member
    (i + shift) % size (ref: lax.ppermute).  Call it with no ring in
    flight along ``axis`` (after :func:`flush`): its messages would share
    the neighbours' order with the ring's."""
    size = grid.axis_size(axis)
    me = grid.axis_index(axis)
    if shift % size == 0:
        return x.clone(memory_format=torch.contiguous_format)
    dist = _dist()
    group = grid.axis_group(axis)
    src = _wire(x.contiguous())
    out = _empty(x)
    ops = [dist.P2POp(dist.isend, src, grid.axis_rank(axis, (me + shift)
                                                       % size), group),
           dist.P2POp(dist.irecv, _wire(out),
                      grid.axis_rank(axis, (me - shift) % size), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out
