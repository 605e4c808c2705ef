"""TileStorage: the tile map as one blocked tensor (port of the
reference's slate_tpu/core/storage.py ``TileStorage``).

On the serial grid ``data`` is one tensor ``[Mt, Nt, mb, nb]`` on one
explicit device, in the reference's cyclic order (which on the 1 x 1 grid
is the natural tile order), so ``data`` holds the same bytes as the
reference's ``TileStorage.data`` for the same matrix.

On a grid with a process group (core/grid.py) the storage is SHARDED:
each rank's ``data`` is its local block ``[mtl, ntl, mb, nb]``, bit for
bit the slice ``[r*mtl:(r+1)*mtl, c*ntl:(c+1)*ntl]`` of the reference's
cyclic array ``[p*mtl, q*ntl, mb, nb]`` for grid coordinate (r, c), pad
tiles zero: local slot (s, t) holds global tile (r + p*s, c + q*t).
``from_dense`` takes the global array, replicated on every rank, and
keeps the rank's tiles; ``canonical`` and ``to_dense`` all-gather the
tiles of every rank, so they are collectives that every rank calls.

``TileMap`` (ref: storage.py:191) is the host-resident tile map of the
out-of-core drivers: the authoritative bytes stay in host memory and
panel-shaped windows stream through the device.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from ..exceptions import slate_error
from . import layout
from .grid import Grid


def resolve_device(device=None) -> torch.device:
    """The device an entry point places data on: ``None`` means CUDA, and
    CUDA (by default or by name) raises when there is none, so nothing
    runs on the CPU unless the caller asks for it with ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "slate_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return device


def grid_device(grid, device=None):
    """The device an entry point's data goes to on ``grid``: ``device``
    when given, else the grid's own (a rank's card on a grid with a
    group; None, hence CUDA, on the serial grid)."""
    if grid is not None:
        slate_error(grid.member, f"rank {grid.rank} of the group lies "
                    f"outside the {grid.p}x{grid.q} grid")
    if device is not None or grid is None:
        return device
    return grid.device


def as_tensor(a, device=None) -> torch.Tensor:
    """Host data (numpy array, tensor or nested lists) -> tensor on the
    resolved device (:func:`resolve_device`)."""
    if isinstance(a, np.ndarray):
        # a read-only array (e.g. np.asarray of a jax array) is copied:
        # torch tensors over it would be writable
        a = np.ascontiguousarray(a) if a.flags.writeable else np.array(a)
        t = torch.from_numpy(a)
    else:
        t = torch.as_tensor(a)
    return t.to(resolve_device(device))


def _local(cyclic: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's block of a whole cyclic array [p*mtl, q*ntl, ...] on a
    grid with a group; the array itself on the serial grid."""
    if grid.group is None:
        return cyclic
    r, c = grid.coords
    mtl, ntl = cyclic.shape[0] // grid.p, cyclic.shape[1] // grid.q
    return cyclic[r * mtl:(r + 1) * mtl, c * ntl:(c + 1) * ntl].contiguous()


class TileStorage:
    """Tiles of an m x n matrix, ``data[s, t]`` = tile (i, j) in the 2D
    block-cyclic order of ``grid`` (identity order on the 1 x 1 grid); on
    a grid with a group, the rank's local block of that order."""

    def __init__(self, data: torch.Tensor, m: int, n: int, mb: int, nb: int,
                 grid: Grid | None = None):
        self.data = data
        self.m, self.n = int(m), int(n)
        self.mb, self.nb = int(mb), int(nb)
        self.grid = grid or Grid(1, 1)
        self.Mt = layout.num_tiles(self.m, self.mb)
        self.Nt = layout.num_tiles(self.n, self.nb)
        self.mtl = -(-self.Mt // self.grid.p)
        self.ntl = -(-self.Nt // self.grid.q)
        want = ((self.mtl, self.ntl) if self.sharded else
                (self.grid.p * self.mtl, self.grid.q * self.ntl))
        slate_error(tuple(data.shape) == want + (self.mb, self.nb),
                    f"tile data shape {tuple(data.shape)} does not hold a "
                    f"{m}x{n} matrix in {mb}x{nb} tiles on {self.grid}")

    @property
    def sharded(self) -> bool:
        """True when ``data`` is this rank's local block of a grid with a
        process group."""
        return self.grid.group is not None

    # ---- constructors ----
    @classmethod
    def zeros(cls, m, n, mb, nb, grid: Grid | None = None,
              dtype=torch.float32, device=None):
        """All-zero tiles on ``device`` (``None`` means the grid's device,
        and on the serial grid CUDA, as :func:`resolve_device` reads it)."""
        grid = grid or Grid(1, 1)
        Mt, Nt = layout.num_tiles(m, mb), layout.num_tiles(n, nb)
        mtl, ntl = -(-Mt // grid.p), -(-Nt // grid.q)
        shape = ((mtl, ntl) if grid.group is not None
                 else (grid.p * mtl, grid.q * ntl))
        data = torch.zeros(shape + (mb, nb), dtype=dtype,
                           device=resolve_device(grid_device(grid, device)))
        return cls(data, m, n, mb, nb, grid)

    def with_dense(self, dense: torch.Tensor) -> "TileStorage":
        """This storage's tiling over ``dense``, on ``dense``'s device."""
        return TileStorage.from_dense(dense, self.mb, self.nb, self.grid)

    def with_canonical(self, tiles: torch.Tensor) -> "TileStorage":
        """This storage's shape over canonical tiles [Mt, Nt, mb, nb]."""
        return TileStorage.from_canonical(tiles, self.m, self.n, self.grid)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, mb, nb,
                   grid: Grid | None = None):
        """Tile a dense tensor on the device it lies on (ref:
        Matrix::fromLAPACK); host data enters through ``Matrix.from_numpy``.
        On a grid with a group, ``dense`` is the whole matrix, the same on
        every rank, and the rank keeps its own tiles."""
        grid = grid or Grid(1, 1)
        slate_error(dense.dim() == 2, "from_dense needs a 2D tensor")
        tiles = layout.tile_dense(dense, mb, nb)
        return cls.from_canonical(tiles, dense.shape[0], dense.shape[1],
                                  grid)

    @classmethod
    def from_canonical(cls, tiles: torch.Tensor, m, n,
                       grid: Grid | None = None):
        """Storage over canonical tiles [Mt, Nt, mb, nb] of an m x n
        matrix (the whole matrix's, on a grid with a group too)."""
        grid = grid or Grid(1, 1)
        Mt, Nt, mb, nb = tiles.shape
        slate_error(Mt == layout.num_tiles(m, mb) and
                    Nt == layout.num_tiles(n, nb), "tile grid mismatch")
        data = _local(layout.canonical_to_cyclic(tiles, grid.p, grid.q),
                      grid)
        return cls(data, m, n, mb, nb, grid)

    def astype(self, dtype) -> "TileStorage":
        """Precision-converting copy (ref: storage.py:173)."""
        return TileStorage(self.data.to(dtype), self.m, self.n, self.mb,
                           self.nb, self.grid)

    # ---- distribution lambdas (ref: MatrixStorage.hh:533-586) ----
    def tile_mb(self, i: int) -> int:
        """Rows in tile-row i (last tile may be partial)."""
        return self.mb if i < self.Mt - 1 else self.m - (self.Mt - 1) * self.mb

    def tile_nb(self, j: int) -> int:
        return self.nb if j < self.Nt - 1 else self.n - (self.Nt - 1) * self.nb

    def tile_rank(self, i: int, j: int) -> int:
        return self.grid.tile_rank(i, j)

    # ---- views of the store ----
    def cyclic(self) -> torch.Tensor:
        """The whole cyclic array [p*mtl, q*ntl, mb, nb]: on a grid with a
        group, every rank's block all-gathered (a collective)."""
        if not self.sharded:
            return self.data
        from ..comm.collectives import allgather_grid
        blocks = allgather_grid(self.data, self.grid)
        g = self.grid
        rows = [torch.cat([blocks[g.coord_rank(r, c)] for c in range(g.q)],
                          dim=1) for r in range(g.p)]
        return torch.cat(rows, dim=0)

    def local_block(self, cyclic: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole cyclic array [p*mtl, q*ntl, ...]
        (the array itself on the serial grid)."""
        return _local(cyclic, self.grid)

    def canonical(self) -> torch.Tensor:
        """Tiles in natural (i, j) order: [Mt, Nt, mb, nb] (a collective on
        a grid with a group)."""
        return layout.cyclic_to_canonical(
            self.cyclic(), self.Mt, self.Nt, self.grid.p, self.grid.q)

    def to_dense(self) -> torch.Tensor:
        return layout.untile_dense(self.canonical(), self.m, self.n)

    def tile(self, i: int, j: int) -> torch.Tensor:
        """One tile (debug/test path; ref: BaseMatrix::at); a collective on
        a grid with a group."""
        ci, _, _ = layout.cyclic_row_maps(self.Mt, self.grid.p)
        cj, _, _ = layout.cyclic_row_maps(self.Nt, self.grid.q)
        return self.cyclic()[int(ci[i]), int(cj[j])]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self):
        return (f"TileStorage({self.m}x{self.n}, tiles {self.mb}x{self.nb}, "
                f"grid {self.grid.p}x{self.grid.q}, {self.dtype}, "
                f"{self.device})")


# residency codes for TileMap._res
_RES_HOST = 0    # host bytes authoritative, no device copy
_RES_DEVICE = 1  # clean copy staged on device (prefetch in flight or held)
_RES_DIRTY = 2   # device bytes newer than host (writeback pending)

_RES_NAMES = {_RES_HOST: "host", _RES_DEVICE: "device", _RES_DIRTY: "dirty"}

#: bytes every TileMap of this process moved host -> device ("h2d") and
#: device -> host ("d2h"): the traffic counters the smoke reads around a
#: driver call
TRAFFIC = {"h2d": 0, "d2h": 0}


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0


class TileMap:
    """Host-resident tile map with per-tile residency for out-of-core work
    (port of slate_tpu/core/storage.py ``TileMap``).

    The authoritative bytes live in host memory, and panel-shaped windows
    stream to the device on demand, so that ``potrf_ooc``/``getrf_ooc``
    run at n beyond device memory.  Residency of each tile:

    - ``host``    host bytes authoritative, nothing staged,
    - ``device``  a clean copy staged on the device (``prefetch`` issued),
    - ``dirty``   device bytes newer than host (``store`` writeback
      pending until :meth:`drain`).

    The host bytes are kept as block columns, each an [m, nb] row-major
    array in one pinned buffer (on CUDA), so that the rows of a panel
    window, the out-of-core loops' only window, are one contiguous range
    of pinned memory: a window of a row-major matrix would be strided, and
    a non-blocking copy of a strided pinned tensor goes through an
    unpinned temporary and is synchronous.  Every copy is non-blocking on
    one side stream: ``prefetch(window)`` issues the H2D copy and records
    an event; ``fetch(window)`` pops the staged buffer (or copies it now
    on a miss) and makes the current (compute) stream wait on its event;
    ``store(window, t)`` queues the D2H copy into the host block after the
    compute stream's work and records an event; ``drain`` waits on each
    pending event before the window's host bytes count as authoritative
    again, and every read of those bytes (an overlapping fetch,
    ``permute_rows``, ``host_array``) drains first.  A buffer filled on
    the side stream is ``record_stream``-ed onto the compute stream, and a
    stored tensor onto the side stream and kept in ``_pending`` until its
    drain, so that the caching allocator reuses neither while a copy is in
    flight.  A window that is not whole block columns is copied correctly
    but synchronously.  On the CPU (``device="cpu"``) a window is a copy of
    the host bytes and a writeback lands at drain.  ``device=None`` means
    CUDA and raises without it.

    Thread safety: the residency ledger (``_res``), the staged-buffer
    table (``_device``) and the writeback queue (``_pending``) are guarded
    by ``_lock``, so that a checkpoint or observer thread can read
    residency while the factorization thread streams.  Blocking work (the
    ``ooc_copy_stall`` chaos sleep, event waits, host copies) happens
    outside the lock.
    """

    def __init__(self, dense, mb: int, nb: int, max_pending: int = 4,
                 device=None):
        slate_error(np.ndim(dense) == 2, "TileMap needs a 2D host array")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        src = np.asarray(dense)
        self.m, self.n = src.shape
        self.mb, self.nb = int(mb), int(nb)
        # writeback queue depth before a forced drain: bounds how much
        # device memory in-flight D2H copies can pin
        self.max_pending = max(1, int(max_pending))
        self.Mt = layout.num_tiles(self.m, self.mb)
        self.Nt = layout.num_tiles(self.n, self.nb)
        self._dtype = src.dtype
        tdtype = torch.from_numpy(np.empty(0, src.dtype)).dtype
        flat = torch.empty(src.size, dtype=tdtype, pin_memory=self._cuda)
        self._cols = []                      # block column j: [m, nb_j]
        for j in range(self.Nt):
            c0, c1 = j * self.nb, min((j + 1) * self.nb, self.n)
            blk = flat[self.m * c0:self.m * c1].view(self.m, c1 - c0)
            np.copyto(blk.numpy(), src[:, c0:c1])
            self._cols.append(blk)
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._res = np.zeros((self.Mt, self.Nt), np.uint8)
        self._device: dict[tuple, Any] = {}
        self._pending: list[tuple] = []
        self._lock = threading.Lock()

    @classmethod
    def from_dense(cls, dense, mb: int, nb: int, device=None) -> "TileMap":
        return cls(np.asarray(dense), mb, nb, device=device)

    # ---- residency ledger ----
    def _tiles_of(self, r0, r1, c0, c1):
        return (slice(r0 // self.mb, -(-r1 // self.mb)),
                slice(c0 // self.nb, -(-c1 // self.nb)))

    def residency(self, i: int, j: int) -> str:
        """Residency of tile (i, j): 'host' | 'device' | 'dirty'."""
        with self._lock:
            return _RES_NAMES[int(self._res[i, j])]

    def residency_counts(self) -> dict:
        with self._lock:
            counts = np.bincount(self._res.reshape(-1), minlength=3)
        return {name: int(counts[code]) for code, name in _RES_NAMES.items()}

    @staticmethod
    def _stall() -> None:
        # chaos: a congested host<->device copy path; the sleep stays
        # outside _lock
        from ..robust import faults
        plan = faults.host_fire("ooc_copy_stall")
        if plan is not None and plan.delay_s > 0:
            time.sleep(plan.delay_s)

    @staticmethod
    def _hits(key: tuple, other: tuple) -> bool:
        return not (other[1] <= key[0] or other[0] >= key[1]
                    or other[3] <= key[2] or other[2] >= key[3])

    # ---- copies ----
    def _pieces(self, r0, r1, c0, c1):
        """(host view, first column, last column) of the window's part in
        each block column it touches, columns relative to c0."""
        for j in range(c0 // self.nb, -(-c1 // self.nb)):
            b0 = j * self.nb
            lo, hi = max(c0, b0), min(c1, b0 + self._cols[j].shape[1])
            yield self._cols[j][r0:r1, lo - b0:hi - b0], lo - c0, hi - c0

    def _h2d(self, key: tuple) -> tuple:
        """Copy a host window to the device: (tensor, event), the event
        None on the CPU."""
        r0, r1, c0, c1 = key
        pieces = list(self._pieces(*key))
        TRAFFIC["h2d"] += (r1 - r0) * (c1 - c0) * self._dtype.itemsize
        if not self._cuda:
            return torch.cat([p for p, _, _ in pieces], dim=1), None
        with torch.cuda.stream(self._side):
            buf = torch.empty((r1 - r0, c1 - c0), dtype=pieces[0][0].dtype,
                              device=self.device)
            for p, a, b in pieces:
                buf[:, a:b].copy_(p, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        return buf, ev

    def _consume(self, staged: tuple) -> torch.Tensor:
        """A staged window, safe to use on the current stream."""
        buf, ev = staged
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            buf.record_stream(cur)
        return buf

    def _d2h(self, key: tuple, arr) -> tuple:
        """Queue the copy of ``arr`` into the window's host bytes: (source,
        event); host data (a CPU tensor or array) is written at drain, a
        CUDA tensor is copied on the side stream now."""
        TRAFFIC["d2h"] += int(np.prod(arr.shape)) * self._dtype.itemsize
        if not (isinstance(arr, torch.Tensor) and arr.is_cuda):
            return torch.as_tensor(np.asarray(arr)), None
        src = arr if arr.is_contiguous() else arr.contiguous()
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            for p, a, b in self._pieces(*key):
                p.copy_(src[:, a:b], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        src.record_stream(self._side)
        return src, ev

    # ---- streaming ----
    def prefetch(self, r0: int, r1: int, c0: int, c1: int) -> None:
        """Stage host window [r0:r1, c0:c1] on the device (async H2D)."""
        key = (int(r0), int(r1), int(c0), int(c1))
        with self._lock:
            staged = key in self._device
            conflict = any(self._hits(key, p[0]) for p in self._pending)
        if staged:
            return
        self._stall()
        if conflict:
            self.drain()
        buf = self._h2d(key)
        ti, tj = self._tiles_of(*key)
        with self._lock:
            self._device[key] = buf
            self._res[ti, tj] = np.maximum(self._res[ti, tj], _RES_DEVICE)

    def fetch(self, r0: int, r1: int, c0: int, c1: int) -> torch.Tensor:
        """Consume the staged window (pop), or copy it now on a miss.

        A window overlapping a pending writeback drains first, so a fetch
        always observes the newest bytes; disjoint windows ride through
        without waiting for in-flight D2H copies."""
        key = (int(r0), int(r1), int(c0), int(c1))
        with self._lock:
            buf = self._device.pop(key, None)
            conflict = any(self._hits(key, p[0]) for p in self._pending)
        if buf is not None:
            return self._consume(buf)
        self._stall()
        if conflict:
            self.drain()
        buf = self._h2d(key)
        ti, tj = self._tiles_of(*key)
        with self._lock:
            self._res[ti, tj] = np.maximum(self._res[ti, tj], _RES_DEVICE)
        return self._consume(buf)

    def store(self, r0: int, r1: int, c0: int, c1: int, arr) -> None:
        """Queue an async writeback of ``arr`` into the window."""
        key = (int(r0), int(r1), int(c0), int(c1))
        slate_error(tuple(arr.shape) == (r1 - r0, c1 - c0),
                    f"store shape {tuple(arr.shape)} != window "
                    f"({r1 - r0},{c1 - c0})")
        self._stall()
        entry = self._d2h(key, arr)
        ti, tj = self._tiles_of(*key)
        with self._lock:
            self._pending.append((key, entry))
            depth = len(self._pending)
            self._res[ti, tj] = _RES_DIRTY
            # staged clean copies overlapping a dirty window are stale
            for k in [k for k in self._device if self._hits(key, k)]:
                del self._device[k]
        if depth > self.max_pending:
            self.drain()

    def drain(self) -> None:
        """Land every pending writeback in host memory (blocks)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for key, (src, ev) in pending:
            if ev is not None:
                ev.synchronize()
                continue
            for p, a, b in self._pieces(*key):
                p.copy_(src[:, a:b])
        if pending:
            with self._lock:
                for key, _ in pending:
                    ti, tj = self._tiles_of(*key)
                    self._res[ti, tj] = _RES_HOST

    def permute_rows(self, r0: int, c0: int, c1: int, perm) -> None:
        """Host-side row permutation of the window [r0:, c0:c1], the LU
        left-columns pivot exchange: ``host[r0:][i] = host[r0:][perm[i]]``,
        written for the rows ``perm`` moves only (a partial-pivot panel
        moves at most twice its width)."""
        self.drain()
        perm = np.asarray(perm)
        slate_error(perm.shape == (self.m - r0,),
                    f"permute_rows: perm of {perm.shape} for "
                    f"{self.m - r0} rows")
        moved = np.flatnonzero(perm != np.arange(perm.size))
        if c1 > c0 and moved.size:
            dst = torch.from_numpy(r0 + moved)
            src = torch.from_numpy(r0 + perm[moved])
            for p, _, _ in self._pieces(0, self.m, c0, c1):
                p[dst] = p[src]

    # ---- host views ----
    def host_array(self) -> np.ndarray:
        """The authoritative host bytes after draining writebacks, as a
        new row-major array (the block columns side by side): a snapshot
        that later steps do not change."""
        self.drain()
        return torch.cat(self._cols, dim=1).numpy()

    def to_dense(self) -> np.ndarray:
        return self.host_array()

    @property
    def dtype(self):
        return self._dtype

    @property
    def nbytes(self) -> int:
        return self.m * self.n * self._dtype.itemsize

    def __repr__(self):
        counts = self.residency_counts()
        return (f"TileMap({self.m}x{self.n}, tiles {self.mb}x{self.nb}, "
                f"{self.dtype}, {self.device}, residency {counts})")
