"""TileStorage: the tile map as one blocked tensor (port of the
reference's slate_tpu/core/storage.py ``TileStorage``).

``data`` is one tensor ``[Mt, Nt, mb, nb]`` on one explicit device, in
the reference's cyclic order (which on the 1 x 1 grid is the natural tile
order), so ``data`` holds the same bytes as the reference's
``TileStorage.data`` for the same matrix.  The host-offload ``TileMap``
is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..exceptions import slate_error
from . import layout
from .grid import Grid


def resolve_device(device=None) -> torch.device:
    """The device an entry point places data on: ``None`` means CUDA, and
    raises when there is none, so nothing runs on the CPU unless the
    caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "slate_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the kernels' plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


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


class TileStorage:
    """Tiles of an m x n matrix, ``data[s, t]`` = tile (i, j) in the 2D
    block-cyclic order of ``grid`` (identity order on the 1 x 1 grid)."""

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
        slate_error(tuple(data.shape) == (self.grid.p * self.mtl,
                                          self.grid.q * self.ntl,
                                          self.mb, self.nb),
                    f"tile data shape {tuple(data.shape)} does not hold a "
                    f"{m}x{n} matrix in {mb}x{nb} tiles")

    # ---- constructors ----
    @classmethod
    def zeros(cls, m, n, mb, nb, grid: Grid | None = None,
              dtype=torch.float32, device=None):
        """All-zero tiles on ``device`` (``None`` means CUDA, as
        :func:`resolve_device` reads it)."""
        grid = grid or Grid(1, 1)
        Mt, Nt = layout.num_tiles(m, mb), layout.num_tiles(n, nb)
        mtl, ntl = -(-Mt // grid.p), -(-Nt // grid.q)
        data = torch.zeros((grid.p * mtl, grid.q * ntl, mb, nb), dtype=dtype,
                           device=resolve_device(device))
        return cls(data, m, n, mb, nb, grid)

    def with_dense(self, dense: torch.Tensor) -> "TileStorage":
        """This storage's tiling over ``dense``, on ``dense``'s device."""
        return TileStorage.from_dense(dense, self.mb, self.nb, self.grid)

    def with_canonical(self, tiles: torch.Tensor) -> "TileStorage":
        """This storage's shape over canonical tiles [Mt, Nt, mb, nb]."""
        data = layout.canonical_to_cyclic(tiles, self.grid.p, self.grid.q)
        return TileStorage(data, self.m, self.n, self.mb, self.nb, self.grid)

    @classmethod
    def from_dense(cls, dense: torch.Tensor, mb, nb,
                   grid: Grid | None = None):
        """Tile a dense tensor on the device it lies on (ref:
        Matrix::fromLAPACK); host data enters through ``Matrix.from_numpy``."""
        grid = grid or Grid(1, 1)
        slate_error(dense.dim() == 2, "from_dense needs a 2D tensor")
        tiles = layout.tile_dense(dense, mb, nb)
        data = layout.canonical_to_cyclic(tiles, grid.p, grid.q)
        return cls(data, dense.shape[0], dense.shape[1], mb, nb, grid)

    @classmethod
    def from_canonical(cls, tiles: torch.Tensor, m, n,
                       grid: Grid | None = None):
        """Storage over canonical tiles [Mt, Nt, mb, nb] of an m x n
        matrix."""
        grid = grid or Grid(1, 1)
        Mt, Nt, mb, nb = tiles.shape
        slate_error(Mt == layout.num_tiles(m, mb) and
                    Nt == layout.num_tiles(n, nb), "tile grid mismatch")
        data = layout.canonical_to_cyclic(tiles, grid.p, grid.q)
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
    def canonical(self) -> torch.Tensor:
        """Tiles in natural (i, j) order: [Mt, Nt, mb, nb]."""
        return layout.cyclic_to_canonical(
            self.data, self.Mt, self.Nt, self.grid.p, self.grid.q)

    def to_dense(self) -> torch.Tensor:
        return layout.untile_dense(self.canonical(), self.m, self.n)

    def tile(self, i: int, j: int) -> torch.Tensor:
        """One tile (debug/test path; ref: BaseMatrix::at)."""
        ci, _, _ = layout.cyclic_row_maps(self.Mt, self.grid.p)
        cj, _, _ = layout.cyclic_row_maps(self.Nt, self.grid.q)
        return self.data[int(ci[i]), int(cj[j])]

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
