"""Matrix classes (port of slate_tpu/core/matrix.py): general, trapezoid,
triangular, symmetric, Hermitian and the band classes.

As in the reference, a matrix is its storage plus view metadata
(tile offset, extent, ``op``); ``transpose``/``conj_transpose`` share the
storage and only change ``op``.  Drivers return new matrices; they never
write into a caller's storage.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..exceptions import slate_error
from ..types import Diag, Op, TileKind, Uplo, compose_op, is_complex
from . import layout
from .grid import Grid
from .storage import TileStorage, as_tensor, grid_device

__all__ = [
    "BaseMatrix", "Matrix", "BaseTrapezoidMatrix", "TrapezoidMatrix",
    "TriangularMatrix", "SymmetricMatrix", "HermitianMatrix",
    "BaseBandMatrix", "BandMatrix", "TriangularBandMatrix",
    "HermitianBandMatrix",
]


class BaseMatrix:
    """Shared base: storage + (tile-offset, extent, op) view metadata.

    View coordinates (io, jo, mt, nt) index the *storage* tile grid; ``op``
    transposes on top, applied in accessors (BaseMatrix.hh:4048-4088).
    """

    uplo: Uplo = Uplo.General
    diag: Diag = Diag.NonUnit

    def __init__(self, storage: TileStorage, io: int = 0, jo: int = 0,
                 mt: Optional[int] = None, nt: Optional[int] = None,
                 op: Op = Op.NoTrans, kind: TileKind = TileKind.SlateOwned):
        self.storage = storage
        self.io, self.jo = int(io), int(jo)
        self._mt = storage.Mt - self.io if mt is None else int(mt)
        self._nt = storage.Nt - self.jo if nt is None else int(nt)
        self.op = op
        self.kind = kind
        slate_error(0 <= self.io and self.io + self._mt <= storage.Mt and
                    0 <= self.jo and self.jo + self._nt <= storage.Nt,
                    "view out of range")

    def _extra_aux(self):
        return ()

    def _apply_extra_aux(self, extra):
        pass

    def _same_view(self, storage: TileStorage, op: Op | None = None):
        """This view's class and metadata over ``storage`` (and ``op``)."""
        v = self.__class__.__new__(self.__class__)
        BaseMatrix.__init__(v, storage, self.io, self.jo, self._mt, self._nt,
                            self.op if op is None else op, self.kind)
        v._apply_extra_aux(self._extra_aux())
        return v

    # ---- shape accessors (op-aware) ----
    @property
    def grid(self) -> Grid:
        return self.storage.grid

    @property
    def dtype(self) -> torch.dtype:
        return self.storage.dtype

    @property
    def device(self) -> torch.device:
        return self.storage.device

    def _m_store(self) -> int:
        st = self.storage
        if self._mt == 0:
            return 0
        return (self._mt - 1) * st.mb + st.tile_mb(self.io + self._mt - 1)

    def _n_store(self) -> int:
        st = self.storage
        if self._nt == 0:
            return 0
        return (self._nt - 1) * st.nb + st.tile_nb(self.jo + self._nt - 1)

    @property
    def m(self) -> int:
        return self._m_store() if self.op is Op.NoTrans else self._n_store()

    @property
    def n(self) -> int:
        return self._n_store() if self.op is Op.NoTrans else self._m_store()

    @property
    def mt(self) -> int:
        return self._mt if self.op is Op.NoTrans else self._nt

    @property
    def nt(self) -> int:
        return self._nt if self.op is Op.NoTrans else self._mt

    @property
    def mb(self) -> int:
        return self.storage.mb if self.op is Op.NoTrans else self.storage.nb

    @property
    def nb(self) -> int:
        return self.storage.nb if self.op is Op.NoTrans else self.storage.mb

    def tile_mb(self, i: int) -> int:
        if self.op is Op.NoTrans:
            return min(self.storage.tile_mb(self.io + i),
                       self._m_store() - i * self.mb)
        return min(self.storage.tile_nb(self.jo + i),
                   self._n_store() - i * self.mb)

    def tile_nb(self, j: int) -> int:
        if self.op is Op.NoTrans:
            return min(self.storage.tile_nb(self.jo + j),
                       self._n_store() - j * self.nb)
        return min(self.storage.tile_mb(self.io + j),
                   self._m_store() - j * self.nb)

    def tile_rank(self, i: int, j: int) -> int:
        if self.op is not Op.NoTrans:
            i, j = j, i
        return self.storage.tile_rank(self.io + i, self.jo + j)

    # ---- views (zero-copy: share self.storage) ----
    def sub(self, i1: int, i2: int, j1: int, j2: int) -> "Matrix":
        """Tile-index submatrix view, inclusive ranges as in the reference
        (ref: BaseMatrix.hh:941-1122); always a general Matrix view."""
        if self.op is not Op.NoTrans:
            i1, i2, j1, j2 = j1, j2, i1, i2
        v = Matrix.__new__(Matrix)
        BaseMatrix.__init__(v, self.storage, self.io + i1, self.jo + j1,
                            max(0, i2 - i1 + 1), max(0, j2 - j1 + 1),
                            self.op, self.kind)
        return v

    def transpose(self):
        return self._same_view(self.storage, compose_op(self.op, Op.Trans))

    def conj_transpose(self):
        if not is_complex(self.dtype):
            return self.transpose()
        return self._same_view(self.storage,
                               compose_op(self.op, Op.ConjTrans))

    @property
    def T(self):
        return self.transpose()

    @property
    def H(self):
        return self.conj_transpose()

    def is_root_view(self) -> bool:
        return (self.io == 0 and self.jo == 0 and
                self._mt == self.storage.Mt and self._nt == self.storage.Nt)

    # ---- materialisation ----
    def _dense_store(self) -> torch.Tensor:
        """Dense [m, n] of the untransposed view region (may share memory
        with the storage)."""
        st = self.storage
        if self.is_root_view():
            return st.to_dense()
        tiles = st.canonical()[self.io:self.io + self._mt,
                               self.jo:self.jo + self._nt]
        return layout.untile_dense(tiles, self._m_store(), self._n_store())

    def to_dense(self) -> torch.Tensor:
        """The view as a dense [m, n] tensor, op applied and structure
        expanded (subclasses override ``_expand``)."""
        d = self._expand(self._dense_store())
        if self.op is Op.Trans:
            d = d.T
        elif self.op is Op.ConjTrans:
            d = d.conj().T
        return d

    def _expand(self, dense: torch.Tensor) -> torch.Tensor:
        return dense

    def to_numpy(self) -> np.ndarray:
        return self.to_dense().resolve_conj().cpu().numpy()

    def with_dense(self, dense: torch.Tensor):
        """A same-view matrix whose view region holds ``dense`` (a new
        storage; the parent storage's regions outside the view are
        kept).  ``dense`` must lie on this matrix' device."""
        slate_error(dense.device == self.device,
                    f"with_dense: data on {dense.device}, matrix on "
                    f"{self.device}")
        if self.op is Op.Trans:
            dense = dense.T
        elif self.op is Op.ConjTrans:
            dense = dense.conj().T
        st = self.storage
        if self.is_root_view():
            new_st = st.with_dense(dense)
        else:
            tiles = st.canonical().clone()
            sub = layout.tile_dense(dense.to(st.dtype), st.mb, st.nb)
            tiles[self.io:self.io + sub.shape[0],
                  self.jo:self.jo + sub.shape[1]] = sub
            new_st = st.with_canonical(tiles)
        return self._same_view(new_st)

    def emptyLike(self, dtype=None):
        """Same shape, tiling and view over all-zero storage on this
        matrix' device (ref: Matrix::emptyLike)."""
        st = self.storage
        z = TileStorage.zeros(st.m, st.n, st.mb, st.nb, st.grid,
                              dtype or st.dtype, st.device)
        return self._same_view(z)

    def __repr__(self):
        extra = "" if self.op is Op.NoTrans else f", op={self.op.name}"
        return (f"{self.__class__.__name__}({self.m}x{self.n}, "
                f"tiles {self.mb}x{self.nb}, grid {self.grid.p}x"
                f"{self.grid.q}, {self.device}{extra})")


class Matrix(BaseMatrix):
    """General m x n matrix (ref: include/slate/Matrix.hh:58-163)."""

    @classmethod
    def zeros(cls, m, n, mb, nb=None, grid=None, dtype=torch.float32,
              device=None):
        """An all-zero m x n matrix; ``device=None`` means CUDA."""
        return cls(TileStorage.zeros(m, n, mb, nb or mb, grid or Grid(1, 1),
                                     dtype, device))

    @classmethod
    def from_numpy(cls, a, mb, nb=None, grid=None, kind=TileKind.UserOwned,
                   device=None):
        """Import host data (ref: fromLAPACK).  ``device=None`` means the
        grid's device, and on the serial grid CUDA, raising without it;
        ``device="cpu"`` runs the plain versions.  On a grid with a
        process group ``a`` is the whole matrix, the same on every rank,
        and each rank keeps its own tiles."""
        st = TileStorage.from_dense(as_tensor(a, grid_device(grid, device)),
                                    mb, nb or mb, grid or Grid(1, 1))
        return cls(st, kind=kind)

    # ---- structure reinterpretation (ref: conversion ctors) ----
    def triangular(self, uplo: Uplo, diag: Diag = Diag.NonUnit):
        slate_error(self.m == self.n, "triangular view needs square")
        return TriangularMatrix._from_view(self, uplo, diag)

    def symmetric(self, uplo: Uplo):
        slate_error(self.m == self.n, "symmetric view needs square")
        return SymmetricMatrix._from_view(self, uplo)

    def hermitian(self, uplo: Uplo):
        slate_error(self.m == self.n, "hermitian view needs square")
        return HermitianMatrix._from_view(self, uplo)

    def trapezoid(self, uplo: Uplo, diag: Diag = Diag.NonUnit):
        return TrapezoidMatrix._from_view(self, uplo, diag)


class BaseTrapezoidMatrix(BaseMatrix):
    """Upper/lower trapezoid storage base
    (ref: include/slate/BaseTrapezoidMatrix.hh)."""

    def __init__(self, storage, uplo: Uplo = Uplo.Lower,
                 diag: Diag = Diag.NonUnit, **kw):
        super().__init__(storage, **kw)
        self.uplo = uplo
        self.diag = diag

    def _extra_aux(self):
        return (self.uplo, self.diag)

    def _apply_extra_aux(self, extra):
        self.uplo, self.diag = extra

    @classmethod
    def _from_view(cls, src: BaseMatrix, uplo: Uplo,
                   diag: Diag = Diag.NonUnit):
        v = cls.__new__(cls)
        BaseMatrix.__init__(v, src.storage, src.io, src.jo, src._mt, src._nt,
                            src.op, src.kind)
        # A lower view of a transposed matrix is an upper view of storage.
        if src.op is not Op.NoTrans:
            uplo = Uplo.Upper if uplo is Uplo.Lower else Uplo.Lower
        v._apply_extra_aux((uplo, diag))
        return v

    def _uplo_logical(self) -> Uplo:
        """uplo as seen through op (ref: BaseMatrix::uploLogical)."""
        if self.op is Op.NoTrans:
            return self.uplo
        return Uplo.Upper if self.uplo is Uplo.Lower else Uplo.Lower

    def _expand(self, dense):
        d = torch.tril(dense) if self.uplo is Uplo.Lower else torch.triu(dense)
        if self.diag is Diag.Unit:
            d.diagonal().fill_(1)
        return d

    def general(self) -> Matrix:
        """Expand to a general Matrix (materialises the structure)."""
        g = Matrix.zeros(self.m, self.n, self.mb, self.nb, self.grid,
                         self.dtype, self.device)
        return g.with_dense(self.to_dense())


class TrapezoidMatrix(BaseTrapezoidMatrix):
    """ref: include/slate/TrapezoidMatrix.hh"""


class TriangularMatrix(BaseTrapezoidMatrix):
    """ref: include/slate/TriangularMatrix.hh"""

    @classmethod
    def from_numpy(cls, a, mb, uplo=Uplo.Lower, diag=Diag.NonUnit, grid=None,
                   device=None):
        return cls._from_view(Matrix.from_numpy(a, mb, mb, grid,
                                                device=device), uplo, diag)


class SymmetricMatrix(BaseTrapezoidMatrix):
    """ref: include/slate/SymmetricMatrix.hh: only the uplo triangle is
    referenced; _expand mirrors it."""

    @classmethod
    def from_numpy(cls, a, mb, uplo=Uplo.Lower, grid=None, device=None):
        return cls._from_view(Matrix.from_numpy(a, mb, mb, grid,
                                                device=device), uplo)

    def _expand(self, dense):
        tri = BaseTrapezoidMatrix._expand(self, dense)
        return tri + tri.T - torch.diag(tri.diagonal())


class HermitianMatrix(BaseTrapezoidMatrix):
    """ref: include/slate/HermitianMatrix.hh"""

    @classmethod
    def from_numpy(cls, a, mb, uplo=Uplo.Lower, grid=None, device=None):
        return cls._from_view(Matrix.from_numpy(a, mb, mb, grid,
                                                device=device), uplo)

    def _expand(self, dense):
        tri = BaseTrapezoidMatrix._expand(self, dense)
        d = tri.diagonal().real.clone()
        full = tri + tri.conj().T
        full.diagonal().copy_(d.to(full.dtype))
        return full


class BaseBandMatrix(BaseMatrix):
    """Band storage base (ref: include/slate/BaseBandMatrix.hh).  The band
    is kept inside the same blocked layout; entries outside it are
    structural zeros, which ``_expand`` masks."""

    def __init__(self, storage, kl: int = 0, ku: int = 0, **kw):
        super().__init__(storage, **kw)
        self.kl, self.ku = int(kl), int(ku)

    def _extra_aux(self):
        return (self.kl, self.ku)

    def _apply_extra_aux(self, extra):
        self.kl, self.ku = extra

    def _expand(self, dense):
        # keep -kl <= j - i <= ku
        return torch.triu(torch.tril(dense, self.ku), -self.kl)


class BandMatrix(BaseBandMatrix):
    """General band (ref: include/slate/BandMatrix.hh)."""

    @classmethod
    def from_numpy(cls, a, kl, ku, mb, grid=None, device=None):
        st = TileStorage.from_dense(as_tensor(a, grid_device(grid, device)),
                                    mb, mb,
                                    grid or Grid(1, 1))
        return cls(st, kl=kl, ku=ku)


class TriangularBandMatrix(BaseBandMatrix):
    """ref: include/slate/TriangularBandMatrix.hh"""

    @classmethod
    def from_numpy(cls, a, kd, mb, uplo: Uplo = Uplo.Lower,
                   diag: Diag = Diag.NonUnit, grid=None, device=None):
        st = TileStorage.from_dense(as_tensor(a, grid_device(grid, device)),
                                    mb, mb,
                                    grid or Grid(1, 1))
        return cls(st, kd=kd, uplo=uplo, diag=diag)

    def __init__(self, storage, kd: int = 0, uplo: Uplo = Uplo.Lower,
                 diag: Diag = Diag.NonUnit, **kw):
        kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
        super().__init__(storage, kl=kl, ku=ku, **kw)
        self.uplo, self.diag, self.kd = uplo, diag, int(kd)

    def _extra_aux(self):
        return (self.kd, self.uplo, self.diag)

    def _apply_extra_aux(self, extra):
        self.kd, self.uplo, self.diag = extra
        self.kl, self.ku = (self.kd, 0) if self.uplo is Uplo.Lower \
            else (0, self.kd)

    def _expand(self, dense):
        band = BaseBandMatrix._expand(self, dense)
        if self.diag is Diag.Unit:
            band.diagonal().fill_(1)
        return band


class HermitianBandMatrix(BaseBandMatrix):
    """ref: include/slate/HermitianBandMatrix.hh"""

    @classmethod
    def from_numpy(cls, a, kd, mb, uplo: Uplo = Uplo.Lower, grid=None,
                   device=None):
        st = TileStorage.from_dense(as_tensor(a, grid_device(grid, device)),
                                    mb, mb,
                                    grid or Grid(1, 1))
        return cls(st, kd=kd, uplo=uplo)

    def __init__(self, storage, kd: int = 0, uplo: Uplo = Uplo.Lower, **kw):
        kl, ku = (kd, 0) if uplo is Uplo.Lower else (0, kd)
        super().__init__(storage, kl=kl, ku=ku, **kw)
        self.uplo, self.kd = uplo, int(kd)

    def _extra_aux(self):
        return (self.kd, self.uplo)

    def _apply_extra_aux(self, extra):
        self.kd, self.uplo = extra
        self.kl, self.ku = (self.kd, 0) if self.uplo is Uplo.Lower \
            else (0, self.kd)

    def _expand(self, dense):
        band = BaseBandMatrix._expand(self, dense)
        d = band.diagonal().real.clone() if is_complex(self.dtype) \
            else band.diagonal().clone()
        full = band + band.conj().T
        full.diagonal().copy_(d.to(full.dtype))
        return full
