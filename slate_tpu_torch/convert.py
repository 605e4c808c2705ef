"""Carry slate_tpu state across into the port, byte for byte.

Both packages store a matrix as one tile array in the same (cyclic) order,
so a reference ``TileStorage.data`` (as a numpy array) becomes the port's
``TileStorage.data`` unchanged, and a reference matrix becomes the port's
matrix of the same class over the same view (band matrices with their
kl/ku/kd/uplo/diag).  LU factors carry their packed matrix and ``perm``,
RBT factors their butterflies besides, QR and LQ factors their packed
matrix and the stack of T triangles, band and Aasen factors their packed
arrays and permutations, spectral results their arrays, matrices and
health.  A batched
health record (the reference's leading-axis ``HealthInfo`` pytree) becomes
one port ``HealthInfo`` per problem.  Nothing here imports the reference:
objects are read through the attributes both packages share.
"""

from __future__ import annotations

import numpy as np

from .core.grid import Grid
from .core.matrix import (BandMatrix, BaseBandMatrix, BaseMatrix,
                          BaseTrapezoidMatrix, HermitianBandMatrix,
                          HermitianMatrix, Matrix, SymmetricMatrix,
                          TrapezoidMatrix, TriangularBandMatrix,
                          TriangularMatrix)
from .drivers.band import GBFactors, PBFactors
from .drivers.hetrf import HEFactors
from .core.storage import TileStorage, as_tensor
from .drivers.lu import LUFactors, RBTFactors
from .drivers.qr import LQFactors, QRFactors
from .exceptions import slate_error
from .robust.health import HealthInfo
from .types import Diag, Op, TileKind, Uplo

_CLASSES = {cls.__name__: cls for cls in (
    Matrix, TrapezoidMatrix, TriangularMatrix, SymmetricMatrix,
    HermitianMatrix, BandMatrix, TriangularBandMatrix, HermitianBandMatrix)}


def storage_from_jax(data, m: int, n: int, mb: int, nb: int,
                     device=None) -> TileStorage:
    """The port's TileStorage holding the tiles ``data`` (a reference
    ``TileStorage.data`` as a numpy array, from a 1 x 1 grid) of an
    m x n matrix in mb x nb tiles, in the same tile order.  ``device=None``
    means CUDA."""
    return TileStorage(as_tensor(np.asarray(data), device), m, n, mb, nb,
                       Grid(1, 1))


def matrix_from_jax(M, device=None) -> BaseMatrix:
    """The port's matrix of the same class, view and structure as the
    reference matrix ``M`` (a general, trapezoid, triangular, symmetric,
    Hermitian or band matrix on a 1 x 1 grid), over the same tile
    bytes."""
    cls = _CLASSES.get(type(M).__name__)
    slate_error(cls is not None,
                f"matrix_from_jax: {type(M).__name__} is not ported")
    st = M.storage
    slate_error(st.grid.p * st.grid.q == 1,
                "matrix_from_jax: the port holds 1 x 1 grids only")
    storage = storage_from_jax(st.data, st.m, st.n, st.mb, st.nb, device)
    v = cls.__new__(cls)
    BaseMatrix.__init__(v, storage, M.io, M.jo, M._mt, M._nt,
                        Op(M.op.value), TileKind(M.kind.value))
    if issubclass(cls, BaseTrapezoidMatrix):
        v._apply_extra_aux((Uplo(M.uplo.value), Diag(M.diag.value)))
    elif cls is TriangularBandMatrix:
        v._apply_extra_aux((M.kd, Uplo(M.uplo.value), Diag(M.diag.value)))
    elif cls is HermitianBandMatrix:
        v._apply_extra_aux((M.kd, Uplo(M.uplo.value)))
    elif issubclass(cls, BaseBandMatrix):
        v._apply_extra_aux((M.kl, M.ku))
    return v


def lu_factors_from_jax(F, device=None) -> LUFactors:
    """The port's LUFactors of a reference ``LUFactors`` (packed L\\U
    matrix and ``perm``, A[perm] = L U)."""
    return LUFactors(matrix_from_jax(F.LU, device),
                     as_tensor(np.asarray(F.perm).astype(np.int64), device))


def rbt_factors_from_jax(R, device=None) -> RBTFactors:
    """The port's RBTFactors of a reference ``RBTFactors``: its NoPiv
    factors of the transformed matrix and its two butterflies."""
    def levels(bf):
        return tuple((as_tensor(np.asarray(r0), device),
                      as_tensor(np.asarray(r1), device)) for r0, r1 in bf)
    return RBTFactors(lu_factors_from_jax(R.F, device), levels(R.u),
                      levels(R.v), int(R.n))


def qr_factors_from_jax(F, device=None) -> QRFactors:
    """The port's QRFactors of a reference ``QRFactors``: the packed V\\R
    matrix and the T stack [K, nb, nb], byte for byte."""
    return QRFactors(matrix_from_jax(F.QR, device),
                     as_tensor(np.asarray(F.T), device))


def lq_factors_from_jax(F, device=None) -> LQFactors:
    """The port's LQFactors of a reference ``LQFactors`` (the QR factors of
    A^H)."""
    return LQFactors(qr_factors_from_jax(F.F, device))


def health_from_jax(h) -> list[HealthInfo]:
    """The port's HealthInfo of each problem of a reference ``HealthInfo``
    whose fields have a leading axis (a batched or vmapped health), as
    Python values."""
    f = [np.atleast_1d(np.asarray(x)) for x in h]
    return [HealthInfo(
        nonfinite=bool(f[0][i]), info=int(f[1][i]),
        min_pivot=float(f[2][i]), min_pivot_index=int(f[3][i]),
        growth=float(f[4][i]), iters=int(f[5][i]), converged=bool(f[6][i]),
        abft_detected=int(f[7][i]), abft_corrected=int(f[8][i]),
        abft_site=int(f[9][i])) for i in range(len(f[0]))]


def pb_factors_from_jax(F, device=None) -> PBFactors:
    """The port's PBFactors of a reference ``PBFactors`` (packed band L)."""
    return PBFactors(as_tensor(np.asarray(F.L_band), device), int(F.kd),
                     int(F.n), int(F.w))


def gb_factors_from_jax(F, device=None) -> GBFactors:
    """The port's GBFactors of a reference ``GBFactors`` (packed band LU
    and each block's window permutation)."""
    return GBFactors(as_tensor(np.asarray(F.LU_band), device),
                     as_tensor(np.asarray(F.perms).astype(np.int64), device),
                     int(F.kl), int(F.ku), int(F.n), int(F.w))


def he_factors_from_jax(F, device=None) -> HEFactors:
    """The port's HEFactors of a reference ``HEFactors`` (Aasen's L, T's
    blocks, the permutation and T's band-LU factors)."""
    def t(x, dtype=None):
        a = np.asarray(x)
        return as_tensor(a if dtype is None else a.astype(dtype), device)
    return HEFactors(t(F.L), t(F.Tdiag), t(F.Tsub), t(F.piv, np.int64),
                     int(F.nb), t(F.Tlu), t(F.Tperms, np.int64))


def spectral_from_jax(result, device=None) -> tuple:
    """The port's form of a reference spectral result: heev's (w, Z),
    svd's (s, U, V), a tridiagonal or bidiagonal driver's arrays, each with
    its HealthInfo under ErrorPolicy.Info.  Arrays become tensors, matrices
    the port's matrices over the same tiles, the HealthInfo the port's;
    None (Z when not jobz) stays None."""
    out = []
    for x in result:
        if x is None:
            out.append(None)
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            out.append(health_from_jax(x)[0])
        elif hasattr(x, "storage"):
            out.append(matrix_from_jax(x, device))
        else:
            out.append(as_tensor(np.asarray(x), device))
    return tuple(out)
