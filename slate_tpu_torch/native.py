"""Host tile packing and ScaLAPACK descriptor arithmetic (port of
slate_tpu/native.py), in numpy.

The reference binds ``slate_tpu/_native.so`` (native/slate_tpu_native.cc,
OpenMP across tiles) and falls back to numpy without it.  That library
belongs to the JAX package; the port has no native host library, so
:func:`available` is False and every function here is the numpy version,
byte-equal to the native one: the cyclic tile array
``[p*mtl, q*ntl, mb, nb]`` of a row-major matrix, zero outside it.
"""

from __future__ import annotations

import numpy as np


def available() -> bool:
    """False: the port has no native host library (the reference's
    ``_native.so`` belongs to the JAX package); the numpy versions here
    serve instead."""
    return False


def version() -> int | None:
    """The native library's version; None, since there is none."""
    return None


def supports(dtype) -> bool:
    """Whether :func:`pack_tiles`/:func:`unpack_tiles` take this dtype:
    every numeric numpy dtype."""
    return np.dtype(dtype).kind in "biufc"


def numroc(n: int, nb: int, iproc: int, isrcproc: int, nprocs: int) -> int:
    """ScaLAPACK numroc (the compat tier's implementation)."""
    from .compat.scalapack import numroc as _numroc
    return _numroc(n, nb, iproc, isrcproc, nprocs)


def _cyclic_maps(tiles: int, procs: int) -> tuple:
    """(local count a process, global tile index of each cyclic slot, -1
    for a pad slot) of one dimension."""
    loc = -(-tiles // procs)
    s = np.arange(procs * loc)
    idx = (s % loc) * procs + s // loc
    return loc, np.where(idx < tiles, idx, -1)


def pack_tiles(a: np.ndarray, mb: int, nb: int, p: int, q: int):
    """Row-major [m, n] -> cyclic tile array [p*mtl, q*ntl, mb, nb]:
    slot (s, t) holds tile (i, j) with i = (s % mtl) * p + s // mtl and
    j = (t % ntl) * q + t // ntl; pad entries are zero.  None for an
    input that is not a 2D numeric array."""
    if a.ndim != 2 or not supports(a.dtype):
        return None
    m, n = a.shape
    Mt, Nt = -(-m // mb), -(-n // nb)
    padded = np.zeros((Mt * mb, Nt * nb), a.dtype)
    padded[:m, :n] = a
    canon = padded.reshape(Mt, mb, Nt, nb).transpose(0, 2, 1, 3)
    mtl, ri = _cyclic_maps(Mt, p)
    ntl, ci = _cyclic_maps(Nt, q)
    out = np.zeros((p * mtl, q * ntl, mb, nb), a.dtype)
    rs, cs = np.flatnonzero(ri >= 0), np.flatnonzero(ci >= 0)
    out[np.ix_(rs, cs)] = canon[np.ix_(ri[rs], ci[cs])]
    return out


def unpack_tiles(tiles: np.ndarray, m: int, n: int, p: int, q: int):
    """Cyclic tile array -> row-major numpy [m, n] (the inverse of
    :func:`pack_tiles`)."""
    if not supports(tiles.dtype):
        return None
    mb, nb = tiles.shape[2], tiles.shape[3]
    Mt, Nt = -(-m // mb), -(-n // nb)
    _, ri = _cyclic_maps(Mt, p)
    _, ci = _cyclic_maps(Nt, q)
    rs, cs = np.flatnonzero(ri >= 0), np.flatnonzero(ci >= 0)
    canon = np.zeros((Mt, Nt, mb, nb), tiles.dtype)
    canon[np.ix_(ri[rs], ci[cs])] = tiles[np.ix_(rs, cs)]
    dense = canon.transpose(0, 2, 1, 3).reshape(Mt * mb, Nt * nb)
    return np.ascontiguousarray(dense[:m, :n])
