"""ScaLAPACK descriptor import/export (port of
slate_tpu/compat/scalapack.py).

A legacy application owns per-process local arrays in ScaLAPACK's 2D
block-cyclic column-major layout, described by the 9-integer descriptor

    DESC = [DTYPE, CTXT, M, N, MB, NB, RSRC, CSRC, LLD]

- ``numroc``, ``descinit_pq``, ``descinit``, ``gather_locals`` and
  ``scatter_locals`` are pure numpy and integer arithmetic over any
  p x q process split, equal byte for byte to the reference's.  This
  layout is the checkpoint payload format (robust/checkpoint.py): a real
  ScaLAPACK program could read a payload without a slate-specific
  decoder.
- ``from_scalapack`` and ``to_scalapack`` cross into tiled matrices on any
  p x q grid: ScaLAPACK process (pr, pc) is grid coordinate (r, c), under
  either GridOrder (the order numbers the ranks, not the tiles).  On a
  grid with a process group every rank passes the whole map of locals
  and keeps its own tiles; ``to_scalapack`` all-gathers, so every rank
  calls it.  Locals that do not match the grid raise SlateValueError.

Local arrays on import may be exactly numroc-sized or allocated with LLD
rows (what a single-descriptor ScaLAPACK program holds); at ragged sizes
the two differ for processes owning the short block row, and both must
round-trip.  Only RSRC = CSRC = 0 is supported.
"""

from __future__ import annotations

import numpy as np

from ..core.grid import Grid
from ..exceptions import slate_error

DTYPE_DENSE = 1  # ScaLAPACK descriptor DTYPE_ for dense matrices


def numroc(n: int, nb: int, iproc: int, isrc: int, nprocs: int) -> int:
    """NUMber of Rows Or Columns owned locally (scalapack numroc.f)."""
    mydist = (nprocs + iproc - isrc) % nprocs
    nblocks = n // nb
    num = (nblocks // nprocs) * nb
    extrablocks = nblocks % nprocs
    if mydist < extrablocks:
        num += nb
    elif mydist == extrablocks:
        num += n % nb
    return num


def descinit_pq(m: int, n: int, mb: int, nb: int, p: int,
                rsrc: int = 0, csrc: int = 0, ctxt: int = 0) -> tuple:
    """Grid-free ``descinit``: LLD depends on the process-row count ``p``
    alone.  The entry the checkpoint layer uses."""
    slate_error(rsrc == 0 and csrc == 0,
                "descinit: only RSRC=CSRC=0 supported")
    lld = max(1, max(numroc(m, mb, pr, rsrc, p) for pr in range(p)))
    return (DTYPE_DENSE, ctxt, m, n, mb, nb, rsrc, csrc, lld)


def descinit(m: int, n: int, mb: int, nb: int, grid: Grid | None = None,
             rsrc: int = 0, csrc: int = 0, ctxt: int = 0) -> tuple:
    """The 9-integer array descriptor (scalapack descinit.f) on ``grid``
    (1 x 1 by default).  LLD is the largest local row count of a grid
    column, as a single-descriptor program allocates."""
    grid = grid or Grid(1, 1)
    return descinit_pq(m, n, mb, nb, grid.p, rsrc, csrc, ctxt)


def _check_desc(desc) -> tuple:
    slate_error(len(desc) == 9, "descriptor must have 9 entries")
    dtype_, _, m, n, mb, nb, rsrc, csrc, lld = (int(x) for x in desc)
    slate_error(dtype_ == DTYPE_DENSE, "only dense (DTYPE=1) descriptors")
    slate_error(rsrc == 0 and csrc == 0, "only RSRC=CSRC=0 supported")
    return m, n, mb, nb, lld


def _piece(locals_, pr: int, pc: int) -> np.ndarray:
    piece = (locals_[(pr, pc)] if isinstance(locals_, dict)
             else locals_[pr][pc])
    return np.asarray(piece)


def gather_locals(desc, locals_, p: int, q: int) -> np.ndarray:
    """Assemble per-process ScaLAPACK locals into one dense numpy array.

    ``locals_``: {(pr, pc): 2D array} or nested ``locals_[pr][pc]``.  Each
    piece is exactly numroc-sized ``(ml, nl)`` or LLD-row-padded
    ``(lld, nl)``; only the leading ``ml`` rows are read.  Pure numpy."""
    m, n, mb, nb, lld = _check_desc(desc)
    dense = np.zeros((m, n), _piece(locals_, 0, 0).dtype)
    for pr in range(p):
        for pc in range(q):
            piece = _piece(locals_, pr, pc)
            ml = numroc(m, mb, pr, 0, p)
            nl = numroc(n, nb, pc, 0, q)
            slate_error(
                piece.shape == (ml, nl)
                or (piece.shape[0] == lld >= ml and piece.shape[1] == nl),
                f"local ({pr},{pc}) shape {piece.shape} != "
                f"numroc ({ml},{nl}) nor LLD-padded ({lld},{nl})")
            piece = piece[:ml]
            # local block row lb covers global rows of block ib = lb*p + pr
            for lb in range(-(-ml // mb) if mb else 0):
                gi = (lb * p + pr) * mb
                h = min(mb, m - gi, ml - lb * mb)
                for lc in range(-(-nl // nb) if nb else 0):
                    gj = (lc * q + pc) * nb
                    w = min(nb, n - gj, nl - lc * nb)
                    dense[gi:gi + h, gj:gj + w] = \
                        piece[lb * mb:lb * mb + h, lc * nb:lc * nb + w]
    return dense


def scatter_locals(dense: np.ndarray, mb: int, nb: int,
                   p: int, q: int) -> tuple:
    """Split a dense numpy array into (desc, {(pr, pc): local array}) in
    ScaLAPACK 2D block-cyclic layout: Fortran-ordered, exactly
    numroc-sized locals.  Pure numpy; the checkpoint writer's path."""
    dense = np.asarray(dense)
    m, n = dense.shape
    desc = descinit_pq(m, n, mb, nb, p)
    out = {}
    for pr in range(p):
        for pc in range(q):
            ml = numroc(m, mb, pr, 0, p)
            nl = numroc(n, nb, pc, 0, q)
            piece = np.zeros((ml, nl), dense.dtype, order="F")
            for lb in range(-(-ml // mb) if mb else 0):
                gi = (lb * p + pr) * mb
                h = min(mb, m - gi, ml - lb * mb)
                for lc in range(-(-nl // nb) if nb else 0):
                    gj = (lc * q + pc) * nb
                    w = min(nb, n - gj, nl - lc * nb)
                    piece[lb * mb:lb * mb + h, lc * nb:lc * nb + w] = \
                        dense[gi:gi + h, gj:gj + w]
            out[(pr, pc)] = piece
    return desc, out


def from_scalapack(desc, locals_, grid: Grid | None = None, device=None):
    """Assemble per-process local arrays into a tiled ``Matrix`` with tile
    sizes (MB, NB) on ``grid`` (1 x 1 by default; ref:
    scalapack.py:160-173), on ``device`` (``None`` means the grid's, and
    on the serial grid CUDA).  Pieces may be numroc-sized or LLD-padded,
    in either memory order, and must be those of a ``grid.p x grid.q``
    process grid: others raise SlateValueError, as the reference's do.
    On a grid with a process group each rank keeps its own tiles."""
    from ..core.matrix import Matrix
    grid = grid or Grid(1, 1)
    _, _, mb, nb, _ = _check_desc(desc)
    dense = gather_locals(desc, locals_, grid.p, grid.q)
    return Matrix.from_numpy(dense, mb, nb, grid, device=device)


def to_scalapack(A):
    """Export a Matrix to (desc, {(pr, pc): local array}) in ScaLAPACK
    layout on A's grid: Fortran-ordered locals, as a ScaLAPACK program
    holds them (on a grid with a process group an all-gather: every rank
    calls it and gets every process's locals)."""
    return scatter_locals(A.to_numpy(), A.mb, A.nb, A.grid.p, A.grid.q)
