"""Debug dumps of tile state (port of slate_tpu/util/debug.py; ref:
src/core/Debug.cc:66-336 checkTilesLives / printTilesMaps).

The storage is one blocked tensor on one device, with no tile lives or
coherency states to dump; what stays debuggable is the map: which rank
owns each tile, what lives in it (its norm), and whether the pad
invariant holds.
"""

from __future__ import annotations

import numpy as np


def _canonical(A) -> np.ndarray:
    return A.storage.canonical().resolve_conj().cpu().numpy()


def tiles_map(A, *, max_tiles: int = 32) -> str:
    """Owner and Frobenius norm of each tile (ref: Debug::printTilesMaps).

    One cell a tile, ``r<rank>:<norm>``, '.' for an all-zero tile;
    truncated to ``max_tiles`` tile rows and columns."""
    st = A.storage
    can = _canonical(A)
    Mt, Nt = min(st.Mt, max_tiles), min(st.Nt, max_tiles)
    lines = [f"tiles_map {st.m}x{st.n} mb={st.mb} nb={st.nb} "
             f"grid={st.grid.p}x{st.grid.q}"]
    for i in range(Mt):
        cells = []
        for j in range(Nt):
            nrm = float(np.linalg.norm(can[i, j]))
            r = st.tile_rank(i, j)
            cells.append("." if nrm == 0 else f"r{r}:{nrm:.2e}")
        lines.append(" ".join(cells) + (" ..." if Nt < st.Nt else ""))
    if Mt < st.Mt:
        lines.append("...")
    return "\n".join(lines)


def check_pad_invariant(A) -> bool:
    """True iff every entry of the tiles' pad outside the matrix is
    exactly zero, the invariant every kernel keeps (the analog of
    Debug::checkTiles)."""
    st = A.storage
    can = _canonical(A)
    dense = can.transpose(0, 2, 1, 3).reshape(st.Mt * st.mb, st.Nt * st.nb)
    ok = True
    if st.Mt * st.mb > st.m:
        ok &= not np.any(dense[st.m:, :])
    if st.Nt * st.nb > st.n:
        ok &= not np.any(dense[:, st.n:])
    return bool(ok)


def memory_report(A) -> str:
    """Device-memory footprint of a matrix's storage, on the card or the
    CPU it lies on (the analog of the reference's Memory pool counters,
    Memory.hh:29-95)."""
    st = A.storage
    nbytes = st.data.numel() * st.data.element_size()
    ndev = max(st.grid.p * st.grid.q, 1)
    return (f"storage {tuple(st.data.shape)} {st.dtype} on {st.device}: "
            f"{nbytes / 1e6:.2f} MB total, {nbytes / ndev / 1e6:.2f} MB "
            f"per device over {ndev} device(s)")
