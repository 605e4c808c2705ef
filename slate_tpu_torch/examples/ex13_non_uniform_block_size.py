"""ex13: ragged tile sizes (port of examples/ex13_non_uniform_block_size.py;
ref: ex13_non_uniform_block_size.cc).

The reference supports arbitrary per-tile sizes via tileMb/tileNb lambdas;
here tile sizes are uniform with a ragged LAST tile (the padding
discipline of core/storage.py) - this example shows computations are exact
when no dimension divides the tile size."""

import numpy as np

import slate_tpu_torch as st
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    m, n, k, nb = 37, 29, 23, 8            # nothing divides 8
    a = r.standard_normal((m, k))
    b = r.standard_normal((k, n))
    A = st.Matrix.from_numpy(a, nb, nb, g)
    B = st.Matrix.from_numpy(b, nb, nb, g)
    C = st.gemm(1.0, A, B)
    report("ex13 ragged gemm", float(np.abs(C.to_numpy() - a @ b).max()),
           1e-10)

    sq = r.standard_normal((37, 37)) + 37 * np.eye(37)
    bb = r.standard_normal((37, 3))
    _, X = st.gesv(st.Matrix.from_numpy(sq, 7, 7, g),
                   st.Matrix.from_numpy(bb, 7, 7, g))
    report("ex13 ragged gesv", float(np.linalg.norm(
        sq @ X.to_numpy() - bb) / np.linalg.norm(bb)), 1e-10)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
