"""ex01: creating distributed matrices (port of examples/ex01_matrix.py;
ref: examples/ex01_matrix.cc).

Build matrices from host data onto a 2D process grid, inspect the
block-cyclic tile map, and round-trip back to host."""

import numpy as np
import torch

import slate_tpu_torch as st
from ._common import grid, report, rng, say, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 4, device)
    if g is None:
        return
    m, n, nb = 40, 28, 8
    a = r.standard_normal((m, n))

    A = st.Matrix.from_numpy(a, nb, nb, g)
    assert (A.m, A.n) == (m, n)
    assert (A.mt, A.nt) == (5, 4)          # ceil(40/8), ceil(28/8)
    # distribution lambdas (ref: MatrixStorage tileRank/tileMb)
    assert A.storage.tile_mb(4) == 8 and A.storage.tile_nb(3) == 4
    assert A.storage.tile_rank(0, 0) == 0
    report("ex01 from_numpy round-trip", float(np.abs(A.to_numpy() - a).max()))

    Z = st.Matrix.zeros(16, 16, 4, 4, g, torch.float64)
    assert np.all(Z.to_numpy() == 0)
    say(f"ex01 tile map: {A.storage}")


if __name__ == "__main__":
    with session() as dev:
        main(dev)
