"""ex03: submatrix and transpose views (port of examples/ex03_submatrix.py;
ref: ex03_submatrix.cc).

sub() selects a tile-aligned block; transpose/conj_transpose are
metadata-only op flips, exactly the reference's view semantics."""

import numpy as np

import slate_tpu_torch as st
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    m, n, nb = 32, 32, 8
    a = r.standard_normal((m, n))
    A = st.Matrix.from_numpy(a, nb, nb, g)

    S = A.sub(1, 2, 0, 1)                  # tile rows 1:2, tile cols 0:1
    report("ex03 sub view", float(np.abs(
        S.to_numpy() - a[8:24, 0:16]).max()))

    T = A.transpose()
    report("ex03 transpose view", float(np.abs(T.to_numpy() - a.T).max()))

    # views compose with compute: gemm on a transposed view
    C = st.gemm(1.0, A.transpose(), A)
    report("ex03 gemm(A^T, A)", float(np.abs(C.to_numpy() - a.T @ a).max()),
           1e-9)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
