"""ex05: parallel BLAS-3 (port of examples/ex05_blas.py; ref:
ex05_blas.cc:13-42 - gemm, hemm, herk, trsm on distributed matrices),
through the simplified API verbs."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    n, nb = 32, 8
    a = r.standard_normal((n, n))
    b = r.standard_normal((n, n))
    A = st.Matrix.from_numpy(a, nb, nb, g)
    B = st.Matrix.from_numpy(b, nb, nb, g)

    C = api.multiply(1.0, A, B)                     # gemm
    report("ex05 multiply (gemm)", float(np.abs(C.to_numpy() - a @ b).max()),
           1e-9)

    H = st.HermitianMatrix.from_numpy(a, nb, grid=g)
    hd = np.tril(a) + np.tril(a, -1).T
    C2 = api.multiply(1.0, H, B)                    # hemm dispatch
    report("ex05 multiply (hemm)", float(np.abs(C2.to_numpy() - hd @ b).max()),
           1e-9)

    Csym = st.HermitianMatrix.from_numpy(np.zeros((n, n)), nb, grid=g)
    C3 = api.rank_k_update(1.0, A, 0.0, Csym)       # herk
    report("ex05 rank_k_update", float(np.abs(
        C3.to_numpy() - a @ a.T).max()), 1e-9)

    spd = a @ a.T + n * np.eye(n)
    L = np.linalg.cholesky(spd)
    Lt = st.TriangularMatrix.from_numpy(L, nb, uplo=st.Uplo.Lower, grid=g)
    X = api.triangular_solve(1.0, Lt, B)            # trsm
    report("ex05 triangular_solve", float(np.abs(
        L @ X.to_numpy() - b).max()), 1e-9)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
