"""ex08: Hermitian-indefinite solve via Aasen's factorization (port of
examples/ex08_linear_system_indefinite.py; ref:
ex08_linear_system_indefinite.cc -> hesv)."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import report, rng, session


def main(device="cuda"):
    r = rng()
    n, nb = 32, 8
    a = r.standard_normal((n, n))
    sym = a + a.T                           # indefinite symmetric
    b = r.standard_normal((n, 2))
    H = st.HermitianMatrix.from_numpy(sym, nb, device=device)
    B = st.Matrix.from_numpy(b, nb, device=device)

    X = api.indefinite_solve(H, B)
    report("ex08 indefinite_solve", float(np.linalg.norm(
        sym @ X.to_numpy() - b) / np.linalg.norm(b)), 1e-8)

    F = api.indefinite_factor(H)
    X2 = api.indefinite_solve_using_factor(F, B)
    report("ex08 factor+solve", float(np.linalg.norm(
        sym @ X2.to_numpy() - b) / np.linalg.norm(b)), 1e-8)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
