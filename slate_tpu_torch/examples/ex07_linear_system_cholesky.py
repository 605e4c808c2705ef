"""ex07: Cholesky linear systems (port of
examples/ex07_linear_system_cholesky.py; ref:
ex07_linear_system_cholesky.cc) - chol_solve, factor/solve split,
inverse, condition estimate."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import grid, report, rng, say, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    n, nb = 32, 8
    a = r.standard_normal((n, n))
    spd = a @ a.T + n * np.eye(n)
    b = r.standard_normal((n, 3))
    H = st.HermitianMatrix.from_numpy(spd, nb, grid=g)
    B = st.Matrix.from_numpy(b, nb, nb, g)

    X = api.chol_solve(H, B)
    report("ex07 chol_solve", float(np.linalg.norm(
        spd @ X.to_numpy() - b) / np.linalg.norm(b)))

    L = api.chol_factor(H)
    X2 = api.chol_solve_using_factor(L, B)
    report("ex07 factor+solve", float(np.linalg.norm(
        spd @ X2.to_numpy() - b) / np.linalg.norm(b)))

    Hinv = api.chol_inverse_using_factor(L)
    report("ex07 potri", float(np.linalg.norm(
        Hinv.to_numpy() @ spd - np.eye(n))), 1e-7)

    F = st.getrf(st.Matrix.from_numpy(spd, nb, nb, g))
    rcond = float(st.gecondest(F, st.norm(
        st.Norm.One, st.Matrix.from_numpy(spd, nb, nb, g))))
    true_rcond = 1.0 / np.linalg.cond(spd, 1)
    # 1-norm estimator is within a small factor of truth
    assert 0.05 * true_rcond < rcond <= 3 * true_rcond + 1e-30
    say(f"ex07 gecondest rcond {rcond:.3e} (true {true_rcond:.3e})  PASS")


if __name__ == "__main__":
    with session() as dev:
        main(dev)
