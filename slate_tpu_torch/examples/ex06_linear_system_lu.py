"""ex06: LU linear systems (port of examples/ex06_linear_system_lu.py; ref:
ex06_linear_system_lu.cc) - lu_solve, factor/solve split, tournament
pivoting, mixed precision."""

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
    a = r.standard_normal((n, n)) + n * np.eye(n)
    b = r.standard_normal((n, 4))
    A = st.Matrix.from_numpy(a, nb, nb, g)
    B = st.Matrix.from_numpy(b, nb, nb, g)

    X = api.lu_solve(A, B)
    report("ex06 lu_solve", float(np.linalg.norm(a @ X.to_numpy() - b) /
                                  np.linalg.norm(b)))

    F = api.lu_factor(A)
    X2 = api.lu_solve_using_factor(F, B)
    report("ex06 factor+solve", float(np.linalg.norm(
        a @ X2.to_numpy() - b) / np.linalg.norm(b)))

    opts = {st.Option.MethodLU: st.MethodLU.CALU}
    _, X3 = st.gesv(A, B, opts)
    report("ex06 CALU (tntpiv)", float(np.linalg.norm(
        a @ X3.to_numpy() - b) / np.linalg.norm(b)))

    # mixed precision: f32 factor + f64 refinement
    res = st.gesv_mixed(st.Matrix.from_numpy(a, nb, device=device),
                        st.Matrix.from_numpy(b, nb, device=device))
    assert bool(res.converged)
    report("ex06 gesv_mixed", float(np.linalg.norm(
        a @ res.X.to_numpy() - b) / np.linalg.norm(b)))

    Ainv = api.lu_inverse_using_factor_out_of_place(A)
    report("ex06 inverse", float(np.linalg.norm(
        Ainv.to_numpy() @ a - np.eye(n))), 1e-8)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
