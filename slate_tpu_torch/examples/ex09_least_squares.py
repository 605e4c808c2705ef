"""ex09: least squares (port of examples/ex09_least_squares.py; ref:
ex09_least_squares.cc) - gels via QR and CholQR, plus an explicit
qr_factor / multiply_by_q."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    m, n, nb = 48, 16, 8
    a = r.standard_normal((m, n))
    b = r.standard_normal((m, 2))
    A = st.Matrix.from_numpy(a, nb, nb, g)
    B = st.Matrix.from_numpy(b, nb, nb, g)
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]

    X = api.least_squares_solve(A, B)
    report("ex09 least_squares_solve", float(np.linalg.norm(
        X.to_numpy()[:n] - x_ref) / np.linalg.norm(x_ref)), 1e-8)

    opts = {st.Option.MethodGels: st.MethodGels.CholQR}
    X2 = st.gels(A, B, opts)
    report("ex09 gels CholQR", float(np.linalg.norm(
        X2.to_numpy()[:n] - x_ref) / np.linalg.norm(x_ref)), 1e-8)

    F = api.qr_factor(A)
    QtB = api.qr_multiply_by_q(st.Side.Left, "c", F, B)
    # R x = Q^H b gives the same LS solution
    Rd = np.triu(F.QR.to_numpy()[:n, :n])
    x3 = np.linalg.solve(Rd, QtB.to_numpy()[:n])
    report("ex09 qr_factor path", float(np.linalg.norm(
        x3 - x_ref) / np.linalg.norm(x_ref)), 1e-8)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
