"""ex11: Hermitian eigensolver (port of examples/ex11_hermitian_eig.py;
ref: ex11_hermitian_eig.cc) - two-stage reduction + tridiagonal solve,
values-only and full vectors."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import report, rng, session


def main(device="cuda"):
    r = rng()
    n, nb = 32, 8
    a = r.standard_normal((n, n))
    sym = (a + a.T) / 2
    H = st.HermitianMatrix.from_numpy(sym, nb, device=device)

    lam = api.eig_vals(H).cpu().numpy()
    lam_ref = np.linalg.eigvalsh(np.tril(sym) + np.tril(sym, -1).T)
    report("ex11 eig_vals", float(np.abs(lam - lam_ref).max() /
                                  np.abs(lam_ref).max()))

    w, Z = api.eig(H)
    zd = Z.to_numpy()
    hd = np.tril(sym) + np.tril(sym, -1).T
    report("ex11 eig residual", float(np.abs(
        hd @ zd - zd * w.cpu().numpy()[None, :]).max() /
        np.abs(lam_ref).max()), 1e-9)
    report("ex11 eig orthonormal", float(np.abs(
        zd.T @ zd - np.eye(n)).max()), 1e-9)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
