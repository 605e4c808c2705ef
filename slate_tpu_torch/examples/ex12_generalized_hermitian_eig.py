"""ex12: generalized Hermitian-definite eigenproblem A x = lambda B x (port
of examples/ex12_generalized_hermitian_eig.py; ref:
ex12_generalized_hermitian_eig.cc -> hegv)."""

import numpy as np
import scipy.linalg

import slate_tpu_torch as st
from ._common import report, rng, session


def main(device="cuda"):
    r = rng()
    n, nb = 24, 6
    a = r.standard_normal((n, n))
    sym = (a + a.T) / 2
    c = r.standard_normal((n, n))
    spd = c @ c.T + n * np.eye(n)
    A = st.HermitianMatrix.from_numpy(sym, nb, device=device)
    B = st.HermitianMatrix.from_numpy(spd, nb, device=device)

    w, X = st.hegv(A, B)
    w = w.cpu().numpy()
    w_ref = scipy.linalg.eigh(sym, spd, eigvals_only=True)
    report("ex12 hegv values", float(np.abs(w - w_ref).max() /
                                     np.abs(w_ref).max()))

    xd = X.to_numpy()
    report("ex12 hegv residual", float(np.abs(
        sym @ xd - spd @ xd * w[None, :]).max() /
        (np.abs(w_ref).max() * np.linalg.norm(spd))), 1e-10)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
