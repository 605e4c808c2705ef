"""ex10: singular value decomposition (port of examples/ex10_svd.py; ref:
ex10_svd.cc)."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch import api
from ._common import report, rng, session


def main(device="cuda"):
    r = rng()
    m, n, nb = 40, 24, 8
    a = r.standard_normal((m, n))
    A = st.Matrix.from_numpy(a, nb, device=device)

    s = api.svd_vals(A).cpu().numpy()
    s_ref = np.linalg.svd(a, compute_uv=False)
    report("ex10 svd_vals", float(np.abs(s - s_ref).max() / s_ref[0]))

    s2, U, V = api.svd(A)
    ud, vd = U.to_numpy(), V.to_numpy()
    recon = ud[:, :n] @ np.diag(s2.cpu().numpy()) @ vd[:, :n].T.conj()
    report("ex10 svd reconstruct", float(np.abs(recon - a).max() /
                                         s_ref[0]), 1e-9)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
