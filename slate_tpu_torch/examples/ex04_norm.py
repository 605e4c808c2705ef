"""ex04: matrix norms across types (port of examples/ex04_norm.py; ref:
ex04_norm.cc)."""

import numpy as np

import slate_tpu_torch as st
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 4, device)
    if g is None:
        return
    m, n, nb = 36, 28, 8
    a = r.standard_normal((m, n))
    A = st.Matrix.from_numpy(a, nb, nb, g)

    checks = [
        ("Max", st.Norm.Max, np.abs(a).max()),
        ("One", st.Norm.One, np.abs(a).sum(axis=0).max()),
        ("Inf", st.Norm.Inf, np.abs(a).sum(axis=1).max()),
        ("Fro", st.Norm.Fro, np.linalg.norm(a)),
    ]
    for name, nt, ref in checks:
        got = float(st.norm(nt, A))
        report(f"ex04 ge norm {name}", abs(got - ref) / ref)

    h = a[:28, :28]
    H = st.HermitianMatrix.from_numpy(h, nb, grid=g)
    hd = np.tril(h) + np.tril(h, -1).T
    report("ex04 he norm One",
           abs(float(st.norm(st.Norm.One, H)) -
               np.abs(hd).sum(axis=0).max()) / np.abs(hd).sum())

    cn = st.col_norms(A)
    report("ex04 col_norms", float(np.abs(
        cn.cpu().numpy() - np.abs(a).max(axis=0)).max()))


if __name__ == "__main__":
    with session() as dev:
        main(dev)
