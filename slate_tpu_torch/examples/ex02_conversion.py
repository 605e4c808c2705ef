"""ex02: conversions between matrix types (port of
examples/ex02_conversion.py; ref: ex02_conversion.cc).

Reinterpret a general matrix's triangle as Triangular/Symmetric/Hermitian
(metadata-only views), convert structured back to general, and do a
precision-converting copy."""

import numpy as np
import torch

import slate_tpu_torch as st
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    n, nb = 24, 6
    a = r.standard_normal((n, n))
    A = st.Matrix.from_numpy(a, nb, nb, g)

    L = A.triangular(st.Uplo.Lower)
    report("ex02 triangular view", float(np.abs(
        L.to_numpy() - np.tril(a)).max()))

    H = A.hermitian(st.Uplo.Lower)
    hd = np.tril(a) + np.tril(a, -1).T
    report("ex02 hermitian expand", float(np.abs(H.to_numpy() - hd).max()))

    G = H.general()                         # materialized general copy
    assert type(G) is st.Matrix
    report("ex02 general()", float(np.abs(G.to_numpy() - hd).max()))

    # precision-converting copy (ref: slate::copy f64 -> f32)
    B32 = st.Matrix.zeros(n, n, nb, nb, g, torch.float32)
    B32 = st.copy(A, B32)
    report("ex02 f64->f32 copy", float(np.abs(
        B32.to_numpy() - a.astype(np.float32)).max()), 1e-6)


if __name__ == "__main__":
    with session() as dev:
        main(dev)
