"""ex14: ScaLAPACK interop (port of examples/ex14_scalapack_gemm.py; ref:
ex14_scalapack_gemm.cc - PDGEMM wrapper).

A legacy app hands over its per-process block-cyclic local arrays + array
descriptor; the framework assembles them, multiplies, and hands back
ScaLAPACK-layout results."""

import numpy as np

import slate_tpu_torch as st
from slate_tpu_torch.compat import (descinit, from_scalapack, numroc,
                                    to_scalapack)
from ._common import grid, report, rng, session


def main(device="cuda"):
    r = rng()
    g = grid(2, 2, device)
    if g is None:
        return
    m, n, k, mb, nb = 36, 28, 20, 8, 8
    a = r.standard_normal((m, k))
    b = r.standard_normal((k, n))

    # the "legacy app": chop a into ScaLAPACK local pieces by hand
    desc_a, locals_a = to_scalapack(st.Matrix.from_numpy(a, mb, nb, g))
    desc_b, locals_b = to_scalapack(st.Matrix.from_numpy(b, mb, nb, g))
    assert desc_a[2:6] == (m, k, mb, nb)
    ml = numroc(m, mb, 0, 0, g.p)
    assert locals_a[(0, 0)].shape[0] == ml

    # import -> compute -> export
    A = from_scalapack(desc_a, locals_a, g)
    B = from_scalapack(desc_b, locals_b, g)
    report("ex14 from_scalapack", float(np.abs(A.to_numpy() - a).max()))
    C = st.gemm(1.0, A, B)
    desc_c, locals_c = to_scalapack(C)
    # reassemble what the legacy app would hold
    C2 = from_scalapack(desc_c, locals_c, g)
    report("ex14 pdgemm round-trip", float(np.abs(
        C2.to_numpy() - a @ b).max()), 1e-10)

    d2 = descinit(m, n, mb, nb, g)
    assert d2[8] == numroc(m, mb, 0, 0, g.p)  # LLD = max local rows


if __name__ == "__main__":
    with session() as dev:
        main(dev)
