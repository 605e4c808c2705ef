"""The port's blocked Aasen, hetrf and hetrs, against slate_tpu's on the
CPU (the Hermitian-indefinite layer's tests are split over
test_torch_hetrf*.py so that a loadfile run spreads them over workers,
the complex128 cases of the parity test in test_torch_hetrf_complex.py;
shared inputs and the parity check in torch_hetrf_common.py).

The same numpy inputs, from a seed, go through both packages.
Tolerances: f64 and c128 factors and solves within 1e-12 relative (the
symmetric permutation equal).  The reference's drivers are wrapped in
``@annotate``, which calls ``jax.core.trace_state_clean``; the installed
JAX no longer exports that name, so the ``ref_drivers`` fixture restores
it on the test side only.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu_torch as st

from torch_hetrf_common import (  # noqa: F401  (ref_drivers: autouse)
    SHAPES, _indef, check_hetrf_matches_the_reference, ref_drivers)


# ------------------------------------------------------------- hetrf

@pytest.mark.parametrize("dtype", [np.float64])
@pytest.mark.parametrize("n,nb", SHAPES)
def test_hetrf_matches_the_reference(dtype, n, nb):
    check_hetrf_matches_the_reference(dtype, n, nb)


def test_hetrf_rejects_complex_symmetric():
    a = _indef(5, 16, np.complex128)
    with pytest.raises(st.SlateValueError):
        st.hetrf(st.SymmetricMatrix.from_numpy(a, 8, device="cpu"))
    with pytest.raises(st.SlateValueError):
        st.hetrf(st.Matrix.from_numpy(a, 8, device="cpu"))


def test_hetrf_mesh_without_group_takes_the_single_route():
    """The mesh Aasen is ported (tests/test_torch_dist_lu.py holds it on
    grids with a process group); Target.mesh on a grid without one takes
    the single route, as the reference's hetrf does where the grid has no
    mesh: the same bits as the default target."""
    P = st.HermitianMatrix.from_numpy(_indef(6, 16), 8, device="cpu")
    F = st.hetrf(P, {st.Option.Target: st.Target.mesh})
    G = st.hetrf(P)
    for x, y in zip(F, G):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
