"""The port's mixed-precision solvers against slate_tpu's on the CPU (split
from test_torch_mixed.py; shared inputs in torch_mixed_common.py): the
parity at n = 33 (nb = 8, a ragged last tile), complex128 systems factored
in complex64, the cond-1e9 fallback and gesv_mixed under Speculate.

Held as in test_torch_mixed.py: the same ``iters``, ``converged`` and
health flags, and X within 1e-12 relative (1e-12 * cond where cond is
1e9).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

from torch_mixed_common import (  # noqa: F401  (ref_drivers: autouse)
    RTOL, SOLVERS, _agree, _problem, _run, ref_drivers)


@pytest.mark.parametrize("fn", SOLVERS)
@pytest.mark.parametrize("n,nb", [(33, 8)])
def test_mixed_matches_the_reference(fn, n, nb):
    a, b = _problem(n, n, kind="spd" if fn.startswith("posv")
                    else "orthogonal")
    rr, rp = _run(fn, a, b, nb)
    _agree(rr, rp)
    assert rp.converged and rp.X.dtype == torch.float64


@pytest.mark.parametrize("fn", SOLVERS)
def test_mixed_complex128(fn):
    a, b = _problem(5, 40, dtype=np.complex128,
                    kind="spd" if fn.startswith("posv") else "orthogonal")
    rr, rp = _run(fn, a, b, 8)
    _agree(rr, rp)
    assert rp.X.dtype == torch.complex128


@pytest.mark.parametrize("fn", ["gesv_mixed", "gesv_mixed_gmres"])
def test_ill_conditioned_falls_back(fn):
    """cond 1e9: the f32 factor cannot refine to f64 within 30 steps
    (gesv_mixed) or 3 cycles (GMRES); both packages fall back alike.  An
    f64 solve of a system with cond 1e9 is determined to ~1e9 eps, so the
    two X agree within 1e-12 * cond, and each has a backward error under
    1e-14."""
    a, b = _problem(9, 48, kind=9)
    rr, rp = _run(fn, a, b, 16)
    _agree(rr, rp, RTOL * 1e9)
    for x in (rp.X.to_numpy(), np.asarray(rr.X.to_numpy())):
        res = np.abs(b - a @ x).max() / (np.abs(a).sum(1).max()
                                         * np.abs(x).max())
        assert res <= 1e-14


def test_gesv_mixed_speculate_takes_the_rbt_factor():
    a, b = _problem(11, 64)
    a = a + 64 * np.eye(64)
    rr, rp = _run("gesv_mixed", a, b, 16, {"Speculate": "on"})
    _agree(rr, rp)
    assert rp.converged
