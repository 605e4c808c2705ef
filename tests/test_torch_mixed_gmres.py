"""The port's mixed-precision solvers against slate_tpu's on the CPU (split
from test_torch_mixed.py; shared inputs in torch_mixed_common.py): where
GMRES-IR stops (at the start of a restart cycle) and the fallback to the
f64 solve after MaxIterations.

Held as in test_torch_mixed.py: the same ``iters``, ``converged`` and
health flags, and X within 1e-12 relative (1e-5, the f32 tolerance, where
the result is the unconverged f32 solve).
"""

import pytest

from slate_tpu_torch.drivers import mixed

from torch_mixed_common import (  # noqa: F401  (ref_drivers: autouse)
    RTOL, SOLVERS, _agree, _problem, _run, ref_drivers)


def test_gmres_reports_the_late_stop():
    """GMRES tests convergence at the start of a cycle: a system that
    converges within two cycles reports 30 iterations in both packages
    (the third cycle only finds it converged), and the stop flag is read
    once a cycle plus once before the first."""
    a, b = _problem(6, 48)
    mixed.STOP_READS = 0
    rr, rp = _run("posv_mixed_gmres", a, b, 16)
    assert rp.iters == int(rr.iters) == 30 and rp.converged
    assert mixed.STOP_READS == 4


def test_gmres_late_stop_exhausts_the_iterations_at_n512():
    """An orthogonal A at n = 512: each GMRES cycle gains ~4-5 digits (its
    update goes through the f32 solve), so x converges in the third cycle
    and the start-of-cycle test would find it only in a fourth; at the
    default MaxIterations = 30 both packages report converged=False, and
    with MaxIterations = 60 both stop at 40, converged."""
    a, b = _problem(13, 512, nrhs=2, kind="orthogonal")
    for itmax, conv in ((30, False), (60, True)):
        rr, rp = _run("gesv_mixed_gmres", a, b, 128,
                      {"UseFallbackSolver": False, "MaxIterations": itmax})
        _agree(rr, rp, RTOL if conv else 1e-5)
        assert rp.converged is conv
        assert rp.iters == (30 if itmax == 30 else 40)


@pytest.mark.parametrize("fn", SOLVERS)
def test_fallback_after_max_iterations(fn):
    """One refinement step (one GMRES cycle) cannot reach a tolerance of
    1e-30: the loop stops unconverged and UseFallbackSolver re-solves in
    f64 (X within 1e-12); without it the result reports converged=False
    and X is the refined f32 solve, which carries the f32 factor's
    rounding (the two packages' f32 factors differ in their last bits),
    so it is held within 1e-5, the f32 tolerance."""
    a, b = _problem(8, 40, kind="spd" if fn.startswith("posv")
                    else "orthogonal")
    for fb in (True, False):
        opts = {"MaxIterations": 1 if "gmres" not in fn else 10,
                "Tolerance": 1e-30, "UseFallbackSolver": fb}
        rr, rp = _run(fn, a, b, 8, opts)
        _agree(rr, rp, RTOL if fb else 1e-5)
        assert rp.converged is fb
