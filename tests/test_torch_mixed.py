"""The port's mixed-precision solvers against slate_tpu's, on the CPU:
gesv_mixed, posv_mixed and their GMRES-IR variants, with the options they
read (MaxIterations, Tolerance, UseFallbackSolver, Speculate).

The same numpy inputs, from a seed, go through both packages, f64 (and
c128) systems factored in f32 (c64).  Held: the same ``iters`` and
``converged`` (GMRES included, which tests convergence at the start of a
restart cycle, so a converged x costs one more cycle), the same health
flags, and X within 1e-12 relative.  An f32 system would factor in bf16,
which the reference refuses on the CPU (XLA: unsupported dtype); the
port raises SlateUnsupportedDtypeError.  The reference's drivers are
wrapped in ``@annotate``, which calls ``jax.core.trace_state_clean``; the
installed JAX no longer exports that name, so the ``ref_drivers``
fixture restores it on the test side only.  The shared inputs are in
torch_mixed_common.py; the n = 33 shape, c128, the ill-conditioned and
Speculate cases are in test_torch_mixed_c128.py, the GMRES late stops and
the fallback after MaxIterations in test_torch_mixed_gmres.py.
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest
import torch

import slate_tpu_torch as st
from slate_tpu_torch.drivers import mixed
from slate_tpu_torch.types import lower_precision

from torch_mixed_common import (  # noqa: F401  (ref_drivers: autouse)
    SOLVERS, _agree, _problem, _run, _run_ref_only, ref_drivers)


@pytest.mark.parametrize("fn", SOLVERS)
@pytest.mark.parametrize("n,nb", [(64, 16), (70, 16)])
def test_mixed_matches_the_reference(fn, n, nb):
    a, b = _problem(n, n, kind="spd" if fn.startswith("posv")
                    else "orthogonal")
    rr, rp = _run(fn, a, b, nb)
    _agree(rr, rp)
    assert rp.converged and rp.X.dtype == torch.float64


def test_refine_reads_its_stop_flag_once_a_step():
    a, b = _problem(7, 48)
    mixed.STOP_READS = 0
    rr, rp = _run("posv_mixed", a, b, 16)
    assert mixed.STOP_READS == rp.iters + 1 == int(rr.iters) + 1


def test_per_column_stop_test():
    """Columns of B scaled 1e-8 .. 1e8 apart: the stop test is per column
    (colNorms), so both packages take the same number of steps."""
    a, b = _problem(10, 48, nrhs=4, kind="orthogonal",
                    scale=[1e-8, 1.0, 1e4, 1e8])
    rr, rp = _run("gesv_mixed", a, b, 16)
    _agree(rr, rp)


def test_lower_precision_table():
    assert lower_precision(torch.float64) == torch.float32
    assert lower_precision(torch.complex128) == torch.complex64
    assert lower_precision(torch.float32) == torch.bfloat16
    assert lower_precision(torch.int32) == torch.int32


@pytest.mark.parametrize("fn", SOLVERS)
def test_f32_system_raises_unsupported_dtype(fn):
    """An f32 system factors in bf16: the reference's factorizations raise
    on the CPU (XLA has no bf16 Cholesky or LU there), and the port raises
    SlateUnsupportedDtypeError naming bfloat16 rather than factor in f32."""
    a, b = _problem(12, 32, kind="spd")
    a, b = a.astype(np.float32), b.astype(np.float32)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        _run_ref_only(fn, a, b)
    herm = fn.startswith("posv")
    A = (st.HermitianMatrix if herm else st.Matrix).from_numpy(
        a, 8, device="cpu")
    with pytest.raises(st.SlateUnsupportedDtypeError) as e:
        getattr(st, fn)(A, st.Matrix.from_numpy(b, 8, device="cpu"))
    assert e.value.dtype == "bfloat16"
