"""One compute thread for each test process of the port's CPU tests.

The suite runs under pytest-xdist: several worker processes share the
host's cores.  Left alone, each worker's torch (OpenMP, MKL) and numpy
(OpenBLAS) pools start a thread per core, and their idle threads spin
while the other workers compute.  With six workers on an eight-core host
(the tier-1 command) that cost ~30% of the CPU time and ~25% of the wall
(PERF.md, CHANGES.md).  Every ``tests/test_torch_*.py`` that runs on the
CPU imports this module, which caps those pools at one thread in its
process.  It changes what a library call sums in which order, never what
a test checks.  Without threadpoolctl (the repo does not declare it) the
cap falls back to torch's own pool and the environment variables that the
BLAS pools read when they start: a pool already started keeps its size.
"""

import os

import torch

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ[_var] = "1"
else:
    threadpool_limits(1)
