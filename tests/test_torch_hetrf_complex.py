"""The complex128 cases of the port's blocked Aasen parity test, hetrf
and hetrs against slate_tpu's on the CPU (split from test_torch_hetrf.py,
whose float64 cases take the same shapes, so that a loadfile run spreads
them over workers; the check is torch_hetrf_common.py's).
"""

import torch_threads  # noqa: F401  (one compute thread a worker)
import numpy as np
import pytest

from torch_hetrf_common import (  # noqa: F401  (ref_drivers: autouse)
    SHAPES, check_hetrf_matches_the_reference, ref_drivers)


@pytest.mark.parametrize("dtype", [np.complex128])
@pytest.mark.parametrize("n,nb", SHAPES)
def test_hetrf_matches_the_reference(dtype, n, nb):
    check_hetrf_matches_the_reference(dtype, n, nb)
