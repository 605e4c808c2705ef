"""slate_tpu_torch: the PyTorch/CUDA port of slate_tpu for one NVIDIA H100.

The JAX package ``slate_tpu`` stays the reference; this package reproduces
it slice by slice, with each of its Pallas TPU kernels rewritten by hand
as a CUDA kernel for Hopper (``csrc/``, built with nvcc for sm_90a at
first use).  The ported slices carry the single-device solvers on tiled
``Matrix`` classes:

- Cholesky, ``posv``/``potrf``/``potrs``, through the kernels K0
  (triangular inverse), K1 (tile Cholesky) and K2 (fused panel step);
- LU, ``gesv``/``getrf``/``getrs`` with ``MethodLU`` PartialPiv (the
  library's pivoted LU), CALU (``getrf_tntpiv``: K4 selects each
  tournament round's pivots, K3 factors the permuted panel, K0 between)
  and NoPiv (``getrf_nopiv``, ``gesv_nopiv``: K3), plus ``getrf_rbt``,
  ``getri`` and ``getriOOP``.

Matrices are placed on CUDA unless the caller passes ``device="cpu"``;
with no GPU, ``device=None`` raises.  On CPU tensors every kernel wrapper
runs its plain PyTorch version, which the tests compare with slate_tpu.
"""

import torch

# The reference's f32 products are Precision.HIGHEST (pallas_chol.py:60):
# no TF32 anywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .types import Diag, Op, Side, TileKind, Uplo  # noqa: E402,F401
from .options import (  # noqa: E402,F401
    Abft, ErrorPolicy, GridOrder, MethodLU, Option, Precision, Speculate,
    Target,
)
from .exceptions import (  # noqa: E402,F401
    SlateError, SlateNotConvergedError, SlateNotPositiveDefiniteError,
    SlateSingularError, SlateUnsupportedDtypeError, SlateValueError,
)
from .core.grid import Grid  # noqa: E402,F401
from .core.storage import TileStorage  # noqa: E402,F401
from .core.matrix import (  # noqa: E402,F401
    BaseMatrix, BaseTrapezoidMatrix, HermitianMatrix, Matrix,
    SymmetricMatrix, TriangularMatrix,
)
from .robust.health import HealthInfo  # noqa: E402,F401
from .tune.plans import (  # noqa: E402,F401
    CUDA_PLAN, LIBRARY_PLAN, TilePlan, plan_override,
)
from .drivers.blas3 import trsm  # noqa: E402,F401
from .drivers.cholesky import posv, potrf, potrs  # noqa: E402,F401
from .drivers.lu import (  # noqa: E402,F401
    LUFactors, RBTFactors, gesv, gesv_nopiv, getrf, getrf_nopiv, getrf_ooc,
    getrf_rbt, getrf_tntpiv, getri, getriOOP, getrs,
)
