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
  tournament round's pivots, K3 factors the permuted panel and forms its
  U^-1 in the same launch) and NoPiv (``getrf_nopiv``, ``gesv_nopiv``:
  K3), plus ``getrf_rbt``, ``getri`` and ``getriOOP``;
- QR and least squares, ``geqrf``/``gelqf``/``unmqr``/``unmlq``/
  ``qr_multiply``, ``cholqr``, ``gels_cholqr``, ``gels_qr`` and ``gels``
  (``MethodGels``: CholQR through herk, potrf and trsm; Householder QR
  through K5, the Householder panel with its compact-WY T);
- the rest of BLAS-3 on the single device: ``gemm`` (``gemmA``,
  ``gemmC``), ``trmm``, ``herk``/``syrk``/``her2k``/``syr2k`` and
  ``hemm``/``symm``, besides ``trsm``;
- serving, ``serve.Server``: mixed-size ``solve``/``chol_solve``/
  ``least_squares_solve`` requests packed into identity-augmented bucket
  batches whose fast rung is one ragged batched factorization through K6
  (batched Cholesky panel), K7 (batched no-pivot LU panel) or K8 (batched
  Householder panel), with per-problem escalation to the single-problem
  drivers, admission control, poison quarantine and the certified bf16
  rung (``robust/certify.py``, ``robust/precision.py``);
- robustness on those paths: ``Option.Abft`` (Huang-Abraham checksums
  that locate and repair a single corrupted element of every panel step,
  ``robust/abft.py``), the fault sites of ``robust/faults.py``, and
  ``Option.Speculate`` (the certified RBT rung of gesv, the bf16 rung of
  posv, the CholQR2 and bf16 QR rungs of gels, ``robust/recovery.py``),
  with the analytic flop model ``obs/flops.py`` that prices them.

Matrices are placed on CUDA unless the caller passes ``device="cpu"``;
with no GPU, ``device=None`` raises.  On CPU tensors every kernel wrapper
runs its plain PyTorch version, which the tests compare with slate_tpu.
"""

import torch

# The reference's f32 products are Precision.HIGHEST (pallas_chol.py:60):
# no TF32 anywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .types import Diag, Norm, Op, Side, TileKind, Uplo  # noqa: E402,F401
from .options import (  # noqa: E402,F401
    Abft, ErrorPolicy, GridOrder, MethodCholQR, MethodGels, MethodGemm,
    MethodHemm, MethodLU, NormScope, Option, Precision, Speculate, Target,
)
from .version import __version__  # noqa: E402,F401
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
from .drivers.blas3 import (  # noqa: E402,F401
    gemm, gemmA, gemmC, hemm, hemmA, her2k, herk, symm, syr2k, syrk, trmm,
    trsm,
)
from .drivers.auxiliary import add, norm  # noqa: E402,F401
from .drivers.cholesky import posv, potrf, potrs  # noqa: E402,F401
from .drivers.lu import (  # noqa: E402,F401
    LUFactors, RBTFactors, gesv, gesv_nopiv, getrf, getrf_nopiv, getrf_ooc,
    getrf_rbt, getrf_tntpiv, getri, getriOOP, getrs,
)
from .drivers.qr import (  # noqa: E402,F401
    LQFactors, QRFactors, cholqr, gelqf, gels, gels_cholqr, gels_qr, geqrf,
    qr_multiply, unmlq, unmqr,
)
from . import serve  # noqa: E402,F401
