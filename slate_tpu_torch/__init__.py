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
- mixed precision, ``gesv_mixed``/``posv_mixed`` and their GMRES-IR
  variants: factor in ``lower_precision`` (an f64 system on the f32
  kernels: K2 and K0 for posv, K3 under ``Option.Speculate`` for gesv),
  refine in the working precision;
- band (``pbsv``/``gbsv``/``tbsm``/``gbmm``/``hbmm`` on packed band
  storage) and Hermitian indefinite (``hesv``, blocked Aasen) solvers,
  posv's fallback hesv -> gesv, the auxiliary drivers (copy, scale, set,
  redistribute, ...), inverses (``trtri``, ``trtrm``, ``potri``),
  condition estimates, printing, the test-matrix generator and the
  simplified ``api`` (its batch verbs over the serving cores);
- the spectral drivers: ``heev``/``heevd``/``heev_vals`` (two-stage:
  he2hb band reduction, then the library's eigh of the band, or under
  ``MethodEig`` QR and DC the hb2st bulge chase and the library's eigh of
  T or the native divide and conquer ``stedc``), ``svd``/``svd_vals``
  (ge2tb, then the library's SVD of the band, or under ``MethodSvd``
  Bidiag the tb2bd chase and ``bdsqr``), ``hegv``/``hegst`` (B factored by
  ``potrf``: K2 and K0 on the card), ``sterf``, ``steqr``, ``hb2st`` and
  ``tb2bd``, every result certified (``certify_eig``, ``certify_svd``) and
  escalated along Auto -> DC -> QR and Auto -> Bidiag on failure;
- robustness on those paths: ``Option.Abft`` (Huang-Abraham checksums
  that locate and repair a single corrupted element of every panel step,
  ``robust/abft.py``), the fault sites of ``robust/faults.py``, and
  ``Option.Speculate`` (the certified RBT rung of gesv, the bf16 rung of
  posv, the CholQR2 and bf16 QR rungs of gels, ``robust/recovery.py``),
  with the analytic flop model ``obs/flops.py`` that prices them;
- tuning and telemetry: the plan cache every kernel seam resolves through
  (``tune``; ``python -m slate_tpu_torch.tune`` measures each kernel
  against its library route on the card and persists the winners), one
  ``slate-obs-v1`` event per public driver call, recorded spans, and the
  metrics, compare and SLO command lines (``obs``; ``python -m
  slate_tpu_torch.obs``);
- durable jobs: ``potrf_ooc`` (K1 for each f32 diagonal tile of width <=
  128) and ``getrf_ooc``, out-of-core factorizations of a host matrix
  streamed through the card by a ``TileMap`` (pinned host bytes, copies on
  a side stream), with panel-boundary checkpoints and a bit-identical
  resume (``robust/checkpoint.py``, ``CheckpointManager``);
- compatibility: the ScaLAPACK descriptors and ``pd*`` routines, the
  LAPACK-style shims, the buffer-pointer entry points of an embedded C
  API (``native/slate_tpu_torch_capi.h``) and its Fortran module
  (``compat``), and the host tile packing of ``native.py`` in numpy;
- the distributed BLAS-3 and Cholesky layer, SPMD over
  ``torch.distributed`` (one rank a device, as SLATE's MPI ranks): a
  ``Grid(p, q, group=...)`` shards every matrix 2D block-cyclically, each
  rank holding only its own tiles (``core/storage.py``), and ``gemm``
  (SUMMA and gemmA), ``hemm``, ``trsm``, ``trmm``, the rank-k updates,
  ``potrf``/``potrs``/``posv`` and ``trtri`` take their mesh routes
  (``parallel/``, over the collectives of ``comm/``); the distributed
  Cholesky factors each diagonal tile through K1.

Matrices are placed on CUDA unless the caller passes ``device="cpu"``;
with no GPU, ``device=None`` raises.  On CPU tensors every kernel wrapper
runs its plain PyTorch version, which the tests compare with slate_tpu.
"""

import torch

# The reference's f32 products are Precision.HIGHEST (pallas_chol.py:60):
# no TF32 anywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .types import (  # noqa: E402,F401
    Diag, Layout, Norm, Op, Side, TileKind, Uplo,
)
from .options import (  # noqa: E402,F401
    Abft, ErrorPolicy, GridOrder, MethodCholQR, MethodEig, MethodGels,
    MethodGemm, MethodHemm, MethodLU, MethodSvd, MethodTrsm, NormScope,
    Option,
    Precision, Speculate, Target,
)
from .version import __version__, id, version  # noqa: E402,F401
from .exceptions import (  # noqa: E402,F401
    SlateError, SlateNotConvergedError, SlateNotPositiveDefiniteError,
    SlateSingularError, SlateUnsupportedDtypeError, SlateValueError,
)
from .core.grid import Grid, make_grid  # noqa: E402,F401
from .core.storage import TileMap, TileStorage  # noqa: E402,F401
from .core.matrix import (  # noqa: E402,F401
    BandMatrix, BaseBandMatrix, BaseMatrix, BaseTrapezoidMatrix,
    HermitianBandMatrix, HermitianMatrix, Matrix, SymmetricMatrix,
    TrapezoidMatrix, TriangularBandMatrix, TriangularMatrix,
)
from . import robust  # noqa: E402,F401
from .robust.health import HealthInfo  # noqa: E402,F401
from .tune.plans import (  # noqa: E402,F401
    CUDA_PLAN, LIBRARY_PLAN, TilePlan, plan_override,
)
from .drivers.blas3 import (  # noqa: E402,F401
    gemm, gemmA, gemmC, hemm, hemmA, her2k, herk, symm, syr2k, syrk, trmm,
    trsm,
)
from .drivers.auxiliary import (  # noqa: E402,F401
    add, col_norms, copy, norm, redistribute, scale, scale_row_col, set,
)
from .drivers.cholesky import (  # noqa: E402,F401
    posv, potrf, potrf_ooc, potri, potrs,
)
from .drivers.inverse import trtri, trtrm  # noqa: E402,F401
from .drivers.lu import (  # noqa: E402,F401
    LUFactors, OocLUFactors, RBTFactors, gesv, gesv_nopiv, getrf,
    getrf_nopiv, getrf_ooc, getrf_rbt, getrf_tntpiv, getri, getriOOP, getrs,
)
from .drivers.qr import (  # noqa: E402,F401
    CAQRFactors, LQFactors, QRFactors, cholqr, gelqf, gels, gels_cholqr,
    gels_qr, geqrf, qr_multiply, unmlq, unmqr,
)
from .drivers.band import (  # noqa: E402,F401
    GBFactors, PBFactors, gbmm, gbsv, gbtrf, gbtrs, hbmm, pbsv, pbtrf,
    pbtrs, tbsm,
)
from .drivers.printing import format_matrix, print_matrix  # noqa: E402,F401
from .drivers.condest import gecondest, norm1est, trcondest  # noqa: E402,F401
from .drivers.hetrf import HEFactors, hesv, hetrf, hetrs  # noqa: E402,F401
from .drivers.mixed import (  # noqa: E402,F401
    MixedResult, gesv_mixed, gesv_mixed_gmres, posv_mixed, posv_mixed_gmres,
)
from .drivers.heev import (  # noqa: E402,F401
    hb2st, heev, heev_vals, heevd, hegst, hegv, steqr, sterf,
)
from .drivers.stedc import stedc  # noqa: E402,F401
from .drivers.svd import bdsqr, svd, svd_vals, tb2bd  # noqa: E402,F401
from .util.generator import (  # noqa: E402,F401
    generate_hermitian, generate_matrix,
)
from .robust.checkpoint import CheckpointManager  # noqa: E402,F401
from . import api, compat, obs, serve, tune  # noqa: E402,F401
