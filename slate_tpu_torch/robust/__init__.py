"""robust layer of slate_tpu_torch (see the package docstring): health,
certificates, the precision policy, fault injection, the Huang-Abraham
checksum rungs, the recovery ladders and the durable panel-boundary
checkpoints of the out-of-core drivers."""

from .health import (  # noqa: F401
    HealthInfo, error_policy, finalize, finalize_flat, from_pivots,
    from_result, healthy, merge, poison,
)
from .certify import (  # noqa: F401
    certify_eig, certify_ldlt, certify_svd, tolerance,
)
from .precision import normalize_dtype, resolve_precision  # noqa: F401
from .faults import FaultPlan, inject, maybe_corrupt  # noqa: F401
from .recovery import (  # noqa: F401
    bounded_retry, gesv_with_recovery, heev_with_recovery,
    hesv_with_recovery, posv_with_recovery, svd_with_recovery,
)
from .checkpoint import (  # noqa: F401
    Checkpoint, CheckpointManager, SimulatedPreemption,
)
