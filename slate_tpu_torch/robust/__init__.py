"""robust layer of slate_tpu_torch (see the package docstring): health,
certificates, the precision policy, fault injection, the Huang-Abraham
checksum rungs, the recovery ladders and the durable panel-boundary
checkpoints of the out-of-core drivers."""

from .faults import FaultPlan, inject, maybe_corrupt  # noqa: F401
from .certify import certify_eig, certify_svd  # noqa: F401
from .recovery import heev_with_recovery, svd_with_recovery  # noqa: F401
from .checkpoint import (  # noqa: F401
    Checkpoint, CheckpointManager, SimulatedPreemption,
)
