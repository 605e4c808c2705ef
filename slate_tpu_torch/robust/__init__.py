"""robust layer of slate_tpu_torch (see the package docstring): health,
certificates, the precision policy, fault injection, the Huang-Abraham
checksum rungs and the recovery ladders."""

from .faults import FaultPlan, inject, maybe_corrupt  # noqa: F401
from .certify import certify_eig, certify_svd  # noqa: F401
from .recovery import heev_with_recovery, svd_with_recovery  # noqa: F401
