"""robust layer of slate_tpu_torch (see the package docstring): health,
certificates, the precision policy, fault injection, the Huang-Abraham
checksum rungs and the recovery ladders."""

from .faults import FaultPlan, inject, maybe_corrupt  # noqa: F401
