"""Version info (port of slate_tpu/version.py; ref: src/version.cc,
include/slate/slate.hh:30).  The port carries the reference's version: it
reproduces that release's contracts."""

__version__ = "2026.07.00"


def version() -> int:
    """Integer version YYYYMMRR (ref: slate::version)."""
    return 2026_07_00


def id() -> str:
    """Source identifier (ref: slate::id)."""
    return f"slate_tpu_torch {__version__}"
