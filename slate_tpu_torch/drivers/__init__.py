"""drivers layer of slate_tpu_torch (see the package docstring)."""

from . import blas3  # noqa: F401
