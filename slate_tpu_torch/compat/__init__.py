"""Compatibility APIs (port of slate_tpu/compat): ScaLAPACK descriptors
and routine entry points, LAPACK-style shims, the buffer-pointer entry
points of the embedded C API and its Fortran interface.

Analog of the reference's compat tier (ref: scalapack_api/,
lapack_api/): legacy callers keep their data layouts and calling
conventions; the shims translate in and out of the tiled storage.
"""

from . import lapack, scalapack, scalapack_api  # noqa: F401
from .scalapack import (  # noqa: F401
    descinit, from_scalapack, numroc, to_scalapack,
)
