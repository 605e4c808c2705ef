"""Buffer-pointer driver entry points behind the port's embedded C API
(port of slate_tpu/compat/capi.py).

The analog of the reference's generated driver C API (ref:
src/c_api/wrappers.cc, include/slate/c_api/wrappers.h): C callers hand
raw buffers to driver-level routines.  The C host
(native/slate_tpu_torch_capi.cc beside this package's modules) embeds
CPython and calls these functions: pointers arrive as integers, are
wrapped with numpy, copied in, and the results are written back into the
caller's output buffers.  Double precision, row-major with a row stride
("ld" = elements between consecutive rows), full matrices.

The device is ``SLATE_TORCH_CAPI_DEVICE`` (the counterpart of the
reference's ``SLATE_CAPI_PLATFORM``): unset means CUDA, and a process
without a GPU then fails every call; ``cpu`` runs the plain versions.

Every function returns 0 on success and 1 on failure (the exception is
printed on stderr: a C caller cannot unwind Python exceptions).
"""

from __future__ import annotations

import ctypes
import os
import traceback

import numpy as np


def _device():
    return os.environ.get("SLATE_TORCH_CAPI_DEVICE") or None


def _in(ptr, rows, cols, ld):
    """Copy the [rows, cols] payload out of a caller buffer [rows, ld]."""
    base = np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ctypes.c_double)),
        shape=(int(rows), int(ld)))
    return np.array(base[:, :int(cols)], dtype=np.float64)


def _out(ptr, rows, cols, ld, value):
    base = np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ctypes.c_double)),
        shape=(int(rows), int(ld)))
    base[:, :int(cols)] = np.asarray(value, dtype=np.float64)


def _vec_out(ptr, n, value):
    base = np.ctypeslib.as_array(
        ctypes.cast(int(ptr), ctypes.POINTER(ctypes.c_double)),
        shape=(int(n),))
    base[:] = np.asarray(value, dtype=np.float64)


def _guard(fn):
    try:
        fn()
        return 0
    except Exception:  # noqa: BLE001 (the C boundary: report, return rc)
        traceback.print_exc()
        return 1


def dgesv(n, nrhs, a_ptr, lda, b_ptr, ldb, x_ptr, ldx, nb):
    """Solve A X = B by LU (ref: c_api slate_dgesv)."""
    def run():
        import slate_tpu_torch as st
        dev = _device()
        A = st.Matrix.from_numpy(_in(a_ptr, n, n, lda), nb, nb, device=dev)
        B = st.Matrix.from_numpy(_in(b_ptr, n, nrhs, ldb), nb, nb,
                                 device=dev)
        _, X = st.gesv(A, B)
        _out(x_ptr, n, nrhs, ldx, X.to_numpy())
    return _guard(run)


def dposv(n, nrhs, a_ptr, lda, b_ptr, ldb, x_ptr, ldx, nb):
    """Hermitian positive-definite solve, lower triangle read (ref: c_api
    slate_dposv)."""
    def run():
        import slate_tpu_torch as st
        dev = _device()
        H = st.HermitianMatrix.from_numpy(_in(a_ptr, n, n, lda), nb,
                                          st.Uplo.Lower, device=dev)
        B = st.Matrix.from_numpy(_in(b_ptr, n, nrhs, ldb), nb, nb,
                                 device=dev)
        _, X = st.posv(H, B)
        _out(x_ptr, n, nrhs, ldx, X.to_numpy())
    return _guard(run)


def dgels(m, n, nrhs, a_ptr, lda, b_ptr, ldb, x_ptr, ldx, nb):
    """Least squares min ||A X - B|| (ref: c_api slate_dgels)."""
    def run():
        import slate_tpu_torch as st
        dev = _device()
        A = st.Matrix.from_numpy(_in(a_ptr, m, n, lda), nb, nb, device=dev)
        B = st.Matrix.from_numpy(_in(b_ptr, m, nrhs, ldb), nb, nb,
                                 device=dev)
        X = st.gels(A, B)
        _out(x_ptr, n, nrhs, ldx, X.to_numpy())
    return _guard(run)


def dsyev(n, a_ptr, lda, w_ptr, nb):
    """Eigenvalues, ascending, lower triangle read (ref: c_api
    slate_dsyev, values mode)."""
    def run():
        import slate_tpu_torch as st
        H = st.HermitianMatrix.from_numpy(_in(a_ptr, n, n, lda), nb,
                                          st.Uplo.Lower, device=_device())
        w = st.heev_vals(H)
        _vec_out(w_ptr, n, np.sort(w.cpu().numpy()))
    return _guard(run)


def dgesvd(m, n, a_ptr, lda, s_ptr, nb):
    """Singular values, descending (ref: c_api slate_dgesvd, values
    mode)."""
    def run():
        import slate_tpu_torch as st
        A = st.Matrix.from_numpy(_in(a_ptr, m, n, lda), nb, nb,
                                 device=_device())
        s = st.svd_vals(A)
        _vec_out(s_ptr, min(m, n), s.cpu().numpy())
    return _guard(run)
