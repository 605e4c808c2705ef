/* Embedded-interpreter driver C API for slate_tpu_torch.
 *
 * C programs call slate_tpu_torch_dgesv / dposv / dgels / dsyev / dgesvd
 * with raw row-major buffers.  The runtime is the PyTorch program layer,
 * so this host embeds CPython, imports slate_tpu_torch.compat.capi once,
 * and forwards buffer POINTERS (as integers) plus dimensions; the Python
 * side wraps them with numpy and runs the drivers on the device
 * SLATE_TORCH_CAPI_DEVICE names (unset: CUDA).
 *
 * Build (g++ only; link the embedding flags of the Python that has torch):
 *   g++ -O2 -std=c++17 -fPIC -shared $(python3-config --includes) \
 *       slate_tpu_torch_capi.cc -o libslate_tpu_torch_capi.so \
 *       $(python3-config --ldflags --embed)
 * The embedding process must have slate_tpu_torch importable (PYTHONPATH).
 */
#include <Python.h>
#include <stdarg.h>
#include <stdint.h>

#include "slate_tpu_torch_capi.h"

static PyObject* g_mod = NULL;

int slate_tpu_torch_init(void) {
  if (!Py_IsInitialized()) Py_InitializeEx(0);
  PyGILState_STATE g = PyGILState_Ensure();
  if (g_mod == NULL) {
    g_mod = PyImport_ImportModule("slate_tpu_torch.compat.capi");
    if (g_mod == NULL) PyErr_Print();
  }
  int rc = (g_mod == NULL) ? 1 : 0;
  PyGILState_Release(g);
  return rc;
}

void slate_tpu_torch_finalize(void) {
  if (g_mod != NULL) {
    PyGILState_STATE g = PyGILState_Ensure();
    Py_CLEAR(g_mod);
    PyGILState_Release(g);
  }
}

/* Call capi.<name>(...) -> int rc; 1 on any Python error. */
static int call_rc(const char* name, const char* fmt, ...) {
  if (g_mod == NULL && slate_tpu_torch_init() != 0) return 1;
  PyGILState_STATE g = PyGILState_Ensure();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  int rc = 1;
  if (args != NULL) {
    PyObject* fn = PyObject_GetAttrString(g_mod, name);
    if (fn != NULL) {
      PyObject* res = PyObject_CallObject(fn, args);
      if (res != NULL) {
        rc = (int)PyLong_AsLong(res);
        Py_DECREF(res);
      }
      Py_DECREF(fn);
    }
    Py_DECREF(args);
  }
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(g);
  return rc;
}

#define PTR(p) ((unsigned long long)(uintptr_t)(p))

int slate_tpu_torch_dgesv(int64_t n, int64_t nrhs, const double* a,
                          int64_t lda, const double* b, int64_t ldb,
                          double* x, int64_t ldx, int64_t nb) {
  return call_rc("dgesv", "(LLKLKLKLL)", (long long)n, (long long)nrhs,
                 PTR(a), (long long)lda, PTR(b), (long long)ldb, PTR(x),
                 (long long)ldx, (long long)nb);
}

int slate_tpu_torch_dposv(int64_t n, int64_t nrhs, const double* a,
                          int64_t lda, const double* b, int64_t ldb,
                          double* x, int64_t ldx, int64_t nb) {
  return call_rc("dposv", "(LLKLKLKLL)", (long long)n, (long long)nrhs,
                 PTR(a), (long long)lda, PTR(b), (long long)ldb, PTR(x),
                 (long long)ldx, (long long)nb);
}

int slate_tpu_torch_dgels(int64_t m, int64_t n, int64_t nrhs,
                          const double* a, int64_t lda, const double* b,
                          int64_t ldb, double* x, int64_t ldx, int64_t nb) {
  return call_rc("dgels", "(LLLKLKLKLL)", (long long)m, (long long)n,
                 (long long)nrhs, PTR(a), (long long)lda, PTR(b),
                 (long long)ldb, PTR(x), (long long)ldx, (long long)nb);
}

int slate_tpu_torch_dsyev(int64_t n, const double* a, int64_t lda,
                          double* w, int64_t nb) {
  return call_rc("dsyev", "(LKLKL)", (long long)n, PTR(a), (long long)lda,
                 PTR(w), (long long)nb);
}

int slate_tpu_torch_dgesvd(int64_t m, int64_t n, const double* a,
                           int64_t lda, double* s, int64_t nb) {
  return call_rc("dgesvd", "(LLKLKL)", (long long)m, (long long)n, PTR(a),
                 (long long)lda, PTR(s), (long long)nb);
}
