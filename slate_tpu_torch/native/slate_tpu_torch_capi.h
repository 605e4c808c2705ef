/* Driver-level C API of slate_tpu_torch (the analog of the reference's
 * include/slate/c_api/wrappers.h generated tier).
 *
 * Buffers are double precision, ROW-major, with `ld*` = elements between
 * consecutive rows (>= the column count).  `nb` is the tile size.
 * Every routine returns 0 on success.  The process embeds CPython:
 * call slate_tpu_torch_init() first (slate_tpu_torch must be importable),
 * and slate_tpu_torch_finalize() before exit if desired.  The device is
 * SLATE_TORCH_CAPI_DEVICE: unset means CUDA, "cpu" the CPU.
 */
#ifndef SLATE_TPU_TORCH_CAPI_H
#define SLATE_TPU_TORCH_CAPI_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int slate_tpu_torch_init(void);
void slate_tpu_torch_finalize(void);

/* Solve A X = B by partially-pivoted LU (A [n, n], B/X [n, nrhs]). */
int slate_tpu_torch_dgesv(int64_t n, int64_t nrhs, const double* a,
                          int64_t lda, const double* b, int64_t ldb,
                          double* x, int64_t ldx, int64_t nb);

/* Solve A X = B for Hermitian positive-definite A (lower triangle read). */
int slate_tpu_torch_dposv(int64_t n, int64_t nrhs, const double* a,
                          int64_t lda, const double* b, int64_t ldb,
                          double* x, int64_t ldx, int64_t nb);

/* Least squares min ||A X - B||: A [m, n] (m >= n), B [m, nrhs],
 * X [n, nrhs]. */
int slate_tpu_torch_dgels(int64_t m, int64_t n, int64_t nrhs,
                          const double* a, int64_t lda, const double* b,
                          int64_t ldb, double* x, int64_t ldx, int64_t nb);

/* Eigenvalues (ascending) of symmetric A (lower triangle read), w [n]. */
int slate_tpu_torch_dsyev(int64_t n, const double* a, int64_t lda,
                          double* w, int64_t nb);

/* Singular values (descending) of A [m, n], s [min(m, n)]. */
int slate_tpu_torch_dgesvd(int64_t m, int64_t n, const double* a,
                           int64_t lda, double* s, int64_t nb);

#ifdef __cplusplus
}
#endif

#endif /* SLATE_TPU_TORCH_CAPI_H */
