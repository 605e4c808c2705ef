// The Cholesky column loop of one tile in shared memory, shared by K1
// (chol_tile.cu) and K2 (chol_panel.cu). It is the lower-form transpose of
// the reference's _chol_factor_in_place (slate_tpu/internal/pallas_chol.py:63),
// which builds the upper factor U = L^T in bw-row panels; the plain PyTorch
// version (slate_tpu_torch/internal/chol_kernels.py chol_tile_plain) repeats
// this loop step for step.
#pragma once

// Factor the SPD n x n tile s (row-major, leading dimension lds; only the
// lower triangle is read) in place into its lower Cholesky factor L, with the
// strictly upper part set to 0, in bw-column panels:
//   inside a panel, column by column: pivot = sqrt(s[j][j]); the column below
//   the pivot times 1 / pivot; the panel's later columns take this column's
//   rank-1 update;
//   after a panel: the trailing columns take the panel's rank-bw update,
//   s[r][c] -= sum_t s[r][t] * s[c][t].
// A negative pivot gives NaN (a zero pivot Inf), which reaches every later
// column, as in the reference; the driver reads the first bad pivot from L's
// diagonal. Works with any blockDim. The caller syncs before (s complete);
// the routine ends with a barrier. An odd lds keeps row and column walks free
// of bank conflicts.
__device__ inline void chol_factor_smem(float* s, int lds, int n, int bw) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int p0 = 0; p0 < n; p0 += bw) {
    const int p1 = p0 + bw;
    for (int j = p0; j < p1; ++j) {
      const float piv = sqrtf(s[j * lds + j]);
      const float inv = 1.f / piv;
      for (int r = j + 1 + tid; r < n; r += nthr) s[r * lds + j] *= inv;
      __syncthreads();  // column j scaled, and every thread has read s[j][j]
      if (tid == 0) s[j * lds + j] = piv;
      const int rows = n - j - 1, cols = p1 - j - 1;
      for (int idx = tid; idx < rows * cols; idx += nthr) {
        const int c = j + 1 + idx / rows, r = j + 1 + idx % rows;
        if (r >= c) s[r * lds + c] -= s[r * lds + j] * s[c * lds + j];
      }
      __syncthreads();
    }
    const int m = n - p1;
    for (int idx = tid; idx < m * m; idx += nthr) {
      const int c = p1 + idx / m, r = p1 + idx % m;
      if (r >= c) {
        float acc = 0.f;
        for (int t = p0; t < p1; ++t) acc += s[r * lds + t] * s[c * lds + t];
        s[r * lds + c] -= acc;
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < n * n; idx += nthr) {
    const int r = idx / n, c = idx % n;
    if (c > r) s[r * lds + c] = 0.f;
  }
  __syncthreads();
}
