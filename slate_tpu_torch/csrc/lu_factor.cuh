// The unpivoted LU of one tile in shared memory, shared by K3 (lu_panel.cu)
// and K7 (lu_panel_batched.cu), as chol_factor.cuh serves K1, K2 and K6. It
// is the column loop of the reference's _lu_factor_in_place
// (slate_tpu/internal/pallas_lu.py:137); the plain PyTorch version
// (slate_tpu_torch/internal/lu_kernels.py lu_tile_plain) repeats it step for
// step.
#pragma once

#include "tri_inv.cuh"

// Unpivoted LU of the n x n tile s (row-major, leading dimension lds) in
// place into packed L\U, in bw-row slabs (n % bw == 0), with the arithmetic
// of _lu_factor_in_place (pallas_lu.py:137) and of the plain version
// (slate_tpu_torch/internal/lu_kernels.py lu_tile_plain):
//   for the slab rows j0 .. j1-1, column by column j = j0 .. j1-1: each slab
//   row r > j takes l = s[r][j] / piv, piv = s[j][j] (1 where that is 0, as
//   the reference divides), then s[r][c] -= l * s[j][c] for c > j, and
//   stores l at s[r][j];
//   for the tile's rows below the slab: l21 = s[rows][slab] @ D^-1, D the
//   slab's upper bw x bw block; s[rows][c] -= l21 @ s[slab][c] for c >= j1;
//   l21 is stored in the slab's columns.
// dinv holds bw x (bw + 1) floats and t (n - bw) x bw. Works with any
// blockDim. The caller syncs before (s complete); the routine ends with a
// barrier. An odd lds keeps the row walks free of bank conflicts.
__device__ inline void lu_factor_smem(float* s, int lds, int n, int bw,
                                      float* dinv, float* t) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int j0 = 0; j0 < n; j0 += bw) {
    const int j1 = j0 + bw;
    for (int j = j0; j < j1; ++j) {
      const float piv = s[j * lds + j];
      const float safe = (piv == 0.f) ? 1.f : piv;
      const int rows = j1 - j - 1, cols = n - j - 1;
      for (int idx = tid; idx < rows * cols; idx += nthr) {
        const int r = j + 1 + idx / cols, c = j + 1 + idx % cols;
        s[r * lds + c] -= (s[r * lds + j] / safe) * s[j * lds + c];
      }
      __syncthreads();  // every update has read column j
      for (int r = j + 1 + tid; r < j1; r += nthr) s[r * lds + j] /= safe;
      __syncthreads();
    }
    if (j1 < n) {
      const int m = n - j1;
      upper_tri_inv_smem(s + j0 * lds + j0, lds, 1, dinv, bw + 1, bw);
      __syncthreads();
      for (int idx = tid; idx < m * bw; idx += nthr) {
        const int r = idx / bw, c = idx % bw;
        const float* a = s + (j1 + r) * lds + j0;
        float acc = 0.f;
        for (int k = 0; k <= c; ++k) acc += a[k] * dinv[k * (bw + 1) + c];
        t[idx] = acc;
      }
      __syncthreads();
      for (int idx = tid; idx < m * m; idx += nthr) {
        const int r = idx / m, c = j1 + idx % m;
        float acc = 0.f;
        for (int k = 0; k < bw; ++k) {
          acc += t[r * bw + k] * s[(j0 + k) * lds + c];
        }
        s[(j1 + r) * lds + c] -= acc;
      }
      for (int idx = tid; idx < m * bw; idx += nthr) {
        s[(j1 + idx / bw) * lds + j0 + idx % bw] = t[idx];
      }
      __syncthreads();
    }
  }
}
