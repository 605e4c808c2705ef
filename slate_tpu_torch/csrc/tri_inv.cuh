// K0: inverse of an upper-triangular tile, the port of upper_tri_inv
// (slate_tpu/internal/pallas_tri.py:28).
//
// Replaces: the helper the reference traces inside its fused Pallas panels
// (chol_panel_fused, and later lu_panel_fused and the batched panels). Mosaic
// has no triangular solve, so the reference expands U = D(I + N) and
// multiplies the nilpotent series (I - N)(I + N^2)(I + N^4)..., log2(n) MXU
// products of n x n.
//
// Bound on this card: n^3/3 flops for n <= 128 (0.7 MFLOP), on a tile that
// already sits in one block's shared memory. No launch of that size is bound
// by bytes or flops; what bounds it is the back substitution's chain of n
// dependent steps on one SM.
//
// Design: column-parallel back substitution in shared memory, n^3/6 FMAs
// instead of the series' ~2 n^3 log2(n). Thread j owns column j of X and all
// threads walk the rows i = n-1 .. 0 together, so U(i, k) is a broadcast read
// and X(k, j) a bank-conflict-free one. A column reads only itself, so no
// barrier is needed inside the routine.
#pragma once

// X = U^-1 for an upper-triangular n x n U in shared memory. U(i, k) is read
// at u[i * us0 + k * us1], so a caller holding L = U^T passes swapped strides;
// entries below U's diagonal are never read. X is written row-major at
// x[i * ldx + j], zero below the diagonal. The caller syncs before (U
// complete) and after (X complete).
__device__ inline void upper_tri_inv_smem(const float* u, int us0, int us1,
                                          float* x, int ldx, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    for (int i = n - 1; i >= 0; --i) {
      float v = 0.f;
      if (i <= j) {
        float s = (i == j) ? 1.f : 0.f;
        for (int k = i + 1; k <= j; ++k) s -= u[i * us0 + k * us1] * x[k * ldx + j];
        v = s / u[i * us0 + i * us1];
      }
      x[i * ldx + j] = v;
    }
  }
}
