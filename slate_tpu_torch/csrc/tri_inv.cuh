// K0: inverse of an upper-triangular tile, the port of upper_tri_inv
// (slate_tpu/internal/pallas_tri.py:28). The factor launches of K3 and K7
// (lu_factor.cuh) and of K6 (chol_panel_batched.cu) run K0's blocked
// doubling inside their blocks.
//
// Replaces: the helper the reference traces inside its fused Pallas panels
// (chol_panel_fused, and later lu_panel_fused and the batched panels). Mosaic
// has no triangular solve, so the reference expands U = D(I + N) and
// multiplies the nilpotent series (I - N)(I + N^2)(I + N^4)..., log2(n) MXU
// products of n x n. The series is accurate only while U is close to
// diagonal; on the U of a partially pivoted LU panel it is off by ~1e-2, so
// the routine here solves instead.
//
// Bound on this card: n^3/3 flops for n <= 128 (0.7 MFLOP), on a tile that
// already sits in one block's shared memory. No launch of that size is bound
// by bytes or flops; what bounds it is the length of the longest chain of
// dependent steps and the block barriers between them.
#pragma once

constexpr int TRI_DIAG = 8;  // the diagonal blocks inverted first

// K0's routine: X = U^-1 by blocked recursive doubling, for np a multiple
// of TRI_DIAG. U (np x np, row-major at u[i * ldu + k]) is upper triangular
// with a nonzero diagonal; entries below it are never read. X (ldx) is
// written whole, zero below the diagonal; T (np x ldt, ldt >= np / 2) is
// scratch; ldx and ldt are multiples of 4 and x, t 16-byte aligned.
//   1. The np / 8 diagonal 8 x 8 blocks are inverted by back substitution,
//      one thread a column (chains of at most 36 FMAs).
//   2. For b = 8, 16, 32, ...: every pair of neighbouring inverted blocks
//      [X11 ., 0 X22] of sizes b and b2 <= b is joined into one of size
//      b + b2 by X12 = -X11 (U12 X22): T = U12 X22 for every pair at once,
//      a barrier, X12 = -X11 T, a barrier. A thread forms a 4 x 4 block of
//      outputs from one 16-byte read of X22 (or T) and four reads of U12
//      (or X11) per k; X11 and X22 are upper triangular, so each block
//      sums only over k inside their triangles (the zeros below the
//      diagonal cover a block's ragged corner).
// log2(np / 8) levels of two products each, every output of a level
// spread over the whole block, replace the back substitution's chain of
// n^2 / 2 dependent FMAs. This is the recursion of LAPACK's trtri (X12 =
// -X11 U12 X22), whose error is that of back substitution: within 1e-5 of
// the f64 inverse on the U of a pivoted Gaussian panel (cond ~100).
// Works with any blockDim; the caller syncs before (U complete) and after
// (X complete).
__device__ inline void upper_tri_inv_doubling(const float* u, int ldu,
                                              float* x, int ldx, float* t,
                                              int ldt, int np) {
  const int tid = threadIdx.x, nt = blockDim.x, nq4 = np / 4;
  // zeros outside the diagonal blocks, four columns (one 16-byte store,
  // inside one block column) at a time
  for (int idx = tid; idx < np * nq4; idx += nt) {
    const int i = idx / nq4, j = 4 * (idx - i * nq4);
    if (j / TRI_DIAG != i / TRI_DIAG) {
      *reinterpret_cast<float4*>(x + i * ldx + j) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int j = tid; j < np; j += nt) {
    const int d0 = j - j % TRI_DIAG;
    for (int i = d0 + TRI_DIAG - 1; i > j; --i) x[i * ldx + j] = 0.f;
    for (int i = j; i >= d0; --i) {
      float s = (i == j) ? 1.f : 0.f;
      for (int k = i + 1; k <= j; ++k) s -= u[i * ldu + k] * x[k * ldx + j];
      x[i * ldx + j] = s / u[i * ldu + i];
    }
  }
  __syncthreads();
  for (int b = TRI_DIAG; b < np; b *= 2) {
    // 4 x 4 output blocks (rq, cq) of pair p: rows i0 + 4 rq .., columns
    // j0 + 4 cq .. of X12, i0 = 2 b p, j0 = i0 + b
    const int nq = b / 4, pairs = (np - b + 2 * b - 1) / (2 * b);
    for (int idx = tid; idx < pairs * nq * nq; idx += nt) {
      const int cq = idx % nq, rq = idx / nq % nq, i0 = idx / (nq * nq) * 2 * b;
      const int i = i0 + 4 * rq, j = i0 + b + 4 * cq;
      if (j >= np) continue;
      float s[4][4] = {};  // T(i + r, 4 cq + c) = sum_k U(i + r, k) X(k, j + c)
      for (int k = i0 + b; k < j + 4; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(x + k * ldx + j);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float uv = u[(i + r) * ldu + k];
          s[r][0] += uv * xv.x;
          s[r][1] += uv * xv.y;
          s[r][2] += uv * xv.z;
          s[r][3] += uv * xv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(t + (i + r) * ldt + 4 * cq) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();
    for (int idx = tid; idx < pairs * nq * nq; idx += nt) {
      const int cq = idx % nq, rq = idx / nq % nq, i0 = idx / (nq * nq) * 2 * b;
      const int i = i0 + 4 * rq, j = i0 + b + 4 * cq;
      if (j >= np) continue;
      float s[4][4] = {};  // X(i + r, j + c) = -sum_k X(i + r, k) T(k, 4 cq + c)
      for (int k = i; k < i0 + b; ++k) {
        const float4 tv = *reinterpret_cast<const float4*>(t + k * ldt + 4 * cq);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xv = x[(i + r) * ldx + k];
          s[r][0] += xv * tv.x;
          s[r][1] += xv * tv.y;
          s[r][2] += xv * tv.z;
          s[r][3] += xv * tv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(x + (i + r) * ldx + j) =
            make_float4(-s[r][0], -s[r][1], -s[r][2], -s[r][3]);
    }
    __syncthreads();
  }
}
