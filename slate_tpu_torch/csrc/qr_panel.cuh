// The Householder QR of one panel with its compact-WY T, run by one thread
// block: the per-panel routine of K5 (qr_panel.cu), written to be shared by
// the batched panel of the serving slice, which runs the same column loop
// (slate_tpu/internal/pallas_qr.py _qr_panel_steps, used by qr_panel_pallas
// and qr_panel_batched), as chol_factor.cuh serves K1 and K2.
//
//   A  [mm, w] f32 or bf16 (widened to f32 as it is read), any strides,
//      mm >= w, 1 <= w <= QR_MAX_W
//   P  [mm, w] f32 row-major (ld = w): on return the packed panel, R on and
//      above the diagonal (beta_j on it), the Householder vectors strictly
//      below (unit diagonal implied); the working copy of the panel throughout
//   T  [w, w] f32 or bf16 row-major (rounded as it is stored): the larft
//      Forward/Columnwise triangle, tau_j on the diagonal, T[:j, j] = -tau_j
//      T (V^T v_j); Q = I - V T V^T
//
// The larfg scalars are those of slate_tpu/internal/qr.py _larfg:
// mu = sqrt(alpha^2 + sum x^2) with no scaling, beta = -mu if alpha >= 0 else
// +mu (a comparison, not copysign: at alpha = -0.0 the two differ), tau =
// (beta - alpha) / beta, the tail scaled by 1 / (alpha - beta); a column with
// mu = 0 gets tau = 0 and keeps its input, untouched.
//
// What differs from the TPU: the reference holds the whole panel and T in
// VMEM and runs w rank-1 steps over all of it. A [8192, 128] panel is 4 MB,
// beyond a block's 227 KB of shared memory, so here the panel stays in
// global memory (P, L2-resident up to the port's cap of 2^20 elements) and
// only T and small scratch sit in shared memory. The column loop is blocked
// in slabs of bw columns:
//   (1) per column j of the slab: one pass over the slab's rows below j
//       forms sum_r x_r P[r, t] for every slab column t (sum x^2 at t = j);
//       the larfg scalars follow, then w_t = P[j, t] + scale s_t, which is
//       v^T P[:, t] for t > j and (V^T v_j)_t for t < j (T's recursion, on V
//       already written, never on the input); a second pass writes column j
//       and applies the reflector to the slab's later columns;
//   (2) one pass over all rows from j0 forms Z = Vs^T P[j0:, :] for every
//       column outside the slab: left of it that is V1^T Vs, which merges
//       the slab's T into the panel's, T12 = -T1 (V1^T Vs) Ts
//       (_householder_blocked_rec, qr.py:206); right of it, Vs^T A_right;
//   (3) one pass applies the slab's compact-WY update to the columns to its
//       right, A_right -= Vs (Ts^T Z).
// So the panel is read about w / bw + 1 times instead of w times. Sums over
// rows reduce warp by warp in a fixed order, so a launch is deterministic.
// No TF32: every product is an f32 FMA on the CUDA cores.
#pragma once

#include <cuda_runtime.h>

#include "storage.cuh"

constexpr int QR_THREADS = 512;
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int QR_MAX_W = 128;   // four columns a lane in the wide passes
constexpr int QR_MAX_BW = 8;    // the slab's sums are registers
constexpr int QR_ROWS = 4;      // rows a thread (or a warp) keeps in flight

// Shared memory of qr_panel_block, in floats: T, Z, Y (w x w, bw x w twice),
// the cross-warp reduction buffer and the column step's scalars.
__host__ __device__ inline size_t qr_panel_smem_floats(int w, int bw) {
  return (size_t)w * w + 2 * (size_t)bw * w + (size_t)QR_WARPS * bw * 32 +
         (QR_MAX_BW + 8);
}

// The panels qr_panel_block takes: 1 <= w <= 128 (four columns a lane),
// mm >= w, 1 <= bw <= 8. The panel lives in global memory, so mm has no
// limit here.
inline bool qr_panel_shape_ok(int mm, int w, int bw) {
  return w >= 1 && w <= QR_MAX_W && mm >= w && bw >= 1 && bw <= QR_MAX_BW;
}

// Column step scalars, in the block's sc[] slots.
enum { QR_BETA, QR_TAU, QR_SCALE, QR_LIVE, QR_G0 = 8 };

// vs_i(r): row r of the slab's unit lower V (column j0 + i).
__device__ inline float qr_slab_v(const float* prow, int r, int j0, int i) {
  const int d = j0 + i;
  return r > d ? prow[d] : (r == d ? 1.f : 0.f);
}

__device__ inline float qr_warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <class TA, class TT>
__device__ inline void qr_panel_block(const TA* __restrict__ A, long long as0,
                                      long long as1, int mm, int w, int bw,
                                      float* P, TT* __restrict__ Tout,
                                      float* smem) {
  float* T = smem;                         // w x w
  float* Z = T + (size_t)w * w;            // bw x w: Vs^T P[j0:, :]
  float* Y = Z + (size_t)bw * w;           // bw x w: M^T (left), Ts^T Z (right)
  float* red = Y + (size_t)bw * w;         // QR_WARPS x bw x 32
  float* sc = red + (size_t)QR_WARPS * bw * 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t total = (size_t)mm * w;

  // the panel into P, four loads a thread in flight; T to zero
  for (size_t i0 = tid; i0 < total; i0 += 4 * QR_THREADS) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = i0 + (size_t)k * QR_THREADS;
      if (i < total)
        v[k] = to_f32(A[(long long)(i / w) * as0 + (long long)(i % w) * as1]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const size_t i = i0 + (size_t)k * QR_THREADS;
      if (i < total) P[i] = v[k];
    }
  }
  for (int i = tid; i < w * w; i += QR_THREADS) T[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < w; j0 += bw) {
    const int j1 = min(j0 + bw, w), nbs = j1 - j0;
    // ---- (1) the slab's column loop
    for (int j = j0; j < j1; ++j) {
      const int jl = j - j0;
      // pass A: s_t = sum_{r>j} x_r P[r, j0 + t], QR_ROWS rows a thread in
      // flight
      float acc[QR_MAX_BW];
#pragma unroll
      for (int t = 0; t < QR_MAX_BW; ++t) acc[t] = 0.f;
      for (int r0 = j + 1 + tid; r0 < mm; r0 += QR_ROWS * QR_THREADS) {
        float s[QR_ROWS][QR_MAX_BW], x[QR_ROWS];
#pragma unroll
        for (int q = 0; q < QR_ROWS; ++q) {
          const int r = r0 + q * QR_THREADS;
          const float* row = P + (size_t)r * w + j0;
          x[q] = r < mm ? row[jl] : 0.f;
#pragma unroll
          for (int t = 0; t < QR_MAX_BW; ++t)
            s[q][t] = (r < mm && t < nbs) ? row[t] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < QR_ROWS; ++q)
#pragma unroll
          for (int t = 0; t < QR_MAX_BW; ++t) acc[t] += x[q] * s[q][t];
      }
#pragma unroll
      for (int t = 0; t < QR_MAX_BW; ++t) {
        if (t < nbs) {
          const float v = qr_warp_sum(acc[t]);
          if (lane == 0) red[warp * QR_MAX_BW + t] = v;
        }
      }
      __syncthreads();
      if (tid == 0) {
        float s[QR_MAX_BW];
        for (int t = 0; t < nbs; ++t) {
          float v = 0.f;
          for (int q = 0; q < QR_WARPS; ++q) v += red[q * QR_MAX_BW + t];
          s[t] = v;
        }
        const float* prow = P + (size_t)j * w;
        const float alpha = prow[j];
        const float mu = sqrtf(alpha * alpha + s[jl]);
        const bool live = mu > 0.f;
        const float beta = alpha >= 0.f ? -mu : mu;
        const float sb = live ? beta : 1.f;
        const float tau = live ? (sb - alpha) / sb : 0.f;
        const float scale = live ? 1.f / (alpha - sb) : 0.f;
        sc[QR_BETA] = beta;
        sc[QR_TAU] = tau;
        sc[QR_SCALE] = scale;
        sc[QR_LIVE] = live ? 1.f : 0.f;
        for (int t = 0; t < nbs; ++t) sc[QR_G0 + t] = prow[j0 + t] + scale * s[t];
        // T's column j within the slab: T[k, j] = -tau sum_{l=k}^{j-1}
        // T[k, l] (V_l^T v_j)
        T[(size_t)j * w + j] = tau;
        for (int k = j0; k < j; ++k) {
          float v = 0.f;
          for (int l = k; l < j; ++l) v += T[(size_t)k * w + l] * sc[QR_G0 + l - j0];
          T[(size_t)k * w + j] = -tau * v;
        }
      }
      __syncthreads();
      // pass B: column j and the reflector on the slab's later columns, all
      // of a row's loads before its stores
      if (sc[QR_LIVE] != 0.f) {
        const float tau = sc[QR_TAU], scale = sc[QR_SCALE], beta = sc[QR_BETA];
        float g[QR_MAX_BW];
#pragma unroll
        for (int t = 0; t < QR_MAX_BW; ++t) g[t] = t < nbs ? sc[QR_G0 + t] : 0.f;
        for (int r0 = j + tid; r0 < mm; r0 += QR_ROWS * QR_THREADS) {
          float s[QR_ROWS][QR_MAX_BW], x[QR_ROWS];
#pragma unroll
          for (int q = 0; q < QR_ROWS; ++q) {
            const int r = r0 + q * QR_THREADS;
            const float* row = P + (size_t)r * w + j0;
            x[q] = r < mm ? row[jl] : 0.f;
#pragma unroll
            for (int t = 0; t < QR_MAX_BW; ++t)
              s[q][t] = (r < mm && t > jl && t < nbs) ? row[t] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < QR_ROWS; ++q) {
            const int r = r0 + q * QR_THREADS;
            if (r >= mm) continue;
            float* row = P + (size_t)r * w + j0;
            const float v = r == j ? 1.f : x[q] * scale;
#pragma unroll
            for (int t = 0; t < QR_MAX_BW; ++t)
              if (t > jl && t < nbs) row[t] = s[q][t] - tau * v * g[t];
            row[jl] = r == j ? beta : v;
          }
        }
      }
      __syncthreads();
    }
    const bool left = j0 > 0, right = j1 < w;
    if (!left && !right) break;
    // ---- (2) Z = Vs^T P[j0:, c] for every column c outside the slab: one
    // warp a row, lanes over the columns, QR_ROWS rows a warp in flight
    {
      float acc[QR_MAX_BW][4];
#pragma unroll
      for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      for (int r0 = j0 + warp; r0 < mm; r0 += QR_ROWS * QR_WARPS) {
        float x[QR_ROWS][4], v[QR_ROWS][QR_MAX_BW];
#pragma unroll
        for (int k = 0; k < QR_ROWS; ++k) {
          const int r = r0 + k * QR_WARPS;
          const float* prow = P + (size_t)r * w;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = lane + 32 * q;
            x[k][q] = (r < mm && c < w && (c < j0 || c >= j1)) ? prow[c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i)
            v[k][i] = (r < mm && i < nbs) ? qr_slab_v(prow, r, j0, i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < QR_ROWS; ++k)
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += v[k][i] * x[k][q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (32 * q >= w) break;
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          if (i < nbs) red[((size_t)warp * bw + i) * 32 + lane] = acc[i][q];
        __syncthreads();
        for (int idx = tid; idx < nbs * 32; idx += QR_THREADS) {
          const int i = idx / 32, c = 32 * q + idx % 32;
          float v = 0.f;
          for (int p = 0; p < QR_WARPS; ++p) v += red[((size_t)p * bw + i) * 32 + idx % 32];
          if (c < w) Z[(size_t)i * w + c] = v;
        }
        __syncthreads();
      }
    }
    // Y[i, c] = sum_{k<=i} Ts[k, i] Z[k, c]: for c < j0, (V1^T Vs Ts)^T;
    // for c >= j1, Ts^T Vs^T A_right
    for (int idx = tid; idx < nbs * w; idx += QR_THREADS) {
      const int i = idx / w, c = idx % w;
      if (c >= j0 && c < j1) continue;
      float v = 0.f;
      for (int k = 0; k <= i; ++k)
        v += T[(size_t)(j0 + k) * w + j0 + i] * Z[(size_t)k * w + c];
      Y[(size_t)i * w + c] = v;
    }
    __syncthreads();
    // T12 = -T1 (V1^T Vs Ts), T1 upper triangular
    for (int idx = tid; idx < j0 * nbs; idx += QR_THREADS) {
      const int k = idx / nbs, i = idx % nbs;
      float v = 0.f;
      for (int l = k; l < j0; ++l) v += T[(size_t)k * w + l] * Y[(size_t)i * w + l];
      T[(size_t)k * w + j0 + i] = -v;
    }
    // ---- (3) A_right -= Vs Y_right: one warp a row, lanes over the
    // columns, Y_right in registers, QR_ROWS rows a warp in flight
    if (right) {
      float y[QR_MAX_BW][4];
#pragma unroll
      for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = lane + 32 * q;
          y[i][q] = (i < nbs && c >= j1 && c < w) ? Y[(size_t)i * w + c] : 0.f;
        }
      for (int r0 = j0 + warp; r0 < mm; r0 += QR_ROWS * QR_WARPS) {
        float x[QR_ROWS][4], v[QR_ROWS][QR_MAX_BW];
#pragma unroll
        for (int k = 0; k < QR_ROWS; ++k) {
          const int r = r0 + k * QR_WARPS;
          const float* prow = P + (size_t)r * w;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = lane + 32 * q;
            x[k][q] = (r < mm && c >= j1 && c < w) ? prow[c] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i)
            v[k][i] = (r < mm && i < nbs) ? qr_slab_v(prow, r, j0, i) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < QR_ROWS; ++k) {
          const int r = r0 + k * QR_WARPS;
          if (r >= mm) continue;
          float* prow = P + (size_t)r * w;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = lane + 32 * q;
            if (c < j1 || c >= w) continue;
            float acc = x[k][q];
#pragma unroll
            for (int i = 0; i < QR_MAX_BW; ++i) acc -= v[k][i] * y[i][q];
            prow[c] = acc;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < w * w; i += QR_THREADS) Tout[i] = from_f32<TT>(T[i]);
}
