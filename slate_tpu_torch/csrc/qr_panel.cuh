// The Householder QR of one panel with its compact-WY T, run by a thread
// block cluster: the per-panel routine of K5 (qr_panel.cu) and K8
// (qr_panel_batched.cu), the port of the column loop of
// slate_tpu/internal/pallas_qr.py _qr_panel_steps (used by qr_panel_pallas
// and qr_panel_batched).
//
//   A    [mm, w] f32 or bf16 (widened to f32 as it is read), any strides,
//        mm >= w, 1 <= w <= QR_MAX_W
//   P    [mm, w] f32 row-major (ld = w): the working copy of the rows that
//        do not fit in shared memory
//   out  [mm, w] row-major, f32 or bf16 (rounded as it is stored): the
//        packed panel, R on and above the diagonal (beta_j on it), the
//        Householder vectors strictly below (unit diagonal implied). It may
//        be P itself (f32): rows kept in P are then already in place.
//   T    [w, w] f32 or bf16 row-major: the larft Forward/Columnwise
//        triangle, tau_j on the diagonal, T[:j, j] = -tau_j T (V^T v_j);
//        Q = I - V T V^T
//
// The larfg scalars are those of slate_tpu/internal/qr.py _larfg:
// mu = sqrt(alpha^2 + sum x^2) with no scaling, beta = -mu if alpha >= 0 else
// +mu (a comparison, not copysign: at alpha = -0.0 the two differ), tau =
// (beta - alpha) / beta, the tail scaled by 1 / (alpha - beta); a column with
// mu = 0 gets tau = 0 and keeps its input, untouched.
//
// What bounds a panel on this card: w dependent column steps, each a
// reduction over every row below the diagonal, a scalar step, and an update
// of those rows; the card's 67 TFLOP/s are never in reach. One block on one
// SM over an L2-resident panel (the first port) spent ~170 us a column at
// [8192, 128], latency in passes over L2 and in a serial reduction. So a
// panel's rows are split over a cluster of C CTAs (one CTA an SM, C <= 16):
// CTA r owns the contiguous range of ceil(mm / C) rows from r ceil(mm / C)
// (rank 0 also holds T). A CTA keeps as many of its rows as fit
// in its shared memory (f32, row stride w | 1, odd, so that a thread a row
// reads without bank conflicts); the rest stay in P (L2), their slab's
// columns copied into shared memory (Sb) while the slab's column loop runs.
// The column loop runs in slabs of bw columns:
//   (1) per column j: each CTA sums x_r P[r, t] over its own rows r > j for
//       every slab column t (sum x^2 at t = j) and publishes the bw partial
//       sums in its shared memory; the owner of row j publishes P[j, slab].
//       One cluster barrier (the slots alternate by column parity, so one a
//       column is enough); every CTA then reads the C partials through
//       distributed shared memory in rank order, so every CTA sums the same
//       numbers in the same order and computes the same larfg scalars, g_t =
//       P[j, t] + scale s_t (v^T P[:, t] for t > j, (V^T v_j)_t for t < j)
//       and T's column within the slab. Each CTA then writes column j and
//       applies the reflector to the slab's later columns on its own rows;
//   (2) each CTA forms its partial Z = Vs^T P[j0:, c] over its own rows for
//       every column c outside the slab (left: V1^T Vs, right: Vs^T A_right),
//       one warp a row, and its warps' partials are summed in warp order
//       through W; the partial is published, one cluster barrier follows,
//       and every CTA sums the C partials in rank order and forms Y = Ts^T Z;
//       rank 0 merges the slab's T into the panel's, T12 = -T1 (V1^T Vs) Ts
//       (_householder_blocked_rec, qr.py:206);
//   (3) each CTA applies A_right -= Vs Y_right to its own rows.
// No atomics: every sum runs in a fixed order, so two launches give the same
// bits. No TF32: every product is an f32 FMA on the CUDA cores. A cluster
// barrier before the copy-out keeps every CTA alive while others may still
// read its shared memory. What is left on the critical path is the column
// step's latency: two block barriers and one cluster barrier (which the
// compiler fences at GPU scope), the scalar chain, and the passes over the
// rows that stayed in L2.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>


#include "common.cuh"
#include "storage.cuh"

namespace cg = cooperative_groups;

constexpr int QR_THREADS = 512;
constexpr int QR_WARPS = QR_THREADS / 32;
constexpr int QR_MAX_W = 128;       // four columns a lane in the wide passes
constexpr int QR_MAX_BW = 8;        // the slab's sums are registers
constexpr int QR_MAX_CLUSTER = 16;  // the largest (non-portable) cluster
constexpr int QR_CTA_ROWS = 256;    // rows a CTA aims for when C is chosen
constexpr int QR_SB = QR_MAX_BW + 1;  // a global row's slab columns, odd

// Shared memory of a CTA, in floats: the column step's slots and scalars
// (QR_FIXED: sc, the two parity slots of the partial sums and of row j, the
// cross-warp sums, Ts), then Zp (the published partial Z), Z and Y, bw x w
// each, and W (the warps' partial Z, QR_WARPS x 8 x 32); then, on rank 0
// only, T (w x w); then the CTA's rows, as many as the rest holds at the
// stride w | 1, and Sb for the others. Every CTA gets the device's whole
// opt-in (227 KB on an H100: at [8192, 128] and C = 16, 247 of rank 0's
// 512 rows and 384 of another rank's 512 stay in shared memory; at [4096,
// 128] every row does).
enum {
  QR_SC = 0,                                  // scalars, then g
  QR_PART = 16,                               // [2][QR_MAX_BW]
  QR_ROWJ = QR_PART + 2 * QR_MAX_BW,          // [2][QR_MAX_BW]
  QR_RED = QR_ROWJ + 2 * QR_MAX_BW,           // [QR_WARPS][QR_MAX_BW]
  QR_TS = QR_RED + QR_WARPS * QR_MAX_BW,      // [QR_MAX_BW][QR_MAX_BW]
  QR_FIXED = QR_TS + QR_MAX_BW * QR_MAX_BW
};
enum { QR_BETA, QR_TAU, QR_SCALE, QR_LIVE, QR_G0 = 8 };

// The least shared memory a CTA needs, in floats: rank 0 with T and no row
// (every row may stay in P), ~93 KB at w = 128, bw = 8.
__host__ __device__ inline size_t qr_panel_smem_floats(int w, int bw) {
  return QR_FIXED + 3 * (size_t)bw * w + QR_WARPS * QR_MAX_BW * 32 +
         (size_t)w * w;
}

// The panels the routine takes: 1 <= w <= 128, mm >= w, 1 <= bw <= 8. Rows
// that do not fit in shared memory stay in P, so mm has no limit here.
inline bool qr_panel_shape_ok(int mm, int w, int bw) {
  return w >= 1 && w <= QR_MAX_W && mm >= w && bw >= 1 && bw <= QR_MAX_BW;
}

// Sums v[t] (t < 8) over the warp's 32 lanes in a fixed order, halving the
// values a lane carries at each of three exchanges: lane l returns the sum
// for t = qr_sum8_index(l), complete in the lanes with l % 4 == 0.
__device__ inline float qr_warp_sum8(float (&v)[QR_MAX_BW], int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool up = lane & 16;
    const float give = up ? v[k] : v[k + 4];
    const float keep = up ? v[k + 4] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool up = lane & 8;
    const float give = up ? v[k] : v[k + 2];
    const float keep = up ? v[k + 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
  {
    const bool up = lane & 4;
    const float give = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
  float s = v[0];
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}
__device__ inline int qr_sum8_index(int lane) {
  return ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

// One row of A into f32, lanes over the columns; 16-byte loads through L2
// where the row is contiguous and aligned (K5's wide kernel hands the
// routine rows that other CTAs of the cluster wrote).
template <class TA>
__device__ inline void qr_load_row(const TA* src, long long as1, int w,
                                   float* dst, int lane) {
  constexpr int VEC = 16 / sizeof(TA);
  if (as1 == 1 && w % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = lane * VEC; c < w; c += 32 * VEC) {
      const uint4 u = __ldcg(reinterpret_cast<const uint4*>(src + c));
      const TA* e = reinterpret_cast<const TA*>(&u);
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[c + k] = to_f32(e[k]);
    }
  } else {
    for (int c = lane; c < w; c += 32) dst[c] = to_f32(src[c * as1]);
  }
}

// A barrier of the whole cluster. The compiler fences a cluster barrier at
// GPU scope; a cluster of one CTA needs only the block's barrier.
__device__ inline void qr_sync(const cg::cluster_group& cluster, int C) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
}

// sum_{q < C} of rank q's src[idx], in rank order (the loads all in flight
// first), so that every CTA of the cluster forms the same bits.
__device__ inline float qr_cluster_sum(const cg::cluster_group& cluster,
                                       float* src, int idx, int C) {
  float v[QR_MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < QR_MAX_CLUSTER; ++q)
    if (q < C) v[q] = cluster.map_shared_rank(src, q)[idx];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < QR_MAX_CLUSTER; ++q)
    if (q < C) s += v[q];
  return s;
}

// Launched on a cluster of C CTAs of QR_THREADS threads with smem_floats of
// shared memory each (at least qr_panel_smem_floats(w, bw)).
template <class TA, class TO, class TT>
__device__ inline void qr_panel_cluster(const TA* __restrict__ A,
                                        long long as0, long long as1, int mm,
                                        int w, int bw, float* P, TO* out,
                                        TT* __restrict__ Tout, float* smem,
                                        int smem_floats) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = w | 1;
  // rows [r0, r1): an even split, so row j belongs to rank j / per
  const int per = (mm + C - 1) / C;
  const int r0 = min(mm, rank * per), r1 = min(mm, r0 + per), nr = r1 - r0;
  float* sc = smem + QR_SC;
  float* red = smem + QR_RED;
  float* Ts = smem + QR_TS;
  float* Zp = smem + QR_FIXED;             // published: this CTA's Vs^T P
  float* Z = Zp + (size_t)bw * w;          // the cluster's sum
  float* Y = Z + (size_t)bw * w;           // Ts^T Z
  float* W = Y + (size_t)bw * w;           // the warps' partial Z
  float* T = W + QR_WARPS * QR_MAX_BW * 32;  // rank 0 only
  float* S = rank == 0 ? T + (size_t)w * w : T;
  // The first cap rows at stride ld in shared memory; each of the next nsb
  // rows keeps the slab's columns in Sb (stride QR_SB, odd) while the
  // column loop runs, the rest of it in P; rows past cap + nsb (only in
  // panels far past the port's cap) stay in P whole.
  const int avail = smem_floats - (int)(S - smem);
  int cap = nr, nsb = 0;
  if (nr * ld > avail) {
    if (ld > QR_SB && avail >= nr * QR_SB) {
      cap = (avail - nr * QR_SB) / (ld - QR_SB);
      nsb = nr - cap;
    } else {
      cap = max(0, avail / ld);
    }
  }
  float* Sb = S + (size_t)cap * ld;

  // the CTA's rows into shared memory (or P), one warp a row
  for (int r = r0 + warp; r < r1; r += QR_WARPS) {
    if (r - r0 < cap)
      qr_load_row(A + r * as0, as1, w, S + (size_t)(r - r0) * ld, lane);
    else
      qr_load_row(A + r * as0, as1, w, P + (size_t)r * w, lane);
  }
  if (rank == 0)
    for (int i = tid; i < w * w; i += QR_THREADS) T[i] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < w; j0 += bw) {
    const int j1 = min(j0 + bw, w), nbs = j1 - j0;
    // Calls f(p) with p the slab's columns of a row of this CTA: in its
    // shared-memory row, in Sb, or in P. Each call site is its own copy, so
    // the compiler sees which memory it reads.
    auto slab = [&](int r, auto f) {
      const int i = r - r0;
      if (i < cap)
        f(S + (size_t)i * ld + j0);
      else if (i < cap + nsb)
        f(Sb + (size_t)(i - cap) * QR_SB);
      else
        f(P + (size_t)r * w + j0);
    };
    for (int i = tid; i < QR_MAX_BW * QR_MAX_BW; i += QR_THREADS) Ts[i] = 0.f;
    for (int r = r0 + tid; r < r1; r += QR_THREADS) {
      const int i = r - r0;
      if (i < cap || i >= cap + nsb) continue;
      const float* p = P + (size_t)r * w + j0;
      float* b = Sb + (size_t)(i - cap) * QR_SB;
      for (int t = 0; t < nbs; ++t) b[t] = p[t];
    }
    // ---- (1) the slab's column loop; a thread keeps the same rows in pass
    // A and pass B (and in the Sb copies), so only the cross-thread steps
    // need a barrier
    for (int j = j0; j < j1; ++j) {
      const int jl = j - j0;
      float* part = smem + QR_PART + (j & 1) * QR_MAX_BW;
      float* rowj = smem + QR_ROWJ + (j & 1) * QR_MAX_BW;
      // pass A: s_t = sum_{r>j} x_r P[r, j0 + t] over the CTA's rows
      float acc[QR_MAX_BW];
#pragma unroll
      for (int t = 0; t < QR_MAX_BW; ++t) acc[t] = 0.f;
      for (int r = r0 + tid; r < r1; r += QR_THREADS) {
        if (r <= j) continue;
        slab(r, [&](const float* p) {
          const float x = p[jl];
#pragma unroll
          for (int t = 0; t < QR_MAX_BW; ++t) {
            const float e = p[min(t, nbs - 1)];
            acc[t] += x * (t < nbs ? e : 0.f);
          }
        });
      }
      {
        const float v = qr_warp_sum8(acc, lane);
        if ((lane & 3) == 0) red[warp * QR_MAX_BW + qr_sum8_index(lane)] = v;
      }
      __syncthreads();
      if (warp == 0) {
        // the 16 warps' sums: lane l adds those of warps l / 8 + 4 m for t
        // = l % 8, then lanes l, l ^ 8, l ^ 16, l ^ 24 combine
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < QR_WARPS / 4; ++m)
          v += red[((lane >> 3) + 4 * m) * QR_MAX_BW + (lane & 7)];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < nbs) {
          part[lane] = v;
          if (j >= r0 && j < r1)
            slab(j, [&](const float* p) { rowj[lane] = p[lane]; });
        }
      }
      qr_sync(cluster, C);
      // the scalars, identical on every CTA: the C partials in rank order
      if (warp == 0) {
        float s = 0.f, rv = 0.f;
        if (lane < nbs) {
          s = qr_cluster_sum(cluster, part, lane, C);
          rv = cluster.map_shared_rank(rowj, j / per)[lane];
        }
        const float alpha = __shfl_sync(0xffffffffu, rv, jl);
        const float sjj = __shfl_sync(0xffffffffu, s, jl);
        const float mu = sqrtf(alpha * alpha + sjj);
        const bool live = mu > 0.f;
        const float beta = alpha >= 0.f ? -mu : mu;
        const float sb = live ? beta : 1.f;
        const float tau = live ? (sb - alpha) / sb : 0.f;
        const float scale = live ? 1.f / (alpha - sb) : 0.f;
        const float g = rv + scale * s;
        if (lane < nbs) sc[QR_G0 + lane] = g;
        // T's column j within the slab: T[k, j] = -tau sum_{l=k}^{j-1}
        // T[k, l] (V_l^T v_j), lane k - j0 for row k
        float v = 0.f;
#pragma unroll
        for (int l = 0; l < QR_MAX_BW; ++l) {
          const float gl = __shfl_sync(0xffffffffu, g, l);
          if (l >= lane && l < jl) v += Ts[lane * QR_MAX_BW + l] * gl;
        }
        if (lane < jl) {
          Ts[lane * QR_MAX_BW + jl] = -tau * v;
          if (rank == 0) T[(size_t)(j0 + lane) * w + j] = -tau * v;
        }
        if (lane == 0) {
          Ts[jl * QR_MAX_BW + jl] = tau;
          if (rank == 0) T[(size_t)j * w + j] = tau;
          sc[QR_BETA] = beta;
          sc[QR_TAU] = tau;
          sc[QR_SCALE] = scale;
          sc[QR_LIVE] = live ? 1.f : 0.f;
        }
      }
      __syncthreads();
      // pass B: column j and the reflector on the slab's later columns
      if (sc[QR_LIVE] != 0.f) {
        const float tau = sc[QR_TAU], scale = sc[QR_SCALE], beta = sc[QR_BETA];
        float g[QR_MAX_BW];
#pragma unroll
        for (int t = 0; t < QR_MAX_BW; ++t) g[t] = t < nbs ? sc[QR_G0 + t] : 0.f;
        for (int r = r0 + tid; r < r1; r += QR_THREADS) {
          if (r < j) continue;
          slab(r, [&](float* p) {
            const float x = p[jl];
            const float v = r == j ? 1.f : x * scale;
#pragma unroll
            for (int t = 0; t < QR_MAX_BW; ++t)
              if (t > jl && t < nbs) p[t] -= tau * v * g[t];
            p[jl] = r == j ? beta : v;
          });
        }
      }
    }
    for (int r = r0 + tid; r < r1; r += QR_THREADS) {
      const int i = r - r0;
      if (i < cap || i >= cap + nsb) continue;
      const float* b = Sb + (size_t)(i - cap) * QR_SB;
      float* p = P + (size_t)r * w + j0;
      for (int t = 0; t < nbs; ++t) p[t] = b[t];
    }
    __syncthreads();
    const bool left = j0 > 0, right = j1 < w;
    if (!left && !right) break;
    // The wide passes walk the CTA's rows from j0 on: one warp a row, four
    // columns a lane (c = lane + 32 q), two rows in flight. rows(f) calls
    // f(base, stride, roff, ra, rb) for the rows [ra, rb) kept in shared
    // memory (row r at base + (r - roff) stride) and for those in P.
    const int ra = max(r0, j0), rs = min(r1, r0 + cap);
    auto rows = [&](auto f) {
      f(S, ld, r0, ra, max(ra, rs));
      f(P, w, 0, max(ra, rs), r1);
    };
    // vs(p, r): the slab's V on row r, loaded whole and then masked
    auto vs = [&](const float* p, int r, float (&v)[QR_MAX_BW]) {
#pragma unroll
      for (int i = 0; i < QR_MAX_BW; ++i) {
        const int d = j0 + i;
        const float e = p[min(d, j1 - 1)];
        v[i] = i < nbs ? (r > d ? e : (r == d ? 1.f : 0.f)) : 0.f;
      }
    };
    // ---- (2) Zp = Vs^T P[j0:, c] over the CTA's rows for every column c
    // outside the slab; the warps' partials meet in W, a column quarter at
    // a time, and are summed in warp order
    {
      float acc[QR_MAX_BW][4];
#pragma unroll
      for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
      rows([&](float* base, int stride, int roff, int rbeg, int rend) {
        for (int r = rbeg + warp; r < rend; r += 2 * QR_WARPS) {
          float x[2][4], v[2][QR_MAX_BW];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int rk = r + k * QR_WARPS;
            const bool in = rk < rend;
            const float* p = base + (size_t)((in ? rk : r) - roff) * stride;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = lane + 32 * q;
              const float e = p[min(c, w - 1)];
              x[k][q] = (in && c < w && (c < j0 || c >= j1)) ? e : 0.f;
            }
            vs(p, rk, v[k]);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][q] += v[k][i] * x[k][q];
        }
      });
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (32 * q >= w) break;
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          W[(warp * QR_MAX_BW + i) * 32 + lane] = acc[i][q];
        __syncthreads();
        if (tid < QR_MAX_BW * 32) {
          const int i = tid >> 5, c = 32 * q + lane;
          float v = 0.f;
#pragma unroll
          for (int ws = 0; ws < QR_WARPS; ++ws)
            v += W[(ws * QR_MAX_BW + i) * 32 + lane];
          if (i < nbs && c < w && (c < j0 || c >= j1))
            Zp[(size_t)i * w + c] = v;
        }
        __syncthreads();
      }
    }
    qr_sync(cluster, C);
    // Z: the C partials in rank order; then Y[i, c] = sum_{k<=i} Ts[k, i]
    // Z[k, c]: for c < j0, (V1^T Vs Ts)^T; for c >= j1, Ts^T Vs^T A_right
    for (int idx = tid; idx < nbs * w; idx += QR_THREADS) {
      const int c = idx % w;
      if (c < j0 || c >= j1) Z[idx] = qr_cluster_sum(cluster, Zp, idx, C);
    }
    __syncthreads();
    for (int idx = tid; idx < nbs * w; idx += QR_THREADS) {
      const int i = idx / w, c = idx % w;
      if (c >= j0 && c < j1) continue;
      float v = 0.f;
      for (int k = 0; k <= i; ++k)
        v += Ts[k * QR_MAX_BW + i] * Z[(size_t)k * w + c];
      Y[idx] = v;
    }
    __syncthreads();
    // T12 = -T1 (V1^T Vs Ts), T1 upper triangular: rank 0 holds T; one
    // warp a row k of T12, lanes over l
    if (rank == 0) {
      for (int k = warp; k < j0; k += QR_WARPS) {
        float a[QR_MAX_BW];
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i) a[i] = 0.f;
        for (int l = k + lane; l < j0; l += 32) {
          const float t = T[(size_t)k * w + l];
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i)
            if (i < nbs) a[i] += t * Y[(size_t)i * w + l];
        }
        const float v = qr_warp_sum8(a, lane);
        const int i = qr_sum8_index(lane);
        if ((lane & 3) == 0 && i < nbs) T[(size_t)k * w + j0 + i] = -v;
      }
    }
    // ---- (3) A_right -= Vs Y_right on the CTA's rows, Y_right in registers
    if (right) {
      float y[QR_MAX_BW][4];
#pragma unroll
      for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = lane + 32 * q;
          y[i][q] = (i < nbs && c >= j1 && c < w) ? Y[(size_t)i * w + c] : 0.f;
        }
      rows([&](float* base, int stride, int roff, int rbeg, int rend) {
        for (int r = rbeg + warp; r < rend; r += 2 * QR_WARPS) {
          float x[2][4], v[2][QR_MAX_BW];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int rk = r + k * QR_WARPS;
            const float* p =
                base + (size_t)((rk < rend ? rk : r) - roff) * stride;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              x[k][q] = p[min(lane + 32 * q, w - 1)];
            vs(p, rk, v[k]);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int rk = r + k * QR_WARPS;
            if (rk >= rend) continue;
            float* p = base + (size_t)(rk - roff) * stride;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = lane + 32 * q;
              if (c < j1 || c >= w) continue;
              float a = x[k][q];
#pragma unroll
              for (int i = 0; i < QR_MAX_BW; ++i) a -= v[k][i] * y[i][q];
              p[c] = a;
            }
          }
        }
      });
    }
    __syncthreads();
  }
  // no CTA may leave while another can still read its shared memory
  qr_sync(cluster, C);
  for (int r = r0 + warp; r < r1; r += QR_WARPS) {
    TO* dst = out + (size_t)r * w;
    if (r - r0 < cap) {
      const float* src = S + (size_t)(r - r0) * ld;
      for (int c = lane; c < w; c += 32) dst[c] = from_f32<TO>(src[c]);
    } else if (static_cast<const void*>(P) != static_cast<const void*>(out)) {
      const float* src = P + (size_t)r * w;
      for (int c = lane; c < w; c += 32) dst[c] = from_f32<TO>(src[c]);
    }
  }
  if (rank == 0)
    for (int i = tid; i < w * w; i += QR_THREADS) Tout[i] = from_f32<TT>(T[i]);
}

// ---- the wide panel: w = 256, 384, 512 by 128-column blocks (K5's wide
// kernel, qr_panel.cu, and K8's at those widths, qr_panel_batched.cu)

constexpr int QRW_B = QR_MAX_W;    // a wide panel's column block
constexpr int QRW_MAX_W = 512;     // the widest panel
constexpr int QRW_ROWS = 16;       // rows of a staged slice in the Z pass
constexpr int QRW_ZC = 192;        // columns of one Z pass

// The panels the wide kernel takes: w in {256, 384, 512}, mm >= w, 1 <= bw
// <= 8.
inline bool qr_wide_shape_ok(int mm, int w, int bw) {
  return w > QRW_B && w <= QRW_MAX_W && w % QRW_B == 0 && mm >= w &&
         bw >= 1 && bw <= QR_MAX_BW;
}

// The wide kernel's workspace, in floats: the block's packed rows [mm, 128]
// (the routine's P), T_b [128, 128], the CTAs' partial Z [16][128][w], Z and
// Y [128][w] each.
__host__ __device__ inline long long qr_wide_work_floats(int mm, int w) {
  return (long long)mm * QRW_B + QRW_B * QRW_B +
         (long long)(QR_MAX_CLUSTER + 2) * QRW_B * w;
}

// The barrier between the wide routine's steps (qr_panel.cu's note: fences
// around the cluster barrier).
__device__ inline void qrw_sync(const cg::cluster_group& cluster, int C) {
  __threadfence();
  qr_sync(cluster, C);
  __threadfence();
}

// V_b(r, i) of block c0 for row r >= c0 of the packed output (leading
// dimension w): unit lower.
__device__ inline float qrw_v(const float* out, int w, int c0, int r, int i) {
  const int rr = r - c0;
  return rr > i ? __ldcg(out + (size_t)r * w + c0 + i)
                : (rr == i ? 1.f : 0.f);
}

// The wide panel on this cluster (qr_panel.cu says how): A [mm, w] (f32 or
// bf16, widened as it is read, any strides) into out [mm, w] (f32,
// row-major) packed, T [w, w] (f32, row-major), work holding
// qr_wide_work_floats(mm, w) floats. Every thread of the cluster calls it;
// it ends with a cluster barrier, after which out and T are complete.
template <class TA>
__device__ inline void qr_panel_wide_cluster(const TA* __restrict__ A,
                                             long long as0, long long as1,
                                             int mm, int w, int bw,
                                             float* out, float* T,
                                             float* work, float* smem,
                                             int smem_floats) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gt = rank * QR_THREADS + tid, gn = C * QR_THREADS;
  float* Pb = work;                               // [mm, 128]
  float* Tb = Pb + (size_t)mm * QRW_B;            // [128, 128]
  float* Zp = Tb + QRW_B * QRW_B;                 // [16][128][w]
  float* Z = Zp + (size_t)QR_MAX_CLUSTER * QRW_B * w;   // [128][w]
  float* Y = Z + (size_t)QRW_B * w;               // [128][w]
  // the panel into the output (f32, row-major, widened from A's storage),
  // T = 0
  for (long long idx = gt; idx < (long long)mm * w; idx += gn) {
    const long long r = idx / w, c = idx % w;
    out[idx] = to_f32(A[r * as0 + c * as1]);
  }
  for (int idx = gt; idx < w * w; idx += gn) T[idx] = 0.f;
  for (int c0 = 0; c0 < w; c0 += QRW_B) {
    const int mb = mm - c0;                       // the block's rows
    qrw_sync(cluster, C);
    qr_panel_cluster<float, float, float>(out + (size_t)c0 * w + c0, w, 1,
                                          mb, QRW_B, bw, Pb, Pb, Tb, smem,
                                          smem_floats);
    qrw_sync(cluster, C);
    for (long long idx = gt; idx < (long long)mb * QRW_B; idx += gn) {
      const long long r = idx / QRW_B, c = idx % QRW_B;
      out[(c0 + r) * w + c0 + c] = __ldcg(Pb + idx);
    }
    for (int idx = gt; idx < QRW_B * QRW_B; idx += gn)
      T[(size_t)(c0 + idx / QRW_B) * w + c0 + idx % QRW_B] = __ldcg(Tb + idx);
    qrw_sync(cluster, C);
    const int per = (mb + C - 1) / C;
    const int rb = c0 + min(mb, rank * per), re = c0 + min(mb, rank * per + per);
    if (c0 > 0) {
      // ---- the T merge. Zp[rank] = V_b^T V_left over this CTA's rows of the
      // block (V_left: the output's columns c < c0, all below their
      // diagonal there)
      const int ti = tid & 15, tc = tid >> 4;
      float* Vs = smem;                              // [16][128]
      float* Xs = Vs + QRW_ROWS * QRW_B;             // [16][QRW_ZC]
      for (int oc0 = 0; oc0 < c0; oc0 += QRW_ZC) {
        const int ncp = min(QRW_ZC, c0 - oc0);
        float acc[8][6];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 6; ++q) acc[a][q] = 0.f;
        for (int r0 = rb; r0 < re; r0 += QRW_ROWS) {
          __syncthreads();
          for (int idx = tid; idx < QRW_ROWS * QRW_B; idx += QR_THREADS) {
            const int r = r0 + idx / QRW_B, i = idx % QRW_B;
            Vs[idx] = r < re ? qrw_v(out, w, c0, r, i) : 0.f;
          }
          for (int idx = tid; idx < QRW_ROWS * QRW_ZC; idx += QR_THREADS) {
            const int r = r0 + idx / QRW_ZC, o = idx % QRW_ZC;
            Xs[idx] = (r < re && o < ncp)
                          ? __ldcg(out + (size_t)r * w + oc0 + o)
                          : 0.f;
          }
          __syncthreads();
          for (int rr = 0; rr < QRW_ROWS; ++rr) {
            float v[8], x[6];
#pragma unroll
            for (int a = 0; a < 8; ++a) v[a] = Vs[rr * QRW_B + ti + 16 * a];
#pragma unroll
            for (int q = 0; q < 6; ++q) x[q] = Xs[rr * QRW_ZC + tc + 32 * q];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
              for (int q = 0; q < 6; ++q)
                acc[a][q] = fmaf(v[a], x[q], acc[a][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const int o = tc + 32 * q;
          if (o >= ncp) continue;
#pragma unroll
          for (int a = 0; a < 8; ++a)
            Zp[((size_t)rank * QRW_B + ti + 16 * a) * w + oc0 + o] =
                acc[a][q];
        }
      }
      qrw_sync(cluster, C);
      // Z: the C partials in rank order; Y = T_b^T Z, Y[i, l] = sum_{k <= i}
      // T_b[k, i] Z[k, l]
      for (int idx = gt; idx < QRW_B * c0; idx += gn) {
        const int i = idx / c0, l = idx % c0;
        float s = 0.f;
        for (int q = 0; q < C; ++q)
          s += __ldcg(Zp + ((size_t)q * QRW_B + i) * w + l);
        Z[(size_t)i * w + l] = s;
      }
      qrw_sync(cluster, C);
      for (int idx = gt; idx < QRW_B * c0; idx += gn) {
        const int i = idx / c0, l = idx % c0;
        float s = 0.f;
        for (int k = 0; k <= i; ++k)
          s = fmaf(__ldcg(Tb + k * QRW_B + i), __ldcg(Z + (size_t)k * w + l),
                   s);
        Y[(size_t)i * w + l] = s;
      }
      qrw_sync(cluster, C);
      // T[k, c0 + i] = -sum_{l = k}^{c0 - 1} T[k, l] Y[i, l], k < c0
      for (int idx = gt; idx < c0 * QRW_B; idx += gn) {
        const int k = idx / QRW_B, i = idx % QRW_B;
        float s = 0.f;
        for (int l = k; l < c0; ++l)
          s = fmaf(__ldcg(T + (size_t)k * w + l),
                   __ldcg(Y + (size_t)i * w + l), s);
        T[(size_t)k * w + c0 + i] = -s;
      }
    }
    // ---- the columns right of the block, A_right -= V_s T_s^T V_s^T
    // A_right, one slab s of the block after another (the update one slab
    // loop over the whole panel would make): a thread takes the columns
    // lane-group cl + 128 k of the rows r = group + 4 t of the CTA's share
    const int R = w - c0 - QRW_B, cr = c0 + QRW_B;
    if (R == 0) break;
    const int grp = tid >> 7, cl = tid & 127;
    float* Zs = smem;                                 // [8][R]
    float* Ys = Zs + QR_MAX_BW * R;                   // [8][R]
    float* red = Ys + QR_MAX_BW * R;                  // [4][8][R]
    for (int s0 = c0; s0 < c0 + QRW_B; s0 += bw) {
      const int nbs = min(bw, c0 + QRW_B - s0), sl = s0 - c0;
      float* zp = Zp + (size_t)((s0 / bw) & 1) * QR_MAX_CLUSTER * QR_MAX_BW * w;
      const int r1 = max(rb, s0);   // V_s is zero above row s0
      float acc[3][QR_MAX_BW];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i) acc[k][i] = 0.f;
      for (int r = r1 + grp; r < re; r += 4) {
        float v[QR_MAX_BW];
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          v[i] = i < nbs ? qrw_v(out, w, c0, r, sl + i) : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = cl + 128 * k;
          if (c >= R) continue;
          const float x = __ldcg(out + (size_t)r * w + cr + c);
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i) acc[k][i] = fmaf(v[i], x, acc[k][i]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int c = cl + 128 * k;
        if (c >= R) continue;
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          red[(grp * QR_MAX_BW + i) * R + c] = acc[k][i];
      }
      __syncthreads();
      // the CTA's partial, the four row groups summed in order
      for (int idx = tid; idx < QR_MAX_BW * R; idx += QR_THREADS) {
        const float s = red[idx] + red[QR_MAX_BW * R + idx] +
                        red[2 * QR_MAX_BW * R + idx] +
                        red[3 * QR_MAX_BW * R + idx];
        zp[(size_t)rank * QR_MAX_BW * w + idx] = s;
      }
      qrw_sync(cluster, C);
      // Z_s: the C partials in rank order; Y_s = T_s^T Z_s
      for (int idx = tid; idx < nbs * R; idx += QR_THREADS) {
        float s = 0.f;
        for (int q = 0; q < C; ++q)
          s += __ldcg(zp + (size_t)q * QR_MAX_BW * w + idx);
        Zs[idx] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < nbs * R; idx += QR_THREADS) {
        const int i = idx / R, c = idx % R;
        float s = 0.f;
        for (int k = 0; k <= i; ++k)
          s = fmaf(__ldcg(Tb + (sl + k) * QRW_B + sl + i), Zs[k * R + c], s);
        Ys[idx] = s;
      }
      __syncthreads();
      float y[3][QR_MAX_BW];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i) {
          const int c = cl + 128 * k;
          y[k][i] = (i < nbs && c < R) ? Ys[i * R + c] : 0.f;
        }
      for (int r = r1 + grp; r < re; r += 4) {
        float v[QR_MAX_BW];
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          v[i] = i < nbs ? qrw_v(out, w, c0, r, sl + i) : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = cl + 128 * k;
          if (c >= R) continue;
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i) a = fmaf(v[i], y[k][i], a);
          float* e = out + (size_t)r * w + cr + c;
          *e = __ldcg(e) - a;
        }
      }
      __syncthreads();
    }
  }
  // no CTA may leave while another can still read its shared memory
  qr_sync(cluster, C);
}


// ---- host side: the cluster size and the launch, shared by K5 and K8

// Opt the kernel into the device's whole shared memory and into clusters of
// more than 8, and choose the cluster size C for panels of mm rows: the
// smallest power of two that gives a CTA at most QR_CTA_ROWS rows (at most
// 16), halved only while the card holds no cluster of the size. C depends
// on mm and the device alone, never on the batch: C fixes the order of the
// cross-CTA sums, so a panel gets the same bits in a batch of any size.
// *resident = the clusters of C CTAs the card holds at once (a batch of
// more runs in waves). Returns a CUDA error code, cudaErrorInvalidValue past
// the routine's limits.
template <class Kernel>
int qr_prepare_cluster(Kernel kernel, int device, int mm, int w, int bw,
                       int* c, int* resident, int* smem) {
  if (!qr_panel_shape_ok(mm, w, bw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  if (sizeof(float) * qr_panel_smem_floats(w, bw) > (size_t)*smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SLATE_SET_SMEM(kernel, *smem);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  int size = 1;
  while (size < QR_MAX_CLUSTER && (mm + size - 1) / size > QR_CTA_ROWS) {
    size *= 2;
  }
  SLATE_RETURN_IF_ERROR(
      active_clusters(kernel, device, size, QR_THREADS, *smem, resident));
  while (*resident == 0 && size > 1) {
    size /= 2;
    SLATE_RETURN_IF_ERROR(
        active_clusters(kernel, device, size, QR_THREADS, *smem, resident));
  }
  *c = size;
  return 0;
}

// Launch a grid of batch clusters of c CTAs (grid (c, batch)) on stream s;
// a refused launch (a cluster the card cannot place, too much shared memory)
// is reported here, from cudaLaunchKernelEx or cudaGetLastError().
template <class Kernel, class... Args>
int qr_launch_cluster(Kernel kernel, cudaStream_t s, int c, int batch,
                      int smem, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, batch, 1);
  cfg.blockDim = dim3(QR_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
