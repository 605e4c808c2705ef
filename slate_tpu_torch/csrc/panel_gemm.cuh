// The tiled f32 product of K2 (chol_panel.cu), of K3's rows below
// (lu_panel.cu) and of K6 and K7's update and solve (batched_step.cuh): one
// block's PG_BM x NB tile of A @ B over a range [kb, ke) of K, with the sum
// in registers; the rank-order sum of a split K loop's partial tiles over a
// thread-block cluster; and the solve launches' product against U^-1,
// which skips U^-1's zero lower part (pg_upper_product).
//
// A(r, k) = A[r*as0 + k*as1] and B(k, c) = B[k*bs0 + c*bs1] in global
// memory, any strides, f32 or bf16 storage (storage.cuh: widened to f32 in
// shared memory). Each KC-deep slice of both operands is staged in
// shared memory K-innermost (As[r][k], Bs[c][k], rows PG_LDK floats apart),
// PG_STAGES slices in flight:
//   - an f32 operand that is unit-stride along K, with 16-byte aligned
//     rows, is staged by cp.async 16-byte copies started PG_STAGES - 1
//     slices ahead, so that the copies overlap the FMAs (the copy's source
//     size masks the ragged end of K and the rows past the tile with zeros);
//     where the caller asks for it (PG_COPY4), an f32 operand unit-stride
//     along its other index is staged the same way by 4-byte copies;
//   - any other operand (a transposed view, an odd stride, bf16 storage)
//     is staged by plain loads that walk whichever index is unit-stride and
//     widen to f32, into the same ring at the same point, so its loads
//     stall the thread before the FMAs of the current slice.
// Each thread holds a 16 x 8 tile of the output: rows ty + TY*i, columns
// tx + TX*j (128 threads at nb = 128, 255 registers, two CTAs an SM). A
// warp is WY x WX threads, and the WX (or WY) staged rows one 16-byte read
// touches fall in distinct bank groups (PG_LDK = 36 floats shifts each
// staged row by one 16-byte group): 24 reads of 16 bytes feed 512 FMAs,
// where an 8 x 8 tile feeds 256 with 16 and needs twice the warps to keep
// the FMA pipes busy. PERF.md has the rate this reaches. Every sum runs
// over k in ascending order, so a tile's bits depend only on the operands
// and [kb, ke).
// No TF32: every product is an f32 FMA on the CUDA cores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "storage.cuh"

constexpr int PG_BM = 128;          // rows of a block's output tile
constexpr int PG_RM = 16;           // output rows a thread holds
constexpr int PG_KC = 32;           // depth of a staged K slice
constexpr int PG_LDK = PG_KC + 4;   // floats between two staged rows
constexpr int PG_STAGES = 3;        // staged slices in the ring
// (pg_slice unrolls two k-quads at a time: a whole slice unrolled is tens
// of KB of code, past what the instruction caches keep near the warps)

template <int NB>
struct PanelGemm {
  static constexpr int TX = NB / 8, TY = PG_BM / PG_RM, THREADS = TX * TY;
  static constexpr int WX = TX % 8 == 0 ? 8 : 4, WY = 32 / WX;
  static constexpr int STAGE_FLOATS = (PG_BM + NB) * PG_LDK;
  static constexpr int SMEM_FLOATS = PG_STAGES * STAGE_FLOATS;
  static_assert(NB % 32 == 0 && TY % WY == 0 && TX % WX == 0,
                "the warp layout must tile the thread grid");
};

__device__ inline void pg_cp_async16(float* dst, const float* src,
                                     int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ inline void pg_cp_async4(float* dst, const float* src,
                                    int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ inline void pg_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void pg_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// This thread's place (tx, ty) in the TX x TY grid.
template <int NB>
__device__ inline void pg_thread(int& tx, int& ty) {
  using G = PanelGemm<NB>;
  constexpr int WCOLS = G::TX / G::WX;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  tx = (warp % WCOLS) * G::WX + lane % G::WX;
  ty = (warp / WCOLS) * G::WY + lane / G::WX;
}

// How an operand is staged: plain widening loads, cp.async 16-byte copies
// (f32, s1 == 1, s0 % 4 == 0, src 16-byte aligned) or cp.async 4-byte
// copies (f32, s0 == 1).
enum { PG_LOADS = 0, PG_COPY16 = 1, PG_COPY4 = 2 };

// dst[r][k] = src(r, k0 + k) for r < R, k < PG_KC, with src(r, k) =
// src[r*s0 + k*s1]; rows at or past `rows` and k at or past ke read as 0;
// `mode` as above.
template <int R, int NT, class T>
__device__ inline void pg_stage_operand(float* dst, const T* src,
                                        long long s0, long long s1, int rows,
                                        int mode, int k0, int ke) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (mode == PG_COPY4) {
      // consecutive threads on consecutive r, the unit-stride index
      for (int idx = tid; idx < R * PG_KC; idx += NT) {
        const int r = idx % R, k = idx / R;
        const bool in = r < rows && k0 + k < ke;
        pg_cp_async4(dst + r * PG_LDK + k,
                     in ? src + r + (long long)(k0 + k) * s1 : src,
                     in ? 4 : 0);
      }
      return;
    }
    if (mode == PG_COPY16) {
      // thread tid copies 16 bytes at k = k0 + 4 (tid % Q) of rows tid / Q,
      // + STEP, + 2 STEP, ...
      constexpr int Q = PG_KC / 4, STEP = NT / Q;
      const int r0 = tid / Q, k = k0 + 4 * (tid % Q);
      int kbytes = 4 * (ke - k);
      kbytes = kbytes < 0 ? 0 : (kbytes > 16 ? 16 : kbytes);
      const float* p = src + r0 * s0 + k;
      float* d = dst + r0 * PG_LDK + 4 * (tid % Q);
#pragma unroll
      for (int e = 0; e < (R + STEP - 1) / STEP; ++e) {
        const int r = r0 + e * STEP;
        if (r >= R) break;
        const int bytes = r < rows ? kbytes : 0;
        pg_cp_async16(d + e * STEP * PG_LDK,
                      bytes ? p + e * STEP * s0 : src, bytes);
      }
      return;
    }
  }
  if (s1 == 1) {
    for (int idx = tid; idx < R * PG_KC; idx += NT) {
      const int r = idx / PG_KC, k = idx % PG_KC;
      dst[r * PG_LDK + k] =
          (r < rows && k0 + k < ke) ? to_f32(src[r * s0 + k0 + k]) : 0.f;
    }
  } else {
    for (int idx = tid; idx < R * PG_KC; idx += NT) {
      const int r = idx % R, k = idx / R;
      dst[r * PG_LDK + k] =
          (r < rows && k0 + k < ke)
              ? to_f32(src[r * s0 + (long long)(k0 + k) * s1])
              : 0.f;
    }
  }
}

// acc[i][j] += sum over the PG_KC staged k of As[ty+TY*i][k] * Bs[tx+TX*j][k]
// for the column blocks j >= J0 (the others are left as they are)
template <int NB, int J0 = 0>
__device__ inline void pg_slice(float (&acc)[PG_RM][8], const float* As,
                                const float* Bs, int tx, int ty) {
  using G = PanelGemm<NB>;
#pragma unroll 2
  for (int k = 0; k < PG_KC; k += 4) {
    float4 b[8];
#pragma unroll
    for (int j = J0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bs + (tx + G::TX * j) * PG_LDK +
                                              k);
#pragma unroll
    for (int i = 0; i < PG_RM; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(As + (ty + G::TY * i) * PG_LDK + k);
      // k by k across the row's sums: no two FMAs in a row on one sum
#pragma unroll
      for (int j = J0; j < 8; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
      for (int j = J0; j < 8; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
      for (int j = J0; j < 8; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
      for (int j = J0; j < 8; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
    }
  }
}

// The ring in smem (PanelGemm<NB>::SMEM_FLOATS floats, 16-byte aligned)
// over nk staged slices: stage(s, As) stages slice s into the ring slot As
// (A's PG_BM rows, then B's NB rows at As + PG_BM * PG_LDK), PG_STAGES - 1
// slices ahead of compute(s, As), which takes slice s from its slot. Every
// thread of the block calls it; it ends with a barrier, after which smem is
// free.
template <int NB, class Stage, class Compute>
__device__ inline void pg_ring(int nk, Stage stage, Compute compute,
                               float* smem) {
  using G = PanelGemm<NB>;
#pragma unroll
  for (int s = 0; s < PG_STAGES - 1; ++s) {
    if (s < nk) stage(s, smem + s * G::STAGE_FLOATS);
    pg_cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    pg_cp_async_wait<PG_STAGES - 2>();  // slice s has landed
    __syncthreads();  // ... for every thread, and slice s - 1 is consumed
    const int next = s + PG_STAGES - 1;
    if (next < nk) stage(next, smem + (next % PG_STAGES) * G::STAGE_FLOATS);
    pg_cp_async_commit();
    compute(s, smem + (s % PG_STAGES) * G::STAGE_FLOATS);
  }
  pg_cp_async_wait<0>();
  __syncthreads();
}

// acc += the product of nk staged slices, through the ring (pg_ring).
template <int NB, class Stage>
__device__ inline void pg_pipeline(float (&acc)[PG_RM][8], int nk,
                                   Stage stage, float* smem, int tx, int ty) {
  pg_ring<NB>(
      nk, stage,
      [&](int, const float* As) {
        pg_slice<NB>(acc, As, As + PG_BM * PG_LDK, tx, ty);
      },
      smem);
}

// The slices of [kb, ke): PG_KC deep, the last one ragged.
__device__ inline int pg_slices(int kb, int ke) {
  return ke > kb ? (ke - kb + PG_KC - 1) / PG_KC : 0;
}

// Stage slice s of A[0:rows, kb:ke] and B[kb:ke, 0:cols] into the ring
// slot As (pg_stage_operand for each operand; B's columns at or past cols
// read as 0).
template <int NB, class T>
__device__ inline void pg_stage_slice(float* As, int s, const T* A,
                                      long long as0, long long as1, int rows,
                                      int mode_a, const T* B, long long bs0,
                                      long long bs1, int cols, int mode_b,
                                      int kb, int ke) {
  using G = PanelGemm<NB>;
  const int k0 = kb + s * PG_KC;
  pg_stage_operand<PG_BM, G::THREADS>(As, A, as0, as1, rows, mode_a, k0,
                                      ke);
  // B(k, c) as rows c of Bs: the row stride of that view is bs1
  pg_stage_operand<NB, G::THREADS>(As + PG_BM * PG_LDK, B, bs1, bs0, cols,
                                   mode_b, k0, ke);
}

// acc += A[0:rows, kb:ke] @ B[kb:ke, 0:NB] for this block's tile, through
// the ring in smem (pg_pipeline).
template <int NB, class T>
__device__ inline void pg_product(float (&acc)[PG_RM][8], const T* A,
                                  long long as0, long long as1, int rows,
                                  int mode_a, const T* B, long long bs0,
                                  long long bs1, int mode_b, int kb, int ke,
                                  float* smem, int tx, int ty) {
  pg_pipeline<NB>(
      acc, pg_slices(kb, ke),
      [&](int s, float* As) {
        pg_stage_slice<NB>(As, s, A, as0, as1, rows, mode_a, B, bs0, bs1,
                           NB, mode_b, kb, ke);
      },
      smem, tx, ty);
}

// The first column block j of slice s that meets U^-1's upper triangle:
// block j holds columns TX j .. TX j + TX - 1, slice s rows 32 s .. 32 s +
// 31, and U^-1(k, c) = 0 for k > c, so the blocks before this one sum only
// zeros from slice s.
template <int NB>
__host__ __device__ constexpr int pg_first_block(int s) {
  return PG_KC * s / PanelGemm<NB>::TX < 8 ? PG_KC * s / PanelGemm<NB>::TX
                                            : 8;
}

// acc += A[0:rows, 0:nb] @ X for an upper-triangular X [nb, nb] in global
// memory (row-major, leading dimension nb; nb <= NB, nb % 32 == 0, columns
// at or past nb read as 0), through the ring in smem (pg_ring): each slice
// skips the column blocks left of its diagonal, which would add exact zeros
// (pg_first_block), so the product takes sum over s of (8 - j0(s)) / 8 of
// the full one's FMAs (20 / 32 at nb = 128). A (f32) is staged as mode_a
// says, X by 4-byte cp.async (unit-stride along its columns). The solve launches of
// K2, K3, K6 and K7 (L21 = A21 U^-1) all run this one product.
template <int NB>
__device__ inline void pg_upper_product(float (&acc)[PG_RM][8], const float* A,
                                        long long as0, long long as1,
                                        int rows, int mode_a, const float* X,
                                        int nb, float* smem, int tx, int ty) {
  static_assert(NB <= 4 * PG_KC, "at most four slices");
  constexpr int J1 = pg_first_block<NB>(1), J2 = pg_first_block<NB>(2),
                J3 = pg_first_block<NB>(3);
  pg_ring<NB>(
      pg_slices(0, nb),
      [&](int s, float* As) {
        pg_stage_slice<NB>(As, s, A, as0, as1, rows, mode_a, X, nb, 1, nb,
                           PG_COPY4, 0, nb);
      },
      [&](int s, const float* As) {
        const float* Bs = As + PG_BM * PG_LDK;
        switch (s) {
          case 0: pg_slice<NB, 0>(acc, As, Bs, tx, ty); break;
          case 1: pg_slice<NB, J1>(acc, As, Bs, tx, ty); break;
          case 2: pg_slice<NB, J2>(acc, As, Bs, tx, ty); break;
          default: pg_slice<NB, J3>(acc, As, Bs, tx, ty);
        }
      },
      smem);
}

// The solve launch of K2 (chol_panel.cu) and K3 (lu_panel.cu), one block of
// PanelGemm<NB>::THREADS threads a 128-row tile: out rows 0 .. rows-1
// (row-major, NB wide) = A rows @ X, X = U^-1 upper triangular [NB, NB]
// row-major, by pg_upper_product; A f32 with any strides, staged as mode_a
// says.
template <int NB>
__device__ inline void pg_solve_rows(const float* A, long long as0,
                                     long long as1, int mode_a, int rows,
                                     const float* X, float* out,
                                     float* smem) {
  using G = PanelGemm<NB>;
  int tx, ty;
  pg_thread<NB>(tx, ty);
  float acc[PG_RM][8] = {};
  pg_upper_product<NB>(acc, A, as0, as1, rows, mode_a, X, NB, smem, tx, ty);
#pragma unroll
  for (int i = 0; i < PG_RM; ++i) {
    const int r = ty + G::TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(long long)r * NB + tx + G::TX * j] =
        acc[i][j];
  }
}

// 1 when an f32 operand with these strides stages by cp.async 16-byte
// copies: unit-stride along K (stride_k == 1), the other stride a multiple
// of 4 floats, and the base 16-byte aligned.
inline int staged_by_copy(const float* p, long long stride_k,
                          long long stride_other) {
  return stride_k == 1 && stride_other % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The row stride of a partial tile in shared memory: 8-bank shifts a row.
template <int NB>
__host__ __device__ constexpr int pg_partial_ld() {
  return NB + 8;
}

// The rank-order sum of a split K loop over this thread-block cluster: every
// CTA publishes its partial tile acc to P (PG_BM x pg_partial_ld<NB>()
// floats of its shared memory, free after pg_product), then adds the S
// partials of its 1/S share of the tile, four columns at a time over rows
// r < rows, and hands each sum to put(r, c, sum) (columns c .. c+3). Each
// quad is summed by one CTA over ranks 0 .. S-1 in order, with no atomics,
// so the bits depend on S and the operands alone. Every CTA of the cluster
// calls it; it ends with a cluster barrier, after which no partial is read.
template <int NB, class Put>
__device__ inline void pg_cluster_sum(const float (&acc)[PG_RM][8], float* P,
                                      int rows, int tx, int ty, Put put) {
  using G = PanelGemm<NB>;
  constexpr int LDP = pg_partial_ld<NB>(), Q = NB / 4;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
#pragma unroll
  for (int i = 0; i < PG_RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      P[(ty + G::TY * i) * LDP + tx + G::TX * j] = acc[i][j];
  cluster.sync();
  const int lo = rank * (PG_BM * Q) / S, hi = (rank + 1) * (PG_BM * Q) / S;
  for (int idx = lo + (int)threadIdx.x; idx < hi; idx += G::THREADS) {
    const int r = idx / Q, c = 4 * (idx % Q);
    if (r >= rows) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(P, q) + r * LDP + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    put(r, c, s);
  }
  cluster.sync();  // every CTA's share stored; no partial is read again
}
