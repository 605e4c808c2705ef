// The unpivoted LU of one tile in shared memory, and the factor launch that
// K3 (lu_panel.cu) and K7 (lu_panel_batched.cu) share, as chol_factor.cuh
// serves K1, K2 and K6. The routine computes the function of the
// reference's _lu_factor_in_place (slate_tpu/internal/pallas_lu.py:137):
// the packed L\U of the unpivoted LU of an n x n tile, n <= 128, unit lower
// diagonal implied. The blocking is this routine's own, not the reference's
// bw slabs: the plain PyTorch version (lu_kernels.py lu_tile_plain) follows
// the reference's slabs, so the two agree up to the order of their f32 sums.
//
// What bounds a tile this size (0.7 MFLOP at n = 128) on one SM is the chain
// of dependent steps and the block barriers between them: a column loop over
// the whole block pays two barriers a column and three more a slab (about
// 300 at n = 128, bw = 8). Here the tile goes in 32-column blocks j, two
// block barriers each:
//   1. the panel, one warp a work item, all at once: lane l holds row l of
//      the 32 x 32 diagonal block in registers, and every warp factors it
//      column by column, the pivot from its lane by __shfl_sync and the
//      pivot row U(t, t+1:) through the warp's own slots of shared memory,
//      so that no block barrier runs inside a block. A warp of the rows
//      below holds a 32-row chunk of A21 (lane l its row l) and solves
//      L21 = A21 U11^-1 on the way; a warp of the block row to the right
//      holds a 32-column chunk of A12 (lane l its column l) and solves
//      U12 = L11^-1 A12, L11 unit lower, each multiplier column L(t+1:, t)
//      coming through its slots too. Every warp factors the diagonal block
//      with the same instructions, hence to the same bits; warp 0 writes it
//      back after the barrier;
//   2. the trailing update A22 -= L21 U12 by every thread, from 4 x 4
//      register tiles.
// At n = 128 that is 4 steps and 8 barriers.
//
// The pivot rule is the reference's: it divides by 1 where a pivot is
// exactly 0, but only inside that pivot's bw-row slab, and the tile's rows
// below the slab meet the zero through the slab's D^-1, so they become Inf
// or NaN. Here a row in the same bw slab as column j scales by 1 where the
// pivot is 0, any later row by 1 / pivot, so that the health read
// (robust/health.py from_pivots) finds the same info and nonfinite in both.
// That is the only thing bw decides in this routine. A multiplier is the
// entry times the pivot's reciprocal (__fdividef: within 2 ulp of the
// quotient, Inf for a zero pivot), which keeps the pivot chain free of the
// IEEE division's branch.
#pragma once

#include "tri_inv.cuh"

constexpr int LF_BLOCK = 32;     // columns of a diagonal block: a warp's lanes
// Threads of the factor launch: its 8 warps take the 6 panel items of the
// first block step at nb = 128 at once, and a thread may hold the 255
// registers that a warp's two 32-float rows need (at 512 threads, capped at
// 128, they spill).
constexpr int LF_THREADS = 256;
constexpr int LF_SLOTS = 4 * LF_BLOCK;  // a warp's slots: two rows, two columns

__device__ inline void lf_load_row(float (&v)[LF_BLOCK], const float* p) {
#pragma unroll
  for (int q = 0; q < LF_BLOCK / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

__device__ inline void lf_store_row(float* p, const float (&v)[LF_BLOCK]) {
#pragma unroll
  for (int q = 0; q < LF_BLOCK / 4; ++q) {
    *reinterpret_cast<float4*>(p + 4 * q) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Lane l's row of the diagonal block (columns c0 .. c0+31) is d; b is lane
// l's row of a chunk below (cols false) or its column of a chunk to the
// right (cols true). Factor the block and solve the chunk in place, column
// by column: a row of L21 is scaled by the pivot's reciprocal and takes
// b[c] -= b[t] U(t, c); a column of U12 takes b[r] -= L(r, t) b[t], the
// same FMA with the multiplier column in place of the pivot row, so both
// kinds of warp run one code path (the loop is unrolled, 32 columns of
// straight-line code, and one copy of it stays in the instruction cache
// where two would not). d_first (b_first) is the first column of the bw
// slab of lane l's row in d (in b): where a pivot is 0, a row scales by 1
// when the pivot's column is at or past that. slots: the warp's LF_SLOTS
// floats of shared memory, 16-byte aligned: the pivot row goes through two
// of them in turn, the multiplier column through the other two, one
// __syncwarp a column.
__device__ inline void lu_block_warp(float (&d)[LF_BLOCK],
                                     float (&b)[LF_BLOCK], bool cols,
                                     int lane, int c0, int d_first,
                                     int b_first, float* slots) {
  constexpr unsigned FULL = 0xffffffffu;
#pragma unroll
  for (int t = 0; t < LF_BLOCK; ++t) {
    const float piv = __shfl_sync(FULL, d[t], t);
    const float inv = __fdividef(1.f, piv);
    const bool zero = piv == 0.f;
    if (lane > t) d[t] *= (zero && c0 + t >= d_first) ? 1.f : inv;
    if (!cols) b[t] *= (zero && c0 + t >= b_first) ? 1.f : inv;
    if (t == LF_BLOCK - 1) break;
    float* urow = slots + LF_BLOCK * (t & 1);
    float* lcol = slots + LF_BLOCK * (2 + (t & 1));
    if (lane == t) {  // U(t, c) for the quads past t
#pragma unroll
      for (int q = (t + 1) / 4; q < LF_BLOCK / 4; ++q) {
        *reinterpret_cast<float4*>(urow + 4 * q) = make_float4(
            d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
      }
    }
    lcol[lane] = d[t];  // L(lane, t) for lane > t
    __syncwarp();
    const float* bvec = cols ? lcol : urow;
#pragma unroll
    for (int q = (t + 1) / 4; q < LF_BLOCK / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(urow + 4 * q);
      const float4 w = *reinterpret_cast<const float4*>(bvec + 4 * q);
      const float u[4] = {v.x, v.y, v.z, v.w};  // U(t, 4q .. 4q+3)
      const float x[4] = {w.x, w.y, w.z, w.w};  // it, or L(4q .. 4q+3, t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * q + e;
        if (c > t) {
          if (lane > t) d[c] = fmaf(-d[t], u[e], d[c]);
          b[c] = fmaf(-b[t], x[e], b[c]);
        }
      }
    }
  }
}

// Shared memory the routine needs beside the tile, in floats, for a block
// of `threads` threads: each warp's slots.
__host__ __device__ constexpr int lu_factor_scratch(int threads) {
  return LF_SLOTS * (threads / 32);
}

// Factor the np x np tile s (row-major, leading dimension lds) in place into
// packed L\U, the slab rule above at slab width bw. np is a multiple of 32;
// lds a multiple of 4 with lds / 4 odd (np + 4), s 16-byte aligned;
// blockDim.x a multiple of 32; scratch lu_factor_scratch(blockDim.x) floats
// of shared memory, 16-byte aligned. The caller syncs before (s complete);
// the routine ends with a barrier.
__device__ inline void lu_factor_smem(float* s, int lds, int np, int bw,
                                      float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float* slots = scratch + LF_SLOTS * warp;
  float d[LF_BLOCK], b[LF_BLOCK];
  for (int c0 = 0; c0 < np; c0 += LF_BLOCK) {
    const int c1 = c0 + LF_BLOCK, chunks = (np - c1) / LF_BLOCK;
    const int d_first = c0 + lane - (c0 + lane) % bw;
    // items 0 .. chunks-1: row chunks; chunks .. 2 chunks - 1: column chunks
    for (int item = warp; item < (chunks > 0 ? 2 * chunks : 1);
         item += warps) {
      lf_load_row(d, s + (c0 + lane) * lds + c0);
      // a column chunk to the right, or a row chunk below; on the last
      // block step, with neither, the diagonal block's own rows stand in
      // and their solve is dropped
      const bool cols = chunks > 0 && item >= chunks;
      const int r = chunks > 0 ? c1 + LF_BLOCK * item + lane : c0 + lane;
      float* row = s + r * lds + c0;
      float* col = s + c0 * lds + c1 + LF_BLOCK * (item - chunks) + lane;
      if (cols) {
#pragma unroll
        for (int k = 0; k < LF_BLOCK; ++k) b[k] = col[k * lds];
      } else {
        lf_load_row(b, row);
      }
      lu_block_warp(d, b, cols, lane, c0, d_first, r - r % bw, slots);
      if (cols) {
#pragma unroll
        for (int k = 0; k < LF_BLOCK; ++k) col[k * lds] = b[k];
      } else if (chunks > 0) {
        lf_store_row(row, b);
      }
    }
    __syncthreads();  // L21 and U12 written; the diagonal block read
    if (warp == 0) lf_store_row(s + (c0 + lane) * lds + c0, d);
    // A22 -= L21 U12 in 4 x 4 tiles (bi, bj), consecutive threads on
    // consecutive bj: U12's 16-byte reads fall in consecutive bank groups,
    // L21's are shared by the threads of one bi
    const int nq = (np - c1) / 4;
    for (int idx = threadIdx.x; idx < nq * nq; idx += blockDim.x) {
      const int bi = idx / nq, bj = idx % nq;
      const float* x = s + (c1 + 4 * bi) * lds + c0;  // L21 rows
      const float* y = s + c0 * lds + c1 + 4 * bj;    // U12 columns
      float acc[4][4] = {};
#pragma unroll
      for (int q = 0; q < LF_BLOCK / 4; ++q) {
        float4 xv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = *reinterpret_cast<const float4*>(x + i * lds + 4 * q);
          yv[i] = *reinterpret_cast<const float4*>(y + (4 * q + i) * lds);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xi[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][0] = fmaf(xi[k], yv[k].x, acc[i][0]);
            acc[i][1] = fmaf(xi[k], yv[k].y, acc[i][1]);
            acc[i][2] = fmaf(xi[k], yv[k].z, acc[i][2]);
            acc[i][3] = fmaf(xi[k], yv[k].w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4* o = reinterpret_cast<float4*>(s + (c1 + 4 * bi + i) * lds +
                                              c1 + 4 * bj);
        const float4 v = *o;
        *o = make_float4(v.x - acc[i][0], v.y - acc[i][1], v.z - acc[i][2],
                         v.w - acc[i][3]);
      }
    }
    __syncthreads();  // the trailing block updated, block j written back
  }
}

// Shared memory of the factor launch, in bytes: the tile (its L\U), U^-1,
// the doubling's scratch (each nb x (nb + 4), nb x (nb + 4), nb x (nb/2 + 4)
// floats) and the warps' slots.
__host__ __device__ constexpr size_t lu_factor_launch_bytes(int nb) {
  return sizeof(float) *
         ((size_t)2 * nb * (nb + 4) + (size_t)nb * (nb / 2 + 4) +
          (size_t)lu_factor_scratch(LF_THREADS));
}

// The factor launch's body, one block of LF_THREADS threads a tile, for K3
// and K7: load4(r, c) gives elements (r, c .. c+3) of the nb x nb tile in
// f32; the tile is factored in shared memory (lu_factor_smem), store4(r, c,
// v) writes elements (r, c .. c+3) of its packed L\U; when uinv is not null
// (rows below the tile), U^-1 = triu(L\U)^-1 by K0's blocked doubling
// (tri_inv.cuh) in the same launch, into uinv [nb, nb] row-major. nb in
// {32, 64, 96, 128}; smem lu_factor_launch_bytes(nb), 16-byte aligned. A
// thread issues all its loads of the tile before its first store to shared
// memory, so that one round trip to memory, not 16, starts the launch.
template <class Load4, class Store4>
__device__ inline void lu_factor_launch(int nb, int bw, Load4 load4,
                                        Store4 store4, float* uinv,
                                        float* smem) {
  constexpr int QUADS = 128 * 128 / 4 / LF_THREADS;  // a thread's at most
  const int lds = nb + 4, ldt = nb / 2 + 4, q = nb / 4;
  float* S = smem;           // nb x lds: the tile, then its packed L\U
  float* X = S + nb * lds;   // nb x lds: U^-1
  float* T = X + nb * lds;   // nb x ldt: the doubling's scratch
  float* slots = T + nb * ldt;
  float4 v[QUADS];
#pragma unroll
  for (int e = 0; e < QUADS; ++e) {
    const int idx = threadIdx.x + e * LF_THREADS;
    if (idx < nb * q) v[e] = load4(idx / q, 4 * (idx % q));
  }
#pragma unroll
  for (int e = 0; e < QUADS; ++e) {
    const int idx = threadIdx.x + e * LF_THREADS;
    if (idx < nb * q) {
      *reinterpret_cast<float4*>(S + (idx / q) * lds + 4 * (idx % q)) = v[e];
    }
  }
  __syncthreads();
  lu_factor_smem(S, lds, nb, bw, slots);  // ends with a barrier
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += LF_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    store4(r, c, *reinterpret_cast<const float4*>(S + r * lds + c));
  }
  if (uinv == nullptr) return;
  // U = triu(S): the doubling never reads below the diagonal; it ends with
  // a barrier
  upper_tri_inv_doubling(S, lds, X, lds, T, ldt, nb);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += LF_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    *reinterpret_cast<float4*>(uinv + r * nb + c) =
        *reinterpret_cast<const float4*>(X + r * lds + c);
  }
}
