// The Cholesky factor of one tile in shared memory, shared by K1
// (chol_tile.cu), K2's factor launch (chol_panel.cu) and K6's
// (chol_panel_batched.cu). It computes the lower factor L of A = L L^T, the
// function of the reference's _chol_factor_in_place
// (slate_tpu/internal/pallas_chol.py:63), which builds the upper factor
// U = L^T in bw-row slabs. The blocking here is this routine's own, not the
// reference's bw: the plain PyTorch version (chol_kernels.py
// chol_tile_plain) follows the reference's slabs, so the two agree up to
// the order of their f32 sums.
//
// What bounds a tile this size (n <= 128, 0.7 MFLOP) on one SM is the chain
// of dependent steps and the block barriers between them; a column loop
// over the whole block pays two barriers a column. Here the tile goes in
// 32-column blocks j, two block barriers each:
//   1. the panel: every warp takes one 32-row chunk of the rows below the
//      diagonal block (warp 0 the first, or the diagonal block alone on
//      the last step). Lane l holds row l of the diagonal block and row l
//      of the warp's chunk in registers, and the warp factors the diagonal
//      block column by column while it solves its chunk against it: the
//      pivot comes from its lane by __shfl_sync and each column through
//      the warp's own slots of shared memory, so no block barrier runs
//      inside a block. Every warp factors the diagonal block
//      with the same instructions, hence to the same bits; warp 0 writes
//      it back after the barrier;
//   2. the trailing update of the lower triangle below and right of block
//      j, A22 -= L21 L21^T, by every thread from 4 x 4 register tiles (each
//      thread starts its 32-deep sum at a rotated quad, so that the
//      16-byte reads of a warp fall in distinct bank groups).
// At n = 128 that is 4 steps and 8 barriers, where a column loop over the
// block takes two a column. Works with any blockDim that is a multiple of
// 32 (a warp a 32-row chunk; more chunks than warps loop).
//
// A negative pivot gives NaN on its diagonal entry (a zero pivot 0, and Inf
// below it), and NaN reaches every later column, as in the reference: the
// health read takes the first non-finite or non-positive diagonal entry as
// info, the same index as the plain version's.
#pragma once

constexpr int CF_BLOCK = 32;  // columns of a diagonal block: a warp's lanes

// Lane l's row of the diagonal block is d, its diagonal entry own, its row
// of the chunk below b (when BELOW); factor the block and solve the chunk,
// column by column, and return lane l's pivot (the caller writes its
// sqrtf as L(l, l); d[l] is left undefined). col is the warp's 64 floats
// of shared memory: each scaled column goes there (two slots in turn, one
// __syncwarp a column) and every lane reads it back by eight 16-byte
// broadcasts, where a shuffle a row would take up to 31.
// The chain from one pivot to the next is the pivot's shuffle, rsqrtf, the
// scaling and the next diagonal's update, which each lane keeps in own: it
// holds no branch (IEEE sqrtf and division have slow paths, and a branch
// stops the compiler from overlapping the columns), so the column is
// scaled by rsqrtf(pivot), within 2 ulp of 1 / sqrtf(pivot).
template <bool BELOW>
__device__ inline float chol_block_warp(float (&d)[CF_BLOCK],
                                        float (&b)[CF_BLOCK], float own,
                                        int lane, float* col) {
  constexpr unsigned FULL = 0xffffffffu;
  float pivot = 0.f;
#pragma unroll
  for (int t = 0; t < CF_BLOCK; ++t) {
    const float x = __shfl_sync(FULL, own, t);
    const float inv = rsqrtf(x);
    if (lane == t) pivot = x;
    d[t] *= inv;  // lanes <= t: on or above the diagonal, unused
    if (BELOW) b[t] *= inv;
    if (lane > t) own -= d[t] * d[t];
    if (t == CF_BLOCK - 1) break;
    float* slot = col + CF_BLOCK * (t & 1);
    slot[lane] = d[t];  // L(lane, t)
    __syncwarp();
#pragma unroll
    for (int q = (t + 1) / 4; q < CF_BLOCK / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(slot + 4 * q);
      const float lc[4] = {v.x, v.y, v.z, v.w};  // L(4q .. 4q+3, t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * q + e > t) {
          d[4 * q + e] -= d[t] * lc[e];
          if (BELOW) b[4 * q + e] -= b[t] * lc[e];
        }
      }
    }
  }
  return pivot;
}

__device__ inline void cf_load_row(float (&v)[CF_BLOCK], const float* p) {
#pragma unroll
  for (int q = 0; q < CF_BLOCK / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

__device__ inline void cf_store_row(float* p, const float (&v)[CF_BLOCK]) {
#pragma unroll
  for (int q = 0; q < CF_BLOCK / 4; ++q) {
    *reinterpret_cast<float4*>(p + 4 * q) =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// Shared memory the routine needs beside the tile, in floats, for a block
// of `threads` threads: two column slots a warp.
__host__ __device__ constexpr int chol_factor_scratch(int threads) {
  return 2 * CF_BLOCK * (threads / 32);
}

// Factor the SPD np x np tile s (row-major, leading dimension lds; only the
// lower triangle is read) in place: on return s's lower triangle holds L,
// and its strictly upper part is undefined (callers write zeros there at
// their store). np is a multiple of 32; lds a multiple of 4 with lds / 4
// odd (np + 4), s 16-byte aligned; blockDim.x a multiple of 32; scratch
// chol_factor_scratch(blockDim.x) floats of shared memory, 16-byte aligned.
// The caller syncs before (s complete); the routine ends with a barrier.
__device__ inline void chol_factor_smem(float* s, int lds, int np,
                                        float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  float* col = scratch + 2 * CF_BLOCK * warp;
  float d[CF_BLOCK], b[CF_BLOCK], pivot = 0.f;
  for (int c0 = 0; c0 < np; c0 += CF_BLOCK) {
    const int c1 = c0 + CF_BLOCK, chunks = (np - c1) / CF_BLOCK;
    for (int item = warp; item < (chunks > 0 ? chunks : 1); item += warps) {
      cf_load_row(d, s + (c0 + lane) * lds + c0);
      const float own = s[(c0 + lane) * lds + c0 + lane];
      if (chunks > 0) {
        float* row = s + (c1 + CF_BLOCK * item + lane) * lds + c0;
        cf_load_row(b, row);
        pivot = chol_block_warp<true>(d, b, own, lane, col);
        cf_store_row(row, b);
      } else {
        pivot = chol_block_warp<false>(d, b, own, lane, col);
      }
    }
    __syncthreads();  // every chunk of L21 written; the diagonal block read
    if (warp == 0) {
      float* row = s + (c0 + lane) * lds + c0;
      cf_store_row(row, d);
      row[lane] = sqrtf(pivot);
    }
    // A22 -= L21 L21^T on the lower triangle, in 4 x 4 tiles (bi >= bj)
    const int nq = (np - c1) / 4;
    for (int idx = threadIdx.x; idx < nq * (nq + 1) / 2; idx += blockDim.x) {
      const float r8 = 8.f * idx + 1.f;  // bi = floor((sqrt(r8) - 1) / 2)
      int bi = (int)((r8 * rsqrtf(r8) - 1.f) * 0.5f);
      while (bi * (bi + 1) / 2 > idx) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= idx) ++bi;
      const int bj = idx - bi * (bi + 1) / 2;
      const float* x = s + (c1 + 4 * bi) * lds + c0;
      const float* y = s + (c1 + 4 * bj) * lds + c0;
      float acc[4][4] = {};
#pragma unroll
      for (int q = 0; q < CF_BLOCK / 4; ++q) {
        const int t = 4 * ((q + bj) % (CF_BLOCK / 4));
        float4 xv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = *reinterpret_cast<const float4*>(x + i * lds + t);
          yv[i] = *reinterpret_cast<const float4*>(y + i * lds + t);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] += xv[i].x * yv[j].x;
            acc[i][j] += xv[i].y * yv[j].y;
            acc[i][j] += xv[i].z * yv[j].z;
            acc[i][j] += xv[i].w * yv[j].w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (bi > bj || i >= j) {
            s[(c1 + 4 * bi + i) * lds + c1 + 4 * bj + j] -= acc[i][j];
          }
        }
      }
    }
    __syncthreads();  // the trailing block updated, block j written back
  }
}
