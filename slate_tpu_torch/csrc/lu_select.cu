// K4: partial-pivot row selection for one round of the CALU tournament, the
// port of lu_select_pallas (slate_tpu/internal/pallas_lu.py:338, pallas_call
// at :346, kernel _lu_select_kernel at :56).
//
//   chunks [G, W, nb] f32, any strides
//   nrows  [G] int32: rows >= nrows[g] of chunk g are dead, never chosen
//          while a live row is left
//   piv    [G, nb] int64: chunk g's nb partial-pivot rows in elimination
//          order; on input without ties, lax.linalg.lu's perm[:nb]
//
// The reference vmaps one pallas_call over a round's row blocks; here one
// launch takes the whole round, one thread-block cluster per chunk.
//
// What differs from the TPU: the reference holds a whole chunk (up to 4096
// rows of 128, 2 MB) transposed in VMEM. No block's 227 KB of shared memory
// holds that, so a chunk's rows are split evenly over a cluster of C CTAs
// (grid (C, G)), and each CTA keeps its ceil(W / C) rows at the odd stride
// nb | 1 in its shared memory for the whole launch (165 KB at W = 5120, C =
// 16). C depends on W, nb, bw and the device alone: the smallest power of
// two <= 16 whose rows and scratch fit the opt-in limit (W = 256: one CTA,
// block barriers only; W = 512: two; W = 4096 and 5120: sixteen). Chosen
// rows are masked, not swapped, as in the reference; its deferred
// (I + N)^-1 trailing update is a Mosaic idiom, replaced here by the plain
// right-looking update.
//
// Thread t of a CTA owns its row r0 + t (ceil(W / C) <= 512 threads), and
// the row's bw values of the current slab stay in its registers while the
// slab's columns are chosen. Per slab of bw columns:
//   (1) column by column: each CTA finds its candidate, the largest |v|
//       over its live rows (ties to the lowest row, as jnp.argmax breaks
//       them; dead rows lose to every live row, as the reference's -1 does)
//       by two warp reductions (__reduce_max_sync of a key ordered as |v|,
//       then __reduce_min_sync of the row) and one block barrier, and
//       writes (key, row, the row's bw slab values) into slot `rank` of
//       every CTA's exchange buffer through distributed shared memory; the
//       buffer alternates by column parity, so one cluster barrier a column
//       keeps the next column's writes off this column's reads. After the
//       barrier every warp of every CTA combines the C candidates by two
//       more warp reductions and gets the same winner, the lowest row among
//       equal values (a column with no live row left gives row 0, as the
//       reference's argmax of all -1 does). The CTA's candidate is formed
//       by every warp from the warps' candidates, warp q writing it into
//       CTA q; with one CTA (C = 1) it is the winner, and the block barrier
//       is the column's only barrier. Each thread then forms its live
//       row's multiplier l = v / pivot (0 for a zero pivot) and updates the
//       row's later slab columns with the winner's slab values, in
//       registers; the pivot row dies;
//   (2) the rows' slab values go back to shared memory, and each CTA copies
//       the slab's bw pivot rows' trailing columns from their owners
//       through distributed shared memory (a pivot row is never written
//       after it is chosen; its multipliers came with its winning slot) and
//       forms the U rows over the trailing columns, u_i = a(p_i) -
//       sum_{k<i} l_k(p_i) u_k;
//   (3) a(r, trailing) -= sum_i l_i(r) u_i for every live row of the CTA.
// A row's values change only by arithmetic on that row with the pivot
// rows' values, in the order of the first (one-block) version of this
// kernel and of the plain version (slate_tpu_torch/internal/lu_kernels.py
// lu_select_plain); only the argmax crosses CTAs, and it is exact.
//
// Past nb = 128 (nb = 256, 384, 512: the reference's gate gives its kernel
// every multiple of 128) a chunk no longer fits: at W = 5120 and nb = 512
// it is 10.5 MB, where a 16-CTA cluster's shared memory holds 3.6 MB. So
// the wide kernel (lu_select_wide_kernel) keeps a working copy of the chunk
// in device memory (the caller's workspace, never the caller's tensor; four
// chunks of a round are 42 MB, within the card's 50 MB of L2) and walks the
// nb columns by 128-column blocks. Per block:
//   - each CTA loads the block's columns of its rows into shared memory
//     (the same rows and stride 129 as the one-block kernel at nb = 128)
//     and the column loop above chooses the block's 128 pivots, with the
//     block's own later columns updated as above;
//   - the owners write the pivot rows' multipliers, L11 (unit lower, 128 x
//     128), to the workspace; the cluster forms U = L11^-1 A(pivots, the
//     columns right of the block) by forward substitution, one thread a
//     column, eight rows of L11 at a time in shared memory;
//   - each CTA updates its live rows right of the block, A -= L U, with L
//     its rows' multipliers in shared memory and U in 32 x 64 slices, a
//     thread holding a 16 x 4 tile of the product.
// The order of operations within a block is the one-block kernel's, and
// the plain version (lu_select_plain) walks the same blocks.
//
// Bound on this card: W nb^2 - nb^3/3 flops per chunk against 4 W nb bytes
// read, ~nb / 4 = 32 flops a byte, above the f32 ridge (20): bound by
// operations if the card were full. What bounds the kernel is the chain of
// nb dependent column steps: per column two warp reductions, one block
// barrier (the CTA's candidate) and, for C > 1, one cluster barrier (the
// exchange), with the chunk in shared memory and the slab in registers.
// The slab's trailing update is the only pass over all the columns. Past
// nb = 128 the chain is nb column steps long, and the chunk passes once
// through L2 per block (the load, U's pivot rows, the update).
#include <cooperative_groups.h>

#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int SEL_THREADS = 512;      // one row a thread at most
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_BLOCK = 128;        // four columns a lane in (3): the
                                      // columns in shared memory at once
constexpr int SEL_MAX_NB = 512;       // the widest chunk, in SEL_BLOCK blocks
constexpr int SEL_MAX_BW = 8;         // a row's slab values in registers
constexpr int SEL_MAX_CLUSTER = 16;   // the largest (non-portable) cluster
constexpr int SEL_SLOT = SEL_MAX_BW + 2;  // a candidate: key, row, slab
constexpr int SEL_KC = 32;            // the wide update: a slice of U's rows
constexpr int SEL_UC = 64;            // ... and of its columns
static_assert(SEL_MAX_CLUSTER <= SEL_WARPS, "warp q writes into CTA q");

// Shared memory of a CTA holding `rows` rows of a block of nb <= 128
// columns: the exchange slots [2 parities][SEL_MAX_CLUSTER][SEL_SLOT]; the
// warps' candidates (key, row, slab values), [2 parities][SEL_WARPS]; the
// slab's pivot rows, their slab values as they won (PRs) and their
// trailing columns (PR [bw][nb]); the rows themselves at stride nb | 1;
// then a live flag a row.
static size_t select_smem_bytes(int rows, int nb, int bw) {
  return sizeof(float) * (2 * SEL_MAX_CLUSTER * SEL_SLOT +
                          2 * SEL_WARPS * (2 + SEL_MAX_BW) + SEL_MAX_BW +
                          SEL_MAX_BW * SEL_MAX_BW + (size_t)bw * nb +
                          (size_t)rows * (nb | 1)) +
         (size_t)rows;
}

// The wide kernel's: the above for one SEL_BLOCK block, then (16-byte
// aligned) the block's pivot rows, eight rows of L11 and a slice of U.
static size_t select_wide_smem_bytes(int rows, int bw) {
  return select_smem_bytes(rows, SEL_BLOCK, bw) + 16 +
         sizeof(float) * (SEL_BLOCK + SEL_MAX_BW * SEL_BLOCK + SEL_KC * SEL_UC);
}

// The workspace of a wide round of G chunks, in floats: each chunk's working
// copy [W, nb], its L11 [128, 128] and U [128, nb - 128]; none at nb <= 128.
static long long select_work_floats(int W, int nb, int G) {
  return nb > SEL_BLOCK
             ? (long long)G * ((long long)W * nb + (long long)SEL_BLOCK * nb)
             : 0;
}

// A row's pivot key: a larger |v| has a larger key; a dead row 1 (it loses
// to every live row, as the reference's -1 does); 0 for no row and for NaN,
// which never wins a comparison. Ties go to the lower row.
__device__ inline unsigned sel_key(float v, bool live) {
  if (!live) return 1u;
  const float a = fabsf(v);
  return a == a ? __float_as_uint(a) + 2u : 0u;
}

// A barrier of the whole cluster (one CTA: the block's barrier).
__device__ inline void sel_sync(const cg::cluster_group& cluster, int C) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
}

// The barrier between the wide kernel's steps, whose writes to device
// memory other CTAs read (through L2, __ldcg): fenced on both sides.
__device__ inline void sel_fence_sync(const cg::cluster_group& cluster,
                                      int C) {
  __threadfence();
  sel_sync(cluster, C);
  __threadfence();
}

// A CTA's shared memory, laid out as select_smem_bytes counts it.
struct SelShared {
  float* xbuf;            // [2][16][SLOT]
  unsigned* red;          // [2][16] (key, row)
  float* red_vals;        // [2][16][8]
  int* prow;              // the slab's pivot rows
  float* PRs;             // [8][8]
  float* PR;              // [bw][nb]
  float* S;               // the rows, per x (nb | 1)
  unsigned char* live;    // a flag a row
};

__device__ inline SelShared sel_layout(float* smem, int nb, int bw,
                                       int per) {
  SelShared s;
  s.xbuf = smem;
  s.red = reinterpret_cast<unsigned*>(s.xbuf + 2 * SEL_MAX_CLUSTER * SEL_SLOT);
  s.red_vals = reinterpret_cast<float*>(s.red + 4 * SEL_WARPS);
  s.prow = reinterpret_cast<int*>(s.red_vals + 2 * SEL_WARPS * SEL_MAX_BW);
  s.PRs = reinterpret_cast<float*>(s.prow + SEL_MAX_BW);
  s.PR = s.PRs + SEL_MAX_BW * SEL_MAX_BW;
  s.S = s.PR + (size_t)bw * nb;
  s.live = reinterpret_cast<unsigned char*>(s.S + (size_t)per * (nb | 1));
  return s;
}

// The column loop over one block of nb <= 128 columns whose rows sit in
// sh.S (stride nb | 1), steps (1)-(3) above: P[j] (rank 0) and bp[j] (every
// CTA, when given) receive column j's pivot row. On return the rows hold
// the block's multipliers (live rows) or their values as they died, and
// sh.live the rows still live; `alive` is this thread's row's flag. Every
// thread of the cluster calls it after a cluster barrier that follows the
// loads of the rows; the caller synchronizes the block after it.
__device__ inline void sel_block(const cg::cluster_group& cluster, int C,
                                 int rank, const SelShared& sh, int W,
                                 int per, int r0, int nr, int nb, int bw,
                                 long long* P, int* bp, bool& alive) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = nb | 1;
  float* xbuf = sh.xbuf;
  unsigned* red = sh.red;
  float* red_vals = sh.red_vals;
  int* prow = sh.prow;
  float* PRs = sh.PRs;
  float* PR = sh.PR;
  float* S = sh.S;
  unsigned char* live = sh.live;
  const bool mine = tid < nr;
  const unsigned myrow = r0 + tid;
  float* srow = S + (size_t)tid * ld;
  for (int j0 = 0; j0 < nb; j0 += bw) {
    float vals[SEL_MAX_BW];
#pragma unroll
    for (int t = 0; t < SEL_MAX_BW; ++t)
      vals[t] = (mine && t < bw) ? srow[j0 + t] : 0.f;
#pragma unroll
    for (int i = 0; i < SEL_MAX_BW; ++i) {
      if (i >= bw) break;
      const int j = j0 + i;
      float* slots = xbuf + (j & 1) * SEL_MAX_CLUSTER * SEL_SLOT;
      // ---- (1) this CTA's candidate: the largest key, then the lowest row
      const unsigned key = mine ? sel_key(vals[i], alive) : 0u;
      const unsigned row = key ? myrow : (unsigned)W;
      const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
      const unsigned wrow =
          __reduce_min_sync(0xffffffffu, key == wkey ? row : 0xffffffffu);
      // the warps' candidates alternate by column parity too: with one CTA
      // every warp reads them after the one barrier of the column
      unsigned* redp = red + (j & 1) * 2 * SEL_WARPS;
      float* redv = red_vals + (j & 1) * SEL_WARPS * SEL_MAX_BW;
      if (lane == 0) {
        redp[2 * warp] = wkey;
        redp[2 * warp + 1] = wrow;
      }
      if (key == wkey && row == wrow) {  // the warp's candidate row's owner
#pragma unroll
        for (int t = 0; t < SEL_MAX_BW; ++t)
          if (t < bw) redv[warp * SEL_MAX_BW + t] = vals[t];
      }
      __syncthreads();
      // every warp forms the CTA's candidate from the warps' (with one CTA
      // it is the winner): the largest key, then the lowest row
      const unsigned k = lane < SEL_WARPS ? redp[2 * lane] : 0u;
      const unsigned r = lane < SEL_WARPS ? redp[2 * lane + 1] : 0xffffffffu;
      const unsigned ck = __reduce_max_sync(0xffffffffu, k);
      unsigned wr = __reduce_min_sync(0xffffffffu, k == ck ? r : 0xffffffffu);
      const int cw = __ffs(__ballot_sync(
                         0xffffffffu, lane < SEL_WARPS && k == ck && r == wr)) -
                     1;
      const float* pslab = redv + cw * SEL_MAX_BW;  // the winner's slab
      if (C > 1) {
        // warp q writes the candidate into slot `rank` of CTA q: key, row,
        // the row's slab values (none when this CTA has no row)
        if (warp < C && lane < bw + 2) {
          float val = lane == 0 ? __uint_as_float(ck) : __uint_as_float(wr);
          if (lane >= 2) val = wr < (unsigned)W ? pslab[lane - 2] : 0.f;
          cluster.map_shared_rank(slots, warp)[rank * SEL_SLOT + lane] = val;
        }
        cluster.sync();
        // the winner, the same on every CTA: the largest key over the C
        // candidates, then the lowest row (rank order on equal rows)
        const unsigned sk =
            lane < C ? __float_as_uint(slots[lane * SEL_SLOT]) : 0u;
        const unsigned sr =
            lane < C ? __float_as_uint(slots[lane * SEL_SLOT + 1])
                     : 0xffffffffu;
        const unsigned gk = __reduce_max_sync(0xffffffffu, sk);
        wr = __reduce_min_sync(0xffffffffu, sk == gk ? sr : 0xffffffffu);
        const int wq = __ffs(__ballot_sync(0xffffffffu,
                                           lane < C && sk == gk && sr == wr)) -
                       1;
        pslab = slots + wq * SEL_SLOT + 2;
      }
      float pv[SEL_MAX_BW];
#pragma unroll
      for (int t = 0; t < SEL_MAX_BW; ++t) pv[t] = t < bw ? pslab[t] : 0.f;
      if (tid == 0) {
        prow[i] = (int)wr;
        if (rank == 0) P[j] = wr;
        if (bp) bp[j] = (int)wr;
      }
      // the winner's slab values as they are now (multipliers before
      // column i), for the slab's U rows
      if (tid < bw) PRs[i * SEL_MAX_BW + tid] = pslab[tid];
      // the multiplier and the slab's later columns of this thread's row
      if (myrow == wr) {
        alive = false;
      } else if (alive) {
        const float l = (pv[i] != 0.f) ? vals[i] / pv[i] : 0.f;
        vals[i] = l;
#pragma unroll
        for (int t = i + 1; t < SEL_MAX_BW; ++t)
          if (t < bw) vals[t] = fmaf(-l, pv[t], vals[t]);
      }
    }
    const int j1 = j0 + bw;
    // ---- (2) the rows' slab values (multipliers of the live rows) back
    // into shared memory, and the pivot rows' trailing columns from their
    // owners (unchanged since the last slab's trailing update)
    if (mine) {
#pragma unroll
      for (int t = 0; t < SEL_MAX_BW; ++t)
        if (t < bw) srow[j0 + t] = vals[t];
      live[tid] = alive;
    }
    if (j1 == nb) break;
    const int m = nb - j1;
    __syncthreads();  // prow, PRs, the slab values and live flags
    for (int i = warp; i < bw; i += SEL_WARPS) {
      const int p = prow[i];
      if (p >= W) continue;  // no row at all (every value NaN): unused
      const int q = p / per;
      const float* src =
          cluster.map_shared_rank(S, q) + (size_t)(p - q * per) * ld + j1;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        if (c < m) v[k] = src[c];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        if (c < m) PR[i * nb + c] = v[k];
      }
    }
    __syncthreads();
    // U over the trailing columns in registers, u_i = a(p_i) - sum_{k<i}
    // l_k(p_i) u_k, lane's columns j1 + lane + 32 k: every warp forms the
    // same bits
    float u[SEL_MAX_BW][4];
#pragma unroll
    for (int i = 0; i < SEL_MAX_BW; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = lane + 32 * k;
        float v = 0.f;
        if (i < bw && c < m) {
          v = PR[i * nb + c];
#pragma unroll
          for (int t = 0; t < i; ++t)
            v = fmaf(-PRs[i * SEL_MAX_BW + t], u[t][k], v);
        }
        u[i][k] = v;
      }
    }
    // ---- (3) the trailing update of the CTA's live rows: one warp a row
    // (a dead row is skipped by the whole warp), lanes over the columns
    for (int r = warp; r < nr; r += SEL_WARPS) {
      if (!live[r]) continue;
      float* row = S + (size_t)r * ld;
      float l[SEL_MAX_BW];
#pragma unroll
      for (int i = 0; i < SEL_MAX_BW; ++i) l[i] = i < bw ? row[j0 + i] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = j1 + lane + 32 * k;
        if (c < nb) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < SEL_MAX_BW; ++i)
            if (i < bw) acc = fmaf(l[i], u[i][k], acc);
          row[c] = row[c] - acc;
        }
      }
    }
    __syncthreads();
  }
}

// nb <= 128: the whole chunk's rows in shared memory for the launch
// (`work` is unused).
__global__ void __launch_bounds__(SEL_THREADS)
lu_select_kernel(const float* __restrict__ chunks, long long cs0,
                 long long cs1, long long cs2, const int* __restrict__ nrows,
                 int W, int nb, int bw, long long* __restrict__ piv,
                 float* __restrict__ work) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = nb | 1, g = blockIdx.y;
  // rows [r0, r1) of the chunk: an even split, so row p lives on rank p / per
  const int per = (W + C - 1) / C;
  const int r0 = min(W, rank * per), r1 = min(W, r0 + per), nr = r1 - r0;
  const SelShared sh = sel_layout(smem, nb, bw, per);
  const float* A = chunks + g * cs0;
  // the CTA's rows into shared memory: one warp a row, a lane's (up to)
  // four columns loaded before any is stored
  for (int r = warp; r < nr; r += SEL_WARPS) {
    const float* src = A + (long long)(r0 + r) * cs1;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      if (c < nb) v[k] = src[c * cs2];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      if (c < nb) sh.S[r * ld + c] = v[k];
    }
  }
  // thread tid owns row r0 + tid (at most one: ceil(W / C) <= SEL_THREADS);
  // its slab values live in registers while the slab's columns are chosen
  bool alive = tid < nr && r0 + tid < nrows[g];
  // every CTA of the cluster has started (and loaded its rows) before any
  // writes into another's exchange buffer
  sel_sync(cluster, C);
  sel_block(cluster, C, rank, sh, W, per, r0, nr, nb, bw,
            piv + (size_t)g * nb, nullptr, alive);
  // no CTA may leave while another can still read its shared memory
  sel_sync(cluster, C);
}

// nb = 256, 384, 512: the chunk's working copy in `work`
// (select_work_floats), walked by SEL_BLOCK-column blocks (see the note at
// the top).
__global__ void __launch_bounds__(SEL_THREADS)
lu_select_wide_kernel(const float* __restrict__ chunks, long long cs0,
                      long long cs1, long long cs2,
                      const int* __restrict__ nrows, int W, int nb, int bw,
                      long long* __restrict__ piv, float* __restrict__ work) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = SEL_BLOCK | 1, g = blockIdx.y;
  const int per = (W + C - 1) / C;
  const int r0 = min(W, rank * per), r1 = min(W, r0 + per), nr = r1 - r0;
  const SelShared sh = sel_layout(smem, SEL_BLOCK, bw, per);
  int* bpv = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(sh.live + per) + 15) & ~uintptr_t(15));
  float* Ls = reinterpret_cast<float*>(bpv + SEL_BLOCK);   // [8][128]
  float* Us = Ls + SEL_MAX_BW * SEL_BLOCK;                 // [32][64]
  const float* A = chunks + g * cs0;
  long long* P = piv + (size_t)g * nb;
  // the chunk's working copy [W, nb], then L11 [128, 128], U [128, nb-128]
  float* X = work + (size_t)g * ((size_t)W * nb + (size_t)SEL_BLOCK * nb);
  float* L11 = X + (size_t)W * nb;
  float* U = L11 + SEL_BLOCK * SEL_BLOCK;
  const int ldu = nb - SEL_BLOCK;
  for (int idx = tid; idx < nr * nb; idx += SEL_THREADS) {
    const int r = idx / nb, c = idx % nb;
    X[(size_t)(r0 + r) * nb + c] = A[(long long)(r0 + r) * cs1 + c * cs2];
  }
  bool alive = tid < nr && r0 + tid < nrows[g];
  for (int c0 = 0; c0 < nb; c0 += SEL_BLOCK) {
    // the block's columns of the CTA's rows (written by this CTA alone)
    __syncthreads();
    for (int idx = tid; idx < nr * SEL_BLOCK; idx += SEL_THREADS) {
      const int r = idx / SEL_BLOCK, c = idx % SEL_BLOCK;
      sh.S[r * ld + c] = X[(size_t)(r0 + r) * nb + c0 + c];
    }
    sel_sync(cluster, C);
    sel_block(cluster, C, rank, sh, W, per, r0, nr, SEL_BLOCK, bw, P + c0,
              bpv, alive);
    __syncthreads();
    const int R = nb - c0 - SEL_BLOCK;   // the columns right of the block
    if (R == 0) break;
    // L11: pivot row i's multipliers of columns k < i, from its owner (rank
    // 0 writes zeros for a column that had no row at all)
    for (int i = warp; i < SEL_BLOCK; i += SEL_WARPS) {
      const int p = bpv[i];
      const bool none = p >= W;
      if (none ? rank != 0 : p / per != rank) continue;
      for (int k = lane; k < i; k += 32)
        L11[i * SEL_BLOCK + k] = none ? 0.f : sh.S[(p - r0) * ld + k];
    }
    sel_fence_sync(cluster, C);
    // U = L11^-1 A(pivots, right): CTA `rank` takes a range of the columns,
    // one thread a column, eight rows at a time (L11's rows staged in Ls)
    const int cpc = (R + C - 1) / C;
    const int cb = min(R, rank * cpc), ce = min(R, cb + cpc);
    for (int s = 0; s < SEL_BLOCK; s += SEL_MAX_BW) {
      __syncthreads();
      for (int idx = tid; idx < SEL_MAX_BW * SEL_BLOCK; idx += SEL_THREADS)
        Ls[idx] = __ldcg(L11 + (size_t)s * SEL_BLOCK + idx);
      __syncthreads();
      for (int c = cb + tid; c < ce; c += SEL_THREADS) {
        float acc[SEL_MAX_BW];
#pragma unroll
        for (int t = 0; t < SEL_MAX_BW; ++t) {
          const int p = bpv[s + t];
          acc[t] = p < W ? __ldcg(X + (size_t)p * nb + c0 + SEL_BLOCK + c)
                         : 0.f;
        }
        for (int k = 0; k < s; ++k) {
          const float uk = U[(size_t)k * ldu + c];
#pragma unroll
          for (int t = 0; t < SEL_MAX_BW; ++t)
            acc[t] = fmaf(-Ls[t * SEL_BLOCK + k], uk, acc[t]);
        }
#pragma unroll
        for (int t = 0; t < SEL_MAX_BW; ++t) {
#pragma unroll
          for (int k = 0; k < t; ++k)
            acc[t] = fmaf(-Ls[t * SEL_BLOCK + s + k], acc[k], acc[t]);
          U[(size_t)(s + t) * ldu + c] = acc[t];
        }
      }
    }
    sel_fence_sync(cluster, C);
    // A(live rows, right) -= L U: a thread's tile is rows ty + 32 m (m <
    // 16) by the four columns 4 tx .. 4 tx + 3 of a SEL_UC-column pass
    const int tx = tid & 15, ty = tid >> 4, nm = (nr + 31) / 32;
    for (int cb0 = 0; cb0 < R; cb0 += SEL_UC) {
      float acc[16][4];
#pragma unroll
      for (int m = 0; m < 16; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
      for (int k0 = 0; k0 < SEL_BLOCK; k0 += SEL_KC) {
        __syncthreads();
        for (int idx = tid; idx < SEL_KC * SEL_UC; idx += SEL_THREADS) {
          const int kk = idx / SEL_UC, cc = idx % SEL_UC;
          Us[idx] = cb0 + cc < R
                        ? __ldcg(U + (size_t)(k0 + kk) * ldu + cb0 + cc)
                        : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < SEL_KC; ++kk) {
          const float4 u =
              *reinterpret_cast<const float4*>(Us + kk * SEL_UC + 4 * tx);
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            if (m >= nm) break;
            const int r = min(ty + 32 * m, nr - 1);
            const float l = sh.S[r * ld + k0 + kk];
            acc[m][0] = fmaf(l, u.x, acc[m][0]);
            acc[m][1] = fmaf(l, u.y, acc[m][1]);
            acc[m][2] = fmaf(l, u.z, acc[m][2]);
            acc[m][3] = fmaf(l, u.w, acc[m][3]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const int r = ty + 32 * m;
        if (m >= nm || r >= nr || !sh.live[r]) continue;
        float* row = X + (size_t)(r0 + r) * nb + c0 + SEL_BLOCK + cb0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * tx + q;
          if (cb0 + c < R) row[c] = row[c] - acc[m][q];
        }
      }
    }
  }
  // no CTA may leave while another can still read its shared memory
  sel_sync(cluster, C);
}

static bool select_shape_ok(int W, int nb, int bw) {
  if (W < 1 || nb < 1 || bw < 1 || bw > SEL_MAX_BW || nb % bw) return false;
  return nb <= SEL_BLOCK ||
         (nb % SEL_BLOCK == 0 && nb <= SEL_MAX_NB && SEL_BLOCK % bw == 0);
}

using SelKernel = void (*)(const float*, long long, long long, long long,
                           const int*, int, int, int, long long*, float*);

// A CTA's shared memory for `rows` rows of a chunk nb wide.
static size_t select_cta_bytes(int rows, int nb, int bw) {
  return nb > SEL_BLOCK ? select_wide_smem_bytes(rows, bw)
                        : select_smem_bytes(rows, nb, bw);
}

// The cluster for a round of W-row chunks on this device: *c = the smallest
// power of two <= 16 whose ceil(W / c) rows and scratch (select_cta_bytes)
// fit one block's opt-in shared memory, 0 when none fits, the shape is past
// the kernel's limits or the card holds no cluster of that size; *smem = a
// CTA's shared memory, *resident = clusters of c the card holds at once,
// *kernel = the one-block kernel (nb <= 128) or the wide one. C never
// depends on G, so a chunk's bits do not depend on its round.
static int select_prepare(int device, int W, int nb, int bw, int* c,
                          int* smem, int* resident, SelKernel* kernel) {
  *c = *smem = *resident = 0;
  *kernel = nb > SEL_BLOCK ? lu_select_wide_kernel : lu_select_kernel;
  if (!select_shape_ok(W, nb, bw)) return 0;
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  int size = 1;
  while (size <= SEL_MAX_CLUSTER &&
         ((W + size - 1) / size > SEL_THREADS ||
          select_cta_bytes((W + size - 1) / size, nb, bw) > (size_t)limit)) {
    size *= 2;
  }
  if (size > SEL_MAX_CLUSTER) return 0;
  SLATE_SET_SMEM(*kernel, limit);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  *smem = (int)select_cta_bytes((W + size - 1) / size, nb, bw);
  SLATE_RETURN_IF_ERROR(active_clusters(*kernel, device, size, SEL_THREADS,
                                        *smem, resident));
  if (*resident > 0) *c = size;
  return 0;
}

// *fits = 1 when a round of W-row chunks can launch on this device: nb <=
// 128 with bw dividing nb, or nb in {256, 384, 512} with bw dividing 128;
// bw <= 8; and a cluster of at most 16 CTAs that holds the chunk's rows (of
// one 128-column block, past nb = 128) in shared memory (select_prepare);
// else 0. The tournament's gate asks this before it sends a round to the
// kernel.
extern "C" int slate_lu_select_fits(int device, int W, int nb, int bw,
                                    int* fits) {
  SLATE_SET_DEVICE(device);
  int c = 0, smem = 0, resident = 0;
  SelKernel kernel;
  const int e = select_prepare(device, W, nb, bw, &c, &smem, &resident,
                               &kernel);
  *fits = c > 0;
  return e;
}

// *floats = the workspace a round of G chunks [W, nb] takes: 0 at nb <= 128,
// else each chunk's working copy with its L11 and U (select_work_floats).
extern "C" int slate_lu_select_work(int device, int W, int nb, int G,
                                    int* floats) {
  (void)device;
  const long long f = select_work_floats(W, nb, G);
  if (f > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *floats = (int)f;
  return 0;
}

// How a round of W-row chunks launches on this device: *c CTAs a chunk's
// cluster (0: it does not fit), *rows rows a CTA, *smem bytes of shared
// memory a CTA, *resident clusters of *c the card holds at once, *block the
// columns of a chunk in shared memory at once (nb itself up to 128, where
// the whole chunk stays in shared memory; 128 past it, the chunk in the
// workspace).
extern "C" int slate_lu_select_plan(int device, int W, int nb, int bw,
                                    int* c, int* rows, int* smem,
                                    int* resident, int* block) {
  SLATE_SET_DEVICE(device);
  SelKernel kernel;
  const int e = select_prepare(device, W, nb, bw, c, smem, resident,
                               &kernel);
  *rows = *c > 0 ? (W + *c - 1) / *c : 0;
  *block = nb > SEL_BLOCK ? SEL_BLOCK : nb;
  return e;
}

// One launch for a round of G chunks, within slate_lu_select_fits's limits
// (past them the launch is refused with an error code); `work` holds
// slate_lu_select_work's floats (none at nb <= 128).
extern "C" int slate_lu_select(int device, void* stream, const float* chunks,
                               long long cs0, long long cs1, long long cs2,
                               const int* nrows, int G, int W, int nb, int bw,
                               long long* piv, float* work) {
  SLATE_SET_DEVICE(device);
  int c = 0, smem = 0, resident = 0;
  SelKernel kernel;
  const int e = select_prepare(device, W, nb, bw, &c, &smem, &resident,
                               &kernel);
  if (e != 0) return e;
  if (G < 1 || G > 65535 || c == 0 || (nb > SEL_BLOCK && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, G, 1);
  cfg.blockDim = dim3(SEL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, chunks, cs0, cs1,
                                             cs2, nrows, W, nb, bw, piv,
                                             work);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
