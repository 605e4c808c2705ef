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
// block barriers only; W = 512: two; W = 4096 and 5120: sixteen), and past
// nb = 128 more where placed (below). Chosen
// rows are masked, not swapped, as in the reference; its deferred
// (I + N)^-1 trailing update is a Mosaic idiom, replaced here by the plain
// right-looking update.
//
// Thread t of a CTA owns its row r0 + t (ceil(W / C) <= 512 threads), and
// the row's bw values of the current slab stay in its registers while the
// slab's columns are chosen (bw = 8, the plans' width, is compiled in, so
// that the unrolled loops keep no run-time tests). Per slab of bw columns:
//   (1) column by column, by the warps that own rows: each CTA finds its
//       candidate, the largest |v| over its live rows (ties to the lowest
//       row, as jnp.argmax breaks them; dead rows lose to every live row,
//       as the reference's -1 does) by two warp reductions (__reduce_max_
//       sync of a key ordered as |v|, then __reduce_min_sync of the row), a
//       barrier of those warps and two more reductions over the warps'
//       candidates. With one CTA that is the winner. Past one, warp 0's lane
//       q sends the candidate (key, row, the row's bw slab values) into slot
//       `rank` of CTA q's exchange buffer by st.async, whose bytes complete
//       a phase of CTA q's mbarrier for the column's parity (each CTA
//       expects C candidates a phase; its own arrival posts the count). A
//       CTA waits on its own barrier only: no cluster barrier a column. The
//       complete_tx is a release at cluster scope and the wait an acquire
//       there, so what a sender's CTA wrote before its send (its rows' last
//       trailing update) is visible to the receiver too. Every waiting warp
//       then combines the C candidates by two more reductions and gets the
//       same winner, the lowest row among equal values (a column with no
//       live row left gives row 0, as the reference's argmax of all -1
//       does). Each thread forms its live row's multiplier l = v / pivot (0
//       for a zero pivot) and updates the row's later slab columns with the
//       winner's slab values, in registers; the pivot row dies. The buffer
//       and barrier alternate by column parity: a CTA sends column j + 2
//       only after every CTA's column j + 1, which each sends after reading
//       column j;
//   (2) the rows' slab values go back to shared memory, and each CTA copies
//       the slab's bw pivot rows' trailing columns from their owners
//       through distributed shared memory (a pivot row is never written
//       after it is chosen; its multipliers came with its winning slot) and
//       forms the U rows over the trailing columns, u_i = a(p_i) -
//       sum_{k<i} l_k(p_i) u_k, a thread a column;
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
// nb columns by 128-column blocks. It takes more CTAs than its shared
// memory forces where the card places them, at most 128 rows a CTA (W =
// 512: four, 1024: eight; 5120 stays at sixteen), so that (3) and the
// phases below spread a row over two or four threads while the column
// chain costs about the same. Per block:
//   - each CTA loads the block's columns of its rows into shared memory
//     (the same rows and stride 129 as the one-block kernel at nb = 128:
//     from the chunk for the first block, from the working copy after it)
//     and the column loop above chooses the block's 128 pivots, with the
//     block's own later columns updated as above ((3) by U rows kept by
//     column, four columns a step);
//   - the owners write the pivot rows' multipliers, L11 (unit lower, 128 x
//     128), to the workspace; past the split cluster barrier's two halves
//     each CTA forms its range of the columns of U = L11^-1 A(pivots, the
//     columns right of the block) a warp four columns at a time, by 32-row
//     blocks: less the earlier blocks, then the block's own unit triangle
//     a row a step, u_t broadcast by a shuffle (L11 staged in shared memory
//     where the launch left room for it: few rows a CTA);
//   - each CTA updates its live rows right of the block, A -= L U, with L
//     its rows' multipliers in shared memory and U in double-buffered
//     slices of its rows, a thread holding two to four rows of eight
//     columns (the first block reads the chunk and writes the working
//     copy, which holds a row's columns right of a block from then on).
// The plain version (lu_select_plain) walks the same blocks.
//
// Bound on this card: W nb^2 - nb^3/3 flops per chunk against 4 W nb bytes
// read, ~nb / 4 = 32 flops a byte, above the f32 ridge (20): bound by
// operations if the card were full. What bounds the kernel is the chain of
// nb dependent column steps: per column four warp reductions and a barrier
// of the warps with rows and, for C > 1, one exchange (a remote store and
// its barrier's phase), with the chunk in shared memory and the slab in
// registers. The slab's trailing update is the only pass over all the
// columns. Past nb = 128 the chain is nb column steps long, and the chunk
// passes once through L2 per block (the load, U's pivot rows, the update).
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
constexpr int SEL_STAGE = 2048;       // the wide update's two slices of U
static_assert(SEL_MAX_CLUSTER <= SEL_WARPS, "warp q writes into CTA q");
// The wide kernel's stamps a (block, CTA): the block's start, its rows
// loaded, its column chain done, L11 and U formed, the update done
constexpr int SEL_STAMPS = 5;

__device__ inline long long sel_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Shared memory of a CTA holding `rows` rows of a block of nb <= 128
// columns: the exchange's two mbarriers (one a column parity); the exchange
// slots [2 parities][SEL_MAX_CLUSTER][SEL_SLOT]; the warps' candidates
// (key, row, slab values), [2 parities][SEL_WARPS]; the slab's pivot rows,
// their slab values as they won (PRs) and their trailing columns (PR [bw]
// [nb], then the slab's U rows in place); the rows themselves at stride nb
// | 1; then a live flag a row.
__host__ __device__ inline size_t select_smem_bytes(int rows, int nb, int bw) {
  return sizeof(float) * (4 + 2 * SEL_MAX_CLUSTER * SEL_SLOT +
                          2 * SEL_WARPS * (2 + SEL_MAX_BW) + SEL_MAX_BW +
                          SEL_MAX_BW * SEL_MAX_BW + (size_t)bw * nb +
                          (size_t)rows * (nb | 1)) +
         (size_t)rows;
}

// The wide kernel's: the above for one SEL_BLOCK block, then (16-byte
// aligned) the block's pivot rows, the update's two slices of U and a
// slab's U rows by column (the first wide kernel's bytes, so that the
// rounds that fit, and so the launches of a solve, stay as they were).
__host__ __device__ inline size_t select_wide_smem_bytes(int rows, int bw) {
  return select_smem_bytes(rows, SEL_BLOCK, bw) + 16 +
         sizeof(float) * (SEL_BLOCK + SEL_STAGE + SEL_MAX_BW * SEL_BLOCK);
}

// L11 staged in a CTA's shared memory for U's solve (stride SEL_BLOCK + 1),
// past the wide kernel's bytes, where the card's limit leaves room for it
// (a CTA's rows of the chunk are few); the kernel reads the room it was
// given from %dynamic_smem_size.
constexpr size_t SEL_L11_BYTES =
    sizeof(float) * SEL_BLOCK * (SEL_BLOCK + 1) + 16;

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

// The cluster barrier in two halves between the wide kernel's phases, whose
// writes to device memory other CTAs read (through L2, __ldcg): sel_arrive
// publishes them (a device-scope fence, then the arrival, a release), and
// sel_wait blocks until the whole cluster has arrived (an acquire), then
// fences. Between the two a CTA goes on with work no other CTA's arrival
// gates. One CTA: the block's barrier at the wait.
__device__ inline void sel_arrive(int C) {
  __threadfence();
  if (C > 1) asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ inline void sel_wait(int C) {
  if (C > 1)
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
  else
    __syncthreads();
  __threadfence();
}

// The exchange's mbarriers (PTX mbarrier, shared::cta, 8 bytes each): a
// phase a column of its parity, completed by the CTA's own arrival, which
// expects the candidates' bytes, and by those bytes landing (st.async with
// complete_tx: no fence on the sender's side).
constexpr unsigned SEL_SLOT_BYTES = sizeof(float) * SEL_SLOT;

__device__ inline unsigned sel_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void sel_mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   sel_smem_addr(bar))
               : "memory");
}

// This CTA's arrival on its barrier for the coming phase, expecting `bytes`.
__device__ inline void sel_mbar_expect(unsigned long long* bar,
                                       unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sel_smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The candidate (SEL_SLOT floats, v) into slot `slot` of CTA `to`, each
// 8-byte store counted on CTA `to`'s barrier `bar` as it lands.
__device__ inline void sel_send(const float* slot, const float (&v)[SEL_SLOT],
                                unsigned long long* bar, int to) {
  unsigned rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rs)
               : "r"(sel_smem_addr(slot)), "r"(to));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(sel_smem_addr(bar)), "r"(to));
#pragma unroll
  for (int e = 0; e < SEL_SLOT; e += 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(rs + 4 * e),
        "f"(v[e]), "f"(v[e + 1]), "r"(rb)
        : "memory");
  }
}

// Until the phase of `bar` with this parity has completed: an acquire at
// cluster scope, which the senders' complete_tx (a release at cluster
// scope) synchronizes with, so that what each sender's CTA wrote before
// its send (its rows' last trailing update) is visible too. A wait that
// outlasts 2^31 polls traps, so that a lost hand-off fails the launch
// rather than hang the card.
__device__ inline void sel_mbar_wait(unsigned long long* bar,
                                     unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(sel_smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0x80000000u) __trap();
  }
}

// The active warps' barrier (named barrier 1): the warps that own rows.
__device__ inline void sel_bar_active(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
}

// A CTA's shared memory, laid out as select_smem_bytes counts it.
struct SelShared {
  unsigned long long* mbar;   // [2]: the exchange, a column parity each
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
  s.mbar = reinterpret_cast<unsigned long long*>(smem);
  s.xbuf = smem + 4;
  s.red = reinterpret_cast<unsigned*>(s.xbuf + 2 * SEL_MAX_CLUSTER * SEL_SLOT);
  s.red_vals = reinterpret_cast<float*>(s.red + 4 * SEL_WARPS);
  s.prow = reinterpret_cast<int*>(s.red_vals + 2 * SEL_WARPS * SEL_MAX_BW);
  s.PRs = reinterpret_cast<float*>(s.prow + SEL_MAX_BW);
  s.PR = s.PRs + SEL_MAX_BW * SEL_MAX_BW;
  s.S = s.PR + (size_t)bw * nb;
  s.live = reinterpret_cast<unsigned char*>(s.S + (size_t)per * (nb | 1));
  return s;
}

// Before the first exchange: thread 0 readies the exchange's barriers for
// C arrivals a phase; the caller's cluster barrier then orders this before
// any CTA's arrival.
__device__ inline void sel_init(const SelShared& sh, int C) {
  if (threadIdx.x == 0 && C > 1) {
    sel_mbar_init(sh.mbar);
    sel_mbar_init(sh.mbar + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The column loop over one block of nb <= 128 columns whose rows sit in
// sh.S (stride nb | 1), steps (1)-(3) above: P[j] (rank 0) and bp[j] (every
// CTA, when given) receive column j's pivot row; `col0`, the block's first
// column of the chunk, sets the exchange's phases (its barriers complete
// one phase a column). On return the rows hold the block's multipliers
// (live rows) or their values as they died, and sh.live the rows still
// live; `alive` is this thread's row's flag. Every thread of the cluster
// calls it after sel_init and a cluster barrier that follows the loads of
// the rows; the caller synchronizes the block after it.
template <int BWC>
__device__ inline void sel_block_bw(const cg::cluster_group& cluster, int C,
                                    int rank, const SelShared& sh, int W,
                                    int per, int r0, int nr, int nb,
                                    int bw_arg, int col0, long long* P,
                                    int* bp, float* ut, bool& alive) {
  // a slab width known when compiled (BWC) resolves every `< bw` test of
  // the unrolled loops below; 0: the launch's
  const int bw = BWC ? BWC : bw_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = nb | 1;
  // the warps that own rows (warp 0 at least: it sends the candidate)
  const int active = max(1, (nr + 31) / 32);
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
    if (warp < active) {
#pragma unroll
      for (int i = 0; i < SEL_MAX_BW; ++i) {
        if (i >= bw) break;
        const int j = j0 + i, par = (col0 + j) & 1;
        float* slots = xbuf + par * SEL_MAX_CLUSTER * SEL_SLOT;
        // ---- (1) this CTA's candidate: the largest key, then the lowest
        // row, by each warp, then by warp 0 over the warps'
        const unsigned key = mine ? sel_key(vals[i], alive) : 0u;
        const unsigned row = key ? myrow : (unsigned)W;
        const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
        const unsigned wrow =
            __reduce_min_sync(0xffffffffu, key == wkey ? row : 0xffffffffu);
        unsigned* redp = red + par * 2 * SEL_WARPS;
        float* redv = red_vals + par * SEL_WARPS * SEL_MAX_BW;
        if (lane == 0) {
          redp[2 * warp] = wkey;
          redp[2 * warp + 1] = wrow;
        }
        if (key == wkey && row == wrow) {  // the warp's candidate's owner
#pragma unroll
          for (int t = 0; t < SEL_MAX_BW; ++t)
            if (t < bw) redv[warp * SEL_MAX_BW + t] = vals[t];
        }
        sel_bar_active(active);
        // every active warp forms the CTA's candidate from the warps'
        const unsigned k = lane < active ? redp[2 * lane] : 0u;
        const unsigned r = lane < active ? redp[2 * lane + 1] : 0xffffffffu;
        const unsigned ck = __reduce_max_sync(0xffffffffu, k);
        unsigned wr =
            __reduce_min_sync(0xffffffffu, k == ck ? r : 0xffffffffu);
        const int cw =
            __ffs(__ballot_sync(0xffffffffu,
                                lane < active && k == ck && r == wr)) -
            1;
        const float* pslab = redv + cw * SEL_MAX_BW;  // the winner's slab
        if (C > 1) {
          // warp 0's lane q sends the candidate (key, row, the row's slab
          // values: none when this CTA has no row) into slot `rank` of CTA
          // q, its bytes counted on CTA q's barrier of this column's parity
          if (tid == 0) sel_mbar_expect(sh.mbar + par, C * SEL_SLOT_BYTES);
          if (warp == 0 && lane < C) {
            float v[SEL_SLOT];
            v[0] = __uint_as_float(ck);
            v[1] = __uint_as_float(wr);
#pragma unroll
            for (int t = 0; t < SEL_MAX_BW; ++t)
              v[2 + t] = t < bw && wr < (unsigned)W ? pslab[t] : 0.f;
            sel_send(slots + rank * SEL_SLOT, v, sh.mbar + par, lane);
          }
          // the winner, the same on every CTA: the largest key over the C
          // candidates, then the lowest row (rank order on equal rows)
          sel_mbar_wait(sh.mbar + par, ((col0 + j) >> 1) & 1);
          const unsigned sk =
              lane < C ? __float_as_uint(slots[lane * SEL_SLOT]) : 0u;
          const unsigned sr =
              lane < C ? __float_as_uint(slots[lane * SEL_SLOT + 1])
                       : 0xffffffffu;
          const unsigned gk = __reduce_max_sync(0xffffffffu, sk);
          wr = __reduce_min_sync(0xffffffffu, sk == gk ? sr : 0xffffffffu);
          const int wq =
              __ffs(__ballot_sync(0xffffffffu,
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
    // U over the trailing columns, u_i = a(p_i) - sum_{k<i} l_k(p_i) u_k, a
    // thread a column: into ut[c][0 .. 7] (zeros past bw) when given, else
    // in place of the pivot rows' values in PR
    for (int c = tid; c < m; c += SEL_THREADS) {
      float u[SEL_MAX_BW];
#pragma unroll
      for (int i = 0; i < SEL_MAX_BW; ++i) {
        float v = 0.f;
        if (i < bw) {
          v = PR[i * nb + c];
#pragma unroll
          for (int t = 0; t < i; ++t)
            v = fmaf(-PRs[i * SEL_MAX_BW + t], u[t], v);
          if (ut == nullptr) PR[i * nb + c] = v;
        }
        u[i] = v;
      }
      if (ut != nullptr) {
        float4* o = reinterpret_cast<float4*>(ut + SEL_MAX_BW * c);
        o[0] = make_float4(u[0], u[1], u[2], u[3]);
        o[1] = make_float4(u[4], u[5], u[6], u[7]);
      }
    }
    __syncthreads();
    // ---- (3) the trailing update of the CTA's live rows. With ut (U rows
    // by column): each row by SEL_THREADS / cap threads (cap = the rows
    // rounded up to a quarter or a half of the block, or all), each a run
    // of the columns, the slab's multipliers read back from the row;
    // without: each row by its own thread, the multipliers in its
    // registers. Either way a column's sum is formed in one order.
    if (ut != nullptr) {
      // items (row, run): each row's columns in `runs` runs, the nr runs
      // items spread over the block (runs = 4, 2 or 3: at most two items a
      // thread past 256 rows)
      const int runs = nr <= SEL_THREADS / 4   ? 4
                       : nr <= SEL_THREADS / 2 ? 2
                                               : 3;
      const int per_run = (m + runs - 1) / runs;
      for (int it = tid; it < nr * runs; it += SEL_THREADS) {
        const int r = it % nr, cb = it / nr * per_run;
        if (!live[r]) continue;
        float* row = S + (size_t)r * ld;
        float l[SEL_MAX_BW];
#pragma unroll
        for (int i = 0; i < SEL_MAX_BW; ++i) l[i] = i < bw ? row[j0 + i] : 0.f;
        const int ce = min(m, cb + per_run);
        int c = cb;
        // four columns a step, their loads issued before their sums
        for (; c + 4 <= ce; c += 4) {
          float4 ua[4], ub[4];
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ua[q] = *reinterpret_cast<const float4*>(ut + 8 * (c + q));
            ub[q] = *reinterpret_cast<const float4*>(ut + 8 * (c + q) + 4);
            x[q] = row[j1 + c + q];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float uv[8] = {ua[q].x, ua[q].y, ua[q].z, ua[q].w,
                                 ub[q].x, ub[q].y, ub[q].z, ub[q].w};
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < SEL_MAX_BW; ++i)
              if (i < bw) acc = fmaf(l[i], uv[i], acc);
            row[j1 + c + q] = x[q] - acc;
          }
        }
        for (; c < ce; ++c) {
          const float4 a = *reinterpret_cast<const float4*>(ut + 8 * c);
          const float4 b = *reinterpret_cast<const float4*>(ut + 8 * c + 4);
          const float uv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < SEL_MAX_BW; ++i)
            if (i < bw) acc = fmaf(l[i], uv[i], acc);
          row[j1 + c] = row[j1 + c] - acc;
        }
      }
      __syncthreads();   // a row's next slab values may be another's
    } else if (mine && alive) {
#pragma unroll 4
      for (int c = 0; c < m; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < SEL_MAX_BW; ++i)
          if (i < bw) acc = fmaf(vals[i], PR[i * nb + c], acc);
        srow[j1 + c] = srow[j1 + c] - acc;
      }
    }
  }
}

// sel_block_bw at the plans' slab width 8 compiled in, else at bw.
__device__ inline void sel_block(const cg::cluster_group& cluster, int C,
                                 int rank, const SelShared& sh, int W,
                                 int per, int r0, int nr, int nb, int bw,
                                 int col0, long long* P, int* bp, float* ut,
                                 bool& alive) {
  if (bw == SEL_MAX_BW) {
    sel_block_bw<SEL_MAX_BW>(cluster, C, rank, sh, W, per, r0, nr, nb, bw,
                             col0, P, bp, ut, alive);
  } else {
    sel_block_bw<0>(cluster, C, rank, sh, W, per, r0, nr, nb, bw, col0, P,
                    bp, ut, alive);
  }
}

// nb <= 128: the whole chunk's rows in shared memory for the launch
// (`work` is unused).
__global__ void __launch_bounds__(SEL_THREADS)
lu_select_kernel(const float* __restrict__ chunks, long long cs0,
                 long long cs1, long long cs2, const int* __restrict__ nrows,
                 int W, int nb, int bw, long long* __restrict__ piv,
                 float* __restrict__ work, long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = nb | 1, g = blockIdx.y;
  // rows [r0, r1) of the chunk: an even split, so row p lives on rank p / per
  const int per = (W + C - 1) / C;
  const int r0 = min(W, rank * per), r1 = min(W, r0 + per), nr = r1 - r0;
  const SelShared sh = sel_layout(smem, nb, bw, per);
  sel_init(sh, C);
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
  // every CTA of the cluster has started (loaded its rows, readied its
  // barriers) before any writes into another's exchange buffer
  sel_sync(cluster, C);
  sel_block(cluster, C, rank, sh, W, per, r0, nr, nb, bw, 0,
            piv + (size_t)g * nb, nullptr, nullptr, alive);
  // no CTA may leave while another can still read its shared memory
  sel_sync(cluster, C);
}

// U = L11^-1 A(pivots, right) for SEL_UCOLS columns c, c + 1, ... of the
// columns right of the block, by one warp: lane i holds rows 32 b + i of
// each, b = 0 .. 3; a 32-row block at a time, first less the earlier
// blocks' rows (L11's rows from device memory, through L2, each load shared
// by the warp's columns), then solved against its own unit lower 32 x 32
// block, a row a step, each u_t broadcast by a shuffle. Every sum runs k =
// 0, 1, ... in order. pv: the block's pivot rows (a row >= W: none, its U
// row 0); x: the pivot rows' columns right of the block (x[p * nb + c]); U
// (ldu) receives the columns. ncol <= SEL_UCOLS: the columns left.
constexpr int SEL_UCOLS = 4;

template <bool SMEM>
__device__ inline void sel_u_cols(const float* L11, const float* x,
                                  long long xs0, long long xs1,
                                  const int* pv, int W, int c, int ncol,
                                  float* U, int ldu) {
  const int lane = threadIdx.x & 31;
  // L11's entries k .. k + 3 of row r: from device memory (a 16-byte load
  // through L2) or from the staged copy (stride SEL_BLOCK + 1)
  auto quad = [&](int r, int k) {
    if (SMEM) {
      const float* e = L11 + r * (SEL_BLOCK + 1) + k;
      return make_float4(e[0], e[1], e[2], e[3]);
    }
    return __ldcg(reinterpret_cast<const float4*>(L11 + r * SEL_BLOCK + k));
  };
  float u[SEL_UCOLS][4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int row = 32 * b + lane, p = pv[row];
    float sq[SEL_UCOLS];
#pragma unroll
    for (int q = 0; q < SEL_UCOLS; ++q)
      sq[q] = p < W && q < ncol ? __ldcg(x + p * xs0 + (c + q) * xs1) : 0.f;
    // less the earlier blocks' rows: u_k broadcast from lane k % 32
#pragma unroll
    for (int kb = 0; kb < b; ++kb) {
#pragma unroll
      for (int t4 = 0; t4 < 8; ++t4) {
        const float4 l4 = quad(row, 32 * kb + 4 * t4);
        const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int q = 0; q < SEL_UCOLS; ++q)
            sq[q] = fmaf(-l[e],
                         __shfl_sync(0xffffffffu, u[q][kb], 4 * t4 + e),
                         sq[q]);
        }
      }
    }
    // the block's own unit lower triangle, a row a step
#pragma unroll
    for (int t4 = 0; t4 < 8; ++t4) {
      const float4 l4 = quad(row, 32 * b + 4 * t4);
      const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * t4 + e;
#pragma unroll
        for (int q = 0; q < SEL_UCOLS; ++q) {
          const float ut = __shfl_sync(0xffffffffu, sq[q], t);
          if (lane > t) sq[q] = fmaf(-l[e], ut, sq[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < SEL_UCOLS; ++q) u[q][b] = sq[q];
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int q = 0; q < SEL_UCOLS; ++q)
      if (q < ncol) U[(size_t)(32 * b + lane) * ldu + c + q] = u[q][b];
}

// A(live rows, right) -= L U over one UC-column chunk cb0 of the R columns
// right of the block: L the rows' multipliers in S (stride ld), U (ldu)
// from device memory in UK-row slices (UK UC = SEL_STAGE / 2), two slices
// staged by turns in Us; a thread's tile is rows ty + (4096 / UC) m (m <
// NM) by the eight columns 8 tx .. 8 tx + 7. Each output sums k = 0 .. 127
// in order, then leaves its row: out[r * nb + c] = in(r, c) - sum, in(r,
// c) = in[r * is0 + c * is1] (the chunk itself for the first block, out
// after it). Every thread of the CTA calls it.
template <int NM, int UC>
__device__ inline void sel_update_chunk(const SelShared& sh, int ld, int nr,
                                        const float* U, int ldu, int cb0,
                                        const float* in, long long is0,
                                        long long is1, float* out,
                                        long long nb, float* Us) {
  constexpr int UK = SEL_STAGE / 2 / UC, RS = 8 * SEL_THREADS / UC;
  const int tid = threadIdx.x, tx = tid % (UC / 8), ty = tid / (UC / 8);
  int lrow[NM];   // the rows' offsets in S
#pragma unroll
  for (int m = 0; m < NM; ++m) lrow[m] = min(ty + RS * m, nr - 1) * ld;
  float acc[NM][8];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
  // slice s of U's rows into buffer s & 1: a float4 a thread of the first
  // 256
  auto stage = [&](int s) {
    if (tid < UK * UC / 4) {
      const int kk = tid / (UC / 4), cc = 4 * (tid % (UC / 4));
      *reinterpret_cast<float4*>(Us + (s & 1) * UK * UC + kk * UC + cc) =
          __ldcg(reinterpret_cast<const float4*>(
              U + (size_t)(s * UK + kk) * ldu + cb0 + cc));
    }
  };
  __syncthreads();   // the last chunk's reads of Us are done
  stage(0);
  for (int s = 0; s < SEL_BLOCK / UK; ++s) {
    __syncthreads();   // slice s staged; slice s - 1's reads done
    if (s + 1 < SEL_BLOCK / UK) stage(s + 1);
    const float* us = Us + (s & 1) * UK * UC + 8 * tx;
    const float* sk = sh.S + s * UK;
#pragma unroll
    for (int kk = 0; kk < UK; ++kk) {
      const float4 u0 = *reinterpret_cast<const float4*>(us + kk * UC);
      const float4 u1 = *reinterpret_cast<const float4*>(us + kk * UC + 4);
      const float uv[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float l = sk[lrow[m] + kk];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(l, uv[q], acc[m][q]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int r = ty + RS * m;
    if (r >= nr || !sh.live[r]) continue;
    const int c = cb0 + 8 * tx;
    float v[8];
    if (is1 == 1 && is0 % 4 == 0 &&
        reinterpret_cast<uintptr_t>(in) % 16 == 0) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(in + r * is0 + c));
      const float4 b =
          __ldcg(reinterpret_cast<const float4*>(in + r * is0 + c + 4));
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldcg(in + r * is0 + (c + q) * is1);
    }
    float* row = out + (size_t)r * nb + c;
    *reinterpret_cast<float4*>(row) =
        make_float4(v[0] - acc[m][0], v[1] - acc[m][1], v[2] - acc[m][2],
                    v[3] - acc[m][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(v[4] - acc[m][4], v[5] - acc[m][5], v[6] - acc[m][6],
                    v[7] - acc[m][7]);
  }
}

// The update right of a block, UC = 128 columns a chunk where the CTA has
// at most 128 rows (NM = ceil(nr / 32)), else 64 (NM = ceil(nr / 64)), so
// that a thread holds four or more rows of eight columns (a CTA holds at
// most 436 rows, select_prepare; none: the chunks' barriers only).
__device__ inline void sel_update(const SelShared& sh, int ld, int nr,
                                  const float* U, int ldu, int R,
                                  const float* in, long long is0,
                                  long long is1, float* out, long long nb,
                                  float* Us) {
  const int big = nr <= SEL_BLOCK;
  const int uc = big ? 128 : 64;
  for (int cb0 = 0; cb0 < R; cb0 += uc) {
#define SEL_UPD(NM, UC) \
  sel_update_chunk<NM, UC>(sh, ld, nr, U, ldu, cb0, in, is0, is1, out, nb, Us)
    if (big) {
      switch ((nr + 31) / 32) {
        case 1: SEL_UPD(1, 128); break;
        case 2: SEL_UPD(2, 128); break;
        case 3: SEL_UPD(3, 128); break;
        case 4: SEL_UPD(4, 128); break;
        default:
          for (int s = 0; s <= SEL_BLOCK / 8; ++s) __syncthreads();
      }
    } else {
      switch ((nr + 63) / 64) {
        case 3: SEL_UPD(3, 64); break;
        case 4: SEL_UPD(4, 64); break;
        case 5: SEL_UPD(5, 64); break;
        case 6: SEL_UPD(6, 64); break;
        default: SEL_UPD(7, 64); break;
      }
    }
#undef SEL_UPD
  }
}

// nb = 256, 384, 512: the chunk's working copy in `work`
// (select_work_floats), walked by SEL_BLOCK-column blocks (see the note at
// the top).
__global__ void __launch_bounds__(SEL_THREADS)
lu_select_wide_kernel(const float* __restrict__ chunks, long long cs0,
                      long long cs1, long long cs2,
                      const int* __restrict__ nrows, int W, int nb, int bw,
                      long long* __restrict__ piv, float* __restrict__ work,
                      long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ld = SEL_BLOCK | 1, g = blockIdx.y;
  const int per = (W + C - 1) / C;
  const int r0 = min(W, rank * per), r1 = min(W, r0 + per), nr = r1 - r0;
  const SelShared sh = sel_layout(smem, SEL_BLOCK, bw, per);
  sel_init(sh, C);
  int* bpv = reinterpret_cast<int*>(
      (reinterpret_cast<uintptr_t>(sh.live + per) + 15) & ~uintptr_t(15));
  // the update's two slices of U, then a slab's U rows by column
  float* Us = reinterpret_cast<float*>(bpv + SEL_BLOCK);
  float* Ut = Us + SEL_STAGE;
  // L11's staging, where the launch gave room for it
  const size_t lbase = (select_wide_smem_bytes(per, bw) + 15) & ~size_t(15);
  unsigned dsmem;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dsmem));
  float* Ls = dsmem >= lbase + SEL_L11_BYTES - 16
                  ? reinterpret_cast<float*>(
                        reinterpret_cast<char*>(smem) + lbase)
                  : nullptr;
  const float* A = chunks + g * cs0;
  long long* P = piv + (size_t)g * nb;
  // the chunk's working copy [W, nb], then L11 [128, 128], U [128, nb-128];
  // the copy holds a live row's columns right of a block from the first
  // update on (the first block and its update read the chunk itself)
  float* X = work + (size_t)g * ((size_t)W * nb + (size_t)SEL_BLOCK * nb);
  float* L11 = X + (size_t)W * nb;
  float* U = L11 + SEL_BLOCK * SEL_BLOCK;
  const int ldu = nb - SEL_BLOCK;
  bool alive = tid < nr && r0 + tid < nrows[g];
  auto stamp = [&](int blk, int ph) {
    if (stamps != nullptr && g == 0 && tid == 0)
      stamps[((long long)blk * SEL_MAX_CLUSTER + rank) * SEL_STAMPS + ph] =
          sel_now();
  };
  for (int c0 = 0; c0 < nb; c0 += SEL_BLOCK) {
    const int blk = c0 / SEL_BLOCK;
    stamp(blk, 0);
    // the block's columns of the CTA's rows (written by this CTA alone):
    // from the chunk for the first, from the working copy after it
    const float* xr = c0 == 0 ? A + SEL_BLOCK * cs2
                              : X + c0 + SEL_BLOCK;   // pivot rows' right
    const long long xs0 = c0 == 0 ? cs1 : nb, xs1 = c0 == 0 ? cs2 : 1;
    __syncthreads();
    if (c0 > 0) {
#pragma unroll 4
      for (int idx = tid; idx < nr * SEL_BLOCK / 4; idx += SEL_THREADS) {
        const int r = idx / (SEL_BLOCK / 4), c = 4 * (idx % (SEL_BLOCK / 4));
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            X + (size_t)(r0 + r) * nb + c0 + c));
        float* d = sh.S + r * ld + c;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
    } else {
      // one warp a row, a lane's four columns loaded before any is stored
      for (int r = warp; r < nr; r += SEL_WARPS) {
        const float* src = A + (long long)(r0 + r) * cs1;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = src[(lane + 32 * k) * cs2];
#pragma unroll
        for (int k = 0; k < 4; ++k) sh.S[r * ld + lane + 32 * k] = v[k];
      }
    }
    // the first block: every CTA has readied its barriers before any
    // arrival; a later one: the previous block's reads of the exchange
    // are long done (every CTA has passed the update's barrier since)
    if (c0 == 0) {
      sel_sync(cluster, C);
    } else {
      __syncthreads();
    }
    stamp(blk, 1);
    sel_block(cluster, C, rank, sh, W, per, r0, nr, SEL_BLOCK, bw, c0, P + c0,
              bpv, Ut, alive);
    __syncthreads();
    stamp(blk, 2);
    const int R = nb - c0 - SEL_BLOCK;   // the columns right of the block
    if (R == 0) break;
    // L11: pivot row i's multipliers of columns k < i, from its owner (rank
    // 0 writes zeros for a column that had no row at all)
    for (int i = warp; i < SEL_BLOCK; i += SEL_WARPS) {
      const int p = bpv[i];
      const bool none = p >= W;
      if (none ? rank != 0 : p / per != rank) continue;
      for (int k = threadIdx.x & 31; k < i; k += 32)
        L11[i * SEL_BLOCK + k] = none ? 0.f : sh.S[(p - r0) * ld + k];
    }
    sel_arrive(C);
    sel_wait(C);
    // U = L11^-1 A(pivots, right): CTA `rank` takes a range of the
    // columns, a warp SEL_UCOLS at a time (sel_u_cols)
    const int cpc = (R + C - 1) / C;
    const int cb = min(R, rank * cpc), ce = min(R, cb + cpc);
    if (Ls != nullptr) {
      // L11's lower triangle into shared memory, then read from there
#pragma unroll 4
      for (int idx = tid; idx < SEL_BLOCK * SEL_BLOCK / 4;
           idx += SEL_THREADS) {
        const int r = idx / (SEL_BLOCK / 4), k = 4 * (idx % (SEL_BLOCK / 4));
        if (k >= r) continue;
        const float4 v =
            __ldcg(reinterpret_cast<const float4*>(L11 + r * SEL_BLOCK + k));
        float* d = Ls + r * (SEL_BLOCK + 1) + k;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      __syncthreads();
      for (int c = cb + SEL_UCOLS * warp; c < ce;
           c += SEL_UCOLS * SEL_WARPS) {
        sel_u_cols<true>(Ls, xr, xs0, xs1, bpv, W, c,
                         min(SEL_UCOLS, ce - c), U, ldu);
      }
    } else {
      for (int c = cb + SEL_UCOLS * warp; c < ce;
           c += SEL_UCOLS * SEL_WARPS) {
        sel_u_cols<false>(L11, xr, xs0, xs1, bpv, W, c,
                          min(SEL_UCOLS, ce - c), U, ldu);
      }
    }
    sel_arrive(C);
    sel_wait(C);
    stamp(blk, 3);
    // A(live rows, right) -= L U
    sel_update(sh, ld, nr, U, ldu, R, xr + r0 * xs0, xs0, xs1,
               X + (size_t)r0 * nb + c0 + SEL_BLOCK, nb, Us);
    stamp(blk, 4);
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
                           const int*, int, int, int, long long*, float*,
                           long long*);

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
  // past nb = 128, more CTAs where the card places them: at most SEL_BLOCK
  // rows a CTA (or 16 CTAs), so that the trailing updates, U and the
  // update right of each block spread over four or two threads a row (the
  // column chain costs about the same at any C)
  int want = size;
  while (nb > SEL_BLOCK && want < SEL_MAX_CLUSTER &&
         (W + want - 1) / want > SEL_BLOCK) {
    want *= 2;
  }
  if (want > size) {
    const int wsmem = (int)select_cta_bytes((W + want - 1) / want, nb, bw);
    int placed = 0;
    SLATE_RETURN_IF_ERROR(active_clusters(*kernel, device, want,
                                          SEL_THREADS, wsmem, &placed));
    if (placed > 0) size = want;
  }
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
static int select_launch(int device, void* stream, const float* chunks,
                         long long cs0, long long cs1, long long cs2,
                         const int* nrows, int G, int W, int nb, int bw,
                         long long* piv, float* work, long long* stamps) {
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
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  const size_t room = ((size_t)smem + 15) / 16 * 16 + SEL_L11_BYTES;
  cfg.dynamicSmemBytes =
      nb > SEL_BLOCK && room <= (size_t)limit ? room : (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, chunks, cs0, cs1,
                                             cs2, nrows, W, nb, bw, piv,
                                             work, stamps);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

extern "C" int slate_lu_select(int device, void* stream, const float* chunks,
                               long long cs0, long long cs1, long long cs2,
                               const int* nrows, int G, int W, int nb, int bw,
                               long long* piv, float* work) {
  SLATE_SET_DEVICE(device);
  return select_launch(device, stream, chunks, cs0, cs1, cs2, nrows, G, W,
                       nb, bw, piv, work, nullptr);
}

// One wide launch (nb > 128) as slate_lu_select, with chunk 0's CTAs'
// globaltimer stamps (stamps: int64 [nb / 128][SEL_MAX_CLUSTER][SEL_STAMPS],
// zeroed; *cluster = the CTAs a chunk): for chip_smoke.py's split of K4's
// time. The wrapper never calls it; the pivots are slate_lu_select's.
extern "C" int slate_lu_select_trace(int device, void* stream,
                                     const float* chunks, long long cs0,
                                     long long cs1, long long cs2,
                                     const int* nrows, int G, int W, int nb,
                                     int bw, long long* piv, float* work,
                                     long long* stamps, int* cluster) {
  SLATE_SET_DEVICE(device);
  int smem = 0, resident = 0;
  SelKernel kernel;
  const int e = select_prepare(device, W, nb, bw, cluster, &smem, &resident,
                               &kernel);
  if (e != 0) return e;
  if (nb <= SEL_BLOCK || stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return select_launch(device, stream, chunks, cs0, cs1, cs2, nrows, G, W,
                       nb, bw, piv, work, stamps);
}
