// The wide factors: K1 past n = 128, K2's factor launch and K0 at nb = 256,
// 384 and 512, and K3's factor launch at those widths. They port the same
// TPU kernels as their one-block routes (chol_tile_pallas, chol_panel_fused,
// upper_tri_inv and lu_panel_fused: slate_tpu/internal/pallas_chol.py:316,
// :162, pallas_tri.py:28, pallas_lu.py:210) at the widths the reference's
// gates give them (its tiles up to 1024, its panels up to 512).
//
// The hazard: a TPU kernel keeps a 256-1024 wide tile whole in VMEM. Here
// one f32 diagonal block of 256-512 columns (256 KB-1 MB) does not fit one
// block's 227 KB of shared memory, and a 1024 tile (4 MB) does not fit the
// shared memory of a 16-CTA cluster. So the tile stays in device memory
// (L2-resident: 4 MB against the card's 50 MB L2), in a row-major workspace
// of np x np, np a multiple of WF_T = 128, and one launch of one
// thread-block cluster factors it by 128-column diagonal blocks.
//
// The LU and the inverse (wf_lu, wf_tri_inv; WF_CLUSTER CTAs of 128
// threads) meet at a full cluster barrier between the steps:
//   - the diagonal block: one CTA copies it into its shared memory and
//     factors it there by the one-block routine of the narrow kernels
//     (lu_factor.cuh), then inverts its triangular factors by K0's blocked
//     doubling (tri_inv.cuh) into 128 x 128 slots of device memory;
//   - the blocks below and to the right, then the trailing update: every
//     CTA takes whole 128 x 128 output tiles in turn and forms each as one
//     tiled product (panel_gemm.cuh: a 16 x 8 register tile a thread).
// U^-1 of a wide upper-triangular U (K0 past 128) is the same doubling one
// level up: the 128 x 128 diagonal blocks inverted at once, one CTA each,
// then neighbouring inverted blocks joined, b = 1, 2, ... tiles: T = U12
// X22 for every pair at once, a cluster barrier, X12 = -X11 T, a barrier
// (LAPACK trtri's recursion, as in tri_inv.cuh).
//
// The Cholesky factor (wf_chol: K1's wide route, K2's and K6's factor
// launches) is redesigned around its critical path, the chain of n / 128
// diagonal blocks: block j + 1 cannot be factored before L_{j+1,j} =
// A_{j+1,j} L_jj^-T and A_{j+1,j+1} -= L_{j+1,j} L_{j+1,j}^T, and those need
// L_jj^-1. The first port ran each step as three full barriers with the
// diagonal factor and inverse on one 128-thread CTA while seven waited, and
// the products on 8 SMs. Here:
//   - a lookahead by a group of WFC_GROUP CTAs (ranks 0 .. 3): right after
//     step j's barrier each member forms its 32-row quarter of L_{j+1,j}
//     and sends it to every member's shared memory (distributed shared
//     memory, a release-store flag a sender: no atomics), then its quarter
//     of A_{j+1,j+1} - L_{j+1,j} L_{j+1,j}^T straight into rank 0's shared
//     memory; rank 0 factors the block (chol_factor_smem) and inverts it
//     (K0's doubling, k loops unrolled) into a slot, and stores the
//     factored block to device memory only after it arrives at the step's
//     barrier (no CTA reads it before the last one). The critical path of
//     a step is one quarter product, one quarter update, the factor and
//     the inverse;
//   - meanwhile the other CTAs, the workers, form the rest of column j
//     (L_ij = A_ij L_jj^-T, i > j + 1) and, past a split barrier that the
//     group arrives at as soon as its rows of column j are written, the
//     trailing lower tiles A_ik -= L_ij L_kj^T; members 1 .. 3 join them
//     once their quarters are sent. Only the first diagonal block, and a
//     step whose trailing work is shorter than the chain, stay exposed;
//   - the barriers are the cluster barrier split into its arrive and wait
//     halves (wfc_arrive, wfc_wait): a CTA arrives when its part of the
//     step is published and waits only where it needs the others', two a
//     step where the first port had three full ones;
//   - WFC_THREADS = 256 threads a CTA (twice the first port's 128), so the
//     factor and the doubling have twice the warps, and every product is a
//     128 x 128 tile staged whole (128 deep) into shared memory by cp.async
//     and summed from 8 x 8 register tiles (wfc_mma);
//   - a cluster of WFC_MAX_CLUSTER = 16 CTAs where the card places as many
//     such clusters as the launch has problems (non-portable), else 8.
// Each output tile is summed as the first port summed it (the same FMAs in
// the same order), so the bits do not depend on the cluster size, on which
// CTA takes which tile, or on the redesign: they are the first port's.
// All products are f32 FMAs on the CUDA cores (never TF32), no atomics, and
// a launch repeats bit for bit. chol_tile.cu's slate_chol_tile_trace
// records globaltimer stamps of each step (WFC_STAMP_ROW) for chip_smoke.py's
// split of the time into the exposed chain and the products.
//
// Bound on this card: at n = 1024 the Cholesky is n^3 / 3 = 0.36 GFLOP
// against 8 MB moved, bound by f32 operations (5.4 us at 67 TFLOP/s). What
// holds the cluster back is the chain: n / 128 steps of a diagonal factor
// and inverse on one SM. PERF.md has the times.
//
// Every write of one CTA that another reads later is ordered by a
// device-scope fence before the cluster barrier's arrival (release at
// cluster scope) and a fence after its wait (acquire), or by a group flag
// (release store, acquire load at cluster scope). Tiles that another CTA
// wrote are read through L2 (__ldcg, cp.async.cg).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_factor.cuh"
#include "common.cuh"
#include "lu_factor.cuh"
#include "panel_gemm.cuh"

constexpr int WF_T = 128;        // the diagonal block and the output tile
constexpr int WF_CLUSTER = 8;    // the CTAs of the one cluster (portable)
constexpr int WF_THREADS = PanelGemm<WF_T>::THREADS;
constexpr int WF_LDS = WF_T + 4;      // the diagonal block and its inverse
constexpr int WF_LDT = WF_T / 2 + 4;  // the doubling's scratch
// shared memory of a CTA: the diagonal block, its inverse, the doubling's
// scratch and the factor routines' warp slots; the products' ring fits in
// the same bytes
constexpr int WF_SMEM_FLOATS =
    2 * WF_T * WF_LDS + WF_T * WF_LDT + lu_factor_scratch(WF_THREADS);
constexpr size_t WF_SMEM_BYTES = sizeof(float) * WF_SMEM_FLOATS;
static_assert(WF_SMEM_FLOATS >= PanelGemm<WF_T>::SMEM_FLOATS,
              "the products' ring must fit the factor's shared memory");
static_assert(lu_factor_scratch(WF_THREADS) >=
                  chol_factor_scratch(WF_THREADS),
              "the warp slots serve both factors");

constexpr int WF_MAX_TILE = 1024;   // K1's widest tile
constexpr int WF_MAX_PANEL = 512;   // K0's, K2's and K3's widest panel

// The cluster barrier between two steps (see the note above).
__device__ inline void wf_sync() {
  __threadfence();
  cooperative_groups::this_cluster().sync();
  __threadfence();
}

__device__ inline int wf_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

__device__ inline int wf_ctas() {
  return (int)cooperative_groups::this_cluster().num_blocks();
}

// s (WF_T x WF_T in shared memory, leading dimension WF_LDS) = the tile at
// g (leading dimension ld, 16-byte aligned rows) through L2.
__device__ inline void wf_load_tile(float* s, const float* g, long long ld) {
  for (int idx = threadIdx.x; idx < WF_T * WF_T / 4; idx += blockDim.x) {
    const int r = idx / (WF_T / 4), c = 4 * (idx % (WF_T / 4));
    *reinterpret_cast<float4*>(s + r * WF_LDS + c) =
        __ldcg(reinterpret_cast<const float4*>(g + r * ld + c));
  }
}

// g (leading dimension ld) = the tile s (leading dimension lds) in shared
// memory; with `lower`, zeros above the diagonal.
__device__ inline void wf_store_tile(float* g, long long ld, const float* s,
                                     int lds, bool lower) {
  for (int idx = threadIdx.x; idx < WF_T * WF_T / 4; idx += blockDim.x) {
    const int r = idx / (WF_T / 4), c = 4 * (idx % (WF_T / 4));
    float4 v = *reinterpret_cast<const float4*>(s + r * lds + c);
    if (lower) {
      if (c > r) v.x = 0.f;
      if (c + 1 > r) v.y = 0.f;
      if (c + 2 > r) v.z = 0.f;
      if (c + 3 > r) v.w = 0.f;
    }
    *reinterpret_cast<float4*>(g + r * ld + c) = v;
  }
}

// g (leading dimension ld) = scale * acc, or g -= acc with `sub` (g read
// through L2), for this thread's part of the tile (pg_thread's layout).
__device__ inline void wf_store_acc(float* g, long long ld,
                                   const float (&acc)[PG_RM][8], float scale,
                                   bool sub, int tx, int ty) {
  using G = PanelGemm<WF_T>;
#pragma unroll
  for (int i = 0; i < PG_RM; ++i) {
    float* row = g + (long long)(ty + G::TY * i) * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* e = row + tx + G::TX * j;
      *e = sub ? __ldcg(e) - acc[i][j] : scale * acc[i][j];
    }
  }
}

// Invert the upper-triangular tile s in shared memory (only its upper
// triangle and diagonal are read) by K0's doubling into g (leading
// dimension ld): every thread of the CTA calls it.
__device__ inline void wf_invert_tile(const float* s, float* g, long long ld,
                                      float* smem) {
  float* x = smem + WF_T * WF_LDS;
  float* t = x + WF_T * WF_LDS;
  upper_tri_inv_doubling(s, WF_LDS, x, WF_LDS, t, WF_LDT, WF_T);
  wf_store_tile(g, ld, x, WF_LDS, false);
  __syncthreads();
}

// ---- the wide Cholesky factor (K1 past 128, K2's and K6's factor launch):
// the design in the note at the top of this file

constexpr int WFC_THREADS = 256;      // a CTA of the Cholesky factor
constexpr int WFC_MAX_CLUSTER = 16;   // non-portable; taken where placed
constexpr int WFC_GROUP = 4;          // the lookahead's CTAs: ranks 0 .. 3
constexpr int WFC_QROWS = 32;         // a group member's rows of a tile
constexpr int WFC_LD = WF_T + 4;      // a staged row: 33 16-byte groups
constexpr int WFC_TILE = WF_T * WFC_LD;   // one staged 128 x 128 tile
// shared memory of a CTA, in floats: the diagonal block D (rank 0); two
// staged tiles, the operands of a product (As, Bs), or the group's
// L_{j+1,j} and L_jj^-1, or the doubling's X and scratch; a member's 32
// rows of A_{j+1,j}; the group's flags; the factor's warp slots (217 KB)
constexpr int WFC_AQ = 3 * WFC_TILE;
constexpr int WFC_FLAGS = WFC_AQ + WFC_QROWS * WFC_LD;
constexpr int WFC_SCRATCH = WFC_FLAGS + 4 * WFC_GROUP;
constexpr int WFC_SMEM_FLOATS =
    WFC_SCRATCH + chol_factor_scratch(WFC_THREADS);
constexpr size_t WFC_SMEM_BYTES = sizeof(float) * WFC_SMEM_FLOATS;
static_assert(WF_T * WF_LDT <= WFC_TILE,
              "the doubling's scratch fits one staged tile");
static_assert(WFC_GROUP * WFC_QROWS == WF_T, "the group covers a tile");
static_assert(WFC_SCRATCH % 4 == 0, "the warp slots are 16-byte aligned");
// wf_chol's stamps (globaltimer, ns): a row of WFC_STAMP_ROW a step s (0:
// rank 0's first factor; s = j + 1: step j), entry r the time rank r ended
// its part (rank 0: the next diagonal block factored and inverted; a
// worker: its trailing tiles), entry WFC_MAX_CLUSTER rank 0's time past the
// step's closing barrier; row nt, entry 0: the start
constexpr int WFC_STAMP_ROW = WFC_MAX_CLUSTER + 1;

__device__ inline long long wfc_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wf_sync in two halves: wfc_arrive publishes this thread's writes (a
// device-scope fence, then the cluster barrier's arrival, a release), and
// wfc_wait blocks until every thread of the cluster has arrived (an
// acquire) and fences again. Between the two a CTA may go on with work that
// no other CTA's arrival gates. Every thread alternates the two.
__device__ inline void wfc_arrive() {
  __threadfence();
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ inline void wfc_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  __threadfence();
}

// s[r][k] (leading dimension WFC_LD) = the 128 x 128 tile at g (leading
// dimension ld, 16-byte aligned rows), by cp.async 16-byte copies through
// L2; the caller commits and waits.
__device__ inline void wfc_stage(float* s, const float* g, long long ld) {
  for (int idx = threadIdx.x; idx < WF_T * WF_T / 4; idx += WFC_THREADS) {
    const int r = idx >> 5, c = (idx & 31) << 2;
    pg_cp_async16(s + r * WFC_LD + c, g + r * ld + c, 16);
  }
}

// s[c][k] = g[k * ld + c]: the tile transposed, by loads through L2.
__device__ inline void wfc_stage_t(float* s, const float* g, long long ld) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += WFC_THREADS) {
    const int k = idx >> 7, c = idx & (WF_T - 1);
    s[c * WFC_LD + k] = __ldcg(g + k * ld + c);
  }
}

// acc[i][j] += sum over k = 0 .. 127, in ascending order, of As[ty + 16 i][k]
// Bs[tx + 16 j][k], tx = tid % 16, ty = tid / 16: a thread's RM x 8 outputs
// (RM = 8: a 128 x 128 tile; RM = 2: 32 rows of it), the 16-byte reads of
// a k-quad issued before its FMAs. A warp reads two rows of As (a
// broadcast each) and 16 of Bs (33 groups apart: two wavefronts, the least
// for 256 bytes). The FMAs of one output run in pg_slice's order, so a
// tile's bits are those of panel_gemm.cuh's product on the same operands.
template <int RM>
__device__ inline void wfc_mma(float (&acc)[RM][8], const float* As,
                               const float* Bs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* ap = As + ty * WFC_LD;
  const float* bp = Bs + tx * WFC_LD;
#pragma unroll 2
  for (int k = 0; k < WF_T; k += 4) {
    float4 a[RM], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float4*>(bp + 16 * j * WFC_LD + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(ap + 16 * i * WFC_LD + k);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
  }
}

// acc += A B^T over the 128-deep k tiles kb .. ke-1, one staged in turn:
// A(r, k) = a[r * lda + k], B(c, k) = b[c * ldb + k] (or, with trans_b,
// b[k * ldb + c]); As and Bs are two staged tiles of shared memory. Every
// thread of the CTA calls it; it ends with a barrier.
__device__ inline void wfc_product(float (&acc)[8][8], const float* a,
                                   long long lda, const float* b,
                                   long long ldb, bool trans_b, int kb,
                                   int ke, float* As, float* Bs) {
  for (int kt = kb; kt < ke; ++kt) {
    wfc_stage(As, a + (long long)kt * WF_T, lda);
    if (trans_b)
      wfc_stage_t(Bs, b + (long long)kt * WF_T * ldb, ldb);
    else
      wfc_stage(Bs, b + (long long)kt * WF_T, ldb);
    pg_cp_async_commit();
    pg_cp_async_wait<0>();
    __syncthreads();
    wfc_mma<8>(acc, As, Bs);
    __syncthreads();
  }
}

// g (leading dimension ld) = scale * acc, or g -= acc with `sub` (g read
// through L2), for this thread's outputs (wfc_mma's layout).
__device__ inline void wfc_store(float* g, long long ld,
                                 const float (&acc)[8][8], float scale,
                                 bool sub) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = g + (long long)(ty + 16 * i) * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* e = row + tx + 16 * j;
      *e = sub ? __ldcg(e) - acc[i][j] : scale * acc[i][j];
    }
  }
}

// K0's blocked doubling (tri_inv.cuh upper_tri_inv_doubling) on a 128 x 128
// U in shared memory, for a 256-thread CTA: the same sums in the same
// order (so the same bits), with the k loops unrolled by four so that a
// thread keeps several reads in flight; every output block of a level is
// one thread's. X = U^-1, zero below the diagonal; t is scratch.
__device__ inline void wfc_upper_inv(const float* u, float* x, float* t) {
  constexpr int np = WF_T, ldu = WFC_LD, ldx = WFC_LD, ldt = WF_LDT;
  const int tid = threadIdx.x, nq4 = np / 4;
  for (int idx = tid; idx < np * nq4; idx += WFC_THREADS) {
    const int i = idx / nq4, j = 4 * (idx - i * nq4);
    if (j / TRI_DIAG != i / TRI_DIAG) {
      *reinterpret_cast<float4*>(x + i * ldx + j) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (int j = tid; j < np; j += WFC_THREADS) {
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
    const int nq = b / 4, pairs = (np - b + 2 * b - 1) / (2 * b);
    for (int idx = tid; idx < pairs * nq * nq; idx += WFC_THREADS) {
      const int cq = idx % nq, rq = idx / nq % nq;
      const int i0 = idx / (nq * nq) * 2 * b;
      const int i = i0 + 4 * rq, j = i0 + b + 4 * cq;
      if (j >= np) continue;
      float s[4][4] = {};
#pragma unroll 4
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
    for (int idx = tid; idx < pairs * nq * nq; idx += WFC_THREADS) {
      const int cq = idx % nq, rq = idx / nq % nq;
      const int i0 = idx / (nq * nq) * 2 * b;
      const int i = i0 + 4 * rq, j = i0 + b + 4 * cq;
      if (j >= np) continue;
      float s[4][4] = {};
#pragma unroll 4
      for (int k = i; k < i0 + b; ++k) {
        const float4 tv =
            *reinterpret_cast<const float4*>(t + k * ldt + 4 * cq);
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

// The diagonal block in D (the start of smem), updated: factor it
// (chol_factor_smem), store L_jj at wjj with zeros above its diagonal
// (unless not `store`: the caller stores D later, wfc_store_diag) and, with
// `inverse`, L_jj^-1 into slot (row-major, 128 x 128) by K0's doubling on
// U = L_jj^T (wfc_upper_inv): slot[c][k] = (U^-1)[k][c]. Every thread of
// the CTA calls it after a barrier that completes D.
__device__ inline void wfc_factor_diag(float* wjj, long long ld, float* slot,
                                       bool inverse, bool store,
                                       float* smem) {
  float* D = smem;
  float* X = D + WFC_TILE;
  float* t = X + WFC_TILE;
  chol_factor_smem(D, WFC_LD, WF_T, smem + WFC_SCRATCH);
  if (store) wf_store_tile(wjj, ld, D, WFC_LD, true);
  if (!inverse) return;
  __syncthreads();  // the store has read the tile
  // U = L^T above the diagonal (the store reads only on and below it)
  for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += WFC_THREADS) {
    const int r = idx >> 7, c = idx & (WF_T - 1);
    if (c > r) D[r * WFC_LD + c] = D[c * WFC_LD + r];
  }
  __syncthreads();
  wfc_upper_inv(D, X, t);
  for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += WFC_THREADS) {
    const int c = idx >> 7, k = idx & (WF_T - 1);
    slot[idx] = X[k * WFC_LD + c];
  }
}

// The group's hand-offs through distributed shared memory: a member's
// writes into another's shared memory are published by a release store of
// the step's tag (j + 1, so that no flag is ever reset) into a flag of the
// receiver's, which thread 0 of the receiver polls with acquire loads.
// Flags are only ever stored, never added to: no atomics. A poll that
// outlasts 2^31 loads traps, so that a lost hand-off fails the launch
// rather than hang the card.
__device__ inline void wfc_flag_store(int* flag, int tag) {
  asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  asm volatile("st.release.cluster.u32 [%0], %1;\n" ::"l"(flag), "r"(tag)
               : "memory");
}

// Every thread of the CTA calls it: returns once flags[0 .. n-1] all hold
// at least tag, with what their writers published visible to the CTA.
__device__ inline void wfc_flags_wait(const int* flags, int n, int tag) {
  if (threadIdx.x == 0) {
    for (int q = 0; q < n; ++q) {
      int v = 0;
      for (unsigned polls = 0;; ++polls) {
        asm volatile("ld.acquire.cluster.u32 %0, [%1];\n"
                     : "=r"(v)
                     : "l"(flags + q)
                     : "memory");
        if (v >= tag) break;
        if (polls == 0x80000000u) __trap();
      }
    }
  }
  __syncthreads();
}

// The lower Cholesky factor of the SPD np x np workspace w (row-major,
// leading dimension ld, 16-byte aligned rows; np a multiple of WF_T; only
// its lower tiles are read), in place: on return w's lower tiles hold L,
// each diagonal tile with zeros above its diagonal, and the tiles above
// the diagonal are as they were. uinv: np / WF_T - 1 slots of WF_T x WF_T
// floats (np / WF_T with last_inverse, which also inverts the last
// diagonal block), slot j = L_jj^-1. Launched with WFC_THREADS threads and
// WFC_SMEM_FLOATS of shared memory a CTA on a cluster of more than
// WFC_GROUP; every thread of the cluster calls it, after a wf_sync that
// completes w; it ends with a cluster barrier. stamps: null, or (np / WF_T
// + 1) WFC_STAMP_ROW times (see WFC_STAMP_ROW). A negative pivot gives NaN
// on its diagonal entry and NaN in every later column, as chol_factor_smem
// does. Every output tile is summed as wf_chol's first port summed it (the
// same FMAs in the same order), so the bits are that port's.
__device__ inline void wf_chol(float* w, long long ld, int np, float* uinv,
                               float* smem, bool last_inverse = false,
                               long long* stamps = nullptr) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = wf_rank(), ctas = wf_ctas(), nt = np / WF_T;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool member = rank < WFC_GROUP;
  float* D = smem;
  float* As = smem + WFC_TILE;   // also the group's L_{j+1,j}
  float* Bs = As + WFC_TILE;     // also the group's L_jj^-1
  float* Aq = smem + WFC_AQ;
  int* sflags = reinterpret_cast<int*>(smem + WFC_FLAGS);   // L quarters in
  int* dflags = sflags + WFC_GROUP;                         // D quarters in
  auto tile = [&](int i, int k) {
    return w + (long long)i * WF_T * ld + (long long)k * WF_T;
  };
  auto slot = [&](int j) { return uinv + (long long)j * WF_T * WF_T; };
  auto stamp = [&](int row, int col) {
    if (stamps != nullptr && threadIdx.x == 0)
      stamps[row * WFC_STAMP_ROW + col] = wfc_now();
  };
  if (threadIdx.x < 2 * WFC_GROUP) sflags[threadIdx.x] = 0;
  if (rank == 0) {
    stamp(nt, 0);
    wfc_stage(D, tile(0, 0), ld);
    pg_cp_async_commit();
    pg_cp_async_wait<0>();
    __syncthreads();
    wfc_factor_diag(tile(0, 0), ld, slot(0), nt > 1 || last_inverse, true,
                    smem);
    stamp(0, 0);
  }
  wfc_arrive();
  wfc_wait();
  if (rank == 0) stamp(0, WFC_MAX_CLUSTER);
  for (int j = 0; j + 1 < nt; ++j) {
    const int m = nt - j - 1, tag = j + 1;
    if (member) {
      // the lookahead, split over the group by 32-row quarters q = rank:
      // L_{j+1,j}[q] = A_{j+1,j}[q] L_jj^-T, published to every member;
      // then D[q] = A_{j+1,j+1}[q] - L_{j+1,j}[q] L_{j+1,j}^T into rank 0's
      // D; rank 0 factors and inverts the block
      const int q0 = rank * WFC_QROWS;
      for (int idx = threadIdx.x; idx < WFC_QROWS * WF_T / 4;
           idx += WFC_THREADS) {
        const int r = idx >> 5, c = (idx & 31) << 2;
        pg_cp_async16(Aq + r * WFC_LD + c, tile(j + 1, j) + (q0 + r) * ld + c,
                      16);
      }
      wfc_stage(Bs, slot(j), WF_T);
      pg_cp_async_commit();
      pg_cp_async_wait<0>();
      __syncthreads();
      float acc[2][8] = {};
      wfc_mma<2>(acc, Aq, Bs);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + ty + 16 * i;
        float* g = tile(j + 1, j) + (long long)r * ld;
#pragma unroll
        for (int c = 0; c < 8; ++c) g[tx + 16 * c] = 1.f * acc[i][c];
        for (int to = 0; to < WFC_GROUP; ++to) {
          float* lf = cluster.map_shared_rank(As, to) + r * WFC_LD;
#pragma unroll
          for (int c = 0; c < 8; ++c) lf[tx + 16 * c] = acc[i][c];
        }
      }
      __syncthreads();
      if (threadIdx.x < WFC_GROUP)
        wfc_flag_store(cluster.map_shared_rank(sflags, threadIdx.x) + rank,
                       tag);
      wfc_arrive();
      wfc_flags_wait(sflags, WFC_GROUP, tag);
      float s[2][8] = {};
      wfc_mma<2>(s, As + q0 * WFC_LD, As);
      float* d0 = cluster.map_shared_rank(D, 0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + ty + 16 * i;
        const float* a = tile(j + 1, j + 1) + (long long)r * ld;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          d0[r * WFC_LD + tx + 16 * c] = __ldcg(a + tx + 16 * c) - s[i][c];
      }
      __syncthreads();
      if (threadIdx.x == 0)
        wfc_flag_store(cluster.map_shared_rank(dflags, 0) + rank, tag);
      if (rank == 0) {
        wfc_flags_wait(dflags, WFC_GROUP, tag);
        wfc_factor_diag(tile(j + 1, j + 1), ld, slot(j + 1),
                        j + 2 < nt || last_inverse, j + 2 == nt, smem);
        stamp(j + 1, 0);
      }
      wfc_wait();
    } else {
      // the rest of column j, L_ij = A_ij L_jj^-T for i > j + 1
      for (int i = j + 2 + rank - WFC_GROUP; i < nt; i += ctas - WFC_GROUP) {
        float acc[8][8] = {};
        wfc_product(acc, tile(i, j), ld, slot(j), WF_T, false, 0, 1, As,
                    Bs);
        wfc_store(tile(i, j), ld, acc, 1.f, false);
      }
      wfc_arrive();
      wfc_wait();
    }
    if (rank > 0) {
      // the trailing lower tiles (i, k), j < k <= i, but (j+1, j+1):
      // A_ik -= L_ij L_kj^T
      for (int p = rank; p < m * (m + 1) / 2; p += ctas - 1) {
        int ii = 0;
        while ((ii + 1) * (ii + 2) / 2 <= p) ++ii;
        const int i = j + 1 + ii, k = j + 1 + p - ii * (ii + 1) / 2;
        float acc[8][8] = {};
        wfc_product(acc, tile(i, j), ld, tile(k, j), ld, false, 0, 1, As,
                    Bs);
        wfc_store(tile(i, k), ld, acc, 1.f, true);
      }
      stamp(j + 1, rank);
    }
    wfc_arrive();
    // rank 0 stores L_{j+1,j+1}, which no CTA reads before the last
    // barrier, after its arrival (but for the last block); no member
    // writes D again before rank 0's next L quarter is published
    if (rank == 0 && j + 2 < nt)
      wf_store_tile(tile(j + 1, j + 1), ld, D, WFC_LD, true);
    wfc_wait();
    if (rank == 0) stamp(j + 1, WFC_MAX_CLUSTER);
  }
}

// x = U^-1 for U = L^T, after wf_chol(w = u, ..., last_inverse = true) and
// with L mirrored into u's upper tiles (row-major, leading dimension ld):
// wf_tri_inv's doubling, on this file's 256-thread products, so that x's
// bits are wf_tri_inv's. The diagonal tiles are the slots transposed (the
// same doubling); then for b = 1, 2, ...: T = U12 X22 for every pair of
// neighbouring inverted blocks at once, a barrier, X12 = -X11 T, a
// barrier. t is np x np scratch (leading dimension ld); x is written whole,
// zero below the diagonal. Called and synced as wf_chol.
__device__ inline void wfc_tri_inv(const float* u, float* x, float* t,
                                   long long ld, int np, const float* slots,
                                   float* smem) {
  const int rank = wf_rank(), ctas = wf_ctas(), nt = np / WF_T;
  float* As = smem + WFC_TILE;
  float* Bs = As + WFC_TILE;
  for (int d = rank; d < nt; d += ctas) {
    const float* s = slots + (long long)d * WF_T * WF_T;
    float* xd = x + (long long)d * WF_T * ld + d * WF_T;
    for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += WFC_THREADS) {
      const int r = idx >> 7, c = idx & (WF_T - 1);
      xd[r * ld + c] = __ldcg(s + c * WF_T + r);
    }
  }
  // the tiles below the diagonal are zero
  const long long below = (long long)nt * (nt - 1) / 2 * WF_T * WF_T;
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x;
       idx < below; idx += (long long)ctas * blockDim.x) {
    const long long tile = idx / (WF_T * WF_T);
    const int e = (int)(idx % (WF_T * WF_T));
    int r = 1;
    while ((long long)r * (r + 1) / 2 <= tile) ++r;
    const int c = (int)(tile - (long long)r * (r - 1) / 2);
    x[((long long)r * WF_T + e / WF_T) * ld + c * WF_T + e % WF_T] = 0.f;
  }
  wfc_arrive();
  wfc_wait();
  for (int b = 1; b < nt; b *= 2) {
    const int pairs = (nt - b + 2 * b - 1) / (2 * b);
    const int items = pairs * b * b;
    for (int half = 0; half < 2; ++half) {
      for (int p = rank; p < items; p += ctas) {
        const int i0 = p / (b * b) * 2 * b, j0 = i0 + b;
        const int r = i0 + p % (b * b) / b, c = j0 + p % b;
        if (c >= nt) continue;
        float acc[8][8] = {};
        float* out = (half ? x : t) + (long long)r * WF_T * ld + c * WF_T;
        if (half == 0) {   // T = U12 X22: k over X22's rows j0 .. c
          wfc_product(acc, u + (long long)r * WF_T * ld, ld, x + c * WF_T,
                      ld, true, j0, c + 1, As, Bs);
          wfc_store(out, ld, acc, 1.f, false);
        } else {           // X12 = -X11 T: k over X11's columns r .. j0-1
          wfc_product(acc, x + (long long)r * WF_T * ld, ld, t + c * WF_T,
                      ld, true, r, j0, As, Bs);
          wfc_store(out, ld, acc, -1.f, false);
        }
      }
      wfc_arrive();
      wfc_wait();
    }
  }
}

// The unpivoted LU of the np x np workspace w (as wf_chol's), in place into
// packed L\U with the unit lower diagonal implied; the zero-pivot rule of
// lu_factor_smem at slab width bw (WF_T % bw == 0) inside each diagonal
// block, whose Inf or NaN reaches the tiles below and right through the
// block's inverses. slots: 2 (np / WF_T - 1) tiles of WF_T x WF_T floats
// (U_jj^-1 and (L_jj^-1)^T a step). Called and synced as wf_chol.
__device__ inline void wf_lu(float* w, long long ld, int np, int bw,
                             float* slots, float* smem) {
  const int rank = wf_rank(), ctas = wf_ctas(), nt = np / WF_T;
  int tx, ty;
  pg_thread<WF_T>(tx, ty);
  for (int j = 0; j < nt; ++j) {
    float* wjj = w + (long long)j * WF_T * ld + j * WF_T;
    float* uslot = slots + (long long)2 * j * WF_T * WF_T;
    float* lslot = uslot + WF_T * WF_T;
    if (rank == 0) {
      wf_load_tile(smem, wjj, ld);
      __syncthreads();
      lu_factor_smem(smem, WF_LDS, WF_T, bw,
                     smem + 2 * WF_T * WF_LDS + WF_T * WF_LDT);
      wf_store_tile(wjj, ld, smem, WF_LDS, false);
      if (j + 1 < nt) {
        wf_invert_tile(smem, uslot, WF_T, smem);      // U_jj^-1 (reads
                                                      // the tile only)
        // L_jj^T with its unit diagonal in the upper triangle: the
        // doubling gives (L_jj^T)^-1 = (L_jj^-1)^T
        for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += blockDim.x) {
          const int r = idx / WF_T, c = idx % WF_T;
          if (c > r) smem[r * WF_LDS + c] = smem[c * WF_LDS + r];
          if (c == r) smem[r * WF_LDS + c] = 1.f;
        }
        __syncthreads();
        wf_invert_tile(smem, lslot, WF_T, smem);
      }
    }
    wf_sync();
    if (j + 1 == nt) break;
    // items 0 .. m-1: the tiles below, L21 = A21 U_jj^-1; m .. 2m-1: the
    // tiles right, U12 = L_jj^-1 A12 (A(r, k) = lslot[k][r]), each in place
    const int m = nt - j - 1;
    for (int p = rank; p < 2 * m; p += ctas) {
      float acc[PG_RM][8] = {};
      if (p < m) {
        float* t = w + (long long)(j + 1 + p) * WF_T * ld + j * WF_T;
        pg_upper_product<WF_T>(acc, t, ld, 1, WF_T, PG_COPY16, uslot, WF_T,
                               smem, tx, ty);
        wf_store_acc(t, ld, acc, 1.f, false, tx, ty);
      } else {
        float* t = wjj + (p - m + 1) * WF_T;
        pg_product<WF_T>(acc, lslot, 1, WF_T, WF_T, PG_COPY4, t, ld, 1,
                         PG_COPY4, 0, WF_T, smem, tx, ty);
        wf_store_acc(t, ld, acc, 1.f, false, tx, ty);
      }
    }
    wf_sync();
    // the trailing tiles (i, k), i, k > j: A_ik -= L_ij U_jk
    for (int p = rank; p < m * m; p += ctas) {
      const int i = j + 1 + p / m, k = j + 1 + p % m;
      float acc[PG_RM][8] = {};
      pg_product<WF_T>(acc, w + (long long)i * WF_T * ld, ld, 1, WF_T,
                       PG_COPY16, w + k * WF_T, ld, 1, PG_COPY4, j * WF_T,
                       (j + 1) * WF_T, smem, tx, ty);
      wf_store_acc(w + (long long)i * WF_T * ld + k * WF_T, ld, acc, 1.f,
                   true, tx, ty);
    }
    wf_sync();
  }
}

// x = U^-1 for the upper-triangular np x np U in u (row-major, leading
// dimension ld, 16-byte aligned rows; only its upper tiles and the upper
// triangles of its diagonal tiles are read), np a multiple of WF_T; x and
// t (scratch) np x np with the same leading dimension. x is written whole,
// zero below the diagonal. Called and synced as wf_chol.
__device__ inline void wf_tri_inv(const float* u, float* x, float* t,
                                  long long ld, int np, float* smem) {
  const int rank = wf_rank(), ctas = wf_ctas(), nt = np / WF_T;
  int tx, ty;
  pg_thread<WF_T>(tx, ty);
  for (int d = rank; d < nt; d += ctas) {
    const long long off = (long long)d * WF_T * ld + d * WF_T;
    wf_load_tile(smem, u + off, ld);
    __syncthreads();
    wf_invert_tile(smem, x + off, ld, smem);
  }
  // the tiles below the diagonal are zero
  const long long below = (long long)nt * (nt - 1) / 2 * WF_T * WF_T;
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x;
       idx < below; idx += (long long)ctas * blockDim.x) {
    const long long tile = idx / (WF_T * WF_T);
    const int e = (int)(idx % (WF_T * WF_T));
    int r = 1;
    while ((long long)r * (r + 1) / 2 <= tile) ++r;
    const int c = (int)(tile - (long long)r * (r - 1) / 2);
    x[((long long)r * WF_T + e / WF_T) * ld + c * WF_T + e % WF_T] = 0.f;
  }
  wf_sync();
  for (int b = 1; b < nt; b *= 2) {
    // the output tiles (r, c) of every pair at this level: r in
    // [i0, i0 + b), c in [i0 + b, min(i0 + 2b, nt)), i0 = 2 b p
    const int pairs = (nt - b + 2 * b - 1) / (2 * b);
    const int items = pairs * b * b;
    for (int half = 0; half < 2; ++half) {
      for (int p = rank; p < items; p += ctas) {
        const int i0 = p / (b * b) * 2 * b, j0 = i0 + b;
        const int r = i0 + p % (b * b) / b, c = j0 + p % b;
        if (c >= nt) continue;
        float acc[PG_RM][8] = {};
        float* out = (half ? x : t) + (long long)r * WF_T * ld + c * WF_T;
        if (half == 0) {   // T = U12 X22: k over X22's rows j0 .. c
          pg_product<WF_T>(acc, u + (long long)r * WF_T * ld, ld, 1, WF_T,
                           PG_COPY16, x + c * WF_T, ld, 1, PG_COPY4,
                           j0 * WF_T, (c + 1) * WF_T, smem, tx, ty);
          wf_store_acc(out, ld, acc, 1.f, false, tx, ty);
        } else {           // X12 = -X11 T: k over X11's columns r .. j0-1
          pg_product<WF_T>(acc, x + (long long)r * WF_T * ld, ld, 1, WF_T,
                           PG_COPY16, t + c * WF_T, ld, 1, PG_COPY4,
                           r * WF_T, j0 * WF_T, smem, tx, ty);
          wf_store_acc(out, ld, acc, -1.f, false, tx, ty);
        }
      }
      wf_sync();
    }
  }
}

// fac rows below a wide panel's top block: out[nb + r][c] (row-major,
// leading dimension nb) = A rows nb .. M-1 @ X, X = U^-1 upper triangular
// [nb, nb] row-major. Grid (ceil((M - nb) / WF_T), nb / WF_T): a CTA's
// output tile (row tile, column tile ct) sums k over [0, (ct + 1) WF_T)
// only, U^-1's rows past its column tile being zero there. A (f32, any
// strides) is staged as MODE says, X by 4-byte cp.async. The solve launch
// of K2 and K3's launch for the rows below at nb = 256 .. 512.
template <int MODE>
__global__ void __launch_bounds__(WF_THREADS)
wf_solve_kernel(const float* __restrict__ a, long long as0, long long as1,
                int M, int nb, const float* __restrict__ xinv,
                float* __restrict__ out) {
  using G = PanelGemm<WF_T>;
  extern __shared__ __align__(16) float smem[];
  const long long row0 = nb + (long long)blockIdx.x * WF_T;
  const int rows = (int)min((long long)WF_T, M - row0);
  const int c0 = blockIdx.y * WF_T;
  int tx, ty;
  pg_thread<WF_T>(tx, ty);
  float acc[PG_RM][8] = {};
  pg_product<WF_T>(acc, a + row0 * as0, as0, as1, rows, MODE, xinv + c0, nb,
                   1, PG_COPY4, 0, c0 + WF_T, smem, tx, ty);
#pragma unroll
  for (int i = 0; i < PG_RM; ++i) {
    const int r = ty + G::TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[(row0 + r) * nb + c0 + tx + G::TX * j] = acc[i][j];
  }
}

// Launch wf_solve_kernel<MODE> over rows nb .. M-1 (M > nb).
template <int MODE>
int wf_launch_solve(cudaStream_t stream, const float* a, long long as0,
                    long long as1, int M, int nb, const float* xinv,
                    float* out) {
  constexpr size_t smem = sizeof(float) * PanelGemm<WF_T>::SMEM_FLOATS;
  SLATE_SET_SMEM(wf_solve_kernel<MODE>, smem);
  const dim3 grid((M - nb + WF_T - 1) / WF_T, nb / WF_T, 1);
  wf_solve_kernel<MODE><<<grid, WF_THREADS, smem, stream>>>(a, as0, as1, M,
                                                           nb, xinv, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch one cluster of WF_CLUSTER CTAs of `kernel` (WF_THREADS threads,
// WF_SMEM_BYTES of dynamic shared memory each) on `stream`.
template <class... Params, class... Args>
int wf_launch(void (*kernel)(Params...), cudaStream_t stream,
              Args... args) {
  SLATE_SET_SMEM(kernel, WF_SMEM_BYTES);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WF_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(WF_CLUSTER, 1, 1);
  cfg.blockDim = dim3(WF_THREADS, 1, 1);
  cfg.dynamicSmemBytes = WF_SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// *fits = 1 when the card places one cluster of `kernel` (its shared memory
// within a block's opt-in limit, and cudaOccupancyMaxActiveClusters > 0).
template <class Kernel>
int wf_fits(Kernel kernel, int device, int* fits) {
  int limit = 0, placed = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = 0;
  if (WF_SMEM_BYTES > (size_t)limit) return 0;
  SLATE_SET_SMEM(kernel, WF_SMEM_BYTES);
  SLATE_RETURN_IF_ERROR(active_clusters(kernel, device, WF_CLUSTER,
                                        WF_THREADS, (int)WF_SMEM_BYTES,
                                        &placed));
  *fits = placed > 0;
  return 0;
}

// The cluster size of the Cholesky factor for `batch` clusters at once:
// WFC_MAX_CLUSTER CTAs where the card places that many clusters of it
// together, else WF_CLUSTER (the bits do not depend on it: each output tile
// is one CTA's, summed in one order). Opts the kernel into its shared
// memory and into clusters of more than 8.
template <class Kernel>
int wfc_cluster(Kernel kernel, int device, int batch, int* c) {
  SLATE_SET_SMEM(kernel, WFC_SMEM_BYTES);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  int placed = 0;
  SLATE_RETURN_IF_ERROR(active_clusters(kernel, device, WFC_MAX_CLUSTER,
                                        WFC_THREADS, (int)WFC_SMEM_BYTES,
                                        &placed));
  *c = placed >= batch ? WFC_MAX_CLUSTER : WF_CLUSTER;
  return 0;
}

// Launch `batch` clusters of the Cholesky factor's kernel (grid (c, batch),
// c from wfc_cluster; WFC_THREADS threads and WFC_SMEM_BYTES a CTA) on
// `stream`.
template <class... Params, class... Args>
int wfc_launch(void (*kernel)(Params...), cudaStream_t stream, int device,
               int batch, Args... args) {
  int c = WF_CLUSTER;
  const int e = wfc_cluster(kernel, device, batch, &c);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, batch, 1);
  cfg.blockDim = dim3(WFC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = WFC_SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// *fits = 1 when the card places one WF_CLUSTER cluster of the Cholesky
// factor's kernel (its shared memory within a block's opt-in limit).
template <class Kernel>
int wfc_fits(Kernel kernel, int device, int* fits) {
  int limit = 0, placed = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = 0;
  if (WFC_SMEM_BYTES > (size_t)limit) return 0;
  SLATE_SET_SMEM(kernel, WFC_SMEM_BYTES);
  SLATE_RETURN_IF_ERROR(active_clusters(kernel, device, WF_CLUSTER,
                                        WFC_THREADS, (int)WFC_SMEM_BYTES,
                                        &placed));
  *fits = placed > 0;
  return 0;
}

// A wide panel width: 256, 384 or 512.
__host__ __device__ inline bool wf_panel_nb(int nb) {
  return nb > WF_T && nb <= WF_MAX_PANEL && nb % WF_T == 0;
}
