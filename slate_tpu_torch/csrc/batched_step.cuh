// The ragged batched panel step shared by K6 (chol_panel_batched.cu) and K7
// (lu_panel_batched.cu): the update and solve launches around each kernel's
// own factor launch, the port of the batched kernels of
// slate_tpu/internal/pallas_chol.py:197 and pallas_lu.py:228.
//
//   col  [B, M, nb]  A[:, k0:, k0:k0+nb]     left [B, M, K]  A[:, k0:, :k0]
//   lead [B, K, nb]  K6: A[:, k0:k0+nb, :k0]^T; K7: the packed U block
//                    column A[:, :k0, k0:k0+nb] (f32 or bf16, any strides)
//   tiles [B] int32  live tile counts: row tile i (nb rows) of problem b is
//                    live iff k + i < tiles[b], so rows r < live_m(b) =
//                    clamp((tiles[b] - k) nb, 0, M) are live
//   upd  [B, M, nb]  col - left @ lead, the pre-factor panel (storage)
//   fac  [B, M, nb]  row tile 0 factored (K6: L00, zero above its
//                    diagonal; K7: packed L\U), the live rows below it
//                    upd @ U^-1 (K6: U = L00^T; K7: U = triu(tile 0))
//   work [B, M, nb]  f32 scratch: upd before its rounding (upd itself on f32
//                    storage), which the factor and the solve read
//   uinv [B, nb, nb] f32 scratch: U^-1 of each live problem
//
// A dead row is copied from col into upd and fac bit for bit and reads no
// left: identity-augmented packing makes the input its own factor there.
// Storage is f32 or bf16, a launch argument; loads widen to f32, every sum,
// the factor and the solve run in f32 (on work, never on the rounded upd),
// and only the stores to upd and fac round (storage.cuh), as the plain
// versions do.
//
// The hazard: the Pallas grid runs (b, i, j) in order, carrying the K-sum in
// one VMEM scratch and U^-1 from row tile 0 to the later tiles in another.
// CUDA blocks run in no order, so the step is three launches on one stream,
// work and U^-1 handed over in global memory:
//   (a) update (batched_update): grid (S, ceil(M / 128), B), a cluster of S
//       CTAs per (128-row tile, problem), tile 0 included: K2's tiled
//       product (panel_gemm.cuh: 128 x 128 tiles, a 16 x 8 register tile a
//       thread, a 3-deep ring staged by cp.async on f32 operands: 16-byte
//       copies where unit-stride along K, 4-byte copies where unit-stride
//       along the other index (K7's lead), plain widening loads otherwise
//       and on bf16; a width nb < 128 masks the columns past it), the K
//       loop split over the cluster and the partial tiles added in rank
//       order; writes upd, work, and the dead rows of upd and fac;
//   (b) factor: each kernel's own, one block per problem whose tile 0 is
//       live: tile 0 of work factored into fac, then, when M > nb, U^-1 by
//       K0's blocked doubling (tri_inv.cuh) into uinv;
//   (c) solve (batched_solve, M > nb): grid (ceil((M - nb) / 128), B), fac =
//       work rows @ U^-1 over every live 128-row tile below tile 0, the same
//       tiled product at K = nb, skipping U^-1's zero lower part
//       (pg_upper_product, shared with K2's and K3's solve).
// A step is three launches when M > nb and two (update, factor) when
// M == nb. Liveness is read on the device from tiles; the host never reads
// it back.
//
// At the reference's wider panels, nb = 256, 384 and 512 (its route takes
// min(plan.nb, bucket), slate_tpu/serve/batched.py:245), the three launches
// keep their roles, as K2's and K3's do at those widths (chol_panel.cu,
// lu_panel.cu):
//   (a) takes the panel in 128-column tiles: grid (S, row tiles x column
//       tiles, B), each (row tile, column tile, problem) the nb = 128
//       update above, written into its columns of upd and work;
//   (b) the nb x nb tile 0 no longer fits one block's shared memory: one
//       thread-block cluster per problem whose tile 0 is live copies it
//       from work into a per-problem f32 scratch (wide, from the wrapper)
//       and factors it there by 128-column diagonal blocks (wide_factor.cuh
//       wf_chol, wf_lu), writes fac's tile 0 and, when M > nb, U^-1 into
//       uinv (K6: wfc_tri_inv in the same launch; K7: K0's wide route in a
//       second launch, tri_inv_wide.cuh);
//   (c) one CTA per (128-row tile, 128-column tile, problem) of the live
//       rows below tile 0, summing only U^-1's rows down to its column
//       tile's end (batched_solve_wide).
// nb <= 128 keeps the launches above, their code and their bits.
//
// The split S is a function of K and the device alone, never of B, of
// tiles or of timing: S = ceil(slices / BP_SLICES), at most 16, slices the
// 32-deep K slices, so that no CTA sums more than BP_SLICES slices (smaller
// where the card holds no cluster of S). The grid holds live tiles x S CTAs
// of at most 8 slices each, which the block scheduler spreads over the card
// whatever the batch and its liveness, and a problem's bits do not depend
// on its batch.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "panel_gemm.cuh"
#include "storage.cuh"
#include "wide_factor.cuh"

using bf16_t = __nv_bfloat16;

constexpr int BP_MAX_SPLIT = 16;     // the largest (non-portable) cluster
constexpr int BP_SLICES = 8;         // K slices a CTA sums at most
constexpr int BP_FACTOR_THREADS = 512;

// One operand of a problem: element (r, c) of problem b at
// p[b * sb + r * s0 + c * s1], f32 or bf16 as the step's storage.
struct Operand {
  const void* p;
  long long sb, s0, s1;
};

// The storage type and the width are launch arguments, not template
// parameters: the library holds one kernel of each launch for every
// storage and width.
struct Step {
  Operand col, left, lead;
  int bf16;                  // storage: 0 f32, 1 bf16
  int stage_left, stage_lead;  // PG_LOADS, PG_COPY16 or PG_COPY4
  const int* tiles;
  int k, K, M, nb, bw, slices;  // bw: K7's slab width (K6 ignores it)
  void* upd;    // [B, M, nb] row-major, storage
  void* fac;    // [B, M, nb] row-major, storage
  float* work;  // [B, M, nb] row-major; == upd on f32 storage
  float* uinv;  // [B, nb, nb] row-major; null when M == nb
  float* wide;  // [B, bp_wide_floats(nb)]: the wide factor's scratch;
                // null up to nb = 128
};

// Element i of storage p, widened to f32.
__device__ inline float load_f32(const void* p, long long i, int bf16) {
  return bf16 ? to_f32(static_cast<const bf16_t*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Element i of storage p = v, rounded to bf16 on bf16 storage.
__device__ inline void store_f32(void* p, long long i, float v, int bf16) {
  if (bf16) {
    static_cast<bf16_t*>(p)[i] = from_f32<bf16_t>(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// dst[di] = src[si], bit for bit.
__device__ inline void copy_element(void* dst, long long di, const void* src,
                                    long long si, int bf16) {
  if (bf16) {
    copy_bits(static_cast<bf16_t*>(dst) + di,
              static_cast<const bf16_t*>(src) + si);
  } else {
    copy_bits(static_cast<float*>(dst) + di,
              static_cast<const float*>(src) + si);
  }
}

// Rows of problem b that are live: clamp((tiles[b] - k) nb, 0, M).
__device__ inline long long live_rows(const Step& a, int b) {
  const long long m = (long long)(a.tiles[b] - a.k) * a.nb;
  return m < 0 ? 0 : (m > a.M ? a.M : m);
}

// The CTA tile of the update and the solve: 128 rows x 128 columns, a
// 16 x 8 register tile a thread (panel_gemm.cuh). A panel of width nb < 128
// takes the same kernels with the columns past nb read as 0 and never
// stored.
constexpr int BP_NB = 128;
using BPG = PanelGemm<BP_NB>;

// The 128-column tiles of a panel: one (nb columns) up to nb = 128.
__host__ __device__ inline int bp_ctiles(int nb) {
  return nb > BP_NB ? nb / BP_NB : 1;
}

// The wide factor's scratch of one problem, in floats: tile 0 (nb x nb),
// the diagonal blocks' inverses (2 nb / 128 tiles of 128 x 128 at most:
// wf_lu's; wf_chol takes half) and U^-1's scratch T (nb x nb: wfc_tri_inv's
// or K0's wide route's); 0 up to nb = 128.
__host__ __device__ inline long long bp_wide_floats(int nb) {
  return nb > BP_NB ? 2LL * nb * nb + 2LL * nb * WF_T : 0;
}

// (a), the body of a kernel launched with BPG::THREADS threads on a
// cluster of S CTAs: upd and work for the live rows of the 128-row tile
// blockIdx.y / ctiles, column tile blockIdx.y % ctiles (bp_ctiles: one up
// to nb = 128), of problem blockIdx.z, K split over the cluster; col's bits
// into upd and fac for its dead rows.
__device__ inline void batched_update(const Step& a, float* smem) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.z, nb = a.nb, ctiles = bp_ctiles(nb);
  const int cw = nb > BP_NB ? BP_NB : nb;           // the tile's columns
  const int c0 = (int)(blockIdx.y % ctiles) * BP_NB;
  const long long row0 = (long long)(blockIdx.y / ctiles) * PG_BM;
  const int span = (int)min((long long)PG_BM, a.M - row0);
  const long long live = live_rows(a, b) - row0;
  const int rows = (int)(live < 0 ? 0 : (live > span ? span : live));
  const long long col0 = b * a.col.sb + row0 * a.col.s0 + c0 * a.col.s1;
  const long long out0 = ((long long)b * a.M + row0) * nb + c0;
  // the dead rows rows .. span-1 of the tile, shared out over the cluster
  for (int idx = rows * cw + rank * BPG::THREADS + (int)threadIdx.x;
       idx < span * cw; idx += S * BPG::THREADS) {
    const int r = idx / cw, c = idx % cw;
    const long long src = col0 + r * a.col.s0 + c * a.col.s1;
    copy_element(a.upd, out0 + (long long)r * nb + c, a.col.p, src, a.bf16);
    copy_element(a.fac, out0 + (long long)r * nb + c, a.col.p, src, a.bf16);
  }
  if (rows == 0) return;  // the whole cluster: no cluster barrier follows
  int tx, ty;
  pg_thread<BP_NB>(tx, ty);
  float acc[PG_RM][8] = {};
  const long long kspan = (long long)a.slices * PG_KC;
  const int kb = (int)min((long long)a.K, rank * kspan);
  const int ke = (int)min((long long)a.K, kb + kspan);
  const long long left0 = b * a.left.sb + row0 * a.left.s0;
  const long long lead0 = b * a.lead.sb + c0 * a.lead.s1;
  pg_pipeline<BP_NB>(
      acc, pg_slices(kb, ke),
      [&](int s, float* As) {
        if (a.bf16) {
          pg_stage_slice<BP_NB>(
              As, s, static_cast<const bf16_t*>(a.left.p) + left0, a.left.s0,
              a.left.s1, rows, PG_LOADS,
              static_cast<const bf16_t*>(a.lead.p) + lead0, a.lead.s0,
              a.lead.s1, cw, PG_LOADS, kb, ke);
        } else {
          pg_stage_slice<BP_NB>(
              As, s, static_cast<const float*>(a.left.p) + left0, a.left.s0,
              a.left.s1, rows, a.stage_left,
              static_cast<const float*>(a.lead.p) + lead0, a.lead.s0,
              a.lead.s1, cw, a.stage_lead, kb, ke);
        }
      },
      smem, tx, ty);
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < PG_RM; ++i) {
      const int r = ty + BPG::TY * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + BPG::TX * j;
        if (c >= cw) continue;
        const float v =
            load_f32(a.col.p, col0 + r * a.col.s0 + c * a.col.s1, a.bf16) -
            acc[i][j];
        store_f32(a.upd, out0 + r * nb + c, v, a.bf16);
        if (a.bf16) a.work[out0 + r * nb + c] = v;
      }
    }
  } else {
    pg_cluster_sum<BP_NB>(acc, smem, rows, tx, ty,
                          [&](int r, int c, float4 s) {
      if (c >= cw) return;
      const long long x = col0 + r * a.col.s0 + c * a.col.s1;
      float4 v;
      v.x = load_f32(a.col.p, x, a.bf16) - s.x;
      v.y = load_f32(a.col.p, x + a.col.s1, a.bf16) - s.y;
      v.z = load_f32(a.col.p, x + 2 * a.col.s1, a.bf16) - s.z;
      v.w = load_f32(a.col.p, x + 3 * a.col.s1, a.bf16) - s.w;
      const long long o = out0 + r * nb + c;
      if (a.bf16) {
        store_f32(a.upd, o, v.x, 1);
        store_f32(a.upd, o + 1, v.y, 1);
        store_f32(a.upd, o + 2, v.z, 1);
        store_f32(a.upd, o + 3, v.w, 1);
        *reinterpret_cast<float4*>(a.work + o) = v;
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(a.upd) + o) = v;
      }
    });
  }
}

// (c), the body of a kernel launched with BPG::THREADS threads: fac rows
// nb + 128 blockIdx.x .. of problem blockIdx.y = work rows @ U^-1, live rows
// only (launch (a) wrote the dead ones).
__device__ inline void batched_solve(const Step& a, float* smem) {
  const int b = blockIdx.y, nb = a.nb;
  const long long row0 = nb + (long long)blockIdx.x * PG_BM;
  const long long live = live_rows(a, b) - row0;
  if (live <= 0) return;
  const int rows = (int)(live < PG_BM ? live : PG_BM);
  const long long out0 = ((long long)b * a.M + row0) * nb;
  int tx, ty;
  pg_thread<BP_NB>(tx, ty);
  float acc[PG_RM][8] = {};
  // work rows are unit-stride along K with 16-byte aligned rows; U^-1 is
  // upper triangular (pg_upper_product, the product of K2's and K3's solve)
  pg_upper_product<BP_NB>(acc, a.work + out0, nb, 1, rows, PG_COPY16,
                          a.uinv + (long long)b * nb * nb, nb, smem, tx, ty);
#pragma unroll
  for (int i = 0; i < PG_RM; ++i) {
    const int r = ty + BPG::TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + BPG::TX * j;
      if (c < nb) store_f32(a.fac, out0 + r * nb + c, acc[i][j], a.bf16);
    }
  }
}

// (c) at nb = 256 .. 512, the body of a kernel launched with BPG::THREADS
// threads: fac rows nb + 128 blockIdx.x .. of problem blockIdx.z, columns
// 128 blockIdx.y .. + 127, = work rows @ U^-1's columns, k over [0, 128
// (blockIdx.y + 1)) only (U^-1's rows past the column tile are zero
// there: wide_factor.cuh wf_solve_kernel's product); live rows only.
__device__ inline void batched_solve_wide(const Step& a, float* smem) {
  const int b = blockIdx.z, nb = a.nb, c0 = blockIdx.y * BP_NB;
  const long long row0 = nb + (long long)blockIdx.x * PG_BM;
  const long long live = live_rows(a, b) - row0;
  if (live <= 0) return;
  const int rows = (int)(live < PG_BM ? live : PG_BM);
  const long long out0 = ((long long)b * a.M + row0) * nb + c0;
  int tx, ty;
  pg_thread<BP_NB>(tx, ty);
  float acc[PG_RM][8] = {};
  pg_product<BP_NB>(acc, a.work + out0 - c0, nb, 1, rows, PG_COPY16,
                    a.uinv + (long long)b * nb * nb + c0, nb, 1, PG_COPY4, 0,
                    c0 + BP_NB, smem, tx, ty);
#pragma unroll
  for (int i = 0; i < PG_RM; ++i) {
    const int r = ty + BPG::TY * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      store_f32(a.fac, out0 + (long long)r * nb + tx + BPG::TX * j,
                acc[i][j], a.bf16);
    }
  }
}

// The scratch of problem b's wide factor launch: tile 0, the diagonal
// blocks' inverses, U^-1's scratch (bp_wide_floats).
struct WideScratch {
  float *tile, *slots, *t;
};

__host__ __device__ inline WideScratch wide_scratch(const Step& a, int b) {
  float* tile = a.wide + b * bp_wide_floats(a.nb);
  float* slots = tile + (long long)a.nb * a.nb;
  return {tile, slots, slots + 2LL * a.nb * WF_T};
}

// fac's tile 0 of problem b (row-major, leading dimension nb, rounded to
// the storage) = the factored tile in the scratch; every thread of the
// cluster calls it after a fenced cluster barrier. With `lower` (Cholesky)
// fac is zero above the diagonal and the tile's lower triangle is mirrored
// into its upper one (U = L^T for wfc_tri_inv): every read below the
// diagonal, every write to the tile above it, so no CTA reads what another
// writes.
__device__ inline void wide_store_tile(const Step& a, int b, float* tile,
                                       bool lower) {
  const int nb = a.nb, rank = wf_rank(), ctas = wf_ctas();
  const long long out0 = (long long)b * a.M * nb;
  for (int idx = rank * blockDim.x + threadIdx.x; idx < nb * nb;
       idx += ctas * blockDim.x) {
    const int r = idx / nb, c = idx % nb;
    const float v = (lower && c > r) ? 0.f : __ldcg(tile + idx);
    store_f32(a.fac, out0 + idx, v, a.bf16);
    if (lower && c > r) tile[idx] = __ldcg(tile + (long long)c * nb + r);
  }
}

constexpr size_t update_smem_bytes() {
  constexpr size_t ring = BPG::SMEM_FLOATS;
  constexpr size_t partial = (size_t)PG_BM * pg_partial_ld<BP_NB>();
  return sizeof(float) * (ring > partial ? ring : partial);
}

// How an operand with these strides is staged: cp.async 16-byte copies
// (f32, unit-stride along K, the other and batch strides multiples of 4
// floats, the base 16-byte aligned), else cp.async 4-byte copies (f32,
// unit-stride along the other index), else plain widening loads (bf16 and
// any other strides).
inline int staging_mode(int bf16, const void* p, long long stride_b,
                        long long stride_k, long long stride_other) {
  if (bf16) return PG_LOADS;
  if (stride_k == 1 && stride_other % 4 == 0 && stride_b % 4 == 0 &&
      reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    return PG_COPY16;
  }
  return stride_other == 1 ? PG_COPY4 : PG_LOADS;
}

// The step's operands as the C entry points receive them (strides in
// elements; work is upd on f32 storage; uinv null when M == nb; wide null
// up to nb = 128).
inline Step make_step(int bf16, const void* col, long long cb, long long cs0,
                      long long cs1, const void* left, long long lb,
                      long long ls0, long long ls1, const void* lead,
                      long long db, long long ds0, long long ds1,
                      const int* tiles, int k, int K, int M, int nb, int bw,
                      void* upd, void* fac, float* work, float* uinv,
                      float* wide) {
  return Step{{col, cb, cs0, cs1},
              {left, lb, ls0, ls1},
              {lead, db, ds0, ds1},
              bf16,
              staging_mode(bf16, left, lb, ls1, ls0),
              staging_mode(bf16, lead, db, ds0, ds1),
              tiles, k, K, M, nb, bw, 0, upd, fac, work, uinv, wide};
}

enum Launch { UPDATE = 0, FACTOR = 1, SOLVE = 2 };

// The widths the step takes: whole 32-column blocks up to the 128 columns
// of a CTA's tile, or 256, 384 and 512 by 128-column tiles with the wide
// factor (wide_factor.cuh wf_panel_nb).
inline bool step_nb_ok(int nb) {
  return nb == 32 || nb == 64 || nb == 96 || nb == 128 || wf_panel_nb(nb);
}

// The launch arguments both entry points refuse: past the widths, no
// problem, M not a positive multiple of nb, no such launch, a solve with
// no rows below tile 0, uinv given exactly when there are no rows below,
// or the wide factor's scratch given exactly when nb > 128.
inline bool step_args_ok(int which, int B, int M, int nb, const float* uinv,
                         const float* wide) {
  return step_nb_ok(nb) && B >= 1 && M >= nb && M % nb == 0 &&
         which >= UPDATE && which <= SOLVE && !(which == SOLVE && M == nb) &&
         (uinv == nullptr) == (M == nb) &&
         (wide == nullptr) == (nb <= BP_NB);
}

// Opt the update kernel into its shared memory and into clusters of more
// than 8, and choose the split *split for K: S = ceil(slices / BP_SLICES)
// in 1 .. 16, lowered while the card holds no cluster of S; *slices = K
// slices a CTA, *resident = clusters of S the card holds at once.
template <class Kernel>
int prepare_update(Kernel update, int device, int K, int* split, int* slices,
                   int* resident) {
  constexpr size_t smem = update_smem_bytes();
  SLATE_SET_SMEM(update, smem);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      update, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  const int total = (K + PG_KC - 1) / PG_KC;
  int s = (total + BP_SLICES - 1) / BP_SLICES;
  s = s < 1 ? 1 : (s > BP_MAX_SPLIT ? BP_MAX_SPLIT : s);
  for (;; --s) {
    SLATE_RETURN_IF_ERROR(active_clusters(update, device, s, BPG::THREADS,
                                          (int)smem, resident));
    if (*resident > 0 || s == 1) break;
  }
  *split = s;
  *slices = (total + s - 1) / s;
  return 0;
}

template <class Kernel>
int launch_update(Kernel update, int device, cudaStream_t stream, int B,
                  Step a) {
  int split = 1, resident = 0;
  const int e = prepare_update(update, device, a.K, &split, &a.slices,
                               &resident);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(split, (a.M + PG_BM - 1) / PG_BM * bp_ctiles(a.nb), B);
  cfg.blockDim = dim3(BPG::THREADS, 1, 1);
  cfg.dynamicSmemBytes = update_smem_bytes();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, update, a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// (c): `solve` (batched_solve's kernel) over grid (row tiles below tile 0,
// B), or at nb > 128 `wide` (batched_solve_wide's) over (row tiles,
// column tiles, B).
template <class Kernel, class WideKernel>
int launch_solve(Kernel solve, WideKernel wide, cudaStream_t stream, int B,
                 const Step& a) {
  constexpr size_t smem = sizeof(float) * BPG::SMEM_FLOATS;
  const int rtiles = (a.M - a.nb + PG_BM - 1) / PG_BM;
  if (a.nb > BP_NB) {
    SLATE_SET_SMEM(wide, smem);
    wide<<<dim3(rtiles, bp_ctiles(a.nb), B), BPG::THREADS, smem, stream>>>(
        a);
  } else {
    SLATE_SET_SMEM(solve, smem);
    solve<<<dim3(rtiles, B), BPG::THREADS, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the update launch takes for a step on this device: *split = the
// CTAs of a (row tile, problem)'s cluster (the K split, from K and the
// device alone), *resident = clusters of that size the card holds at once,
// *staging = left's staging mode + 4 x lead's (staging_mode).
template <class Kernel>
int step_plan(Kernel update, int device, int bf16, int K, int nb,
              const void* left, long long lb, long long ls0, long long ls1,
              const void* lead, long long db, long long ds0, long long ds1,
              int* split, int* resident, int* staging) {
  SLATE_SET_DEVICE(device);
  if (!step_nb_ok(nb)) return static_cast<int>(cudaErrorInvalidValue);
  *staging = staging_mode(bf16, left, lb, ls1, ls0) +
             4 * staging_mode(bf16, lead, db, ds0, ds1);
  int slices = 0;
  return prepare_update(update, device, K, split, &slices, resident);
}
