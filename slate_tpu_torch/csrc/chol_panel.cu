// K2: one fused left-looking Cholesky panel step, the port of
// chol_panel_fused (slate_tpu/internal/pallas_chol.py:162, pallas_call at
// :180, kernel at :120-158).
//
//   col  [M, nb]  A[k0:, k0:k0+nb]       left [M, K]  A[k0:, :k0]
//   lead [K, nb]  A[k0:k0+nb, :k0]^T     (all f32, any strides)
//   upd = col - left @ lead              the pre-factor panel
//   fac = [L00; L21]: L00 = chol(upd_0), L21 = upd_below @ U^-1, U = L00^T
//
// The hazard: the Pallas grid runs in order, carrying the K-sum in one VMEM
// scratch and U^-1 from row tile 0 to the later row tiles in another. CUDA
// blocks run in no order, so upd_0 and U^-1 are handed on through global
// memory between launches on one stream:
//   (a) chol_panel_update: grid (S, ceil(M / 128)), one thread-block
//       cluster of S CTAs per 128-row tile, tile 0 included. CTA s of a
//       cluster sums its share of the K loop (panel_gemm.cuh); the S
//       partial tiles are added through distributed shared memory in rank
//       order, each CTA adding 1/S of the tile, and upd = col - sum is
//       written;
//   (b) chol_panel_factor: one block of 512 threads factors upd_0 (K1's
//       blocked factor, chol_factor.cuh) and writes L00. It is the only
//       single-block launch of K2 and runs no part of the K loop;
//   then, when there are rows below, the wrapper launches K0 (tri_inv.cu) on
//   U = L00^T, which writes U^-1 to a tile of its own;
//   (c) chol_panel_solve: one CTA per 128 rows below tile 0 forms fac =
//       upd_below @ U^-1, the same tiled product with K = nb, skipping
//       U^-1's zero lower part (pg_upper_product, shared with K3's rows
//       below, K6 and K7).
// K0 runs as its own launch, so that each kernel's launch count is the
// launches its own wrapper made: a panel with rows below is three K2
// launches and one K0, the last panel (M = nb) two K2 launches.
//
// The split S is a function of the shape (M, K, nb) and the device alone:
// the S in 1..16 that minimises waves x K slices per CTA, where a wave is
// the clusters of S CTAs that the card holds at once
// (cudaOccupancyMaxActiveClusters), with no CTA given fewer than 4 slices
// of 32 (ties to the smaller S). It never depends on load or timing, and
// the partials are added in rank order without atomics, so two launches on
// the same inputs give the same bits.
// The Pallas version pads K with zeros to a multiple of nb; here the staging
// masks the ragged end of K instead, and K = 0 skips the loop. On the posv
// path left and lead are views of the factor being built, both unit-stride
// along K (lead is a transpose), so both stage by cp.async; any other
// strides take the kernel's plain-load staging (slate_chol_panel_plan
// reports which).
//
// At the reference's wider panels, nb = 256, 384 and 512 (slate_tpu/
// internal/potrf.py:59-68), the three launches keep their roles:
//   (a) runs on the tensor cores as a split-precision product (3xTF32,
//       tf32x3.cuh), the kernel below the narrow update: a CTA a 128 x 128
//       output tile (grid (S, nb / 128, M / 128), the K loop split over a
//       cluster of S CTAs as at the narrow widths), three warpgroups:
//         - a producer warpgroup stages 32-deep K slices of left's 128
//           rows and of lead's 128 columns into a ring of TC_STAGES
//           slots, 128-byte swizzled, by TMA (one thread; tensor maps
//           from cuTensorMapEncodeTiled, passed as __grid_constant__
//           parameters; zeros past K) with full/empty mbarriers; an
//           operand TMA cannot describe (not unit-stride along K, an
//           unaligned base or row stride: the transposed left of a check)
//           is loaded by the warpgroup's 128 threads into the same layout;
//         - two consumer warpgroups, 64 rows each (setmaxnreg moves the
//           producer's registers to them), split each slice into tf32 hi
//           and lo parts: each its elements of left's 64 rows in
//           registers (wgmma's A operand), and half of lead's columns into
//           shared memory (the B operand, two buffers: slice i + 1's split
//           runs beside slice i's products); then they release the slot,
//           meet at one barrier, and issue per k8 step three wgmma (hi hi,
//           hi lo, lo hi) into a fresh f32 accumulator, which they add to a
//           running f32 sum after the slice (the tensor cores' own
//           accumulation rounds toward zero; FADDs round to nearest);
//         - the S partial tiles meet in rank order through distributed
//           shared memory, without atomics;
//   (b) factors the nb x nb diagonal block, which no longer fits one
//       block's shared memory, by K1's wide route (wide_factor.cuh): one
//       thread-block cluster, the block in device memory (fac's top rows)
//       by 128-column diagonal blocks;
//   (c) one CTA per (128-row tile, 128-column tile) of the rows below
//       multiplies by the nb x nb U^-1 that the wrapper's K0 launch formed,
//       summing only over U^-1's rows down to the column tile's end.
//
// Bound on this card: 2 M K nb flops of the update plus nb^3/3 + (M - nb)
// nb^2 of the factor and the triangular solve, against the bytes of col,
// left, lead, upd and fac read or written once. With K >= nb it is bound by
// operations. The reference asks for Precision.HIGHEST, so never one TF32
// pass: up to nb = 128 every product is an FFMA on the CUDA cores (at most
// 67 TFLOP/s), which the narrow update aims at with 128 x nb tiles a CTA,
// a 16 x 8 register tile a thread, a three-deep cp.async ring, and the
// split filling the card when row tiles are few; past 128 the update's
// three TF32 passes are bound by 3 x 2 M K nb / 494.7 TFLOP/s, a third of
// the CUDA cores' bound.
#include <cooperative_groups.h>

#include <cstdint>

#include "chol_factor.cuh"
#include "common.cuh"
#include "panel_gemm.cuh"
#include "tf32x3.cuh"
#include "wide_factor.cuh"

namespace cg = cooperative_groups;

constexpr int PANEL_MAX_SPLIT = 16;    // the largest (non-portable) cluster
constexpr int PANEL_MIN_SLICES = 4;    // K slices a CTA takes at least

template <int NB>
constexpr size_t update_smem_bytes() {
  constexpr size_t ring = PanelGemm<NB>::SMEM_FLOATS;
  constexpr size_t partial = (size_t)PG_BM * pg_partial_ld<NB>();
  return sizeof(float) * (ring > partial ? ring : partial);
}

// (a): upd for the 128-row tile blockIdx.y, K split over the cluster (nb
// <= 128).
template <int NB>
__global__ void __launch_bounds__(PanelGemm<NB>::THREADS, 2)
chol_panel_update_kernel(const float* __restrict__ col, long long cs0,
                         long long cs1, const float* __restrict__ left,
                         long long ls0, long long ls1, int fast_left,
                         const float* __restrict__ lead, long long ds0,
                         long long ds1, int fast_lead, int M, int K,
                         int slices, float* __restrict__ upd) {
  using G = PanelGemm<NB>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const long long row0 = (long long)blockIdx.y * PG_BM;
  const int rows = (int)min((long long)PG_BM, M - row0);
  int tx, ty;
  pg_thread<NB>(tx, ty);
  float acc[PG_RM][8] = {};
  const long long kspan = (long long)slices * PG_KC;
  const int kb = (int)min((long long)K, rank * kspan);
  const int ke = (int)min((long long)K, kb + kspan);
  pg_product<NB>(acc, left + row0 * ls0, ls0, ls1, rows, fast_left, lead,
                 ds0, ds1, fast_lead, kb, ke, smem, tx, ty);
  if (S == 1) {
#pragma unroll
    for (int i = 0; i < PG_RM; ++i) {
      const int r = ty + G::TY * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + G::TX * j;
        upd[(row0 + r) * NB + c] =
            col[(row0 + r) * cs0 + c * cs1] - acc[i][j];
      }
    }
  } else {
    pg_cluster_sum<NB>(acc, smem, rows, tx, ty, [&](int r, int c, float4 s) {
      const float* crow = col + (row0 + r) * cs0;
      float4 out;
      out.x = crow[c * cs1] - s.x;
      out.y = crow[(c + 1) * cs1] - s.y;
      out.z = crow[(c + 2) * cs1] - s.z;
      out.w = crow[(c + 3) * cs1] - s.w;
      *reinterpret_cast<float4*>(upd + (row0 + r) * NB + c) = out;
    });
  }
}

// ---- (a) at nb = 256 .. 512: the split-precision update on the tensor
// cores (the design in the note at the top of this file)

constexpr int TC_TILE = 128;          // output rows and columns of a CTA
constexpr int TC_STAGES = 5;          // slots of the TMA ring
constexpr int TC_BSPLITS = 2;         // buffers of lead's split slice
constexpr int TC_THREADS = 384;       // consumer warpgroups 0, 1; producer 2
constexpr int TC_SLICE = TC_TILE * TC_BK;    // one operand's staged slice
constexpr int TC_SLOT = 2 * TC_SLICE;        // left's slice, then lead's
// a buffer of lead's split slice: hi, then lo (left's rows are split in
// registers)
constexpr int TC_B_HI = 0, TC_B_LO = TC_SLICE, TC_SPLIT = 2 * TC_SLICE;
constexpr int TC_LDP = TC_TILE + 4;          // a partial tile's row
// registers a thread after the rebalance (setmaxnreg): the producer's few,
// the consumers' accumulator, running sum and left's split; 128 (56 + 2 x
// 224) = 384 x 168, the launch's allotment (without it the update ran ~9%
// slower on an H100)
constexpr int TC_PRODUCER_REGS = 56, TC_CONSUMER_REGS = 224;
// shared memory, in floats past a 1024-byte aligned start: the ring, the
// buffers of lead's split slice, then the barriers; the partial tile of the
// split's sum reuses the ring
constexpr size_t TC_SMEM_BYTES =
    1024 +
    sizeof(float) * (size_t)(TC_STAGES * TC_SLOT + TC_BSPLITS * TC_SPLIT) +
    sizeof(uint64_t) * 2 * TC_STAGES;
static_assert(TC_TILE * TC_LDP <= TC_STAGES * TC_SLOT,
              "the partial tile fits the ring");
static_assert(TC_SMEM_BYTES <= 232448, "a block's shared memory");

// The producer thread p (of 128) loads one slice (128 rows x TC_BK, element
// (r, k) at src[r * s_r + (k0 + k) * s_k], zeros at k0 + k >= K) into the
// swizzled layout, walking the unit-stride index, 16 loads in flight.
__device__ inline void tc_load_plain(float* dst, const float* src,
                                     long long s_r, long long s_k, int k0,
                                     int K, int p) {
  const bool k_fast = s_k == 1 || s_r != 1;
  constexpr int BATCH = 16;
  for (int t0 = 0; t0 < TC_SLICE / 128; t0 += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int e = (t0 + t) * 128 + p;
      const int r = k_fast ? e / TC_BK : e % TC_TILE;
      const int k = k_fast ? e % TC_BK : e / TC_TILE;
      v[t] = k0 + k < K ? src[r * s_r + (long long)(k0 + k) * s_k] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < BATCH; ++t) {
      const int e = (t0 + t) * 128 + p;
      const int r = k_fast ? e / TC_BK : e % TC_TILE;
      const int k = k_fast ? e % TC_BK : e / TC_TILE;
      dst[tc_swizzled(r, k)] = v[t];
    }
  }
}

// upd[row tile blockIdx.z, column tile blockIdx.y] = col - left @ lead over
// this CTA's K slices [rank * slices, + slices), the cluster's partials
// summed in rank order; ldo = nb. Each consumer warpgroup splits its half
// of slice i + 1's lead while slice i's products run (two buffers of the
// split lead), so that between two slices the tensor cores wait only for
// the sum, left's split in registers and one barrier.
__global__ void __launch_bounds__(TC_THREADS, 1)
chol_panel_update_tc_kernel(const __grid_constant__ CUtensorMap left_map,
                            const __grid_constant__ CUtensorMap lead_map,
                            const float* __restrict__ col, long long cs0,
                            long long cs1, const float* __restrict__ left,
                            long long ls0, long long ls1, int tma_left,
                            const float* __restrict__ lead, long long ds0,
                            long long ds1, int tma_lead, int K, int slices,
                            float* __restrict__ upd, int ldo) {
  extern __shared__ unsigned char tc_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + TC_STAGES * TC_SLOT + TC_BSPLITS * TC_SPLIT);
  uint64_t* empty = full + TC_STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, wg = tid / 128;
  const long long row0 = (long long)blockIdx.z * TC_TILE;
  const int c0 = blockIdx.y * TC_TILE;
  const int total = (K + TC_BK - 1) / TC_BK;
  const int sb = min(total, rank * slices);
  const int n = min(total, sb + slices) - sb;
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      tc_bar_init(full + s, 128);
      tc_bar_init(empty + s, 256);
    }
    tc_bar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        TC_PRODUCER_REGS));
    const int p = tid - 256;
    const uint32_t bytes = (tma_left + tma_lead) * TC_SLICE * sizeof(float);
    for (int i = 0; i < n; ++i) {
      const int s = i % TC_STAGES;
      if (i >= TC_STAGES) tc_bar_wait(empty + s, ((i / TC_STAGES) & 1) ^ 1);
      float* a = ring + s * TC_SLOT;
      float* b = a + TC_SLICE;
      const int k0 = (sb + i) * TC_BK;
      if (!tma_left) tc_load_plain(a, left + row0 * ls0, ls0, ls1, k0, K, p);
      if (!tma_lead) tc_load_plain(b, lead + c0 * ds1, ds1, ds0, k0, K, p);
      if (p == 0 && bytes) {
        tc_bar_arrive_tx(full + s, bytes);
        if (tma_left) tc_tma_load(a, &left_map, full + s, k0, (int)row0);
        if (tma_lead) tc_tma_load(b, &lead_map, full + s, k0, c0);
      } else {
        tc_bar_arrive(full + s);
      }
    }
    if (S > 1) {  // the consumers' two cluster barriers of the sum
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      TC_CONSUMER_REGS));
  const int t = tid % 128, lane = tid % 32;
  // this thread's elements of left in a k8 step (tc_wgmma_m64n128k8_rs):
  // rows ar and ar + 8 of the slot, columns lane % 4 and lane % 4 + 4
  const int ar = wg * 64 + t / 32 * 16 + lane / 4;
  float acc[64], run[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = run[i] = 0.f;
  uint32_t ahi[TC_BK / 8][4], alo[TC_BK / 8][4];
  float* bsplit = ring + TC_STAGES * TC_SLOT;  // TC_BSPLITS buffers
  // lead's slice of slot i: this warpgroup's half of its columns into
  // buffer i % TC_BSPLITS, hi then lo
  auto split_lead = [&](int i) {
    const float* b = ring + (i % TC_STAGES) * TC_SLOT + TC_SLICE;
    float* out = bsplit + (i % TC_BSPLITS) * TC_SPLIT;
#pragma unroll
    for (int j = 0; j < TC_SLICE / 8 / 128; ++j) {
      tc_split4(b, out + TC_B_HI, out + TC_B_LO,
                wg * (TC_SLICE / 8) + t + 128 * j);
    }
  };
  // this thread's elements of left in slot i into registers, split; then
  // the slot is released, and both warpgroups' halves of lead's split are
  // published
  auto split_left = [&](int i) {
    const float* a = ring + (i % TC_STAGES) * TC_SLOT;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float h, l;
        tc_split(a[tc_swizzled(ar + 8 * (v & 1), 8 * kk + lane % 4 +
                                                     4 * (v >> 1))],
                 h, l);
        ahi[kk][v] = __float_as_uint(h);
        alo[kk][v] = __float_as_uint(l);
      }
    tc_bar_arrive(empty + i % TC_STAGES);
    tc_fence_async();
    tc_named_sync(1, 256);
  };
  if (n > 0) {
    tc_bar_wait(full, 0);
    split_lead(0);
    split_left(0);
  }
  for (int i = 0; i < n; ++i) {
    const float* bs = bsplit + (i % TC_BSPLITS) * TC_SPLIT;
    const uint64_t b_hi = tc_desc(bs + TC_B_HI), b_lo = tc_desc(bs + TC_B_LO);
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {
      tc_wgmma_m64n128k8_rs(acc, ahi[kk], b_hi + 2 * kk, kk > 0);
      tc_wgmma_m64n128k8_rs(acc, ahi[kk], b_lo + 2 * kk, 1);
      tc_wgmma_m64n128k8_rs(acc, alo[kk], b_hi + 2 * kk, 1);
    }
    tc_wgmma_commit();
    // the next slice's lead beside these products, into the other buffer:
    // its last readers, the products of slice i - 1, completed before the
    // barrier that published slice i
    if (i + 1 < n) {
      tc_bar_wait(full + (i + 1) % TC_STAGES, ((i + 1) / TC_STAGES) & 1);
      split_lead(i + 1);
    }
    tc_wgmma_wait0();
    tc_fence_acc(acc);
    tc_fence_regs(ahi);
    tc_fence_regs(alo);
#pragma unroll
    for (int r = 0; r < 64; ++r) run[r] += acc[r];
    if (i + 1 < n) split_left(i + 1);
  }
  // this thread's outputs: d[4 j + 2 h + v] at row r0 + 8 h, column
  // 8 j + 2 (lane % 4) + v of the tile (tc_wgmma_m64n128k8_rs's layout)
  const int r0 = ar;
  const int cq = 2 * (lane % 4);
  if (S == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + r0 + 8 * h;
        const int c = c0 + 8 * j + cq;
        const float* crow = col + r * cs0;
        float2 out;
        out.x = crow[c * cs1] - run[4 * j + 2 * h];
        out.y = crow[(c + 1) * cs1] - run[4 * j + 2 * h + 1];
        *reinterpret_cast<float2*>(upd + r * ldo + c) = out;
      }
    return;
  }
  tc_named_sync(2, 256);  // both warpgroups are done with the ring
  float* P = ring;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* e = P + (r0 + 8 * h) * TC_LDP + 8 * j + cq;
      e[0] = run[4 * j + 2 * h];
      e[1] = run[4 * j + 2 * h + 1];
    }
  cluster.sync();
  constexpr int Q = TC_TILE / 4;
  const int lo_i = rank * (TC_TILE * Q) / S;
  const int hi_i = (rank + 1) * (TC_TILE * Q) / S;
  for (int idx = lo_i + tid; idx < hi_i; idx += 256) {
    const int r = idx / Q, c = 4 * (idx % Q);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(P, q) + r * TC_LDP + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float* crow = col + (row0 + r) * cs0 + (long long)(c0 + c) * cs1;
    float4 out;
    out.x = crow[0] - sum.x;
    out.y = crow[cs1] - sum.y;
    out.z = crow[2 * cs1] - sum.z;
    out.w = crow[3 * cs1] - sum.w;
    *reinterpret_cast<float4*>(upd + (row0 + r) * ldo + c0 + c) = out;
  }
  cluster.sync();  // no partial is read after this
}

constexpr int FACTOR_THREADS = 512;

// (b): L00 = chol(upd_0) on one block by K1's blocked factor
// (chol_factor.cuh): rows 0 .. nb-1 of fac from rows 0 .. nb-1 of upd. One
// kernel for every width: the routine takes nb at run time.
__global__ void __launch_bounds__(FACTOR_THREADS)
chol_panel_factor_kernel(const float* __restrict__ upd, int nb,
                         float* __restrict__ fac) {
  const int lds = nb + 4, q = nb / 4;
  extern __shared__ __align__(16) float smem[];
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += FACTOR_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    *reinterpret_cast<float4*>(smem + r * lds + c) =
        *reinterpret_cast<const float4*>(upd + r * nb + c);
  }
  __syncthreads();
  chol_factor_smem(smem, lds, nb, smem + nb * lds);
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * nb; idx += FACTOR_THREADS) {
    const int r = idx / nb, c = idx % nb;
    fac[idx] = c > r ? 0.f : smem[r * lds + c];
  }
}

// (b) at nb = 256 .. 512, one cluster: fac's top nb x nb = lower(upd_0)
// with zeros above, factored in place by wf_chol (slots: nb / 128 - 1
// tiles for the diagonal blocks' inverses).
__global__ void __launch_bounds__(WFC_THREADS)
chol_panel_factor_wide_kernel(const float* __restrict__ upd, int nb,
                              float* __restrict__ fac,
                              float* __restrict__ slots) {
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas(), q = nb / 4;
  // 16-byte moves (upd and fac are K2's own row-major scratch, nb % 128
  // == 0), zeros above the diagonal
#pragma unroll 4
  for (int idx = rank * blockDim.x + threadIdx.x; idx < nb * q;
       idx += ctas * blockDim.x) {
    const int r = idx / q, c = 4 * (idx % q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c <= r) {
      v = *reinterpret_cast<const float4*>(upd + r * nb + c);
      if (c + 1 > r) v.y = 0.f;
      if (c + 2 > r) v.z = 0.f;
      if (c + 3 > r) v.w = 0.f;
    }
    *reinterpret_cast<float4*>(fac + r * nb + c) = v;
  }
  wf_sync();
  wf_chol(fac, nb, nb, slots, smem);
}

// (c): fac rows NB + 128*blockIdx.x .. +128 = upd rows @ U^-1, by the solve
// body K3 shares (panel_gemm.cuh pg_solve_rows): upd is unit-stride along
// K with 16-byte aligned rows.
template <int NB>
__global__ void __launch_bounds__(PanelGemm<NB>::THREADS)
chol_panel_solve_kernel(const float* __restrict__ upd,
                        const float* __restrict__ uinv, int M,
                        float* __restrict__ fac) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = NB + (long long)blockIdx.x * PG_BM;
  const int rows = (int)min((long long)PG_BM, M - row0);
  pg_solve_rows<NB>(upd + row0 * NB, NB, 1, PG_COPY16, rows, uinv,
                    fac + row0 * NB, smem);
}

// The split *split of a launch over `tiles` output tiles, K deep: the S in
// 1..16 that minimises ceil(tiles / placed(S)) * ceil(slices / S),
// placed(S) the clusters of S CTAs of `kernel` (threads, smem bytes) that
// the card holds at once, every CTA at least PANEL_MIN_SLICES slices of
// PG_KC (ties to the smaller S); *slices = K slices per CTA. Opts the
// kernel into its shared memory and into clusters of more than 8.
template <class Kernel>
int choose_split(Kernel kernel, int device, int threads, size_t smem,
                 long long tiles, int K, int* split, int* slices) {
  SLATE_SET_SMEM(kernel, smem);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  const int total = (K + PG_KC - 1) / PG_KC;
  int best = 1;
  long long best_cost = -1;
  for (int s = 1; s <= PANEL_MAX_SPLIT; ++s) {
    if (s > 1 && total / s < PANEL_MIN_SLICES) break;
    int placed = 0;
    SLATE_RETURN_IF_ERROR(
        active_clusters(kernel, device, s, threads, (int)smem, &placed));
    if (placed == 0) continue;
    const long long cost =
        ((tiles + placed - 1) / placed) * ((total + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  *split = best;
  *slices = (total + best - 1) / best;
  return 0;
}

// The split of the narrow update for an [M, nb] panel K deep (its output
// tiles: the 128-row tiles).
template <int NB>
int prepare_update(int device, int M, int K, int* split, int* slices) {
  return choose_split(chol_panel_update_kernel<NB>, device,
                      PanelGemm<NB>::THREADS, update_smem_bytes<NB>(),
                      (M + PG_BM - 1) / PG_BM, K, split, slices);
}

// The split of the tensor-core update at nb = 256 .. 512 (its output tiles:
// 128 x 128; TC_BK == PG_KC, so a slice is the same depth).
static_assert(TC_BK == PG_KC, "the split counts 32-deep slices");
int prepare_update_tc(int device, int M, int K, int nb, int* split,
                      int* slices) {
  return choose_split(chol_panel_update_tc_kernel, device, TC_THREADS,
                      TC_SMEM_BYTES,
                      (long long)(nb / TC_TILE) * (M / TC_TILE), K, split,
                      slices);
}

template <int NB>
int launch_update(cudaStream_t stream, int device, const float* col,
                  long long cs0, long long cs1, const float* left,
                  long long ls0, long long ls1, const float* lead,
                  long long ds0, long long ds1, int K, int M, float* upd) {
  int split = 1, slices = 0;
  const int e = prepare_update<NB>(device, M, K, &split, &slices);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(split, (M + PG_BM - 1) / PG_BM);
  cfg.blockDim = dim3(PanelGemm<NB>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = update_smem_bytes<NB>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chol_panel_update_kernel<NB>, col, cs0, cs1, left, ls0, ls1,
      staged_by_copy(left, ls1, ls0), lead, ds0, ds1,
      staged_by_copy(lead, ds0, ds1), M, K, slices, upd);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Which operands of the tensor-core update TMA stages (bit 0 left, bit 1
// lead; the others take the producer's plain loads), with their maps.
int tc_staging(const float* left, long long ls0, long long ls1,
               const float* lead, long long ds0, long long ds1, int M, int K,
               int nb, CUtensorMap* left_map, CUtensorMap* lead_map) {
  int staging = 0;
  if (K > 0 && tc_tma_ok(left, ls1, ls0) &&
      tc_tensor_map(left_map, left, M, K, ls0)) {
    staging |= 1;
  }
  if (K > 0 && tc_tma_ok(lead, ds0, ds1) &&
      tc_tensor_map(lead_map, lead, nb, K, ds1)) {
    staging |= 2;
  }
  return staging;
}

int launch_update_tc(cudaStream_t stream, int device, const float* col,
                     long long cs0, long long cs1, const float* left,
                     long long ls0, long long ls1, const float* lead,
                     long long ds0, long long ds1, int K, int M, float* upd,
                     int nb) {
  int split = 1, slices = 0;
  const int e = prepare_update_tc(device, M, K, nb, &split, &slices);
  if (e != 0) return e;
  CUtensorMap left_map = {}, lead_map = {};
  const int staging = tc_staging(left, ls0, ls1, lead, ds0, ds1, M, K, nb,
                                 &left_map, &lead_map);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(split, nb / TC_TILE, M / TC_TILE);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TC_SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chol_panel_update_tc_kernel, left_map, lead_map, col, cs0, cs1,
      left, ls0, ls1, staging & 1, lead, ds0, ds1, (staging >> 1) & 1, K,
      slices, upd, nb);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

template <int NB>
int launch_solve(cudaStream_t stream, const float* upd, const float* uinv,
                 int M, float* fac) {
  constexpr size_t smem = sizeof(float) * PanelGemm<NB>::SMEM_FLOATS;
  SLATE_SET_SMEM(chol_panel_solve_kernel<NB>, smem);
  const int blocks = (M - NB + PG_BM - 1) / PG_BM;
  chol_panel_solve_kernel<NB><<<blocks, PanelGemm<NB>::THREADS, smem,
                                stream>>>(upd, uinv, M, fac);
  return static_cast<int>(cudaGetLastError());
}

// return fn<nb>(args...) for the narrow widths
#define SLATE_PANEL_NB(fn, ...)                              \
  switch (nb) {                                              \
    case 32: return fn<32>(__VA_ARGS__);                     \
    case 64: return fn<64>(__VA_ARGS__);                     \
    case 96: return fn<96>(__VA_ARGS__);                     \
    case 128: return fn<128>(__VA_ARGS__);                   \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

static bool panel_nb_ok(int nb) {
  return nb == 32 || nb == 64 || nb == 96 || nb == 128 || wf_panel_nb(nb);
}

// Launch (a): upd [M, nb] row-major; nb in {32, 64, 96, 128, 256, 384,
// 512}, M a multiple of nb.
extern "C" int slate_chol_panel_update(int device, void* stream,
                                       const float* col, long long cs0,
                                       long long cs1, const float* left,
                                       long long ls0, long long ls1,
                                       const float* lead, long long ds0,
                                       long long ds1, int K, int nb, int M,
                                       float* upd) {
  SLATE_SET_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wf_panel_nb(nb)) {
    return launch_update_tc(s, device, col, cs0, cs1, left, ls0, ls1, lead,
                            ds0, ds1, K, M, upd, nb);
  }
  SLATE_PANEL_NB(launch_update, s, device, col, cs0, cs1, left, ls0, ls1,
                 lead, ds0, ds1, K, M, upd)
}

// *fits = 1 when K2 takes a panel nb wide on this device: nb in {32, 64,
// 96, 128} (one block's factor), or 256, 384 or 512 where the card places
// the wide factor's cluster.
extern "C" int slate_chol_panel_fits(int device, int nb, int* fits) {
  SLATE_SET_DEVICE(device);
  *fits = panel_nb_ok(nb);
  if (*fits && nb > 128) {
    return wfc_fits(chol_panel_factor_wide_kernel, device, fits);
  }
  return 0;
}

// *floats = the scratch launch (b) takes at width nb (0 up to 128).
extern "C" int slate_chol_panel_work(int device, int nb, int* floats) {
  *floats = nb > 128 ? nb * WF_T : 0;
  return 0;
}

// Launch (b): rows 0 .. nb-1 of fac [M, nb] = chol of rows 0 .. nb-1 of upd;
// work holds slate_chol_panel_work(nb) floats (null up to 128).
extern "C" int slate_chol_panel_factor(int device, void* stream,
                                       const float* upd, int nb, float* fac,
                                       float* work) {
  SLATE_SET_DEVICE(device);
  if (wf_panel_nb(nb)) {
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return wfc_launch(chol_panel_factor_wide_kernel,
                      static_cast<cudaStream_t>(stream), device, 1, upd, nb,
                      fac, work);
  }
  if (nb != 32 && nb != 64 && nb != 96 && nb != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (nb * (nb + 4) + chol_factor_scratch(FACTOR_THREADS));
  SLATE_SET_SMEM(chol_panel_factor_kernel, smem);
  chol_panel_factor_kernel<<<1, FACTOR_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(upd, nb,
                                                                  fac);
  return static_cast<int>(cudaGetLastError());
}

// Launch (c): fac rows nb .. M-1 = upd rows nb .. M-1 @ uinv, M > nb; uinv
// is U^-1 as K0 writes it, [nb, nb] row-major.
extern "C" int slate_chol_panel_solve(int device, void* stream,
                                      const float* upd, const float* uinv,
                                      int nb, int M, float* fac) {
  SLATE_SET_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wf_panel_nb(nb)) {
    return wf_launch_solve<PG_COPY16>(s, upd, nb, 1, M, nb, uinv, fac);
  }
  SLATE_PANEL_NB(launch_solve, s, upd, uinv, M, fac)
}

// What launch (a) takes for this panel on this device: *split = the CTAs
// of an output tile's cluster (the K split), *staging = 1 when left stages
// by copy (cp.async up to nb = 128, TMA past it), plus 2 when lead does
// (else each takes the plain loads), *route = 0 for the f32 product on the
// CUDA cores (nb <= 128), 1 for the 3xTF32 product on the tensor cores.
extern "C" int slate_chol_panel_plan(int device, int M, int K, int nb,
                                     const float* left, long long ls0,
                                     long long ls1, const float* lead,
                                     long long ds0, long long ds1,
                                     int* split, int* staging, int* route) {
  SLATE_SET_DEVICE(device);
  int slices = 0;
  *route = wf_panel_nb(nb) ? 1 : 0;
  if (*route) {
    CUtensorMap left_map = {}, lead_map = {};
    *staging = tc_staging(left, ls0, ls1, lead, ds0, ds1, M, K, nb,
                          &left_map, &lead_map);
    return prepare_update_tc(device, M, K, nb, split, &slices);
  }
  *staging = staged_by_copy(left, ls1, ls0) + 2 * staged_by_copy(lead, ds0,
                                                                 ds1);
  SLATE_PANEL_NB(prepare_update, device, M, K, split, &slices)
}
