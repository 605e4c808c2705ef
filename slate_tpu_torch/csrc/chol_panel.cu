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
//   (a) takes the panel in 128-column tiles, a third grid dimension: each
//       (row tile, column tile) is the nb = 128 update above, written into
//       its columns of upd;
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
// f32 operations: the reference asks for Precision.HIGHEST, so never TF32,
// and wgmma takes no f32 operands, so every product is an FFMA on the CUDA
// cores, at most 67 TFLOP/s. The design aims the update at that ceiling:
// 128 x nb tiles a CTA, a 16 x 8 register tile a thread, a three-deep
// cp.async ring, and the split filling the card when row tiles are few.
#include <cooperative_groups.h>

#include <cstdint>

#include "chol_factor.cuh"
#include "common.cuh"
#include "panel_gemm.cuh"
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

// (a): upd for the 128-row tile blockIdx.y, K split over the cluster; its
// columns NB blockIdx.z .. + NB of a panel ldo wide (ldo == NB but at the
// wide widths, where NB = 128).
template <int NB>
__global__ void __launch_bounds__(PanelGemm<NB>::THREADS, 2)
chol_panel_update_kernel(const float* __restrict__ col, long long cs0,
                         long long cs1, const float* __restrict__ left,
                         long long ls0, long long ls1, int fast_left,
                         const float* __restrict__ lead, long long ds0,
                         long long ds1, int fast_lead, int M, int K,
                         int slices, float* __restrict__ upd, int ldo) {
  using G = PanelGemm<NB>;
  extern __shared__ __align__(16) float smem[];
  const long long c0 = (long long)blockIdx.z * NB;
  col += c0 * cs1;
  lead += c0 * ds1;
  upd += c0;
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
        upd[(row0 + r) * ldo + c] =
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
      *reinterpret_cast<float4*>(upd + (row0 + r) * ldo + c) = out;
    });
  }
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

// Opt the update kernel into its shared memory and into clusters of more
// than 8, and choose the split *split for an [M, nb] panel K deep: the S
// in 1..16 that minimises ceil(R / placed(S)) * ceil(slices / S), R the
// output tiles (the row tiles times a wide panel's ctiles column tiles),
// placed(S) the clusters of S CTAs the card holds at once, every
// CTA at least PANEL_MIN_SLICES slices (ties to the smaller S). *slices =
// K slices per CTA.
template <int NB>
int prepare_update(int device, int M, int K, int ctiles, int* split,
                   int* slices) {
  auto kernel = chol_panel_update_kernel<NB>;
  constexpr size_t smem = update_smem_bytes<NB>();
  constexpr int threads = PanelGemm<NB>::THREADS;
  SLATE_SET_SMEM(kernel, smem);
  SLATE_RETURN_IF_ERROR(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  const long long tiles = (long long)ctiles * ((M + PG_BM - 1) / PG_BM);
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

template <int NB>
int launch_update(cudaStream_t stream, int device, const float* col,
                  long long cs0, long long cs1, const float* left,
                  long long ls0, long long ls1, const float* lead,
                  long long ds0, long long ds1, int K, int M, float* upd,
                  int nb) {
  int split = 1, slices = 0;
  const int e = prepare_update<NB>(device, M, K, nb / NB, &split, &slices);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(split, (M + PG_BM - 1) / PG_BM, nb / NB);
  cfg.blockDim = dim3(PanelGemm<NB>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = update_smem_bytes<NB>();
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, chol_panel_update_kernel<NB>, col, cs0, cs1, left, ls0, ls1,
      staged_by_copy(left, ls1, ls0), lead, ds0, ds1,
      staged_by_copy(lead, ds0, ds1), M, K, slices, upd, nb);
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

// return fn<nb>(args...) for the instantiated widths, fn<128> for the wide
// ones
#define SLATE_PANEL_NB(fn, ...)                              \
  switch (nb) {                                              \
    case 32: return fn<32>(__VA_ARGS__);                     \
    case 64: return fn<64>(__VA_ARGS__);                     \
    case 96: return fn<96>(__VA_ARGS__);                     \
    case 128: return fn<128>(__VA_ARGS__);                   \
    case 256:                                                \
    case 384:                                                \
    case 512: return fn<128>(__VA_ARGS__);                   \
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
  SLATE_PANEL_NB(launch_update, s, device, col, cs0, cs1, left, ls0, ls1,
                 lead, ds0, ds1, K, M, upd, nb)
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
// of a row tile's cluster (the K split), *staging = 1 when left stages by
// cp.async, plus 2 when lead does (else each takes the plain loads).
extern "C" int slate_chol_panel_plan(int device, int M, int K, int nb,
                                     const float* left, long long ls0,
                                     long long ls1, const float* lead,
                                     long long ds0, long long ds1,
                                     int* split, int* staging) {
  SLATE_SET_DEVICE(device);
  int slices = 0;
  *staging = staged_by_copy(left, ls1, ls0) + 2 * staged_by_copy(lead, ds0,
                                                                 ds1);
  SLATE_PANEL_NB(prepare_update, device, M, K, nb > 128 ? nb / 128 : 1,
                 split, &slices)
}
