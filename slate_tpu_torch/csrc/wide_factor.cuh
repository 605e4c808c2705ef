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
// thread-block cluster of WF_CLUSTER CTAs factors it by 128-column diagonal
// blocks, the CTAs meeting at a cluster barrier between the steps:
//   - the diagonal block: one CTA copies it into its shared memory and
//     factors it there by the one-block routine of the narrow kernels
//     (chol_factor.cuh, lu_factor.cuh), then inverts its triangular factor
//     by K0's blocked doubling (tri_inv.cuh) into a 128 x 128 slot of
//     device memory, one slot a step, so that no slot is written twice;
//   - the blocks below (and, for LU, to the right): every CTA takes whole
//     128 x 128 output tiles in turn and forms each as one tiled product
//     against the inverse (panel_gemm.cuh: a 16 x 8 register tile a
//     thread, the three-deep staging ring);
//   - the trailing update: every CTA takes whole output tiles in turn,
//     A22 -= L21 L21^T (lower tiles only) or A22 -= L21 U12, the same
//     tiled product.
// Each output tile is one CTA's, summed over k in ascending order, with no
// atomics: a launch repeats bit for bit whatever CTA takes which tile. All
// products are f32 FMAs on the CUDA cores (never TF32).
//
// U^-1 of a wide upper-triangular U (K0 past 128, K3's factor launch) is
// the same doubling one level up: the 128 x 128 diagonal blocks inverted
// at once, one CTA each, then neighbouring inverted blocks joined,
// b = 1, 2, ... tiles: T = U12 X22 for every pair at once, a cluster
// barrier, X12 = -X11 T, a barrier (LAPACK trtri's recursion, as in
// tri_inv.cuh).
//
// Bound on this card: at n = 1024 the Cholesky is n^3 / 3 = 0.36 GFLOP
// against 8 MB moved, bound by f32 operations (5.4 us at 67 TFLOP/s); what
// holds one cluster back is its WF_CLUSTER SMs out of 132 and the chain of
// n / 128 diagonal factors, each on one CTA while the others wait. The
// design takes that for simplicity: the wide widths run where the library
// ran before, and their times are in PERF.md.
//
// Every write of one CTA that another reads later is ordered by wf_sync:
// a device-scope fence, the cluster barrier (release and acquire at cluster
// scope), and a fence on the reading side. The diagonal tile and the
// trailing tiles that a CTA reads and writes back go through L2 (__ldcg).
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

// The lower Cholesky factor of the SPD np x np workspace w (row-major,
// leading dimension ld, 16-byte aligned rows; np a multiple of WF_T; only
// its lower tiles are read), in place: on return w's lower tiles hold L,
// each diagonal tile with zeros above its diagonal, and the tiles above
// the diagonal are as they were. uinv: (np / WF_T - 1) slots of WF_T x
// WF_T floats. Every thread of the cluster calls it, after a wf_sync that
// completes w; it ends with a wf_sync. A negative pivot gives NaN on its
// diagonal entry and NaN in every later column, as chol_factor_smem does.
__device__ inline void wf_chol(float* w, long long ld, int np, float* uinv,
                               float* smem) {
  const int rank = wf_rank(), ctas = wf_ctas(), nt = np / WF_T;
  int tx, ty;
  pg_thread<WF_T>(tx, ty);
  for (int j = 0; j < nt; ++j) {
    float* wjj = w + (long long)j * WF_T * ld + j * WF_T;
    float* slot = uinv + (long long)j * WF_T * WF_T;
    if (rank == 0) {
      wf_load_tile(smem, wjj, ld);
      __syncthreads();
      chol_factor_smem(smem, WF_LDS, WF_T, smem + 2 * WF_T * WF_LDS +
                                               WF_T * WF_LDT);
      wf_store_tile(wjj, ld, smem, WF_LDS, true);
      if (j + 1 < nt) {
        __syncthreads();  // the store has read the tile
        // U = L^T in the upper triangle, for the doubling
        for (int idx = threadIdx.x; idx < WF_T * WF_T; idx += blockDim.x) {
          const int r = idx / WF_T, c = idx % WF_T;
          if (c > r) smem[r * WF_LDS + c] = smem[c * WF_LDS + r];
        }
        __syncthreads();
        wf_invert_tile(smem, slot, WF_T, smem);
      }
    }
    wf_sync();
    if (j + 1 == nt) break;
    // the tiles below: L21 = A21 U^-1, in place
    for (int i = j + 1 + rank; i < nt; i += ctas) {
      float* wij = w + (long long)i * WF_T * ld + j * WF_T;
      float acc[PG_RM][8] = {};
      pg_upper_product<WF_T>(acc, wij, ld, 1, WF_T, PG_COPY16, slot, WF_T,
                             smem, tx, ty);
      wf_store_acc(wij, ld, acc, 1.f, false, tx, ty);
    }
    wf_sync();
    // the trailing lower tiles (i, k), j < k <= i: A_ik -= L_ij L_kj^T
    const int m = nt - j - 1;
    for (int p = rank; p < m * (m + 1) / 2; p += ctas) {
      int ii = 0;
      while ((ii + 1) * (ii + 2) / 2 <= p) ++ii;
      const int i = j + 1 + ii, k = j + 1 + p - ii * (ii + 1) / 2;
      float acc[PG_RM][8] = {};
      pg_product<WF_T>(acc, w + (long long)i * WF_T * ld, ld, 1, WF_T,
                       PG_COPY16, w + (long long)k * WF_T * ld, 1, ld,
                       PG_COPY16, j * WF_T, (j + 1) * WF_T, smem, tx, ty);
      wf_store_acc(w + (long long)i * WF_T * ld + k * WF_T, ld, acc, 1.f,
                   true, tx, ty);
    }
    wf_sync();
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

// A wide panel width: 256, 384 or 512.
__host__ __device__ inline bool wf_panel_nb(int nb) {
  return nb > WF_T && nb <= WF_MAX_PANEL && nb % WF_T == 0;
}
