// K7: the ragged batched fused no-pivot LU panel step, the port of
// lu_panel_batched (slate_tpu/internal/pallas_lu.py:282, pallas_call at
// :308, kernel _lu_panel_batched_kernel at :228): K3's step (lu_panel.cu)
// over a batch of problems, each computing only its own live row tiles.
//
// The step's contract, its update launch (a) and solve launch (c) are
// batched_step.cuh's, shared with K6 (chol_panel_batched.cu); lead is the
// packed U block column A[:, :k0, k0:k0+nb] and fac is packed L\U with the
// unit lower diagonal implied. This file holds K7's factor launch (b): one
// block of 256 threads per problem whose tile 0 is live runs K3's factor
// launch body (lu_factor.cuh lu_factor_launch), the no-pivot LU of tile 0
// of work by 32-column blocks, a warp a diagonal block, into fac, then,
// when M > nb, U^-1 = triu(tile)^-1 by K0's blocked doubling into uinv. A
// step is three launches when M > nb and two when M == nb.
//
// At nb = 256, 384 and 512 (batched_step.cuh) the factor launch is one
// thread-block cluster a problem: tile 0 of work copied into the problem's
// scratch, factored there by K3's wide route (wide_factor.cuh wf_lu, the
// zero-pivot rule at slab width bw inside each 128-column diagonal block,
// so bw divides 128), packed L\U into fac; then, in a second launch of the
// same step's factor call, U^-1 of each live problem's packed L\U by K0's
// wide route (tri_inv_wide.cuh: a cluster a problem) into uinv.
//
// Bound on this card: per live problem, 2 live_m K nb flops of the update,
// 2 nb^3/3 of the tile's LU and (live_m - nb) nb^2 of L21 = A21 U^-1 as a
// triangular solve, against the live tiles' bytes read and written once. With
// K >= nb it is bound by f32 operations (FFMA, never TF32): 67 TFLOP/s.
//
// Design: K6's, the update over every (128-row tile, problem) with the K
// loop split over a cluster of S CTAs, S from K and the card alone, so a
// problem's bits do not depend on its batch; the first version ran the
// diagonal tile's whole K loop on one block a problem.
#include "batched_step.cuh"
#include "common.cuh"
#include "lu_factor.cuh"
#include "tri_inv_wide.cuh"

__global__ void __launch_bounds__(BPG::THREADS, 2)
lu_panel_batched_update(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_update(a, smem);
}

// (b): tile 0 of problem blockIdx.x factored into fac, U^-1 = triu(tile)^-1
// into uinv, by the factor launch's body K3 runs (lu_factor.cuh).
__global__ void __launch_bounds__(LF_THREADS)
lu_panel_batched_factor(Step a) {
  const int b = blockIdx.x;
  if (a.k >= a.tiles[b]) return;  // tile 0 dead: launch (a) copied it
  extern __shared__ __align__(16) float smem[];
  const long long out0 = (long long)b * a.M * a.nb;
  const float* w = a.work + out0;
  lu_factor_launch(
      a.nb, a.bw,
      [&](int r, int c) {
        return *reinterpret_cast<const float4*>(w + r * a.nb + c);
      },
      [&](int r, int c, float4 v) {
        const long long o = out0 + r * a.nb + c;
        store_f32(a.fac, o, v.x, a.bf16);
        store_f32(a.fac, o + 1, v.y, a.bf16);
        store_f32(a.fac, o + 2, v.z, a.bf16);
        store_f32(a.fac, o + 3, v.w, a.bf16);
      },
      a.uinv == nullptr ? nullptr : a.uinv + (long long)b * a.nb * a.nb,
      smem);
}

// (b) at nb = 256 .. 512: one cluster a problem (blockIdx.y), tile 0 of
// work factored by wf_lu in the problem's scratch and stored into fac; U^-1
// follows in launch_factor's second launch.
__global__ void __launch_bounds__(WFC_THREADS)
lu_panel_batched_factor_wide(Step a) {
  const int b = blockIdx.y, nb = a.nb;
  if (a.k >= a.tiles[b]) return;  // the whole cluster: tile 0 dead
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas();
  const WideScratch w = wide_scratch(a, b);
  const float* src = a.work + (long long)b * a.M * nb;
  // 16-byte moves (work and the scratch are row-major, nb % 4 == 0)
#pragma unroll 4
  for (int idx = rank * blockDim.x + threadIdx.x; idx < nb * nb / 4;
       idx += ctas * blockDim.x) {
    reinterpret_cast<float4*>(w.tile)[idx] =
        reinterpret_cast<const float4*>(src)[idx];
  }
  wf_lu(w.tile, nb, nb, a.bw, w.slots, smem);
  wide_store_tile(a, b, w.tile, false);
}

__global__ void __launch_bounds__(BPG::THREADS)
lu_panel_batched_solve(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_solve(a, smem);
}

__global__ void __launch_bounds__(BPG::THREADS)
lu_panel_batched_solve_wide(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_solve_wide(a, smem);
}

// (b); at nb > 128 the factor's clusters, then, when M > nb, U^-1 of each
// live problem's packed L\U by K0's wide route (a cluster a problem, the
// dead ones skipped) on the same stream: one launch of the step.
static int launch_factor(cudaStream_t stream, int device, int B,
                         const Step& a) {
  if (a.nb > BP_NB) {
    const int e =
        wfc_launch(lu_panel_batched_factor_wide, stream, device, B, a);
    if (e != 0 || a.uinv == nullptr) return e;
    const long long per = bp_wide_floats(a.nb);
    const WideScratch w0 = wide_scratch(a, 0);
    return ti_launch_wide(
        stream,
        ti_args_packed(w0.tile, a.nb, per, a.uinv, (long long)a.nb * a.nb,
                       w0.t, per, a.nb, a.tiles, a.k, nullptr),
        B);
  }
  const size_t smem = lu_factor_launch_bytes(a.nb);
  SLATE_SET_SMEM(lu_panel_batched_factor, smem);
  lu_panel_batched_factor<<<B, LF_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// *fits = 1 when a panel of width nb at slab width bw fits: bw divides nb
// (the slab rule of its zero pivots), and nb in {32, 64, 96, 128} (at most
// the 128 columns of a CTA's tile, whole 32-column blocks of the tile
// factor) with the factor launch's shared memory within one block's opt-in
// limit, or nb in {256, 384, 512} with bw dividing 128 (a slab inside one
// diagonal block) where the card places the wide factor's cluster; else 0.
extern "C" int slate_lu_panel_batched_fits(int device, int nb, int bw,
                                           int* fits) {
  SLATE_SET_DEVICE(device);
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = step_nb_ok(nb) && bw >= 1 && nb % bw == 0 &&
          (nb > BP_NB ? WF_T % bw == 0
                      : lu_factor_launch_bytes(nb) <= (size_t)limit);
  if (*fits && nb > BP_NB) {
    const int e = wfc_fits(lu_panel_batched_factor_wide, device, fits);
    if (e == 0 && *fits) {
      return cluster_fits(upper_tri_inv_wide_kernel, device, TI_CLUSTER,
                          TI_THREADS, TI_SMEM_BYTES, fits);
    }
    return e;
  }
  return 0;
}

// *cluster = the CTAs a problem's wide factor runs on when B problems are
// launched at once (wfc_cluster: 16 where the card places B clusters of 16,
// else 8).
extern "C" int slate_lu_panel_batched_cluster(int device, int B,
                                              int* cluster) {
  SLATE_SET_DEVICE(device);
  return wfc_cluster(lu_panel_batched_factor_wide, device, B, cluster);
}

// *floats = the wide factor's scratch of one problem at width nb (0 up to
// 128); the wrapper passes B times that.
extern "C" int slate_lu_panel_batched_work(int device, int nb, int* floats) {
  (void)device;
  *floats = (int)bp_wide_floats(nb);
  return 0;
}

// One launch of the step: which = 0 the update (a), 1 the factor (b), 2 the
// solve (c, M > nb). bf16 is 0 for f32 storage, 1 for bf16; strides in
// elements; bw the tile factor's slab width; work is upd on f32 storage;
// uinv is null when M == nb; wide holds B slate_lu_panel_batched_work
// floats (null up to nb = 128). Past the shape limits the launch is refused
// with an error code.
extern "C" int slate_lu_panel_batched(
    int device, void* stream, int which, int bf16, const void* col,
    long long cb, long long cs0, long long cs1, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, const int* tiles, int B, int k, int K, int M,
    int nb, int bw, void* upd, void* fac, float* work, float* uinv,
    float* wide) {
  SLATE_SET_DEVICE(device);
  if (!step_args_ok(which, B, M, nb, uinv, wide) || bw < 1 || nb % bw ||
      (nb > BP_NB && WF_T % bw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step a = make_step(bf16, col, cb, cs0, cs1, left, lb, ls0, ls1, lead,
                           db, ds0, ds1, tiles, k, K, M, nb, bw, upd, fac,
                           work, uinv, wide);
  switch (which) {
    case UPDATE: return launch_update(lu_panel_batched_update, device, s, B,
                                      a);
    case FACTOR: return launch_factor(s, device, B, a);
    default: return launch_solve(lu_panel_batched_solve,
                                 lu_panel_batched_solve_wide, s, B, a);
  }
}

// What the update launch takes for this step on this device
// (batched_step.cuh step_plan).
extern "C" int slate_lu_panel_batched_plan(
    int device, int bf16, int K, int nb, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, int* split, int* resident, int* staging) {
  return step_plan(lu_panel_batched_update, device, bf16, K, nb, left, lb,
                   ls0, ls1, lead, db, ds0, ds1, split, resident, staging);
}
