// K7: the ragged batched fused no-pivot LU panel step, the port of
// lu_panel_batched (slate_tpu/internal/pallas_lu.py:282, pallas_call at
// :308, kernel _lu_panel_batched_kernel at :228): K3's step (lu_panel.cu)
// over a batch of problems, each computing only its own live row tiles.
//
// The step's contract, its update launch (a) and solve launch (c) are
// batched_step.cuh's, shared with K6 (chol_panel_batched.cu); lead is the
// packed U block column A[:, :k0, k0:k0+nb] and fac is packed L\U with the
// unit lower diagonal implied. This file holds K7's factor launch (b): one
// block of 512 threads per problem whose tile 0 is live, the no-pivot LU of
// tile 0 of work by K3's slab loop (lu_factor_smem, lu_factor.cuh) into
// fac, then, when M > nb, U^-1 = triu(tile)^-1 by K0's blocked doubling
// (tri_inv.cuh) into uinv. A step is three launches when M > nb and two
// when M == nb.
//
// Bound on this card: per live problem, 2 live_m K nb flops of the update,
// 2 nb^3/3 of the tile's LU, nb^3/3 of U^-1 and 2 (live_m - nb) nb^2 of
// L21 = A21 U^-1, against the live tiles' bytes read and written once. With
// K >= nb it is bound by f32 operations (FFMA, never TF32): 67 TFLOP/s.
//
// Design: K6's, the update over every (128-row tile, problem) with the K
// loop split over a cluster of S CTAs, S from K and the card alone, so a
// problem's bits do not depend on its batch; the first version ran the
// diagonal tile's whole K loop on one block a problem.
#include "batched_step.cuh"
#include "common.cuh"
#include "lu_factor.cuh"
#include "tri_inv.cuh"

__global__ void __launch_bounds__(BPG::THREADS, 2)
lu_panel_batched_update(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_update(a, smem);
}

// Shared memory of the factor launch: the tile (its L\U, at the odd stride
// nb + 1), U^-1 (whose space holds lu_factor_smem's scratch until then) and
// the doubling's scratch.
__host__ __device__ inline size_t factor_smem_bytes(int nb) {
  return sizeof(float) * ((size_t)nb * (nb + 1) + (size_t)nb * (nb + 4) +
                          (size_t)nb * (nb / 2 + 4));
}

// (b): tile 0 of problem blockIdx.x factored into fac, U^-1 = triu(tile)^-1
// into uinv.
__global__ void __launch_bounds__(BP_FACTOR_THREADS)
lu_panel_batched_factor(Step a) {
  const int b = blockIdx.x, nb = a.nb, bw = a.bw;
  const int lds = nb + 1, ldx = nb + 4, q = nb / 4;
  if (a.k >= a.tiles[b]) return;  // tile 0 dead: launch (a) copied it
  extern __shared__ __align__(16) float smem[];
  float* S = smem;            // nb x lds: tile 0, then its packed L\U
  float* X = S + nb * lds;    // nb x ldx: U^-1 (nb lds is a multiple of 4)
  float* Tt = X + nb * ldx;   // nb x (nb/2 + 4): the doubling's scratch
  const long long out0 = (long long)b * a.M * nb;
  const float* w = a.work + out0;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * nb; idx += BP_FACTOR_THREADS) {
    S[(idx / nb) * lds + idx % nb] = w[idx];
  }
  __syncthreads();
  // the slab's D^-1 and l21 in X, free until U^-1; ends with a barrier
  lu_factor_smem(S, lds, nb, bw, X, X + bw * (bw + 1));
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * nb; idx += BP_FACTOR_THREADS) {
    store_f32(a.fac, out0 + idx, S[(idx / nb) * lds + idx % nb], a.bf16);
  }
  if (a.uinv == nullptr) return;
  // U = triu(S): the doubling never reads below the diagonal
  upper_tri_inv_doubling(S, lds, X, ldx, Tt, nb / 2 + 4, nb);
  float* uinv = a.uinv + (long long)b * nb * nb;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += BP_FACTOR_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    *reinterpret_cast<float4*>(uinv + r * nb + c) =
        *reinterpret_cast<const float4*>(X + r * ldx + c);
  }
}

__global__ void __launch_bounds__(BPG::THREADS)
lu_panel_batched_solve(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_solve(a, smem);
}

static int launch_factor(cudaStream_t stream, int B, const Step& a) {
  const size_t smem = factor_smem_bytes(a.nb);
  SLATE_SET_SMEM(lu_panel_batched_factor, smem);
  lu_panel_batched_factor<<<B, BP_FACTOR_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// *fits = 1 when a panel of width nb at slab width bw fits: nb in {32, 64,
// 96, 128} (at most the 128 columns of a CTA's tile), bw divides nb (the
// tile factor's slabs), and the factor launch's shared memory within one
// block's opt-in limit; else 0.
extern "C" int slate_lu_panel_batched_fits(int device, int nb, int bw,
                                           int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = step_nb_ok(nb) && bw >= 1 && nb % bw == 0 &&
          factor_smem_bytes(nb) <= (size_t)limit;
  return 0;
}

// One launch of the step: which = 0 the update (a), 1 the factor (b), 2 the
// solve (c, M > nb). bf16 is 0 for f32 storage, 1 for bf16; strides in
// elements; bw the tile factor's slab width; work is upd on f32 storage;
// uinv is null when M == nb. Past the shape limits the launch is refused
// with an error code.
extern "C" int slate_lu_panel_batched(
    int device, void* stream, int which, int bf16, const void* col,
    long long cb, long long cs0, long long cs1, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, const int* tiles, int B, int k, int K, int M,
    int nb, int bw, void* upd, void* fac, float* work, float* uinv) {
  SLATE_SET_DEVICE(device);
  if (!step_args_ok(which, B, M, nb, uinv) || bw < 1 || nb % bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step a = make_step(bf16, col, cb, cs0, cs1, left, lb, ls0, ls1, lead,
                           db, ds0, ds1, tiles, k, K, M, nb, bw, upd, fac,
                           work, uinv);
  switch (which) {
    case UPDATE: return launch_update(lu_panel_batched_update, device, s, B,
                                      a);
    case FACTOR: return launch_factor(s, B, a);
    default: return launch_solve(lu_panel_batched_solve, s, B, a);
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
