// K6: the ragged batched fused Cholesky panel step, the port of
// chol_panel_batched (slate_tpu/internal/pallas_chol.py:257, pallas_call at
// :286, kernel _chol_panel_batched_kernel at :197): K2's step (chol_panel.cu)
// over a batch of problems, each computing only its own live row tiles.
//
// The step's contract, its update launch (a) and solve launch (c) are
// batched_step.cuh's, shared with K7 (lu_panel_batched.cu); lead is
// A[:, k0:k0+nb, :k0]^T and fac's tile 0 is L00, zero above its diagonal.
// This file holds K6's factor launch (b): one block of 512 threads per
// problem whose tile 0 is live, L00 by K1's blocked factor (chol_factor.cuh)
// into fac, then, when M > nb, U^-1 = (L00^T)^-1 by K0's blocked doubling
// (tri_inv.cuh) into uinv.
//
// At nb = 256, 384 and 512 (batched_step.cuh) the factor launch is one
// thread-block cluster a problem: tile 0 of work copied (its lower
// triangle) into the problem's scratch, factored there by K1's wide route
// (wide_factor.cuh wf_chol), L00 into fac, U = L00^T mirrored into the
// scratch and U^-1 by wf_tri_inv into uinv.
//
// Bound on this card: per live problem, 2 live_m K nb flops of the update,
// nb^3/3 of the factor, nb^3/3 of U^-1 and 2 (live_m - nb) nb^2 of the
// solve, against the bytes of the live rows of col, left and lead read once
// and of upd and fac written once (dead rows: a copy). With K >= nb it is
// bound by f32 operations, FFMA on the CUDA cores (the reference asks for
// Precision.HIGHEST, so never TF32): at most 67 TFLOP/s.
#include "batched_step.cuh"
#include "chol_factor.cuh"
#include "common.cuh"
#include "tri_inv.cuh"

__global__ void __launch_bounds__(BPG::THREADS, 2)
chol_panel_batched_update(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_update(a, smem);
}

// Shared memory of the factor launch: L (and U above its diagonal), U^-1
// and the doubling's scratch.
__host__ __device__ inline size_t factor_smem_bytes(int nb) {
  return sizeof(float) *
         (2 * (size_t)nb * (nb + 4) + (size_t)nb * (nb / 2 + 4));
}

// (b): L00 of problem blockIdx.x into fac, U^-1 = (L00^T)^-1 into uinv.
__global__ void __launch_bounds__(BP_FACTOR_THREADS)
chol_panel_batched_factor(Step a) {
  const int b = blockIdx.x, nb = a.nb, lds = nb + 4, q = nb / 4;
  if (a.k >= a.tiles[b]) return;  // tile 0 dead: launch (a) copied it
  extern __shared__ __align__(16) float smem[];
  float* L = smem;                // nb x lds
  float* X = L + nb * lds;        // nb x lds: U^-1
  float* Tt = X + nb * lds;       // nb x (nb/2 + 4): the doubling's scratch
  const long long out0 = (long long)b * a.M * nb;
  const float* w = a.work + out0;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += BP_FACTOR_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    *reinterpret_cast<float4*>(L + r * lds + c) =
        *reinterpret_cast<const float4*>(w + r * nb + c);
  }
  __syncthreads();
  chol_factor_smem(L, lds, nb, X);  // X is free until U^-1
  // fac = L with zeros above; U = L^T mirrored into L's upper triangle
  // (every read below the diagonal, every write to L above it: no race)
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * nb; idx += BP_FACTOR_THREADS) {
    const int r = idx / nb, c = idx % nb;
    float v = 0.f;
    if (c <= r) v = L[r * lds + c];
    store_f32(a.fac, out0 + idx, v, a.bf16);
    if (c > r) L[r * lds + c] = L[c * lds + r];
  }
  if (a.uinv == nullptr) return;
  __syncthreads();
  upper_tri_inv_doubling(L, lds, X, lds, Tt, nb / 2 + 4, nb);
  float* uinv = a.uinv + (long long)b * nb * nb;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < nb * q; idx += BP_FACTOR_THREADS) {
    const int r = idx / q, c = 4 * (idx % q);
    *reinterpret_cast<float4*>(uinv + r * nb + c) =
        *reinterpret_cast<const float4*>(X + r * lds + c);
  }
}

// (b) at nb = 256 .. 512: one cluster a problem (blockIdx.y), as above;
// the diagonal blocks' inverses that wf_chol forms (the last one too, when
// there are rows below) start wfc_tri_inv's doubling.
__global__ void __launch_bounds__(WFC_THREADS)
chol_panel_batched_factor_wide(Step a) {
  const int b = blockIdx.y, nb = a.nb;
  if (a.k >= a.tiles[b]) return;  // the whole cluster: tile 0 dead
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas();
  const WideScratch w = wide_scratch(a, b);
  const float* src = a.work + (long long)b * a.M * nb;
  for (int idx = rank * blockDim.x + threadIdx.x; idx < nb * nb;
       idx += ctas * blockDim.x) {
    w.tile[idx] = idx % nb > idx / nb ? 0.f : src[idx];
  }
  wf_sync();
  wf_chol(w.tile, nb, nb, w.slots, smem, a.uinv != nullptr);
  wide_store_tile(a, b, w.tile, true);
  if (a.uinv == nullptr) return;
  wf_sync();
  wfc_tri_inv(w.tile, a.uinv + (long long)b * nb * nb, w.t, nb, nb, w.slots,
              smem);
}

__global__ void __launch_bounds__(BPG::THREADS)
chol_panel_batched_solve(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_solve(a, smem);
}

__global__ void __launch_bounds__(BPG::THREADS)
chol_panel_batched_solve_wide(Step a) {
  extern __shared__ __align__(16) float smem[];
  batched_solve_wide(a, smem);
}

static int launch_factor(cudaStream_t stream, int device, int B,
                         const Step& a) {
  if (a.nb > BP_NB) {
    return wfc_launch(chol_panel_batched_factor_wide, stream, device, B, a);
  }
  const size_t smem = factor_smem_bytes(a.nb);
  SLATE_SET_SMEM(chol_panel_batched_factor, smem);
  chol_panel_batched_factor<<<B, BP_FACTOR_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// *fits = 1 when a panel of width nb at slab width bw fits: bw divides nb
// (the plain version's slabs), and nb in {32, 64, 96, 128} (at most the 128
// columns of a CTA's tile, whole 32-column blocks of the factor) with the
// factor launch's shared memory within one block's opt-in limit, or nb in
// {256, 384, 512} where the card places the wide factor's cluster; else 0.
extern "C" int slate_chol_panel_batched_fits(int device, int nb, int bw,
                                             int* fits) {
  SLATE_SET_DEVICE(device);
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = step_nb_ok(nb) && bw >= 1 && nb % bw == 0 &&
          (nb > BP_NB || factor_smem_bytes(nb) <= (size_t)limit);
  if (*fits && nb > BP_NB) {
    return wfc_fits(chol_panel_batched_factor_wide, device, fits);
  }
  return 0;
}

// *floats = the wide factor's scratch of one problem at width nb (0 up to
// 128); the wrapper passes B times that.
extern "C" int slate_chol_panel_batched_work(int device, int nb,
                                             int* floats) {
  (void)device;
  *floats = (int)bp_wide_floats(nb);
  return 0;
}

// One launch of the step: which = 0 the update (a), 1 the factor (b), 2 the
// solve (c, M > nb). bf16 is 0 for f32 storage, 1 for bf16; strides in
// elements; bw is K7's and unused here; work is upd on f32 storage; uinv is
// null when M == nb; wide holds B slate_chol_panel_batched_work floats (null
// up to nb = 128). Past the shape limits the launch is refused with an
// error code.
extern "C" int slate_chol_panel_batched(
    int device, void* stream, int which, int bf16, const void* col,
    long long cb, long long cs0, long long cs1, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, const int* tiles, int B, int k, int K, int M,
    int nb, int bw, void* upd, void* fac, float* work, float* uinv,
    float* wide) {
  SLATE_SET_DEVICE(device);
  if (!step_args_ok(which, B, M, nb, uinv, wide)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Step a = make_step(bf16, col, cb, cs0, cs1, left, lb, ls0, ls1, lead,
                           db, ds0, ds1, tiles, k, K, M, nb, bw, upd, fac,
                           work, uinv, wide);
  switch (which) {
    case UPDATE: return launch_update(chol_panel_batched_update, device, s, B,
                                      a);
    case FACTOR: return launch_factor(s, device, B, a);
    default: return launch_solve(chol_panel_batched_solve,
                                 chol_panel_batched_solve_wide, s, B, a);
  }
}

// What the update launch takes for this step on this device
// (batched_step.cuh step_plan).
extern "C" int slate_chol_panel_batched_plan(
    int device, int bf16, int K, int nb, const void* left, long long lb,
    long long ls0, long long ls1, const void* lead, long long db,
    long long ds0, long long ds1, int* split, int* resident, int* staging) {
  return step_plan(chol_panel_batched_update, device, bf16, K, nb, left, lb,
                   ls0, ls1, lead, db, ds0, ds1, split, resident, staging);
}
