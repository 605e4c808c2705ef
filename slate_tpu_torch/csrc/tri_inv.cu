// K0's launch: X = U^-1 of one upper-triangular f32 tile, n <= 512.
//
// The routine itself is in tri_inv.cuh (upper_tri_inv_doubling), with the
// note on what it replaces and what bounds it. On the Cholesky paths K2's
// wrapper launches this between its launches, on U = L00^T (a transposed
// view: U is read through two strides); K3 and K7 form U^-1 inside their
// own factor launch (lu_factor.cuh). One block of 1024 threads copies U
// into shared memory, padded to np, the next multiple of 8, with the
// identity (entries below the diagonal read as 0), inverts it there by
// blocked recursive doubling and writes the n x n X row-major: ten
// barriers, no dependent chain longer than 2 np FMAs. The copy walks U's
// unit-stride index and keeps TRI_LOADS loads of a thread in flight, since
// one block's round trips to memory, not its FMAs, are what a tile this
// small waits on.
//
// Past n = 128 (K2's wrapper launches K0 on its 256-512 wide U) the three
// tiles no longer fit one block: the wide route (wide_factor.cuh
// wf_tri_inv) copies U, padded to np, the next multiple of 128, with the
// identity, into a device-memory workspace, and one thread-block cluster
// inverts its 128 x 128 diagonal blocks at once by the same doubling and
// joins them by tiled products, in one launch.
#include "common.cuh"
#include "tri_inv.cuh"
#include "wide_factor.cuh"

constexpr int TRI_THREADS = 1024;
constexpr int TRI_LOADS = 16;  // np^2 / TRI_THREADS at np = 128

__global__ void __launch_bounds__(TRI_THREADS)
upper_tri_inv_kernel(const float* __restrict__ u, long long us0, long long us1,
                     float* __restrict__ x, int n, int np) {
  extern __shared__ __align__(16) float smem[];
  const int ld = np + 1, ldx = np + 4, ldt = np / 2 + 4;
  float* U = smem;
  float* X = U + np * ld;  // np * ld is a multiple of 8
  float* T = X + np * ldx;
  // element e of the copy is U(r, c) with the unit-stride index fastest
  const bool by_rows = us1 == 1 || us0 != 1;
  for (int e0 = 0; e0 < np * np; e0 += TRI_THREADS * TRI_LOADS) {
    float v[TRI_LOADS];
#pragma unroll
    for (int t = 0; t < TRI_LOADS; ++t) {
      const int e = e0 + t * TRI_THREADS + threadIdx.x;
      const int r = by_rows ? e / np : e % np, c = by_rows ? e % np : e / np;
      v[t] = (r == c) ? 1.f : 0.f;
      if (e < np * np && r < n && c < n && c >= r) v[t] = u[r * us0 + c * us1];
    }
#pragma unroll
    for (int t = 0; t < TRI_LOADS; ++t) {
      const int e = e0 + t * TRI_THREADS + threadIdx.x;
      const int r = by_rows ? e / np : e % np, c = by_rows ? e % np : e / np;
      if (e < np * np) U[r * ld + c] = v[t];
    }
  }
  __syncthreads();
  upper_tri_inv_doubling(U, ld, X, ldx, T, ldt, np);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    x[idx] = X[(idx / n) * ldx + idx % n];
  }
}

// The wide route, one cluster: work = [U, T, X], each np x np row-major;
// U = the upper triangle of u padded with the identity, X = U^-1 by
// wf_tri_inv, then x (n x n) = X's top left corner.
__global__ void __launch_bounds__(WF_THREADS)
upper_tri_inv_wide_kernel(const float* __restrict__ u, long long us0,
                          long long us1, float* __restrict__ x, int n,
                          int np, float* __restrict__ work) {
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas();
  const long long stride = (long long)ctas * blockDim.x, nn = (long long)np * np;
  float* uw = work;
  float* tw = work + nn;
  float* xw = work + 2 * nn;
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x; idx < nn;
       idx += stride) {
    const int r = (int)(idx / np), c = (int)(idx % np);
    float v = r == c ? 1.f : 0.f;
    if (r < n && c < n && c >= r) v = u[r * us0 + c * us1];
    uw[idx] = v;
  }
  wf_sync();
  wf_tri_inv(uw, xw, tw, np, np, smem);
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x;
       idx < (long long)n * n; idx += stride) {
    x[idx] = __ldcg(xw + (idx / n) * np + idx % n);
  }
}

// *floats = the workspace of the wide route for an n x n U (0 at n <= 128).
extern "C" int slate_upper_tri_inv_work(int device, int n, int* floats) {
  const int np = (n + WF_T - 1) / WF_T * WF_T;
  *floats = n <= 128 ? 0 : 3 * np * np;
  return 0;
}

// *fits = 1 when K0 takes an n x n U on this device: 1 <= n <= 128 (one
// block), or n <= 512 where the card places the wide route's cluster.
extern "C" int slate_upper_tri_inv_fits(int device, int n, int* fits) {
  SLATE_SET_DEVICE(device);
  *fits = n >= 1 && n <= WF_MAX_PANEL;
  if (*fits && n > 128) {
    return wf_fits(upper_tri_inv_wide_kernel, device, fits);
  }
  return 0;
}

// One launch for one n x n U, within slate_upper_tri_inv_fits; work holds
// slate_upper_tri_inv_work(n) floats (null at n <= 128).
extern "C" int slate_upper_tri_inv(int device, void* stream, const float* u,
                                   long long us0, long long us1, float* x,
                                   int n, float* work) {
  SLATE_SET_DEVICE(device);
  if (n > 128) {
    if (n > WF_MAX_PANEL || work == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return wf_launch(upper_tri_inv_wide_kernel,
                     static_cast<cudaStream_t>(stream), u, us0, us1, x, n,
                     (n + WF_T - 1) / WF_T * WF_T, work);
  }
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int np = (n + TRI_DIAG - 1) / TRI_DIAG * TRI_DIAG;
  const size_t smem = sizeof(float) * (size_t)np *
                      ((np + 1) + (np + 4) + (np / 2 + 4));
  SLATE_SET_SMEM(upper_tri_inv_kernel, smem);
  upper_tri_inv_kernel<<<1, TRI_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(u, us0, us1, x,
                                                              n, np);
  return static_cast<int>(cudaGetLastError());
}
