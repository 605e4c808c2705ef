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
// Past n = 128 (K2's wrapper launches K0 on its 256-512 wide U; K3's and
// K7's factor calls launch the same kernel on their packed L\U, a problem
// a cluster) the three tiles no longer fit one block. The wide route
// (tri_inv_wide.cuh) is one thread-block cluster of TI_CLUSTER CTAs of
// TI_THREADS = 1024 threads a problem, in one launch:
//   - the diagonal blocks: CTA d < np / 128 reads U's 128 x 128 diagonal
//     block d straight from u through its strides (the copy above: the
//     unit-stride index, TRI_LOADS loads a thread in flight, the identity
//     past n), inverts it in its shared memory by the same doubling at the
//     same thread count as the one-block kernel, keeps X_dd there and
//     stores it to x;
//   - the joins, LAPACK trtri's recursion one level up (b = 1, 2 tiles):
//     T = U12 X22 for every pair of neighbouring inverted blocks at once,
//     then X12 = -X11 T. Each half-level's output tiles are cut into
//     32-row strips spread over every CTA of the cluster; a strip stages
//     its operands' 128-deep k tiles in shared memory (X_dd from its
//     owner's shared memory through distributed shared memory, U from u,
//     the other X and T tiles through L2) and sums a 4 x 1 column a thread.
//     The split cluster barrier (wfc_arrive, wfc_wait) separates the
//     half-levels.
// X goes straight to x when n is a multiple of 128; otherwise into an np x
// np workspace (np the next multiple of 128) copied out at the end. T is an
// np x np workspace. Each output is one thread's, summed in one order, with
// no atomics: a launch repeats bit for bit. slate_upper_tri_inv_trace
// records each CTA's globaltimer stamps (TI_STAMPS a CTA: the start, the
// copy-in, the diagonal inverse, each half-level, the store), for
// chip_smoke.py's split of K0's time.
#include "common.cuh"
#include "tri_inv.cuh"
#include "tri_inv_wide.cuh"
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

// *floats = the workspace of the wide route for an n x n U: T, and X when n
// is not a multiple of 128 (0 at n <= 128).
extern "C" int slate_upper_tri_inv_work(int device, int n, int* floats) {
  const int np = (n + TI_T - 1) / TI_T * TI_T;
  *floats = n <= 128 ? 0 : (n % TI_T ? 2 : 1) * np * np;
  return 0;
}

// *fits = 1 when K0 takes an n x n U on this device: 1 <= n <= 128 (one
// block), or n <= 512 where the card places the wide route's cluster.
extern "C" int slate_upper_tri_inv_fits(int device, int n, int* fits) {
  SLATE_SET_DEVICE(device);
  *fits = n >= 1 && n <= TI_MAX_N;
  if (*fits && n > 128) {
    return cluster_fits(upper_tri_inv_wide_kernel, device, TI_CLUSTER,
                        TI_THREADS, TI_SMEM_BYTES, fits);
  }
  return 0;
}

static int launch_wide(cudaStream_t stream, const float* u, long long us0,
                       long long us1, float* x, int n, float* work,
                       long long* stamps) {
  if (n > TI_MAX_N || work == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int np = (n + TI_T - 1) / TI_T * TI_T;
  float* xw = n % TI_T ? work + (long long)np * np : x;
  const long long ldx = n % TI_T ? np : n;
  return ti_launch_wide(stream,
                        TiArgs{u, us0, us1, 0, x, 0, work, 0, xw, ldx, 0, n,
                               np, nullptr, 0, stamps},
                        1);
}

// One launch for one n x n U, within slate_upper_tri_inv_fits; work holds
// slate_upper_tri_inv_work(n) floats (null at n <= 128).
extern "C" int slate_upper_tri_inv(int device, void* stream, const float* u,
                                   long long us0, long long us1, float* x,
                                   int n, float* work) {
  SLATE_SET_DEVICE(device);
  if (n > 128) {
    return launch_wide(static_cast<cudaStream_t>(stream), u, us0, us1, x, n,
                       work, nullptr);
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

// The wide route once, with each CTA's globaltimer stamps (stamps: int64
// [TI_CLUSTER][TI_STAMPS]; *cluster = TI_CLUSTER): for chip_smoke.py's
// split of K0's time. Not a launch of the solver paths: the wrapper does
// not count it. The results are slate_upper_tri_inv's, bit for bit.
extern "C" int slate_upper_tri_inv_trace(int device, void* stream,
                                         const float* u, long long us0,
                                         long long us1, float* x, int n,
                                         float* work, long long* stamps,
                                         int* cluster) {
  SLATE_SET_DEVICE(device);
  *cluster = TI_CLUSTER;
  if (n <= 128 || stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_wide(static_cast<cudaStream_t>(stream), u, us0, us1, x, n,
                     work, stamps);
}
