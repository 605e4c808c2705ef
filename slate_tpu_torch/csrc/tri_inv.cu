// K0's launch: X = U^-1 of one upper-triangular f32 tile, n <= 128.
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
#include "common.cuh"
#include "tri_inv.cuh"

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

extern "C" int slate_upper_tri_inv(int device, void* stream, const float* u,
                                   long long us0, long long us1, float* x,
                                   int n) {
  SLATE_SET_DEVICE(device);
  const int np = (n + TRI_DIAG - 1) / TRI_DIAG * TRI_DIAG;
  const size_t smem = sizeof(float) * (size_t)np *
                      ((np + 1) + (np + 4) + (np / 2 + 4));
  SLATE_SET_SMEM(upper_tri_inv_kernel, smem);
  upper_tri_inv_kernel<<<1, TRI_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(u, us0, us1, x,
                                                              n, np);
  return static_cast<int>(cudaGetLastError());
}
