// K0's launch: X = U^-1 of one upper-triangular f32 tile, n <= 128.
//
// The routine itself is in tri_inv.cuh, with the note on what it replaces
// and what bounds it. On the solve path K2's wrapper launches this between
// its two launches, on U = L00^T (a transposed view: U is read through two
// strides). One block of 128 threads copies U into shared memory (entries
// below the diagonal read as 0), inverts it there and writes X row-major.
#include "common.cuh"
#include "tri_inv.cuh"

__global__ void __launch_bounds__(128)
upper_tri_inv_kernel(const float* __restrict__ u, long long us0, long long us1,
                     float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* U = smem;
  float* X = smem + n * ld;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    U[r * ld + c] = (c >= r) ? u[r * us0 + c * us1] : 0.f;
  }
  __syncthreads();
  upper_tri_inv_smem(U, ld, 1, X, ld, n);
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    x[idx] = X[(idx / n) * ld + idx % n];
  }
}

extern "C" int slate_upper_tri_inv(int device, void* stream, const float* u,
                                   long long us0, long long us1, float* x,
                                   int n) {
  SLATE_SET_DEVICE(device);
  const size_t smem = 2 * (size_t)n * (n + 1) * sizeof(float);
  SLATE_SET_SMEM(upper_tri_inv_kernel, smem);
  upper_tri_inv_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      u, us0, us1, x, n);
  return static_cast<int>(cudaGetLastError());
}
