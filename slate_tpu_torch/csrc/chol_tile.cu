// K1: lower Cholesky factor of one SPD f32 tile, the port of chol_tile_pallas
// (slate_tpu/internal/pallas_chol.py:316, pallas_call at :320; its body is
// _chol_factor_in_place at :63). It serves potrf_tile, the diagonal factor
// of the blocked Cholesky when the fused panel (K2) is not taken.
//
// Bound on this card: n^3/3 flops and 2 n^2 * 4 bytes for one n <= 128 tile
// (0.7 MFLOP, 128 KB at n = 128): a few hundred nanoseconds at peak rates.
// What really bounds it is the column loop's sequence of 2n + n/bw
// block-wide barriers on a single SM; a tile this size cannot be spread
// over the card.
//
// Design: one block holds the whole tile in shared memory for the whole
// factorization (n x (n+1) floats, odd stride so that row and column walks
// are free of bank conflicts; 64.5 KB at n = 128, hence the dynamic
// shared-memory opt-in) and runs the shared column loop (chol_factor.cuh)
// with 512 threads: each barrier-separated step is spread over the block,
// and only the loop itself stays sequential. Returns L with exact zeros
// above the diagonal.
#include "common.cuh"
#include "chol_factor.cuh"

__global__ void __launch_bounds__(512)
chol_tile_kernel(const float* __restrict__ a, long long as0, long long as1,
                 float* __restrict__ l, int n, int bw) {
  extern __shared__ float s[];
  const int lds = n + 1;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    s[r * lds + c] = a[r * as0 + c * as1];
  }
  __syncthreads();
  chol_factor_smem(s, lds, n, bw);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    l[idx] = s[(idx / n) * lds + idx % n];
  }
}

extern "C" int slate_chol_tile(int device, void* stream, const float* a,
                               long long as0, long long as1, float* l, int n,
                               int bw) {
  SLATE_SET_DEVICE(device);
  const size_t smem = (size_t)n * (n + 1) * sizeof(float);
  SLATE_SET_SMEM(chol_tile_kernel, smem);
  chol_tile_kernel<<<1, 512, smem, static_cast<cudaStream_t>(stream)>>>(
      a, as0, as1, l, n, bw);
  return static_cast<int>(cudaGetLastError());
}
