// K1: lower Cholesky factor of one SPD f32 tile, the port of chol_tile_pallas
// (slate_tpu/internal/pallas_chol.py:316, pallas_call at :320; its body is
// _chol_factor_in_place at :63). It serves potrf_tile, the diagonal factor
// of the blocked Cholesky when the fused panel (K2) is not taken.
//
// Bound on this card: n^3/3 flops and 2 n^2 * 4 bytes for one n <= 128 tile
// (0.7 MFLOP, 128 KB at n = 128): well under a microsecond at peak rates.
// What really bounds it is the chain of dependent steps and the block
// barriers of one SM; a tile this size cannot be spread over the card.
//
// Design: one block of 512 threads holds the tile in shared memory, padded
// to np, the next multiple of 32, with the identity (np x (np + 4) floats,
// 66 KB at n = 128, hence the dynamic shared-memory opt-in, and 4 KB of
// column slots), and factors
// it in 32-column blocks (chol_factor.cuh): a warp factors a diagonal block
// in registers, every warp solves its 32-row chunk below it at the same
// time, and all threads update the trailing lower triangle, two barriers a
// block. The kernel's blocking is its own: the reference's slab width bw
// is the plain version's business, not the kernel's. Returns L with exact
// zeros above the diagonal.
//
// Past n = 128 (up to 1024, the reference's widest tile, pallas_chol.py
// :316 under slate_tpu/internal/potrf.py:40-43) the tile does not fit one
// block: the wide route (wide_factor.cuh) copies it, padded to np, the next
// multiple of 128, with the identity, into a device-memory workspace and
// factors it there by 128-column diagonal blocks on one thread-block
// cluster, in one launch.
#include <cstdint>

#include "common.cuh"
#include "chol_factor.cuh"
#include "wide_factor.cuh"

constexpr int TILE_THREADS = 512;

// vec: n == np, a row-major with as0 % 4 == 0 and 16-byte aligned, so the
// tile moves in and l out by 16-byte accesses; else element by element.
__global__ void __launch_bounds__(TILE_THREADS)
chol_tile_kernel(const float* __restrict__ a, long long as0, long long as1,
                 float* __restrict__ l, int n, int np, int vec) {
  extern __shared__ __align__(16) float s[];
  const int lds = np + 4, q = np / 4;
  if (vec) {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < np * q; idx += TILE_THREADS) {
      const int r = idx / q, c = 4 * (idx % q);
      *reinterpret_cast<float4*>(s + r * lds + c) =
          *reinterpret_cast<const float4*>(a + r * as0 + c);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < np * np; idx += TILE_THREADS) {
      const int r = idx / np, c = idx % np;
      float v = r == c ? 1.f : 0.f;
      if (r < n && c <= r) v = a[r * as0 + c * as1];
      s[r * lds + c] = v;
    }
  }
  __syncthreads();
  chol_factor_smem(s, lds, np, s + np * lds);
  if (vec) {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < np * q; idx += TILE_THREADS) {
      const int r = idx / q, c = 4 * (idx % q);
      float4 v = *reinterpret_cast<const float4*>(s + r * lds + c);
      if (c + 3 > r) {
        v.w = 0.f;
        if (c + 2 > r) v.z = 0.f;
        if (c + 1 > r) v.y = 0.f;
        if (c > r) v.x = 0.f;
      }
      *reinterpret_cast<float4*>(l + r * np + c) = v;
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n * n; idx += TILE_THREADS) {
      const int r = idx / n, c = idx % n;
      l[idx] = c > r ? 0.f : s[r * lds + c];
    }
  }
}

// The wide route, one cluster: w (np x np, row-major) = lower(a) padded
// with the identity, factored by wf_chol (slots: np / 128 - 1 tiles for the
// diagonal blocks' inverses), then l (n x n) = its lower n x n corner.
__global__ void __launch_bounds__(WF_THREADS)
chol_tile_wide_kernel(const float* __restrict__ a, long long as0,
                      long long as1, float* __restrict__ l, int n,
                      float* __restrict__ w, int np,
                      float* __restrict__ slots) {
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas();
  const long long stride = (long long)ctas * blockDim.x;
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x;
       idx < (long long)np * np; idx += stride) {
    const int r = (int)(idx / np), c = (int)(idx % np);
    float v = r == c ? 1.f : 0.f;
    if (r < n && c <= r) v = a[r * as0 + c * as1];
    w[idx] = v;
  }
  wf_sync();
  wf_chol(w, np, np, slots, smem);
  for (long long idx = (long long)rank * blockDim.x + threadIdx.x;
       idx < (long long)n * n; idx += stride) {
    const int r = (int)(idx / n), c = (int)(idx % n);
    l[idx] = __ldcg(w + (long long)r * np + c);
  }
}

// *floats = the workspace of the wide route for an n x n tile (0 at n <=
// 128, where the one-block kernel takes it).
extern "C" int slate_chol_tile_work(int device, int n, int* floats) {
  const int np = (n + WF_T - 1) / WF_T * WF_T;
  *floats = n <= 128 ? 0 : np * np + np * WF_T;
  return 0;
}

// *fits = 1 when K1 takes an n x n tile on this device: n % 32 == 0 and
// 32 <= n <= 1024 (one block's shared memory up to 128, one cluster of the
// wide route past it).
extern "C" int slate_chol_tile_fits(int device, int n, int* fits) {
  SLATE_SET_DEVICE(device);
  *fits = 0;
  if (n % CF_BLOCK || n < CF_BLOCK || n > WF_MAX_TILE) return 0;
  if (n <= 128) {
    *fits = 1;
    return 0;
  }
  return wf_fits(chol_tile_wide_kernel, device, fits);
}

// One launch for one n x n tile, within slate_chol_tile_fits; work holds
// slate_chol_tile_work(n) floats (null at n <= 128).
extern "C" int slate_chol_tile(int device, void* stream, const float* a,
                               long long as0, long long as1, float* l,
                               int n, float* work) {
  SLATE_SET_DEVICE(device);
  if (n > 128) {
    if (n % CF_BLOCK || n > WF_MAX_TILE || work == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int np = (n + WF_T - 1) / WF_T * WF_T;
    return wf_launch(chol_tile_wide_kernel, static_cast<cudaStream_t>(stream),
                     a, as0, as1, l, n, work, np,
                     work + (long long)np * np);
  }
  const int np = (n + CF_BLOCK - 1) / CF_BLOCK * CF_BLOCK;
  const size_t smem = sizeof(float) * ((size_t)np * (np + 4) +
                                       chol_factor_scratch(TILE_THREADS));
  const int vec = n == np && as1 == 1 && as0 % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(l) % 16 == 0;
  SLATE_SET_SMEM(chol_tile_kernel, smem);
  chol_tile_kernel<<<1, TILE_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(a, as0, as1, l, n,
                                                          np, vec);
  return static_cast<int>(cudaGetLastError());
}
