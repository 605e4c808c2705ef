// K4: partial-pivot row selection for one round of the CALU tournament, the
// port of lu_select_pallas (slate_tpu/internal/pallas_lu.py:338, pallas_call
// at :346, kernel _lu_select_kernel at :56).
//
//   chunks [G, W, nb] f32, any strides
//   nrows  [G] int32: rows >= nrows[g] of chunk g are dead, never chosen
//          while a live row is left
//   piv    [G, nb] int64: chunk g's nb partial-pivot rows in elimination
//          order; on input without ties, lax.linalg.lu's perm[:nb]
//   ws     [G, W, nb] f32 scratch: each chunk as its elimination updates it
//
// The reference vmaps one pallas_call over a round's row blocks; here one
// launch takes the whole round, one block of 1024 threads per chunk.
//
// What differs from the TPU: the reference holds a whole chunk (up to 4096
// rows of 128, 2 MB) transposed in VMEM. No block's 227 KB of shared memory
// holds that, so the chunk lives in global memory (ws; a round's chunks of
// a gesv at n = 20480 are at most 10 MB, which stays in the 50 MB L2) and
// only the current slab of bw columns, W x bw floats, sits in shared
// memory; that slab is the kernel's only limit on W (about 6100 rows at
// bw = 8). Chosen rows are masked, not swapped, as in the reference; its
// deferred (I + N)^-1 trailing update is a Mosaic idiom, replaced here by
// the plain right-looking update.
//
// Per slab of bw columns:
//   (1) column by column: a block-wide argmax of |v| over the live rows, ties
//       to the lowest row as jnp.argmax breaks them (a column with no live
//       row left gives row 0, as the reference's argmax of all -1 does); the
//       live rows' multipliers l = v / pivot (0 for a zero pivot) are stored
//       in place and the slab's later columns updated; the pivot row dies;
//   (2) the U rows of the slab's pivots over the trailing columns,
//       u_i = ws[p_i] - sum_{k<i} l_k(p_i) u_k;
//   (3) ws[r, trailing] -= sum_i l_i(r) u_i for every row still live.
// The plain version (slate_tpu_torch/internal/lu_kernels.py lu_select_plain)
// repeats these steps.
//
// Bound on this card: W nb^2 - nb^3/3 flops per chunk against 4 W nb bytes
// read, ~nb / 4 = 32 flops a byte, above the f32 ridge (20): bound by
// operations if the card were full. It is not: a round of G chunks fills G
// of 132 SMs, and each column's argmax is a chain of block-wide barriers.
// The passes over ws are bound by L2 latency, so each keeps several loads a
// thread in flight (the trailing update: one warp two rows, four columns a
// lane). Splitting a chunk over a thread-block cluster is the way to a
// faster version.
#include <cfloat>

#include "common.cuh"

constexpr int SEL_THREADS = 1024;

static size_t select_smem_bytes(int W, int nb, int bw) {
  return sizeof(float) * ((size_t)W * (bw + 1) + (size_t)bw * nb + 32) +
         sizeof(int) * (32 + bw) + (size_t)W;
}

// (v, r) becomes the larger value; equal values keep the lower row
__device__ inline void argmax_combine(float& v, int& r, float v2, int r2) {
  if (v2 > v || (v2 == v && r2 < r)) {
    v = v2;
    r = r2;
  }
}

__global__ void __launch_bounds__(SEL_THREADS)
lu_select_kernel(const float* __restrict__ chunks, long long cs0,
                 long long cs1, long long cs2, const int* __restrict__ nrows,
                 int W, int nb, int bw, float* __restrict__ ws,
                 long long* __restrict__ piv) {
  extern __shared__ float smem[];
  const int ld = bw + 1;
  float* S = smem;                          // W x ld: the slab
  float* U = S + (size_t)W * ld;            // bw x nb: the slab's U rows
  float* red_v = U + bw * nb;               // one maximum per warp
  int* red_r = reinterpret_cast<int*>(red_v + 32);  // and its row
  int* prow = red_r + 32;                   // the slab's pivot rows
  unsigned char* live = reinterpret_cast<unsigned char*>(prow + bw);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* A = chunks + blockIdx.x * cs0;
  float* Wg = ws + (size_t)blockIdx.x * W * nb;
  long long* P = piv + (size_t)blockIdx.x * nb;
  const int nlive = nrows[blockIdx.x];
  const int nwarps = nthr / 32;
  // the chunk into ws: one warp a row, each lane's (up to) four columns
  // loaded before any is stored
  for (int r = warp; r < W; r += nwarps) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      if (c < nb) v[k] = A[r * cs1 + c * cs2];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      if (c < nb) Wg[(size_t)r * nb + c] = v[k];
    }
  }
  for (int r = tid; r < W; r += nthr) live[r] = r < nlive;
  __syncthreads();
  for (int j0 = 0; j0 < nb; j0 += bw) {
    // the slab into shared memory, four loads a thread in flight
    for (int idx0 = tid; idx0 < W * bw; idx0 += 4 * nthr) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = idx0 + k * nthr;
        if (idx < W * bw) v[k] = Wg[(size_t)(idx / bw) * nb + j0 + idx % bw];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int idx = idx0 + k * nthr;
        if (idx < W * bw) S[(idx / bw) * ld + idx % bw] = v[k];
      }
    }
    __syncthreads();
    for (int i = 0; i < bw; ++i) {
      // (1) the pivot: each thread scans its rows in increasing order
      float bv = -FLT_MAX;
      int br = W;
      for (int r = tid; r < W; r += nthr) {
        const float v = live[r] ? fabsf(S[r * ld + i]) : -1.f;
        if (v > bv) {
          bv = v;
          br = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
        const int r2 = __shfl_down_sync(0xffffffffu, br, off);
        argmax_combine(bv, br, v2, r2);
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_r[warp] = br;
      }
      __syncthreads();
      if (warp == 0) {
        bv = lane < nwarps ? red_v[lane] : -FLT_MAX;
        br = lane < nwarps ? red_r[lane] : W;
        for (int off = 16; off > 0; off >>= 1) {
          const float v2 = __shfl_down_sync(0xffffffffu, bv, off);
          const int r2 = __shfl_down_sync(0xffffffffu, br, off);
          argmax_combine(bv, br, v2, r2);
        }
        if (lane == 0) {
          prow[i] = br;
          P[j0 + i] = br;
        }
      }
      __syncthreads();
      // multipliers and the slab's later columns, live rows only
      const int p = prow[i];
      const float pv = S[p * ld + i];
      for (int r = tid; r < W; r += nthr) {
        if (r == p) {
          live[r] = 0;
        } else if (live[r]) {
          const float l = (pv != 0.f) ? S[r * ld + i] / pv : 0.f;
          S[r * ld + i] = l;
          for (int t = i + 1; t < bw; ++t) S[r * ld + t] -= l * S[p * ld + t];
        }
      }
      __syncthreads();
    }
    const int j1 = j0 + bw;
    if (j1 < nb) {
      const int m = nb - j1;
      // (2) the U rows of the slab's pivots over columns j1 .. nb-1
      for (int c = tid; c < m; c += nthr) {
        for (int i = 0; i < bw; ++i) {
          const int p = prow[i];
          float u = Wg[(size_t)p * nb + j1 + c];
          for (int k = 0; k < i; ++k) u -= S[p * ld + k] * U[k * nb + c];
          U[i * nb + c] = u;
        }
      }
      __syncthreads();
      // (3) the trailing update of the rows still live: one warp two rows
      // at a time (a dead row is skipped by the whole warp), its lanes over
      // the columns, all the loads in flight before the sums
      for (int r0 = 2 * warp; r0 < W; r0 += 2 * nwarps) {
        float v[2][4];
        bool on[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = r0 + q;
          on[q] = r < W && live[r];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = lane + 32 * k;
            if (on[q] && c < m) v[q][k] = Wg[(size_t)r * nb + j1 + c];
          }
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!on[q]) continue;
          const float* l = S + (r0 + q) * ld;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = lane + 32 * k;
            if (c < m) {
              float acc = 0.f;
              for (int i = 0; i < bw; ++i) acc += l[i] * U[i * nb + c];
              Wg[(size_t)(r0 + q) * nb + j1 + c] = v[q][k] - acc;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// *fits = 1 when a round of W-row chunks can launch on this device: nb <=
// 128 (four columns a lane), nb % bw == 0, and the slab and its scratch
// (select_smem_bytes) within one block's opt-in shared memory; else 0.  The
// tournament's gate asks this before it sends a round to the kernel.
extern "C" int slate_lu_select_fits(int device, int W, int nb, int bw,
                                    int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = W >= 1 && nb >= 1 && nb <= 128 && bw >= 1 && nb % bw == 0 &&
          select_smem_bytes(W, nb, bw) <= (size_t)limit;
  return 0;
}

// One launch for a round of G chunks, within slate_lu_select_fits's limits
// (past them the launch is refused with an error code).
extern "C" int slate_lu_select(int device, void* stream, const float* chunks,
                               long long cs0, long long cs1, long long cs2,
                               const int* nrows, int G, int W, int nb, int bw,
                               float* ws, long long* piv) {
  SLATE_SET_DEVICE(device);
  if (G < 1 || W < 1 || nb < 1 || nb > 128 || bw < 1 || nb % bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = select_smem_bytes(W, nb, bw);
  SLATE_SET_SMEM(lu_select_kernel, smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lu_select_kernel<<<G, SEL_THREADS, smem, s>>>(
      chunks, cs0, cs1, cs2, nrows, W, nb, bw, ws, piv);
  return static_cast<int>(cudaGetLastError());
}
