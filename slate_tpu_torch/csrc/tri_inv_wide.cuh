// K0's wide route (128 < n <= 512), in a header so that K3's and K7's
// factor launches (lu_panel.cu, lu_panel_batched.cu) run the same kernel
// on their packed L\U: the design is in tri_inv.cu's note. The kernel takes
// a batch (grid (TI_CLUSTER, B), a cluster a problem), each problem's U, X
// and T at its own offset; with `tiles`, a problem b with k >= tiles[b]
// (K7's dead tile 0) is skipped by its whole cluster.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "tri_inv.cuh"
#include "wide_factor.cuh"

// ---- the wide route (128 < n <= 512): the design in the note above

constexpr int TI_THREADS = 1024;
constexpr int TI_LOADS = 16;         // loads in flight a thread: np^2 / 1024
constexpr int TI_T = 128;            // a diagonal block, a tile
constexpr int TI_CLUSTER = 8;        // portable
constexpr int TI_MAX_N = 512;
constexpr int TI_STRIP = 32;         // rows of a join item
constexpr int TI_LDU = TI_T + 1, TI_LDX = TI_T + 4, TI_LDT = TI_T / 2 + 4;
constexpr int TI_LDA = TI_STRIP + 4; // a staged strip, k-major
// shared memory, in floats: X_dd, then the doubling's U and T, whose space
// the joins' staged strip (A, k-major) and k tile (B) reuse
constexpr int TI_U = TI_T * TI_LDX;
constexpr int TI_TS = TI_U + TI_T * TI_LDU;
constexpr int TI_FLOATS = TI_TS + TI_T * TI_LDT;
constexpr int TI_B = TI_U + TI_T * TI_LDA;
static_assert(TI_B + TI_T * TI_T <= TI_FLOATS, "the joins' staging fits");
static_assert(TI_U % 4 == 0 && TI_TS % 4 == 0 && TI_B % 4 == 0,
              "16-byte aligned regions");
constexpr size_t TI_SMEM_BYTES = sizeof(float) * TI_FLOATS;
constexpr int TI_STAMPS = 8;         // stamps a CTA: see the note above

// One operand tile of a join: element (i, j) at p[i * s0 + j * s1]; for
// the input U (TI_FROM_U), zero at or past (ilim, jlim).
struct TiSrc {
  const float* p;
  long long s0, s1;
  int ilim, jlim;
};
// where a join's operand lies: the input U (read-only), scratch written in
// this launch (read through L2), a CTA's shared memory (distributed)
enum { TI_FROM_U = 0, TI_FROM_L2 = 1, TI_FROM_SMEM = 2 };

template <int MODE>
__device__ inline float ti_get(const TiSrc& s, int i, int j) {
  const float* e = s.p + i * s.s0 + j * s.s1;
  if (MODE == TI_FROM_U) return i < s.ilim && j < s.jlim ? __ldg(e) : 0.f;
  if (MODE == TI_FROM_L2) return __ldcg(e);
  return *e;
}

// dst[i * di + j * dj] = src(i, j) for an R x C tile (R C = PER
// TI_THREADS), walking the source's unit-stride index, PER loads a thread
// in flight.
template <int R, int C, int PER, int MODE>
__device__ inline void ti_stage_from(float* dst, int di, int dj,
                                     const TiSrc& s) {
  const bool i_fast = s.s0 == 1 && s.s1 != 1;
  float v[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = t * TI_THREADS + threadIdx.x;
    v[t] = ti_get<MODE>(s, i_fast ? e % R : e / C, i_fast ? e / R : e % C);
  }
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = t * TI_THREADS + threadIdx.x;
    const int i = i_fast ? e % R : e / C, j = i_fast ? e / R : e % C;
    dst[i * di + j * dj] = v[t];
  }
}

template <int R, int C>
__device__ inline void ti_stage(float* dst, int di, int dj, const TiSrc& s,
                                int mode) {
  constexpr int PER = R * C / TI_THREADS;
  if (mode == TI_FROM_U) {
    ti_stage_from<R, C, PER, TI_FROM_U>(dst, di, dj, s);
  } else if (mode == TI_FROM_L2) {
    ti_stage_from<R, C, PER, TI_FROM_L2>(dst, di, dj, s);
  } else {
    ti_stage_from<R, C, PER, TI_FROM_SMEM>(dst, di, dj, s);
  }
}

__device__ inline void ti_stamp(long long* stamps, int rank, int phase) {
  if (stamps != nullptr && threadIdx.x == 0) {
    stamps[rank * TI_STAMPS + phase] = wfc_now();
  }
}

// One problem's operands: U (n x n, strides us0, us1), X = U^-1 (n x n
// row-major), T (np x np scratch) and xw, where X is formed: x itself (ldx
// = n) when n % 128 == 0, else an np x np scratch (ldx = np) copied into x
// at the end. Problem b's are at b times the batch strides.
struct TiArgs {
  const float* u;
  long long us0, us1, ub;
  float* x;
  long long xb;
  float* tw;
  long long twb;
  float* xw;
  long long ldx, xwb;
  int n, np;
  const int* tiles;   // null, or K7's live tile counts: skip k >= tiles[b]
  int k;
  long long* stamps;  // null, or TI_STAMPS a CTA of problem 0
};

// x = U^-1 for each problem's n x n U, 128 < n <= 512, np = n rounded up
// to 128 (TiArgs); problem blockIdx.y.
__global__ void __launch_bounds__(TI_THREADS, 1)
upper_tri_inv_wide_kernel(TiArgs a) {
  const int b = blockIdx.y;
  if (a.tiles != nullptr && a.k >= a.tiles[b]) return;  // the whole cluster
  const float* __restrict__ u = a.u + b * a.ub;
  float* __restrict__ x = a.x + b * a.xb;
  float* __restrict__ tw = a.tw + b * a.twb;
  float* xw = a.xw + b * a.xwb;
  const long long us0 = a.us0, us1 = a.us1, ldx = a.ldx;
  const int n = a.n, np = a.np;
  long long* stamps = b == 0 ? a.stamps : nullptr;
  extern __shared__ __align__(16) float smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int nt = np / TI_T, tid = threadIdx.x;
  float* X = smem;
  ti_stamp(stamps, rank, 0);
  if (rank < nt) {
    // U's diagonal block, as the one-block kernel copies its tile
    float* U = smem + TI_U;
    const long long d0 = (long long)rank * TI_T;
    const bool by_rows = us1 == 1 || us0 != 1;
#pragma unroll
    for (int e0 = 0; e0 < TI_T * TI_T; e0 += TI_THREADS * TI_LOADS) {
      float v[TI_LOADS];
#pragma unroll
      for (int t = 0; t < TI_LOADS; ++t) {
        const int e = e0 + t * TI_THREADS + tid;
        const int r = by_rows ? e / TI_T : e % TI_T;
        const int c = by_rows ? e % TI_T : e / TI_T;
        v[t] = (r == c) ? 1.f : 0.f;
        if (d0 + r < n && d0 + c < n && c >= r)
          v[t] = u[(d0 + r) * us0 + (d0 + c) * us1];
      }
#pragma unroll
      for (int t = 0; t < TI_LOADS; ++t) {
        const int e = e0 + t * TI_THREADS + tid;
        const int r = by_rows ? e / TI_T : e % TI_T;
        const int c = by_rows ? e % TI_T : e / TI_T;
        U[r * TI_LDU + c] = v[t];
      }
    }
    __syncthreads();
    ti_stamp(stamps, rank, 1);
    upper_tri_inv_doubling(U, TI_LDU, X, TI_LDX, smem + TI_TS, TI_LDT, TI_T);
    float* xd = xw + d0 * ldx + d0;
    for (int idx = tid; idx < TI_T * TI_T / 4; idx += TI_THREADS) {
      const int r = idx / (TI_T / 4), c = 4 * (idx % (TI_T / 4));
      *reinterpret_cast<float4*>(xd + r * ldx + c) =
          *reinterpret_cast<const float4*>(X + r * TI_LDX + c);
    }
  } else {
    ti_stamp(stamps, rank, 1);
  }
  // the tiles below the diagonal are zero
  const long long below = (long long)nt * (nt - 1) / 2 * TI_T * TI_T;
  for (long long idx = (long long)rank * TI_THREADS + tid; idx < below;
       idx += (long long)ctas * TI_THREADS) {
    const long long tile = idx / (TI_T * TI_T);
    const int e = (int)(idx % (TI_T * TI_T));
    int r = 1;
    while ((long long)r * (r + 1) / 2 <= tile) ++r;
    const int c = (int)(tile - (long long)r * (r - 1) / 2);
    xw[((long long)r * TI_T + e / TI_T) * ldx + c * TI_T + e % TI_T] = 0.f;
  }
  ti_stamp(stamps, rank, 2);
  wfc_arrive();
  wfc_wait();
  float* As = smem + TI_U;   // As[k * TI_LDA + i]: the strip, k-major
  float* Bs = smem + TI_B;   // Bs[k * TI_T + c]
  const int cl = tid % TI_T, g = tid / TI_T;   // column, 4-row group
  // X(r, c) as an operand: X_rr from its owner's shared memory, else xw
  auto xsrc = [&](int r, int c, int& mode) {
    mode = r == c ? TI_FROM_SMEM : TI_FROM_L2;
    if (r == c) return TiSrc{cluster.map_shared_rank(X, r), TI_LDX, 1, 0, 0};
    return TiSrc{xw + (long long)r * TI_T * ldx + c * TI_T, ldx, 1, 0, 0};
  };
  int phase = 3;
  for (int b = 1; b < nt; b *= 2) {
    const int pairs = (nt - b + 2 * b - 1) / (2 * b);
    const int items = pairs * b * b * (TI_T / TI_STRIP);
    for (int half = 0; half < 2; ++half) {
      for (int p = rank; p < items; p += ctas) {
        const int tile = p / (TI_T / TI_STRIP), strip = p % (TI_T / TI_STRIP);
        const int i0 = tile / (b * b) * 2 * b, j0 = i0 + b;
        const int r = i0 + tile % (b * b) / b, c = j0 + tile % b;
        if (c >= nt) continue;
        const int s0 = strip * TI_STRIP;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        // half 0: T(r, c) = sum over kt = j0 .. c of U(r, kt) X(kt, c);
        // half 1: X(r, c) = -sum over kt = r .. j0-1 of X(r, kt) T(kt, c)
        const int kb = half ? r : j0, ke = half ? j0 : c + 1;
        for (int kt = kb; kt < ke; ++kt) {
          TiSrc a, bsrc;
          int amode, bmode;
          if (half == 0) {
            a = TiSrc{u + ((long long)r * TI_T + s0) * us0 +
                          (long long)kt * TI_T * us1,
                      us0, us1, n - r * TI_T - s0, n - kt * TI_T};
            amode = TI_FROM_U;
            bsrc = xsrc(kt, c, bmode);
          } else {
            a = xsrc(r, kt, amode);
            a.p += (long long)s0 * a.s0;
            bsrc = TiSrc{tw + (long long)kt * TI_T * np + c * TI_T, np, 1, 0,
                         0};
            bmode = TI_FROM_L2;
          }
          __syncthreads();   // the previous k tile's reads are done
          ti_stage<TI_STRIP, TI_T>(As, 1, TI_LDA, a, amode);
          ti_stage<TI_T, TI_T>(Bs, TI_T, 1, bsrc, bmode);
          __syncthreads();
#pragma unroll 8
          for (int k = 0; k < TI_T; ++k) {
            const float bv = Bs[k * TI_T + cl];
            const float4 av =
                *reinterpret_cast<const float4*>(As + k * TI_LDA + 4 * g);
            acc[0] += av.x * bv;
            acc[1] += av.y * bv;
            acc[2] += av.z * bv;
            acc[3] += av.w * bv;
          }
        }
        const long long row = (long long)r * TI_T + s0 + 4 * g;
        const int colx = c * TI_T + cl;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (half == 0) {
            tw[(row + q) * np + colx] = acc[q];
          } else {
            xw[(row + q) * ldx + colx] = -acc[q];
          }
        }
      }
      wfc_arrive();
      wfc_wait();
      ti_stamp(stamps, rank, phase++);
    }
  }
  if (xw != x) {
    const long long stride = (long long)ctas * TI_THREADS;
    for (long long idx = (long long)rank * TI_THREADS + tid;
         idx < (long long)n * n; idx += stride) {
      x[idx] = __ldcg(xw + (idx / n) * ldx + idx % n);
    }
  }
  ti_stamp(stamps, rank, TI_STAMPS - 1);
}


// Launch the wide route over `batch` problems (TiArgs) on `stream`: a
// cluster of TI_CLUSTER CTAs a problem.
inline int ti_launch_wide(cudaStream_t stream, const TiArgs& a, int batch) {
  SLATE_SET_SMEM(upper_tri_inv_wide_kernel, TI_SMEM_BYTES);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = TI_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(TI_CLUSTER, batch, 1);
  cfg.blockDim = dim3(TI_THREADS, 1, 1);
  cfg.dynamicSmemBytes = TI_SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, upper_tri_inv_wide_kernel,
                                             a);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The arguments of one U^-1 (n % 128 == 0, X formed in x): U (n x n, row
// stride ld, unit column stride; only its upper triangle is read), x (n x
// n row-major) and T (n x n scratch), problem b's at b times ub, xb, twb.
inline TiArgs ti_args_packed(const float* u, long long ld, long long ub,
                             float* x, long long xb, float* tw,
                             long long twb, int n, const int* tiles, int k,
                             long long* stamps) {
  return TiArgs{u, ld, 1, ub, x, xb, tw, twb, x, n, xb, n, n, tiles, k,
                stamps};
}
