// K5: the Householder QR panel with its compact-WY T, the port of
// qr_panel_pallas (slate_tpu/internal/pallas_qr.py:123, pallas_call at :129,
// column loop _qr_panel_steps at :43). Up to w = 128 one launch a panel:
// one cluster of C CTAs running qr_panel_cluster (qr_panel.cuh, which says
// what is computed, how the rows are split and how the column loop is
// blocked).
//
// Bound on this card: 2 mm w^2 - 2 w^3 / 3 flops for the panel (plus about
// mm w^2 for T) against 4 mm w bytes read and written once: ~w / 2 = 64
// flops a byte at w = 128, above the f32 ridge (20), so bound by operations
// if the whole card worked on it. It cannot: a panel is a chain of w
// dependent column steps, each a reduction over all its rows, so what bounds
// the kernel is the latency of one column step. The first port ran the chain
// on one SM over the L2-resident panel (21.6 ms at [8192, 128] on an H100);
// here up to 16 SMs of one cluster split the rows, hold them in shared
// memory as far as it reaches, and exchange each column's partial sums
// through distributed shared memory, so a column step is a pass over ~500
// rows a CTA and one cluster barrier. The launcher picks the cluster size
// (qr_prepare_cluster: 16 at mm > 2048, one CTA at mm <= 256). The port's
// gate (internal/qr.py) keeps panels of more than 2^20 elements off this
// kernel.
//
// Past w = 128 (w = 256, 384, 512: the reference's gate gives its kernel
// every multiple of 128 up to 512) rank 0 can no longer hold T (256 KB at
// w = 256, 1 MB at 512, past one block's 227 KB) and a row's four columns
// a lane become 8-16. So the wide route mirrors the reference's blocked
// panel (_householder_blocked_rec, slate_tpu/internal/qr.py:191) by
// 128-column blocks, the packed panel built in place in the output and T
// in device memory. The first port ran it all on one cluster of 8-16 SMs
// and spent most of its time in the update of the columns right of each
// block: 16 slabs a block, each a pass over every row and right column
// through L2 behind a fence and a cluster barrier. In each block b
// (columns c0 = 128 b .. c0 + 127, rows c0 .. mm - 1) a column right of the
// block depends only on itself and on the block's slabs (V_s, T_s), so
// that update spreads over the card by column strips. One slate_qr_panel
// call makes these launches on the stream, in order:
//   - the copy of A into the output, T = 0 (qr_wide_copy_kernel);
//   - per block, its factor (qr_wide_factor_kernel): qr_panel_cluster at
//     w = 128, unchanged, on one cluster (C CTAs from mm, for at most
//     QRW_CTA_ROWS = 128 rows a CTA: the column step's latency falls with
//     a CTA's rows, up to 16), its packed rows and T_b back in place;
//   - past the first block, the T merge, T[:c0, block] = -T[:c0, :c0]
//     (V_left^T V_b) T_b, as three grids of many CTAs: Z = V_b^T V_left by
//     32 x 32 tiles (qr_merge_z_kernel: 64-row slices staged in shared
//     memory, the eight warps' sums added in warp order), Y = T_b^T Z and
//     T12 = -T1 Y^T (16 x 16 tiles, slices of T1's and Y's rows staged);
//   - but for the last block, the strips (qr_strip_kernel): R / 8 CTAs for
//     the R columns right of the block, 16-48 where the first port had
//     8-16 SMs, each keeping its 8 columns x mb rows in shared memory (at
//     most 128 KB within the 2^20-element cap) through all the block's
//     slabs and applying them in the slab loop's order, X -= V_s (T_s^T
//     (V_s^T X)); Z_s is reduced inside the CTA (a thread its rows, the
//     warp by halving shuffles, the warps in order), with no cluster
//     barrier; V_b is read from L2 by every strip (1-2 MB).
// A block's slabs are not folded into one 128-column compact WY: that
// misses the reference's 1e-5 on the packed panel at [1024, 512]; the
// plain version (qr_kernels.qr_panel_plain) keeps the slab order, and so
// does the kernel. Only the order of the sums in a slab's row reduction
// (Z_s, and Z of the merge) differs from the plain version's. Every sum
// runs in a fixed order and there are no atomics, so a call repeats bit
// for bit; every product is an f32 FMA (no TF32). K8's wide route
// (qr_panel_batched.cu) keeps the one-cluster routine, qr_panel.cuh
// qr_panel_wide_cluster. PERF.md has the times of each launch.
#include "common.cuh"
#include "qr_panel.cuh"

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(const float* __restrict__ A, long long as0, long long as1,
                int mm, int w, int bw, float* P, float* __restrict__ T,
                int smem_floats) {
  extern __shared__ float smem[];
  qr_panel_cluster(A, as0, as1, mm, w, bw, P, P, T, smem, smem_floats);
}

// ---- the wide route (w = 256, 384, 512): the launches of one panel

constexpr int QRS_THREADS = 512;            // a strip's CTA
constexpr int QRS_WARPS = QRS_THREADS / 32;
constexpr int QRS_W = 8;                    // a strip's columns
constexpr int QRS_SUMS = QR_MAX_BW * QRS_W;  // a slab's Z: 8 x 8 sums
constexpr int QRM_THREADS = 256;            // a merge CTA
constexpr int QRM_T = 32;                   // a merge tile: 32 x 32 of Z
constexpr int QRM_ROWS = 64;                // rows of a staged merge slice
constexpr int QRW_CTA_ROWS = 128;           // a block factor's rows a CTA

// Shared memory of a strip over mb rows, in floats: the warps' partial Z,
// Z, Y and T_s (8 x 8 each), then the strip [mb][8].
__host__ __device__ inline size_t qr_strip_smem_floats(int mb) {
  return (size_t)(QRS_WARPS + 3) * QRS_SUMS + (size_t)mb * QRS_W;
}

// The wide route's workspace, in floats: the block's packed rows [mm, 128]
// (qr_panel_cluster's P), T_b [128, 128], the merge's Z and Y [128, w].
__host__ __device__ inline long long qr_strip_work_floats(int mm, int w) {
  return (long long)mm * QRW_B + QRW_B * QRW_B + 2LL * QRW_B * w;
}

// out [mm, w] (f32, row-major) = A (any strides), T [w, w] = 0.
__global__ void __launch_bounds__(256)
qr_wide_copy_kernel(const float* __restrict__ A, long long as0,
                    long long as1, int mm, int w, float* __restrict__ out,
                    float* __restrict__ T) {
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long idx = first; idx < (long long)mm * w; idx += step) {
    const long long r = idx / w, c = idx % w;
    out[idx] = A[r * as0 + c * as1];
  }
  for (long long idx = first; idx < (long long)w * w; idx += step)
    T[idx] = 0.f;
}

// Block c0's factor, one cluster: qr_panel_cluster at w = 128 on rows c0 ..
// mm-1 of the block's columns of out (its working copy and packed output
// the workspace Pb, its T_b Tb), then each CTA's own rows of Pb back into
// out and rank 0's T_b onto T's diagonal.
__global__ void __launch_bounds__(QR_THREADS)
qr_wide_factor_kernel(float* out, int mm, int w, int c0, int bw, float* Pb,
                      float* Tb, float* __restrict__ T, int smem_floats) {
  extern __shared__ float smem[];
  const int mb = mm - c0;
  qr_panel_cluster<float, float, float>(out + (size_t)c0 * w + c0, w, 1, mb,
                                        QRW_B, bw, Pb, Pb, Tb, smem,
                                        smem_floats);
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (mb + C - 1) / C;   // qr_panel_cluster's rows a CTA
  const int r0 = min(mb, rank * per), r1 = min(mb, r0 + per);
  for (int idx = r0 * QRW_B + (int)threadIdx.x; idx < r1 * QRW_B;
       idx += QR_THREADS) {
    out[(size_t)(c0 + idx / QRW_B) * w + c0 + idx % QRW_B] = Pb[idx];
  }
  if (rank == 0) {
    for (int idx = threadIdx.x; idx < QRW_B * QRW_B; idx += QR_THREADS)
      T[(size_t)(c0 + idx / QRW_B) * w + c0 + idx % QRW_B] = Tb[idx];
  }
}

// The merge's Z = V_b^T V_left for block c0: Zm[i][l] (leading dimension w)
// = sum over the rows r = c0 .. mm-1 of V_b(r, i) out[r][l], i < 128, l <
// c0 (V_left lies below its diagonal on those rows). A CTA takes the 32 x
// 32 tile i0 = 32 blockIdx.y, l0 = 32 blockIdx.x; 64-row slices are staged
// in shared memory (the next one's loads in flight in registers while this
// one is summed); warp g sums rows g, g + 8, ... of every slice, lane l
// column l0 + l, 32 sums of i a thread; the eight warps' sums are added in
// warp order.
__global__ void __launch_bounds__(QRM_THREADS)
qr_merge_z_kernel(const float* __restrict__ out, int mm, int w, int c0,
                  float* __restrict__ Zm) {
  __shared__ __align__(16) float sm[(QRM_THREADS / 32) * QRM_T * QRM_T];
  float* Vs = sm;                         // [64][32]: V_b(r, i0 + i)
  float* Ls = sm + QRM_ROWS * QRM_T;      // [64][32]: out[r][l0 + l]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.y * QRM_T, l0 = blockIdx.x * QRM_T;
  const int mb = mm - c0;
  constexpr int PER = QRM_ROWS * QRM_T / QRM_THREADS;   // 8 of each
  float vn[PER], ln[PER];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int idx = tid + q * QRM_THREADS, rr = s0 + idx / QRM_T;
      const int e = idx % QRM_T, i = i0 + e;
      const float* row = out + (size_t)(c0 + rr) * w;
      const bool in = rr < mb;
      vn[q] = in ? (rr > i ? __ldg(row + c0 + i) : (rr == i ? 1.f : 0.f))
                 : 0.f;
      ln[q] = in ? __ldg(row + l0 + e) : 0.f;
    }
  };
  float acc[QRM_T];
#pragma unroll
  for (int i = 0; i < QRM_T; ++i) acc[i] = 0.f;
  fetch(0);
  for (int s0 = 0; s0 < mb; s0 += QRM_ROWS) {
    __syncthreads();   // the last slice is summed
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      Vs[tid + q * QRM_THREADS] = vn[q];
      Ls[tid + q * QRM_THREADS] = ln[q];
    }
    __syncthreads();
    if (s0 + QRM_ROWS < mb) fetch(s0 + QRM_ROWS);
    for (int rr = warp; rr < QRM_ROWS; rr += QRM_THREADS / 32) {
      const float x = Ls[rr * QRM_T + lane];
#pragma unroll
      for (int q = 0; q < QRM_T / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(Vs + rr * QRM_T +
                                                          4 * q);
        acc[4 * q] = fmaf(v.x, x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v.y, x, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, x, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, x, acc[4 * q + 3]);
      }
    }
  }
  __syncthreads();
  float* red = sm;                        // [8][32 i][32 l]
#pragma unroll
  for (int i = 0; i < QRM_T; ++i)
    red[(warp * QRM_T + i) * QRM_T + lane] = acc[i];
  __syncthreads();
  for (int idx = tid; idx < QRM_T * QRM_T; idx += QRM_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < QRM_THREADS / 32; ++g)
      s += red[g * QRM_T * QRM_T + idx];
    Zm[(size_t)(i0 + idx / QRM_T) * w + l0 + idx % QRM_T] = s;
  }
}

// The merge's Y = T_b^T Z: Ym[i][l] = sum_{k <= i} T_b[k][i] Zm[k][l] (T_b
// on T's diagonal), one output a thread, k in ascending order.
__global__ void __launch_bounds__(256)
qr_merge_y_kernel(const float* __restrict__ T, const float* __restrict__ Zm,
                  int w, int c0, float* __restrict__ Ym) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= QRW_B * c0) return;
  const int i = idx / c0, l = idx % c0;
  const float* tb = T + (size_t)c0 * w + c0;
  float s = 0.f;
  for (int k = 0; k <= i; ++k)
    s = fmaf(tb[(size_t)k * w + i], Zm[(size_t)k * w + l], s);
  Ym[(size_t)i * w + l] = s;
}

// The merge itself: T[k][c0 + i] = -sum_{l = k}^{c0 - 1} T[k][l] Ym[i][l],
// k < c0, l in ascending order. A CTA takes a 16 x 16 tile (k0 = 16
// blockIdx.y, i0 = 16 blockIdx.x), one output a thread; 32-column slices of
// T's rows and Ym's rows are staged in shared memory, every slice from k0
// on, and a thread skips the columns left of its own k.
__global__ void __launch_bounds__(256)
qr_merge_t_kernel(float* __restrict__ T, const float* __restrict__ Ym, int w,
                  int c0) {
  __shared__ float Tk[16][33], Yi[16][33];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.y * 16, i0 = blockIdx.x * 16;
  const int k = k0 + ty, i = i0 + tx;
  float s = 0.f;
  for (int l0 = k0 - k0 % 32; l0 < c0; l0 += 32) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < 16 * 32; idx += 256) {
      const int r = idx >> 5, l = l0 + (idx & 31);
      Tk[r][idx & 31] = l < c0 ? T[(size_t)(k0 + r) * w + l] : 0.f;
      Yi[r][idx & 31] = l < c0 ? Ym[(size_t)(i0 + r) * w + l] : 0.f;
    }
    __syncthreads();
    for (int e = 0; e < 32; ++e) {
      const int l = l0 + e;
      if (l >= k && l < c0) s = fmaf(Tk[ty][e], Yi[tx][e], s);
    }
  }
  T[(size_t)k * w + c0 + i] = -s;
}

// One halving exchange of qrs_warp_sum64: the lanes with bit O keep the
// upper N values, the others the lower N, each adding its partner's.
template <int N, int O>
__device__ inline void qrs_halve(float (&v)[QRS_SUMS], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float give = up ? v[k] : v[k + N];
    const float keep = up ? v[k + N] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, give, O);
  }
}

// Sums v[0 .. 63] over the warp's lanes in a fixed order, five exchanges
// halving the values a lane carries: lane l ends with the sums of entries
// qrs_sum64_base(l) and + 1 in v[0] and v[1].
__device__ inline void qrs_warp_sum64(float (&v)[QRS_SUMS], int lane) {
  qrs_halve<32, 16>(v, lane);
  qrs_halve<16, 8>(v, lane);
  qrs_halve<8, 4>(v, lane);
  qrs_halve<4, 2>(v, lane);
  qrs_halve<2, 1>(v, lane);
}

__device__ inline int qrs_sum64_base(int lane) {
  return ((lane >> 4) & 1) * 32 + ((lane >> 3) & 1) * 16 +
         ((lane >> 2) & 1) * 8 + ((lane >> 1) & 1) * 4 + (lane & 1) * 2;
}

// V_s(r, i) of slab sl of block c0 on the block's row rr (rr = r - c0),
// unit lower, for i < nbs (0 past it): 16-byte loads where the slab's
// columns start 16-byte aligned (vec), else one load an entry.
__device__ inline void qrs_vs(const float* out, int w, int c0, int sl,
                              int nbs, bool vec, int rr,
                              float (&v)[QR_MAX_BW]) {
  const float* p = out + (size_t)(c0 + rr) * w + c0 + sl;
  const int d = rr - sl;
  if (vec) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = nbs > 4 ? __ldg(reinterpret_cast<const float4*>(p + 4))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    const float e[QR_MAX_BW] = {lo.x, lo.y, lo.z, lo.w,
                                hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < QR_MAX_BW; ++i)
      v[i] = i < nbs ? (d > i ? e[i] : (d == i ? 1.f : 0.f)) : 0.f;
    return;
  }
#pragma unroll
  for (int i = 0; i < QR_MAX_BW; ++i)
    v[i] = i < nbs ? (d > i ? __ldg(p + i) : (d == i ? 1.f : 0.f)) : 0.f;
}

// The columns right of block c0, by strips: CTA s takes the strip of
// QRS_W columns from c0 + 128 + QRS_W s on rows c0 .. mm-1, keeps it in
// shared memory through all the block's slabs and applies them in turn,
// X -= V_s (T_s^T (V_s^T X)). Thread t owns the strip's rows t, t + 512,
// ... (from the slab's first row on): it sums its rows' share of Z_s =
// V_s^T X in registers, the warp adds its lanes' sums (qrs_warp_sum64) and
// 64 threads the 16 warps' in warp order; Y_s = T_s^T Z_s on 64 threads;
// then each thread updates its own rows, so that no barrier guards the
// strip. V_b and T_b are read through the read-only path (another launch
// wrote them; no CTA of this one does).
__global__ void __launch_bounds__(QRS_THREADS, 1)
qr_strip_kernel(float* __restrict__ out, const float* __restrict__ T, int mm,
                int w, int c0, int bw) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mb = mm - c0, cs = c0 + QRW_B + blockIdx.x * QRS_W;
  float* red = smem;                          // [QRS_WARPS][64]
  float* Z = red + QRS_WARPS * QRS_SUMS;      // [8][8]
  float* Y = Z + QRS_SUMS;                    // [8][8]
  float* Ts = Y + QRS_SUMS;                   // [8][8]: T_s
  float* X = Ts + QRS_SUMS;                   // [mb][8]
  for (int r = tid; r < mb; r += QRS_THREADS) {
    const float4* src =
        reinterpret_cast<const float4*>(out + (size_t)(c0 + r) * w + cs);
    float4* dst = reinterpret_cast<float4*>(X + (size_t)r * QRS_W);
    dst[0] = src[0];
    dst[1] = src[1];
  }
  for (int sl = 0; sl < QRW_B; sl += bw) {
    const int nbs = min(bw, QRW_B - sl);
    const bool vec = (c0 + sl) % 4 == 0 && (nbs == 4 || nbs == 8);
    if (tid < QRS_SUMS) {
      // T_s[k][i], i < nbs (the barrier after the Z pass publishes it)
      const int k = tid / QRS_W, i = tid % QRS_W;
      Ts[tid] = k < nbs && i < nbs
                    ? __ldg(T + (size_t)(c0 + sl + k) * w + c0 + sl + i)
                    : 0.f;
    }
    float acc[QRS_SUMS];
#pragma unroll
    for (int q = 0; q < QRS_SUMS; ++q) acc[q] = 0.f;
    // rows in pairs, the loads of both issued before the FMAs
    for (int r = tid; r < mb; r += 2 * QRS_THREADS) {
      float v[2][QR_MAX_BW], x[2][QRS_W];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rh = r + h * QRS_THREADS;
        const bool in = rh < mb && rh >= sl;
        qrs_vs(out, w, c0, sl, in ? nbs : 0, vec && in, in ? rh : sl, v[h]);
        const float4 x0 = *reinterpret_cast<const float4*>(
            X + (in ? rh : 0) * QRS_W);
        const float4 x1 = *reinterpret_cast<const float4*>(
            X + (in ? rh : 0) * QRS_W + 4);
        x[h][0] = x0.x; x[h][1] = x0.y; x[h][2] = x0.z; x[h][3] = x0.w;
        x[h][4] = x1.x; x[h][5] = x1.y; x[h][6] = x1.z; x[h][7] = x1.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
#pragma unroll
          for (int c = 0; c < QRS_W; ++c)
            acc[i * QRS_W + c] = fmaf(v[h][i], x[h][c], acc[i * QRS_W + c]);
    }
    qrs_warp_sum64(acc, lane);
    const int base = qrs_sum64_base(lane);
    red[warp * QRS_SUMS + base] = acc[0];
    red[warp * QRS_SUMS + base + 1] = acc[1];
    __syncthreads();
    if (tid < QRS_SUMS) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < QRS_WARPS; ++g) s += red[g * QRS_SUMS + tid];
      Z[tid] = s;
    }
    __syncthreads();
    if (tid < QRS_SUMS) {
      // Y_s[i][c] = sum_{k <= i} T_s[k][i] Z_s[k][c]
      const int i = tid / QRS_W, c = tid % QRS_W;
      float s = 0.f;
      for (int k = 0; k <= i; ++k)
        s = fmaf(Ts[k * QRS_W + i], Z[k * QRS_W + c], s);
      Y[tid] = s;
    }
    __syncthreads();
    float y[QRS_SUMS];
#pragma unroll
    for (int q = 0; q < QRS_SUMS; ++q) y[q] = Y[q];
    for (int r = tid; r < mb; r += QRS_THREADS) {
      if (r < sl) continue;
      float v[QR_MAX_BW];
      qrs_vs(out, w, c0, sl, nbs, vec, r, v);
      float* xr = X + r * QRS_W;
#pragma unroll
      for (int c = 0; c < QRS_W; ++c) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          a = fmaf(v[i], y[i * QRS_W + c], a);
        xr[c] -= a;
      }
    }
  }
  for (int r = tid; r < mb; r += QRS_THREADS) {
    const float4* src = reinterpret_cast<const float4*>(X + (size_t)r * QRS_W);
    float4* dst = reinterpret_cast<float4*>(out + (size_t)(c0 + r) * w + cs);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

// The wide route's launches for one [mm, w] panel on stream s: the copy,
// then per 128-column block its factor (one cluster of c CTAs, smem bytes a
// CTA), past the first block the merge (Z, Y, T12), and but for the last
// block the strips. work: qr_strip_work_floats(mm, w).
static int qr_wide_launches(cudaStream_t s, int c, int smem, const float* A,
                            long long as0, long long as1, int mm, int w,
                            int bw, float* out, float* T, float* work) {
  const size_t strip_smem = sizeof(float) * qr_strip_smem_floats(mm);
  SLATE_SET_SMEM(qr_strip_kernel, strip_smem);
  float* Pb = work;
  float* Tb = Pb + (size_t)mm * QRW_B;
  float* Zm = Tb + QRW_B * QRW_B;
  float* Ym = Zm + (size_t)QRW_B * w;
  const long long n = (long long)mm * w;
  const int copy_blocks = (int)(n / 256 < 1024 ? (n + 255) / 256 : 1024);
  qr_wide_copy_kernel<<<copy_blocks, 256, 0, s>>>(A, as0, as1, mm, w, out,
                                                  T);
  SLATE_RETURN_IF_ERROR(cudaGetLastError());
  for (int c0 = 0; c0 < w; c0 += QRW_B) {
    const int e = qr_launch_cluster(qr_wide_factor_kernel, s, c, 1, smem, out,
                                    mm, w, c0, bw, Pb, Tb, T,
                                    smem / (int)sizeof(float));
    if (e != 0) return e;
    if (c0 > 0) {
      const int outs = (QRW_B * c0 + 255) / 256;
      qr_merge_z_kernel<<<dim3(c0 / QRM_T, QRW_B / QRM_T), QRM_THREADS, 0,
                          s>>>(out, mm, w, c0, Zm);
      qr_merge_y_kernel<<<outs, 256, 0, s>>>(T, Zm, w, c0, Ym);
      qr_merge_t_kernel<<<dim3(QRW_B / 16, c0 / 16), 256, 0, s>>>(T, Ym, w,
                                                                  c0);
      SLATE_RETURN_IF_ERROR(cudaGetLastError());
    }
    const int R = w - c0 - QRW_B;   // a multiple of 128: whole strips
    if (R > 0) {
      qr_strip_kernel<<<R / QRS_W, QRS_THREADS, strip_smem, s>>>(out, T, mm,
                                                                 w, c0, bw);
      SLATE_RETURN_IF_ERROR(cudaGetLastError());
    }
  }
  return 0;
}

// *fits = 1 when this kernel takes a [mm, w] panel at slab width bw on this
// device: 1 <= w <= 128 (four columns a lane; rank 0's T with the scratch,
// qr_panel_smem_floats, within one block's opt-in shared memory), or w in
// {256, 384, 512} by 128-column blocks with T in device memory; mm >= w, 1
// <= bw <= 8; else 0. Rows that do not fit in shared memory stay in global
// memory, so mm has no limit here; the size cap is the caller's routing
// policy.
extern "C" int slate_qr_panel_fits(int device, int mm, int w, int bw,
                                   int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  const bool wide = qr_wide_shape_ok(mm, w, bw);
  *fits = (wide || qr_panel_shape_ok(mm, w, bw)) &&
          sizeof(float) * qr_panel_smem_floats(wide ? QRW_B : w, bw) <=
              (size_t)limit &&
          (!wide || sizeof(float) * qr_strip_smem_floats(mm) <=
                        (size_t)limit);
  return 0;
}

// *floats = the workspace a [mm, w] panel takes: 0 at w <= 128, else the
// wide kernel's (qr_wide_work_floats).
extern "C" int slate_qr_panel_work(int device, int mm, int w, int* floats) {
  (void)device;
  const long long f = w > QRW_B ? qr_strip_work_floats(mm, w) : 0;
  if (f > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *floats = (int)f;
  return 0;
}

// The kernel and its cluster for a [mm, w] panel: the wide kernel past w =
// 128, its cluster chosen as for a 128-column panel of mm rows.
static int qr_prepare(int device, int mm, int w, int bw, bool* wide, int* c,
                      int* resident, int* smem) {
  *wide = w > QRW_B;
  if (*wide) {
    if (!qr_wide_shape_ok(mm, w, bw)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the block factors' cluster: as qr_prepare_cluster chooses it, but
    // for QRW_CTA_ROWS rows a CTA (the column step's latency falls with a
    // CTA's rows, and a wide panel's 2-4 blocks run one after another)
    const int e = qr_prepare_cluster(qr_wide_factor_kernel, device, mm,
                                     QRW_B, bw, c, resident, smem);
    if (e != 0) return e;
    int size = *c, placed = 0;
    while (size < QR_MAX_CLUSTER && (mm + size - 1) / size > QRW_CTA_ROWS) {
      SLATE_RETURN_IF_ERROR(active_clusters(qr_wide_factor_kernel, device,
                                            2 * size, QR_THREADS, *smem,
                                            &placed));
      if (placed == 0) break;
      size *= 2;
      *resident = placed;
    }
    *c = size;
    return 0;
  }
  return qr_prepare_cluster(qr_panel_kernel, device, mm, w, bw, c, resident,
                            smem);
}

// *c = the cluster size a launch for a [mm, w] panel takes on this device.
extern "C" int slate_qr_panel_cluster(int device, int mm, int w, int bw,
                                      int* c) {
  SLATE_SET_DEVICE(device);
  int resident = 0, smem = 0;
  bool wide = false;
  return qr_prepare(device, mm, w, bw, &wide, c, &resident, &smem);
}

// One launch for one panel, within slate_qr_panel_fits's limits (past them
// the launch is refused with an error code). P [mm, w] and T [w, w] are
// row-major outputs; `work` holds slate_qr_panel_work's floats (none at w
// <= 128).
extern "C" int slate_qr_panel(int device, void* stream, const float* A,
                              long long as0, long long as1, int mm, int w,
                              int bw, float* P, float* T, float* work) {
  SLATE_SET_DEVICE(device);
  int c = 1, resident = 0, smem = 0;
  bool wide = false;
  const int e = qr_prepare(device, mm, w, bw, &wide, &c, &resident, &smem);
  if (e != 0) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (work == nullptr ||
        sizeof(float) * qr_strip_smem_floats(mm) > (size_t)smem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return qr_wide_launches(s, c, smem, A, as0, as1, mm, w, bw, P, T, work);
  }
  return qr_launch_cluster(qr_panel_kernel, s, c, 1, smem, A, as0, as1, mm,
                           w, bw, P, T, smem / (int)sizeof(float));
}
