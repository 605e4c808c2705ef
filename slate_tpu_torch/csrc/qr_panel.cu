// K5: the Householder QR panel with its compact-WY T, the port of
// qr_panel_pallas (slate_tpu/internal/pallas_qr.py:123, pallas_call at :129,
// column loop _qr_panel_steps at :43). One launch a panel: one cluster of C
// CTAs running qr_panel_cluster (qr_panel.cuh, which says what is computed,
// how the rows are split and how the column loop is blocked).
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
// a lane become 8-16. So the wide kernel (qr_panel_wide_kernel) mirrors
// the reference's blocked panel (_householder_blocked_rec,
// slate_tpu/internal/qr.py:191) by 128-column blocks, in one launch: the
// packed panel is built in place in the output, T in device memory, and
// per block b (columns c0 = 128 b .. c0 + 127, rows c0 .. mm - 1):
//   - the cluster factors the block with qr_panel_cluster at w = 128 (its
//     rows from the output, its T_b and packed block to the workspace),
//     and the block goes back into the output, T_b onto T's diagonal;
//   - the T merge (past the first block), T[:c0, block] = -T[:c0, :c0]
//     (V_left^T V_b) T_b: Z = V_b^T V_left, each CTA summing its share of
//     the rows (16-row slices staged in shared memory, a thread an 8 x 6
//     tile), the partials summed in rank order through the workspace; Y =
//     T_b^T Z; T12 = -T[:c0, :c0] Y^T, one output a thread over the
//     cluster;
//   - (but for the last block) the block's slabs applied in turn to the
//     columns right of it, A_right -= V_s T_s^T (V_s^T A_right): each CTA
//     its rows, the partials of V_s^T A_right summed in rank order. This
//     is the update that one slab loop over the whole panel would make
//     (and the first port's w <= 128 loop makes); a 128-column compact WY
//     at once rounds differently, past the reference's 1e-5 on the packed
//     panel at [1024, 512].
// Every sum runs in a fixed order and there are no atomics, so a launch
// repeats bit for bit; every product is an f32 FMA (no TF32). Writes that
// another CTA reads are fenced around a cluster barrier and read through
// L2 (__ldcg). The plain version (qr_kernels.qr_panel_plain) takes the same
// blocks.
#include "common.cuh"
#include "qr_panel.cuh"

constexpr int QRW_B = QR_MAX_W;    // a wide panel's column block
constexpr int QRW_MAX_W = 512;     // the widest panel
constexpr int QRW_ROWS = 16;       // rows of a staged slice in the Z pass
constexpr int QRW_ZC = 192;        // columns of one Z pass

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(const float* __restrict__ A, long long as0, long long as1,
                int mm, int w, int bw, float* P, float* __restrict__ T,
                int smem_floats) {
  extern __shared__ float smem[];
  qr_panel_cluster(A, as0, as1, mm, w, bw, P, P, T, smem, smem_floats);
}

// The panels the wide kernel takes: w in {256, 384, 512}, mm >= w, 1 <= bw
// <= 8.
inline bool qr_wide_shape_ok(int mm, int w, int bw) {
  return w > QRW_B && w <= QRW_MAX_W && w % QRW_B == 0 && mm >= w &&
         bw >= 1 && bw <= QR_MAX_BW;
}

// The wide kernel's workspace, in floats: the block's packed rows [mm, 128]
// (the routine's P), T_b [128, 128], the CTAs' partial Z [16][128][w], Z and
// Y [128][w] each.
inline long long qr_wide_work_floats(int mm, int w) {
  return (long long)mm * QRW_B + QRW_B * QRW_B +
         (long long)(QR_MAX_CLUSTER + 2) * QRW_B * w;
}

// The barrier between the wide kernel's steps (see the note above).
__device__ inline void qrw_sync(const cg::cluster_group& cluster, int C) {
  __threadfence();
  qr_sync(cluster, C);
  __threadfence();
}

// V_b(r, i) of block c0 for row r >= c0 of the packed output (leading
// dimension w): unit lower.
__device__ inline float qrw_v(const float* out, int w, int c0, int r, int i) {
  const int rr = r - c0;
  return rr > i ? __ldcg(out + (size_t)r * w + c0 + i)
                : (rr == i ? 1.f : 0.f);
}

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_wide_kernel(const float* __restrict__ A, long long as0,
                     long long as1, int mm, int w, int bw, float* out,
                     float* T, float* work, int smem_floats) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gt = rank * QR_THREADS + tid, gn = C * QR_THREADS;
  float* Pb = work;                               // [mm, 128]
  float* Tb = Pb + (size_t)mm * QRW_B;            // [128, 128]
  float* Zp = Tb + QRW_B * QRW_B;                 // [16][128][w]
  float* Z = Zp + (size_t)QR_MAX_CLUSTER * QRW_B * w;   // [128][w]
  float* Y = Z + (size_t)QRW_B * w;               // [128][w]
  // the panel into the output (f32, row-major), T = 0
  for (long long idx = gt; idx < (long long)mm * w; idx += gn) {
    const long long r = idx / w, c = idx % w;
    out[idx] = A[r * as0 + c * as1];
  }
  for (int idx = gt; idx < w * w; idx += gn) T[idx] = 0.f;
  for (int c0 = 0; c0 < w; c0 += QRW_B) {
    const int mb = mm - c0;                       // the block's rows
    qrw_sync(cluster, C);
    qr_panel_cluster<float, float, float>(out + (size_t)c0 * w + c0, w, 1,
                                          mb, QRW_B, bw, Pb, Pb, Tb, smem,
                                          smem_floats);
    qrw_sync(cluster, C);
    for (long long idx = gt; idx < (long long)mb * QRW_B; idx += gn) {
      const long long r = idx / QRW_B, c = idx % QRW_B;
      out[(c0 + r) * w + c0 + c] = __ldcg(Pb + idx);
    }
    for (int idx = gt; idx < QRW_B * QRW_B; idx += gn)
      T[(size_t)(c0 + idx / QRW_B) * w + c0 + idx % QRW_B] = __ldcg(Tb + idx);
    qrw_sync(cluster, C);
    const int per = (mb + C - 1) / C;
    const int rb = c0 + min(mb, rank * per), re = c0 + min(mb, rank * per + per);
    if (c0 > 0) {
      // ---- the T merge. Zp[rank] = V_b^T V_left over this CTA's rows of the
      // block (V_left: the output's columns c < c0, all below their
      // diagonal there)
      const int ti = tid & 15, tc = tid >> 4;
      float* Vs = smem;                              // [16][128]
      float* Xs = Vs + QRW_ROWS * QRW_B;             // [16][QRW_ZC]
      for (int oc0 = 0; oc0 < c0; oc0 += QRW_ZC) {
        const int ncp = min(QRW_ZC, c0 - oc0);
        float acc[8][6];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 6; ++q) acc[a][q] = 0.f;
        for (int r0 = rb; r0 < re; r0 += QRW_ROWS) {
          __syncthreads();
          for (int idx = tid; idx < QRW_ROWS * QRW_B; idx += QR_THREADS) {
            const int r = r0 + idx / QRW_B, i = idx % QRW_B;
            Vs[idx] = r < re ? qrw_v(out, w, c0, r, i) : 0.f;
          }
          for (int idx = tid; idx < QRW_ROWS * QRW_ZC; idx += QR_THREADS) {
            const int r = r0 + idx / QRW_ZC, o = idx % QRW_ZC;
            Xs[idx] = (r < re && o < ncp)
                          ? __ldcg(out + (size_t)r * w + oc0 + o)
                          : 0.f;
          }
          __syncthreads();
          for (int rr = 0; rr < QRW_ROWS; ++rr) {
            float v[8], x[6];
#pragma unroll
            for (int a = 0; a < 8; ++a) v[a] = Vs[rr * QRW_B + ti + 16 * a];
#pragma unroll
            for (int q = 0; q < 6; ++q) x[q] = Xs[rr * QRW_ZC + tc + 32 * q];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
              for (int q = 0; q < 6; ++q)
                acc[a][q] = fmaf(v[a], x[q], acc[a][q]);
          }
        }
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          const int o = tc + 32 * q;
          if (o >= ncp) continue;
#pragma unroll
          for (int a = 0; a < 8; ++a)
            Zp[((size_t)rank * QRW_B + ti + 16 * a) * w + oc0 + o] =
                acc[a][q];
        }
      }
      qrw_sync(cluster, C);
      // Z: the C partials in rank order; Y = T_b^T Z, Y[i, l] = sum_{k <= i}
      // T_b[k, i] Z[k, l]
      for (int idx = gt; idx < QRW_B * c0; idx += gn) {
        const int i = idx / c0, l = idx % c0;
        float s = 0.f;
        for (int q = 0; q < C; ++q)
          s += __ldcg(Zp + ((size_t)q * QRW_B + i) * w + l);
        Z[(size_t)i * w + l] = s;
      }
      qrw_sync(cluster, C);
      for (int idx = gt; idx < QRW_B * c0; idx += gn) {
        const int i = idx / c0, l = idx % c0;
        float s = 0.f;
        for (int k = 0; k <= i; ++k)
          s = fmaf(__ldcg(Tb + k * QRW_B + i), __ldcg(Z + (size_t)k * w + l),
                   s);
        Y[(size_t)i * w + l] = s;
      }
      qrw_sync(cluster, C);
      // T[k, c0 + i] = -sum_{l = k}^{c0 - 1} T[k, l] Y[i, l], k < c0
      for (int idx = gt; idx < c0 * QRW_B; idx += gn) {
        const int k = idx / QRW_B, i = idx % QRW_B;
        float s = 0.f;
        for (int l = k; l < c0; ++l)
          s = fmaf(__ldcg(T + (size_t)k * w + l),
                   __ldcg(Y + (size_t)i * w + l), s);
        T[(size_t)k * w + c0 + i] = -s;
      }
    }
    // ---- the columns right of the block, A_right -= V_s T_s^T V_s^T
    // A_right, one slab s of the block after another (the update one slab
    // loop over the whole panel would make): a thread takes the columns
    // lane-group cl + 128 k of the rows r = group + 4 t of the CTA's share
    const int R = w - c0 - QRW_B, cr = c0 + QRW_B;
    if (R == 0) break;
    const int grp = tid >> 7, cl = tid & 127;
    float* Zs = smem;                                 // [8][R]
    float* Ys = Zs + QR_MAX_BW * R;                   // [8][R]
    float* red = Ys + QR_MAX_BW * R;                  // [4][8][R]
    for (int s0 = c0; s0 < c0 + QRW_B; s0 += bw) {
      const int nbs = min(bw, c0 + QRW_B - s0), sl = s0 - c0;
      float* zp = Zp + (size_t)((s0 / bw) & 1) * QR_MAX_CLUSTER * QR_MAX_BW * w;
      const int r1 = max(rb, s0);   // V_s is zero above row s0
      float acc[3][QR_MAX_BW];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i) acc[k][i] = 0.f;
      for (int r = r1 + grp; r < re; r += 4) {
        float v[QR_MAX_BW];
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          v[i] = i < nbs ? qrw_v(out, w, c0, r, sl + i) : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = cl + 128 * k;
          if (c >= R) continue;
          const float x = __ldcg(out + (size_t)r * w + cr + c);
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i) acc[k][i] = fmaf(v[i], x, acc[k][i]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int c = cl + 128 * k;
        if (c >= R) continue;
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          red[(grp * QR_MAX_BW + i) * R + c] = acc[k][i];
      }
      __syncthreads();
      // the CTA's partial, the four row groups summed in order
      for (int idx = tid; idx < QR_MAX_BW * R; idx += QR_THREADS) {
        const float s = red[idx] + red[QR_MAX_BW * R + idx] +
                        red[2 * QR_MAX_BW * R + idx] +
                        red[3 * QR_MAX_BW * R + idx];
        zp[(size_t)rank * QR_MAX_BW * w + idx] = s;
      }
      qrw_sync(cluster, C);
      // Z_s: the C partials in rank order; Y_s = T_s^T Z_s
      for (int idx = tid; idx < nbs * R; idx += QR_THREADS) {
        float s = 0.f;
        for (int q = 0; q < C; ++q)
          s += __ldcg(zp + (size_t)q * QR_MAX_BW * w + idx);
        Zs[idx] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < nbs * R; idx += QR_THREADS) {
        const int i = idx / R, c = idx % R;
        float s = 0.f;
        for (int k = 0; k <= i; ++k)
          s = fmaf(__ldcg(Tb + (sl + k) * QRW_B + sl + i), Zs[k * R + c], s);
        Ys[idx] = s;
      }
      __syncthreads();
      float y[3][QR_MAX_BW];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i) {
          const int c = cl + 128 * k;
          y[k][i] = (i < nbs && c < R) ? Ys[i * R + c] : 0.f;
        }
      for (int r = r1 + grp; r < re; r += 4) {
        float v[QR_MAX_BW];
#pragma unroll
        for (int i = 0; i < QR_MAX_BW; ++i)
          v[i] = i < nbs ? qrw_v(out, w, c0, r, sl + i) : 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int c = cl + 128 * k;
          if (c >= R) continue;
          float a = 0.f;
#pragma unroll
          for (int i = 0; i < QR_MAX_BW; ++i) a = fmaf(v[i], y[k][i], a);
          float* e = out + (size_t)r * w + cr + c;
          *e = __ldcg(e) - a;
        }
      }
      __syncthreads();
    }
  }
  // no CTA may leave while another can still read its shared memory
  qr_sync(cluster, C);
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
              (size_t)limit;
  return 0;
}

// *floats = the workspace a [mm, w] panel takes: 0 at w <= 128, else the
// wide kernel's (qr_wide_work_floats).
extern "C" int slate_qr_panel_work(int device, int mm, int w, int* floats) {
  (void)device;
  const long long f = w > QRW_B ? qr_wide_work_floats(mm, w) : 0;
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
    return qr_prepare_cluster(qr_panel_wide_kernel, device, mm, QRW_B, bw, c,
                              resident, smem);
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
    if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return qr_launch_cluster(qr_panel_wide_kernel, s, c, 1, smem, A, as0,
                             as1, mm, w, bw, P, T, work,
                             smem / (int)sizeof(float));
  }
  return qr_launch_cluster(qr_panel_kernel, s, c, 1, smem, A, as0, as1, mm,
                           w, bw, P, T, smem / (int)sizeof(float));
}
