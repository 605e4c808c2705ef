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

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(const float* __restrict__ A, long long as0, long long as1,
                int mm, int w, int bw, float* P, float* __restrict__ T,
                int smem_floats) {
  extern __shared__ float smem[];
  qr_panel_cluster(A, as0, as1, mm, w, bw, P, P, T, smem, smem_floats);
}

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_wide_kernel(const float* __restrict__ A, long long as0,
                     long long as1, int mm, int w, int bw, float* out,
                     float* T, float* work, int smem_floats) {
  extern __shared__ float smem[];
  qr_panel_wide_cluster(A, as0, as1, mm, w, bw, out, T, work, smem,
                        smem_floats);
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
