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
#include "common.cuh"
#include "qr_panel.cuh"

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(const float* __restrict__ A, long long as0, long long as1,
                int mm, int w, int bw, float* P, float* __restrict__ T,
                int smem_floats) {
  extern __shared__ float smem[];
  qr_panel_cluster(A, as0, as1, mm, w, bw, P, P, T, smem, smem_floats);
}

// *fits = 1 when this kernel takes a [mm, w] panel at slab width bw on this
// device: 1 <= w <= 128 (four columns a lane), mm >= w, 1 <= bw <= 8, and
// rank 0's T with the scratch (qr_panel_smem_floats) within one block's
// opt-in shared memory; else 0. Rows that do not fit in shared memory stay
// in global memory, so mm has no limit here; the size cap is the caller's
// routing policy.
extern "C" int slate_qr_panel_fits(int device, int mm, int w, int bw,
                                   int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = qr_panel_shape_ok(mm, w, bw) &&
          sizeof(float) * qr_panel_smem_floats(w, bw) <= (size_t)limit;
  return 0;
}

// *c = the cluster size a launch for a [mm, w] panel takes on this device.
extern "C" int slate_qr_panel_cluster(int device, int mm, int w, int bw,
                                      int* c) {
  SLATE_SET_DEVICE(device);
  int resident = 0, smem = 0;
  return qr_prepare_cluster(qr_panel_kernel, device, mm, w, bw, c, &resident,
                            &smem);
}

// One launch for one panel, within slate_qr_panel_fits's limits (past them
// the launch is refused with an error code). P [mm, w] and T [w, w] are
// row-major outputs.
extern "C" int slate_qr_panel(int device, void* stream, const float* A,
                              long long as0, long long as1, int mm, int w,
                              int bw, float* P, float* T) {
  SLATE_SET_DEVICE(device);
  int c = 1, resident = 0, smem = 0;
  const int e = qr_prepare_cluster(qr_panel_kernel, device, mm, w, bw, &c,
                                   &resident, &smem);
  if (e != 0) return e;
  return qr_launch_cluster(qr_panel_kernel, static_cast<cudaStream_t>(stream),
                           c, 1, smem, A, as0, as1, mm, w, bw, P, T,
                           smem / (int)sizeof(float));
}
