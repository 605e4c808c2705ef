// K5: the Householder QR panel with its compact-WY T, the port of
// qr_panel_pallas (slate_tpu/internal/pallas_qr.py:123, pallas_call at :129,
// column loop _qr_panel_steps at :43). One launch a panel, one block of
// QR_THREADS threads running qr_panel_block (qr_panel.cuh, which says what
// is computed and how the column loop is blocked).
//
// Bound on this card: 2 mm w^2 - 2 w^3 / 3 flops for the panel (plus about
// mm w^2 for T) against 4 mm w bytes read and written once: ~w / 2 = 64
// flops a byte at w = 128, above the f32 ridge (20), so bound by
// operations if the whole card worked on it. It does not: a panel is a
// chain of w dependent column steps, each a reduction over all its rows,
// and one block on one of the 132 SMs carries them, its passes over the
// L2-resident panel bound by L2 latency. The port's gate (internal/qr.py)
// keeps panels of more than 2^20 elements off this kernel: past the 50 MB
// L2 every pass would go to HBM, and CholQR2 reconstruction reads such a
// panel only about 8 times. Splitting the rows of a panel over a thread
// block cluster is the way to a faster version.
#include "common.cuh"
#include "qr_panel.cuh"

__global__ void __launch_bounds__(QR_THREADS)
qr_panel_kernel(const float* __restrict__ A, long long as0, long long as1,
                int mm, int w, int bw, float* P, float* __restrict__ T) {
  extern __shared__ float smem[];
  qr_panel_block(A, as0, as1, mm, w, bw, P, T, smem);
}

// *fits = 1 when this kernel takes a [mm, w] panel at slab width bw on this
// device: 1 <= w <= 128 (four columns a lane), mm >= w, 1 <= bw <= 8, and
// T with its scratch (qr_panel_smem_floats) within one block's opt-in
// shared memory; else 0. The panel itself lives in global memory, so mm has
// no limit here; the size cap is the caller's routing policy.
extern "C" int slate_qr_panel_fits(int device, int mm, int w, int bw,
                                   int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = qr_panel_shape_ok(mm, w, bw) &&
          sizeof(float) * qr_panel_smem_floats(w, bw) <= (size_t)limit;
  return 0;
}

// One launch for one panel, within slate_qr_panel_fits's limits (past them
// the launch is refused with an error code). P [mm, w] and T [w, w] are
// row-major outputs.
extern "C" int slate_qr_panel(int device, void* stream, const float* A,
                              long long as0, long long as1, int mm, int w,
                              int bw, float* P, float* T) {
  SLATE_SET_DEVICE(device);
  if (!qr_panel_shape_ok(mm, w, bw)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * qr_panel_smem_floats(w, bw);
  SLATE_SET_SMEM(qr_panel_kernel, smem);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qr_panel_kernel<<<1, QR_THREADS, smem, s>>>(A, as0, as1, mm, w, bw, P, T);
  return static_cast<int>(cudaGetLastError());
}
