// K8: the ragged batched Householder panel, the port of qr_panel_batched
// (slate_tpu/internal/pallas_qr.py:142, pallas_call at :154, kernel
// _qr_panel_batched_kernel at :98). One launch a panel step, one block of
// QR_THREADS threads a problem, each running K5's per-panel routine
// qr_panel_block (qr_panel.cuh, which says what is computed and how).
//
//   a      [B, mm, w] f32 or bf16, any strides; rows [B] int32
//   packed [B, mm, w], T [B, w, w] in a's storage type, row-major
//   work   [B, mm, w] f32: the column loop's working panel. For f32 storage
//          it is packed itself; for bf16 the wrapper allocates it, 4 B mm w
//          bytes (16 MB at [8, 4096, 128]), and the block rounds it into
//          packed at the end.
//
// Raggedness is by whole problem, as in the reference: identity-augmented
// padding columns own real reflectors, so a live problem factors its whole
// bucket panel; rows[b] == 0 (a filler slot) copies a into packed bit for
// bit and writes T = 0. The block reads rows[b] on the device.
//
// Bound on this card: per live problem 3 mm w^2 - w^3 flops (K5's count)
// against a read once and packed and T written once. What binds it is K5's
// latency chain of w dependent column steps on one SM: B problems run on B
// of the 132 SMs at once, each at K5's speed.
#include "common.cuh"
#include "qr_panel.cuh"

template <class T>
__global__ void __launch_bounds__(QR_THREADS)
qr_panel_batched_kernel(const T* __restrict__ A, long long ab, long long as0,
                        long long as1, const int* __restrict__ rows, int mm,
                        int w, int bw, float* work, T* packed,
                        T* __restrict__ Tout) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const long long panel = (long long)mm * w;
  A += b * ab;
  packed += b * panel;
  Tout += (long long)b * w * w;
  if (rows[b] == 0) {
    for (long long i = threadIdx.x; i < panel; i += QR_THREADS) {
      copy_bits(packed + i, A + (i / w) * as0 + (i % w) * as1);
    }
    for (int i = threadIdx.x; i < w * w; i += QR_THREADS) {
      Tout[i] = from_f32<T>(0.f);
    }
    return;
  }
  float* P = work + b * panel;
  qr_panel_block(A, as0, as1, mm, w, bw, P, Tout, smem);
  if (static_cast<void*>(P) != static_cast<void*>(packed)) {
    __syncthreads();
    for (long long i = threadIdx.x; i < panel; i += QR_THREADS) {
      packed[i] = from_f32<T>(P[i]);
    }
  }
}

// *fits = 1 when K8 takes [*, mm, w] panels at slab width bw: K5's limits
// (qr_panel_shape_ok) and T with its scratch within one block's opt-in
// shared memory; else 0.
extern "C" int slate_qr_panel_batched_fits(int device, int mm, int w, int bw,
                                           int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = qr_panel_shape_ok(mm, w, bw) &&
          sizeof(float) * qr_panel_smem_floats(w, bw) <= (size_t)limit;
  return 0;
}

template <class T>
int launch(cudaStream_t s, const void* a, long long ab, long long as0,
           long long as1, const int* rows, int B, int mm, int w, int bw,
           float* work, void* packed, void* t) {
  const size_t smem = sizeof(float) * qr_panel_smem_floats(w, bw);
  SLATE_SET_SMEM(qr_panel_batched_kernel<T>, smem);
  qr_panel_batched_kernel<T><<<B, QR_THREADS, smem, s>>>(
      static_cast<const T*>(a), ab, as0, as1, rows, mm, w, bw, work,
      static_cast<T*>(packed), static_cast<T*>(t));
  return static_cast<int>(cudaGetLastError());
}

// One launch for a batch of panels, within slate_qr_panel_batched_fits's
// limits (past them the launch is refused with an error code). bf16 is 0
// for f32 storage (work == packed), 1 for bf16; strides in elements.
extern "C" int slate_qr_panel_batched(int device, void* stream, int bf16,
                                      const void* a, long long ab,
                                      long long as0, long long as1,
                                      const int* rows, int B, int mm, int w,
                                      int bw, float* work, void* packed,
                                      void* t) {
  SLATE_SET_DEVICE(device);
  if (!qr_panel_shape_ok(mm, w, bw) || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(s, a, ab, as0, as1, rows, B, mm, w, bw, work,
                                 packed, t);
  }
  return launch<float>(s, a, ab, as0, as1, rows, B, mm, w, bw, work, packed,
                       t);
}
