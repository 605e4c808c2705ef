// K8: the ragged batched Householder panel, the port of qr_panel_batched
// (slate_tpu/internal/pallas_qr.py:142, pallas_call at :154, kernel
// _qr_panel_batched_kernel at :98). One launch a panel step: a grid of B
// clusters of C CTAs, one cluster a problem, each running K5's per-panel
// routine qr_panel_cluster (qr_panel.cuh, which says what is computed and
// how a panel's rows are split over the cluster).
//
//   a      [B, mm, w] f32 or bf16, any strides; rows [B] int32
//   packed [B, mm, w], T [B, w, w] in a's storage type, row-major
//   work   [B, mm, w] f32: the working copy of the rows that do not fit in
//          shared memory. For f32 storage it is packed itself; for bf16 the
//          wrapper allocates it, 4 B mm w bytes (16 MB at [8, 4096, 128]),
//          and every row is rounded into packed at the end.
//
// Raggedness is by whole problem, as in the reference: identity-augmented
// padding columns own real reflectors, so a live problem factors its whole
// bucket panel; rows[b] == 0 (a filler slot) copies a into packed bit for
// bit, each CTA of the cluster its own rows, and writes T = 0. The cluster
// reads rows[b] on the device.
//
// Bound on this card: per live problem 3 mm w^2 - w^3 flops (K5's count)
// against a read once and packed and T written once. What binds it is K5's
// latency chain of w dependent column steps. The first port ran each
// problem on one SM, 8 of the 132 SMs busy at B = 8; here each problem's
// rows spread over a cluster. C depends on mm alone (qr_prepare_cluster),
// so a problem gets the same bits in a batch of any size, the serving
// path's retry of one request alone included. Where B clusters do not fit
// on the card at once they run in waves: an H100 holds fewer than eight
// clusters of 16, so [8, 4096, 128] (C = 16, 256 rows a CTA) takes two.
#include "common.cuh"
#include "qr_panel.cuh"

template <class T>
__global__ void __launch_bounds__(QR_THREADS)
qr_panel_batched_kernel(const T* __restrict__ A, long long ab, long long as0,
                        long long as1, const int* __restrict__ rows, int mm,
                        int w, int bw, float* work, T* packed,
                        T* __restrict__ Tout, int smem_floats) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const long long panel = (long long)mm * w;
  A += b * ab;
  packed += b * panel;
  Tout += (long long)b * w * w;
  if (rows[b] == 0) {                  // the whole cluster takes this branch
    const int C = gridDim.x, rank = blockIdx.x;
    const int per = (mm + C - 1) / C;
    const int r1 = min(mm, (rank + 1) * per);
    const int lane = threadIdx.x & 31;
    for (int r = rank * per + (threadIdx.x >> 5); r < r1; r += QR_WARPS) {
      for (int c = lane; c < w; c += 32) {
        copy_bits(packed + (long long)r * w + c, A + r * as0 + c * as1);
      }
    }
    if (rank == 0) {
      for (int i = threadIdx.x; i < w * w; i += QR_THREADS) {
        Tout[i] = from_f32<T>(0.f);
      }
    }
    return;
  }
  qr_panel_cluster(A, as0, as1, mm, w, bw, work + b * panel, packed, Tout,
                   smem, smem_floats);
}

// *fits = 1 when K8 takes [*, mm, w] panels at slab width bw: K5's limits
// (qr_panel_shape_ok) and rank 0's T with the scratch within one block's
// opt-in shared memory; else 0.
extern "C" int slate_qr_panel_batched_fits(int device, int mm, int w, int bw,
                                           int* fits) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = qr_panel_shape_ok(mm, w, bw) &&
          sizeof(float) * qr_panel_smem_floats(w, bw) <= (size_t)limit;
  return 0;
}

// *c = the cluster size a launch for panels [mm, w] takes on this device,
// *resident = how many such clusters the card holds at once (bf16: 0 for
// f32 storage, 1 for bf16).
extern "C" int slate_qr_panel_batched_cluster(int device, int bf16, int mm,
                                              int w, int bw, int* c,
                                              int* resident) {
  SLATE_SET_DEVICE(device);
  int smem = 0;
  if (bf16) {
    return qr_prepare_cluster(qr_panel_batched_kernel<__nv_bfloat16>, device,
                              mm, w, bw, c, resident, &smem);
  }
  return qr_prepare_cluster(qr_panel_batched_kernel<float>, device, mm, w, bw,
                            c, resident, &smem);
}

template <class T>
int launch(int device, cudaStream_t s, const void* a, long long ab,
           long long as0, long long as1, const int* rows, int B, int mm,
           int w, int bw, float* work, void* packed, void* t) {
  int c = 1, resident = 0, smem = 0;
  const int e = qr_prepare_cluster(qr_panel_batched_kernel<T>, device, mm, w,
                                   bw, &c, &resident, &smem);
  if (e != 0) return e;
  return qr_launch_cluster(qr_panel_batched_kernel<T>, s, c, B, smem,
                           static_cast<const T*>(a), ab, as0, as1, rows, mm,
                           w, bw, work, static_cast<T*>(packed),
                           static_cast<T*>(t), smem / (int)sizeof(float));
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(device, s, a, ab, as0, as1, rows, B, mm, w,
                                 bw, work, packed, t);
  }
  return launch<float>(device, s, a, ab, as0, as1, rows, B, mm, w, bw, work,
                       packed, t);
}
