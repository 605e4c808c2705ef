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
//
// At the reference's wider panels, w = 256, 384 and 512 (its route takes
// min(plan.nb, bucket), slate_tpu/serve/batched.py:245, and its kernel any
// multiple of 128 up to 512, pallas_qr.py:142-152), each live problem's
// cluster runs K5's wide routine (qr_panel.cuh qr_panel_wide_cluster:
// 128-column blocks, T in device memory), the cluster size chosen as for a
// 128-column panel of mm rows. Its scratch comes from the wrapper, one
// slice a problem (qr_batched_work_floats): the routine's workspace and, on
// bf16 storage, the f32 working panel and T, which are rounded into packed
// and T only at the end.
#include <type_traits>

#include "common.cuh"
#include "qr_panel.cuh"

// A filler slot (rows[b] == 0): packed = a bit for bit, each CTA of the
// cluster its own rows, and T = 0; the whole cluster calls it.
template <class T>
__device__ inline void qr_filler(const T* A, long long as0, long long as1,
                                 int mm, int w, T* packed, T* Tout) {
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
}

// The scratch of one problem, in floats: narrow (w <= 128) the f32 working
// panel on bf16 storage (none on f32: packed is the working panel); wide
// the routine's workspace, after the f32 working panel and T on bf16.
__host__ __device__ inline long long qr_batched_work_floats(int bf16, int mm,
                                                          int w) {
  if (w <= QRW_B) return bf16 ? (long long)mm * w : 0;
  return qr_wide_work_floats(mm, w) +
         (bf16 ? (long long)mm * w + (long long)w * w : 0);
}

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
    qr_filler(A, as0, as1, mm, w, packed, Tout);
    return;
  }
  qr_panel_cluster(A, as0, as1, mm, w, bw, work + b * panel, packed, Tout,
                   smem, smem_floats);
}

// w = 256 .. 512: problem blockIdx.y on its cluster by the wide routine;
// work holds qr_batched_work_floats(bf16, mm, w) floats a problem.
template <class T>
__global__ void __launch_bounds__(QR_THREADS)
qr_panel_batched_wide_kernel(const T* __restrict__ A, long long ab,
                             long long as0, long long as1,
                             const int* __restrict__ rows, int mm, int w,
                             int bw, float* work, T* packed,
                             T* __restrict__ Tout, int smem_floats) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const long long panel = (long long)mm * w;
  A += b * ab;
  packed += b * panel;
  Tout += (long long)b * w * w;
  if (rows[b] == 0) {                  // the whole cluster takes this branch
    qr_filler(A, as0, as1, mm, w, packed, Tout);
    return;
  }
  float* wk = work + b * qr_batched_work_floats(!f32, mm, w);
  float* pf = reinterpret_cast<float*>(packed);
  float* tf = reinterpret_cast<float*>(Tout);
  if (!f32) {                          // the f32 panel and T, then rounded
    pf = wk;
    tf = pf + panel;
    wk = tf + (long long)w * w;
  }
  qr_panel_wide_cluster(A, as0, as1, mm, w, bw, pf, tf, wk, smem,
                        smem_floats);
  if (f32) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int gt = (int)cluster.block_rank() * QR_THREADS + threadIdx.x;
  qrw_sync(cluster, C);
  for (long long idx = gt; idx < panel; idx += C * QR_THREADS)
    packed[idx] = from_f32<T>(__ldcg(pf + idx));
  for (int idx = gt; idx < w * w; idx += C * QR_THREADS)
    Tout[idx] = from_f32<T>(__ldcg(tf + idx));
}

// *fits = 1 when K8 takes [*, mm, w] panels at slab width bw: K5's limits
// (w <= 128, qr_panel_shape_ok, or w in {256, 384, 512} by 128-column
// blocks, qr_wide_shape_ok; mm >= w, 1 <= bw <= 8) and rank 0's T with the
// scratch (of a 128-column block past 128) within one block's opt-in shared
// memory; else 0.
extern "C" int slate_qr_panel_batched_fits(int device, int mm, int w, int bw,
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

// *floats = the f32 scratch a launch for B panels [mm, w] takes
// (qr_batched_work_floats a problem; 0 for f32 storage up to w = 128).
extern "C" int slate_qr_panel_batched_work(int device, int bf16, int B,
                                           int mm, int w, int* floats) {
  (void)device;
  const long long f = B * qr_batched_work_floats(bf16, mm, w);
  if (f > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *floats = (int)f;
  return 0;
}

// The kernel (the wide one past w = 128) and its cluster for panels
// [mm, w] in storage T: the wide kernel's cluster chosen as for a
// 128-column panel of mm rows.
template <class T>
int qr_batched_prepare(int device, int mm, int w, int bw, int* c,
                       int* resident, int* smem) {
  if (w > QRW_B) {
    if (!qr_wide_shape_ok(mm, w, bw)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return qr_prepare_cluster(qr_panel_batched_wide_kernel<T>, device, mm,
                              QRW_B, bw, c, resident, smem);
  }
  return qr_prepare_cluster(qr_panel_batched_kernel<T>, device, mm, w, bw, c,
                            resident, smem);
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
    return qr_batched_prepare<__nv_bfloat16>(device, mm, w, bw, c, resident,
                                             &smem);
  }
  return qr_batched_prepare<float>(device, mm, w, bw, c, resident, &smem);
}

template <class T>
int launch(int device, cudaStream_t s, const void* a, long long ab,
           long long as0, long long as1, const int* rows, int B, int mm,
           int w, int bw, float* work, void* packed, void* t) {
  int c = 1, resident = 0, smem = 0;
  const int e = qr_batched_prepare<T>(device, mm, w, bw, &c, &resident,
                                      &smem);
  if (e != 0) return e;
  auto kernel = w > QRW_B ? qr_panel_batched_wide_kernel<T>
                          : qr_panel_batched_kernel<T>;
  return qr_launch_cluster(kernel, s, c, B, smem, static_cast<const T*>(a),
                           ab, as0, as1, rows, mm, w, bw, work,
                           static_cast<T*>(packed), static_cast<T*>(t),
                           smem / (int)sizeof(float));
}

// One launch for a batch of panels, within slate_qr_panel_batched_fits's
// limits (past them the launch is refused with an error code). bf16 is 0
// for f32 storage, 1 for bf16; strides in elements; work holds
// slate_qr_panel_batched_work floats (packed itself for f32 storage up to
// w = 128).
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
