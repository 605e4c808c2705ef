// K3: the fused no-pivot LU panel, the port of lu_panel_fused
// (slate_tpu/internal/pallas_lu.py:210, pallas_call at :217; the tile factor
// _lu_factor_in_place at :137 and the kernel _lu_panel_kernel at :192).
//
//   panel [W, nb] f32, any strides, W % nb == 0
//   out   [W, nb] row-major, packed L\U with the unit lower diagonal implied:
//         row tile 0 is its own unpivoted LU, the rows below are
//         panel rows @ U^-1 with U = triu(tile 0)
//
// The hazard is K2's: the Pallas grid runs in order and hands U^-1 from row
// tile 0 to the later row tiles in VMEM scratch. CUDA blocks run in no order,
// so the hand-off goes through global memory between two launches on one
// stream:
//   (a) lu_panel_factor: one block of 256 threads copies row tile 0 into
//       shared memory, factors it there (lu_factor.cuh: 32-column blocks, a
//       warp a diagonal block in registers, 8 block barriers at nb = 128),
//       writes it and, when W > nb, forms U^-1 by K0's blocked doubling in
//       the same launch and writes it to a tile of its own. K7's factor
//       launch runs the same body (lu_factor_launch) once a problem;
//   (b) lu_panel_below (W > nb): one CTA of 128 threads per 128 rows below
//       the tile forms out = panel rows @ U^-1 by the solve body of K2
//       (panel_gemm.cuh pg_solve_rows: a 16 x 8 register tile a thread, a
//       three-deep cp.async ring where the panel's strides allow 16-byte
//       copies, plain loads otherwise), skipping U^-1's zero lower part.
//
// Bound on this card: 2 nb^3 / 3 flops for the tile's LU and (W - nb) nb^2
// for L21 = A21 U^-1 as a triangular solve, against 4 * 2 W nb bytes (the
// panel read once, the factor written once): (W - nb) nb^2 / (8 W nb) ~
// nb / 8 = 16 flops a byte at nb = 128, below the f32 ridge of 67 TFLOP/s /
// 3.35 TB/s = 20, so bound by bytes. The products are FFMA on the CUDA
// cores (the reference asks for Precision.HIGHEST, so never TF32); the
// strips' product with U^-1 takes 20/32 of a full product's FMAs.
//
// At the reference's wider panels, nb = 256, 384 and 512 (slate_tpu/
// internal/getrf.py:67-75), the top block no longer fits one block's
// shared memory, and the two launches keep their roles:
//   (a) one thread-block cluster copies the top nb x nb into out's top
//       rows and factors it there by 128-column diagonal blocks, each in
//       lu_factor.cuh's one-block routine on one CTA with a lookahead over
//       the cluster (wide_factor.cuh wf_lu); then, in a second launch of
//       the same call, K0's wide route forms U^-1 of the packed L\U
//       (tri_inv_wide.cuh, reading U's upper triangle through its
//       strides);
//   (b) one CTA per (128-row tile, 128-column tile) of the rows below
//       multiplies by that U^-1 (wide_factor.cuh wf_solve_kernel), summing
//       only over U^-1's rows down to the column tile's end.
#include "common.cuh"
#include "lu_factor.cuh"
#include "panel_gemm.cuh"
#include "tri_inv_wide.cuh"
#include "wide_factor.cuh"

// (a): row tile 0 of the panel, factored, into rows 0 .. nb-1 of out; U^-1
// into uinv unless it is null.
__global__ void __launch_bounds__(LF_THREADS)
lu_panel_factor_kernel(const float* __restrict__ p, long long ps0,
                       long long ps1, int nb, int bw, float* __restrict__ out,
                       float* __restrict__ uinv) {
  extern __shared__ __align__(16) float smem[];
  // 16-byte loads where rows are unit-stride and 16-byte aligned
  const bool quads = ps1 == 1 && ps0 % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(p) % 16 == 0;
  lu_factor_launch(
      nb, bw,
      [&](int r, int c) {
        const float* e = p + r * ps0 + c * ps1;
        return quads ? *reinterpret_cast<const float4*>(e)
                     : make_float4(e[0], e[ps1], e[2 * ps1], e[3 * ps1]);
      },
      [&](int r, int c, float4 v) {
        *reinterpret_cast<float4*>(out + r * nb + c) = v;
      },
      uinv, smem);
}

// (b): out rows NB + 128 blockIdx.x .. + 128 = panel rows @ U^-1, the panel
// staged as MODE says (a template argument: a run-time mode spills the
// cp.async path's registers at NB = 128).
template <int NB, int MODE>
__global__ void __launch_bounds__(PanelGemm<NB>::THREADS)
lu_panel_below_kernel(const float* __restrict__ p, long long ps0,
                      long long ps1, int W, const float* __restrict__ uinv,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const long long row0 = NB + (long long)blockIdx.x * PG_BM;
  const int rows = (int)min((long long)PG_BM, W - row0);
  pg_solve_rows<NB>(p + row0 * ps0, ps0, ps1, MODE, rows, uinv,
                    out + row0 * NB, smem);
}

template <int NB, int MODE>
int launch_below_as(cudaStream_t stream, const float* p, long long ps0,
                    long long ps1, int W, const float* uinv, float* out) {
  constexpr size_t smem = sizeof(float) * PanelGemm<NB>::SMEM_FLOATS;
  SLATE_SET_SMEM((lu_panel_below_kernel<NB, MODE>), smem);
  const int blocks = (W - NB + PG_BM - 1) / PG_BM;
  lu_panel_below_kernel<NB, MODE><<<blocks, PanelGemm<NB>::THREADS, smem,
                                    stream>>>(p, ps0, ps1, W, uinv, out);
  return static_cast<int>(cudaGetLastError());
}

// (b) stages the panel by 16-byte cp.async copies where it is unit-stride
// along its columns with aligned rows, else by plain loads.
template <int NB>
int launch_below(cudaStream_t stream, const float* p, long long ps0,
                 long long ps1, int W, const float* uinv, float* out) {
  return staged_by_copy(p, ps1, ps0)
             ? launch_below_as<NB, PG_COPY16>(stream, p, ps0, ps1, W, uinv,
                                              out)
             : launch_below_as<NB, PG_LOADS>(stream, p, ps0, ps1, W, uinv,
                                             out);
}

static bool panel_nb_ok(int nb) {
  return nb == 32 || nb == 64 || nb == 96 || nb == 128;
}

// (a) at nb = 256 .. 512, one cluster: out's top nb x nb = the panel's top
// block, factored in place by wf_lu (work: 2 (nb / 128 - 1) slots of 128 x
// 128 for the diagonal blocks' inverses, then nb x nb for K0's T when U^-1
// follows in a second launch, tri_inv_wide.cuh).
__global__ void __launch_bounds__(WFC_THREADS)
lu_panel_factor_wide_kernel(const float* __restrict__ p, long long ps0,
                            long long ps1, int nb, int bw,
                            float* __restrict__ out, float* __restrict__ work,
                            long long* stamps) {
  extern __shared__ __align__(16) float smem[];
  const int rank = wf_rank(), ctas = wf_ctas();
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = ctas * blockDim.x;
  if (ps1 == 1 && ps0 % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    // 16-byte moves, several a thread in flight
    const int q = nb / 4;
#pragma unroll 4
    for (int idx = first; idx < nb * q; idx += stride) {
      const int r = idx / q, c = 4 * (idx % q);
      *reinterpret_cast<float4*>(out + r * nb + c) =
          *reinterpret_cast<const float4*>(p + r * ps0 + c);
    }
  } else {
    for (int idx = first; idx < nb * nb; idx += stride) {
      out[idx] = p[(idx / nb) * ps0 + (idx % nb) * ps1];
    }
  }
  wf_lu(out, nb, nb, bw, work, smem, stamps);
}

// (a) at nb = 256 .. 512: the factor's cluster, then, when uinv is not
// null, U^-1 of the packed L\U's upper triangle by K0's wide route on
// the same stream (its stamps after wf_lu's when stamps is not null).
static int launch_factor_wide(int device, cudaStream_t stream, const float* p,
                              long long ps0, long long ps1, int nb, int bw,
                              float* out, float* uinv, float* work,
                              long long* stamps) {
  const int e = wfc_launch(lu_panel_factor_wide_kernel, stream, device, 1, p,
                           ps0, ps1, nb, bw, out, work, stamps);
  if (e != 0 || uinv == nullptr) return e;
  long long* k0 = stamps == nullptr
                      ? nullptr
                      : stamps + (nb / WF_T + 1) * WFL_STAMP_ROW;
  return ti_launch_wide(stream,
                        ti_args_packed(out, nb, 0, uinv, 0,
                                       work + 2 * nb * WF_T, 0, nb, nullptr,
                                       0, k0),
                        1);
}

// *fits = 1 when K3 takes a panel of width nb at slab width bw on this
// device: bw divides nb, and nb in {32, 64, 96, 128} (whole 32-column
// blocks, at most the 128 columns of (b)'s tile) with (a)'s shared memory
// within one block's opt-in limit, or nb in {256, 384, 512} with bw
// dividing 128 (a slab inside one diagonal block) where the card places
// the wide factor's cluster; else 0.
extern "C" int slate_lu_panel_fits(int device, int nb, int bw, int* fits) {
  SLATE_SET_DEVICE(device);
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *fits = bw >= 1 && nb % bw == 0 &&
          ((panel_nb_ok(nb) && lu_factor_launch_bytes(nb) <= (size_t)limit) ||
           (wf_panel_nb(nb) && WF_T % bw == 0));
  if (*fits && nb > 128) {
    const int e = wfc_fits(lu_panel_factor_wide_kernel, device, fits);
    if (e == 0 && *fits) {
      return cluster_fits(upper_tri_inv_wide_kernel, device, TI_CLUSTER,
                          TI_THREADS, TI_SMEM_BYTES, fits);
    }
    return e;
  }
  return 0;
}

// *floats = the scratch launch (a) takes at width nb (0 up to 128).
extern "C" int slate_lu_panel_work(int device, int nb, int* floats) {
  *floats = nb > 128 ? 2 * nb * WF_T + nb * nb : 0;
  return 0;
}

// Launch (a), within slate_lu_panel_fits; out is [W, nb] row-major and (a)
// writes its rows 0 .. nb-1; uinv is [nb, nb] row-major scratch for (b), or
// null when W == nb; work holds slate_lu_panel_work(nb) floats (null up to
// 128).
extern "C" int slate_lu_panel_factor(int device, void* stream, const float* p,
                                     long long ps0, long long ps1, int nb,
                                     int bw, float* out, float* uinv,
                                     float* work) {
  SLATE_SET_DEVICE(device);
  if (wf_panel_nb(nb)) {
    if (bw < 1 || WF_T % bw || work == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_factor_wide(device, static_cast<cudaStream_t>(stream), p,
                              ps0, ps1, nb, bw, out, uinv, work, nullptr);
  }
  if (!panel_nb_ok(nb) || bw < 1 || nb % bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = lu_factor_launch_bytes(nb);
  SLATE_SET_SMEM(lu_panel_factor_kernel, smem);
  lu_panel_factor_kernel<<<1, LF_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      p, ps0, ps1, nb, bw, out, uinv);
  return static_cast<int>(cudaGetLastError());
}

// Launch (b) over rows nb .. W-1 (W a multiple of nb, W > nb); uinv is U^-1
// as (a) writes it.
extern "C" int slate_lu_panel_below(int device, void* stream, const float* p,
                                    long long ps0, long long ps1, int nb,
                                    int W, const float* uinv, float* out) {
  SLATE_SET_DEVICE(device);
  if (W <= nb || W % nb) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wf_panel_nb(nb)) {
    return staged_by_copy(p, ps1, ps0)
               ? wf_launch_solve<PG_COPY16>(s, p, ps0, ps1, W, nb, uinv, out)
               : wf_launch_solve<PG_LOADS>(s, p, ps0, ps1, W, nb, uinv, out);
  }
  switch (nb) {
    case 32: return launch_below<32>(s, p, ps0, ps1, W, uinv, out);
    case 64: return launch_below<64>(s, p, ps0, ps1, W, uinv, out);
    case 96: return launch_below<96>(s, p, ps0, ps1, W, uinv, out);
    case 128: return launch_below<128>(s, p, ps0, ps1, W, uinv, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How (b) stages this panel: *staging = 1 for cp.async, 0 for plain loads.
extern "C" int slate_lu_panel_plan(int device, const float* p, long long ps0,
                                   long long ps1, int* staging) {
  SLATE_SET_DEVICE(device);
  *staging = staged_by_copy(p, ps1, ps0);
  return 0;
}

// The wide factor launch (a) once with globaltimer stamps (stamps: int64,
// zeroed: (nb / 128 + 1) rows of WFL_STAMP_ROW for wf_lu, then TI_CLUSTER x
// TI_STAMPS for K0's launch when uinv is not null; *cluster = the factor's
// CTAs): for chip_smoke.py's split of K3's time. The wrapper never calls
// it; the results are slate_lu_panel_factor's, bit for bit.
extern "C" int slate_lu_panel_trace(int device, void* stream, const float* p,
                                    long long ps0, long long ps1, int nb,
                                    int bw, float* out, float* uinv,
                                    float* work, long long* stamps,
                                    int* cluster) {
  SLATE_SET_DEVICE(device);
  if (!wf_panel_nb(nb) || bw < 1 || WF_T % bw || work == nullptr ||
      stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = wfc_cluster(lu_panel_factor_wide_kernel, device, 1, cluster);
  if (e != 0) return e;
  return launch_factor_wide(device, static_cast<cudaStream_t>(stream), p,
                            ps0, ps1, nb, bw, out, uinv, work, stamps);
}
