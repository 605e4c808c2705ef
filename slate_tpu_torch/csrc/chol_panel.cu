// K2: one fused left-looking Cholesky panel step, the port of
// chol_panel_fused (slate_tpu/internal/pallas_chol.py:162, pallas_call at
// :180, kernel at :120-158).
//
//   col  [M, nb]  A[k0:, k0:k0+nb]       left [M, K]  A[k0:, :k0]
//   lead [K, nb]  A[k0:k0+nb, :k0]^T     (all f32, any strides)
//   upd = col - left @ lead              the pre-factor panel
//   fac = [L00; L21]: L00 = chol(upd_0), L21 = upd_below @ U^-1, U = L00^T
//
// The hazard: the Pallas grid runs in order, carrying the K-sum in one VMEM
// scratch and U^-1 from row tile 0 to the later row tiles in another. CUDA
// blocks run in no order, so the K loop runs inside each block and the U^-1
// hand-off goes through global memory between launches on one stream:
//   (a) chol_panel_diag:  one block of 256 threads forms upd_0 and writes it,
//       factors it in shared memory (the column loop of K1, chol_factor.cuh)
//       and writes L00;
//   then, when there are rows below, the wrapper launches K0 (tri_inv.cu) on
//   U = L00^T, which writes U^-1 to a tile of its own;
//   (b) chol_panel_below: one block of 128 threads per 32-row strip of the
//       rows below forms its upd strip over the whole K loop, writes it, and
//       writes fac = upd_strip @ U^-1.
// K0 runs as its own launch, not inside (a), so that each kernel's launch
// count is the launches its own wrapper made.
// The Pallas version pads K with zeros to a multiple of nb; here the staging
// loads mask the ragged end of K instead, and K = 0 skips the loop. left and
// lead are strided views of the factor being built (lead is a transpose), so
// each load walks whichever index is unit-stride.
//
// Bound on this card: 2 M K nb flops of the update plus nb^3/3 + (M - nb)
// nb^2 of the factor and the triangular solve, against the bytes of col,
// left, lead, upd and fac read or written once. With K >= nb it is bound by
// f32 operations: the products run as FFMA on the CUDA cores (the reference
// asks for Precision.HIGHEST, so never TF32), at most 67 TFLOP/s.
//
// Design: each block stages KC = 32 deep slices of its left rows and of lead
// in shared memory (padded so that every load and read is free of bank
// conflicts) and keeps its output tile in registers: 8 x 8 values a thread
// in (a), 4 x nb/16 in (b). Launch (a) is a single block: its update and
// factor run on one SM while the rest of the card waits, which is the first
// thing to remove in a faster version (split the diagonal update over
// blocks, then wgmma/TMA for the products).
#include "chol_factor.cuh"
#include "common.cuh"
#include "gemm_acc.cuh"

template <int NB>
constexpr size_t diag_smem_bytes() {
  return sizeof(float) * (NB * (NB + 1) + NB * (KC + 1) + KC * (NB + 1));
}

// (a): upd_0 and L00 from row tile 0 (rows 0 .. NB-1 of col/left).
template <int NB>
__global__ void __launch_bounds__(256)
chol_panel_diag_kernel(const float* __restrict__ col, long long cs0,
                       long long cs1, const float* __restrict__ left,
                       long long ls0, long long ls1,
                       const float* __restrict__ lead, long long ds0,
                       long long ds1, int K, int bw, float* __restrict__ upd,
                       float* __restrict__ fac) {
  constexpr int TY = 16, RM = NB / TY, CN = NB / 16, LDS = NB + 1;
  extern __shared__ float smem[];
  float* S = smem;                 // NB x LDS: upd_0, then L00
  float* As = S + NB * LDS;        // NB x (KC+1)
  float* Bs = As + NB * (KC + 1);  // KC x (NB+1)
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[RM][CN] = {};
  gemm_acc<float, RM, CN, TY>(acc, left, ls0, ls1, lead, ds0, ds1, K, As,
                              Bs);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = ty + i * TY, c = tx + j * 16;
      const float v = col[r * cs0 + c * cs1] - acc[i][j];
      upd[r * NB + c] = v;
      S[r * LDS + c] = v;
    }
  }
  __syncthreads();
  chol_factor_smem(S, LDS, NB, bw);
  for (int idx = threadIdx.x; idx < NB * NB; idx += blockDim.x) {
    fac[idx] = S[(idx / NB) * LDS + idx % NB];
  }
}

constexpr int STRIP = 32;  // rows of the below-diagonal panel per block

template <int NB>
constexpr size_t below_smem_bytes() {
  return sizeof(float) * (STRIP * (KC + 1) + KC * (NB + 1) + STRIP * (NB + 1));
}

// (b): rows NB + STRIP*blockIdx.x .. +STRIP of upd and fac.
template <int NB>
__global__ void __launch_bounds__(128)
chol_panel_below_kernel(const float* __restrict__ col, long long cs0,
                        long long cs1, const float* __restrict__ left,
                        long long ls0, long long ls1,
                        const float* __restrict__ lead, long long ds0,
                        long long ds1, int K, const float* __restrict__ uinv,
                        float* __restrict__ upd, float* __restrict__ fac) {
  constexpr int TY = 8, RM = STRIP / TY, CN = NB / 16, LDP = NB + 1;
  extern __shared__ float smem[];
  float* As = smem;                   // STRIP x (KC+1)
  float* Bs = As + STRIP * (KC + 1);  // KC x (NB+1)
  float* Ps = Bs + KC * (NB + 1);     // STRIP x LDP: this strip of upd
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row0 = NB + (long long)STRIP * blockIdx.x;
  float acc[RM][CN] = {};
  gemm_acc<float, RM, CN, TY>(acc, left + row0 * ls0, ls0, ls1, lead, ds0,
                              ds1, K, As, Bs);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = ty + i * TY, c = tx + j * 16;
      const float v = col[(row0 + r) * cs0 + c * cs1] - acc[i][j];
      upd[(row0 + r) * NB + c] = v;
      Ps[r * LDP + c] = v;
      acc[i][j] = 0.f;
    }
  }
  // fac strip = Ps @ U^-1, U^-1 staged KC rows at a time
  for (int k0 = 0; k0 < NB; k0 += KC) {
    for (int idx = tid; idx < KC * NB; idx += 128) {
      const int k = idx / NB, c = idx % NB;
      Bs[k * (NB + 1) + c] = uinv[(k0 + k) * NB + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Ps[(ty + i * TY) * LDP + k0 + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = Bs[k * (NB + 1) + tx + j * 16];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      fac[(row0 + ty + i * TY) * NB + tx + j * 16] = acc[i][j];
    }
  }
}

template <int NB>
int launch_diag(cudaStream_t stream, const float* col, long long cs0,
                long long cs1, const float* left, long long ls0, long long ls1,
                const float* lead, long long ds0, long long ds1, int K, int bw,
                float* upd, float* fac) {
  constexpr size_t smem = diag_smem_bytes<NB>();
  SLATE_SET_SMEM(chol_panel_diag_kernel<NB>, smem);
  chol_panel_diag_kernel<NB><<<1, 256, smem, stream>>>(
      col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, bw, upd, fac);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_below(cudaStream_t stream, const float* col, long long cs0,
                 long long cs1, const float* left, long long ls0,
                 long long ls1, const float* lead, long long ds0,
                 long long ds1, int K, int M, const float* uinv, float* upd,
                 float* fac) {
  constexpr size_t smem = below_smem_bytes<NB>();
  SLATE_SET_SMEM(chol_panel_below_kernel<NB>, smem);
  const int blocks = (M - NB) / STRIP;
  chol_panel_below_kernel<NB><<<blocks, 128, smem, stream>>>(
      col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, uinv, upd, fac);
  return static_cast<int>(cudaGetLastError());
}

// nb in {32, 64, 96, 128}; upd and fac are [M, nb] row-major. Launch (a)
// writes rows 0 .. nb-1 of both.
extern "C" int slate_chol_panel_diag(int device, void* stream,
                                     const float* col, long long cs0,
                                     long long cs1, const float* left,
                                     long long ls0, long long ls1,
                                     const float* lead, long long ds0,
                                     long long ds1, int K, int nb, int bw,
                                     float* upd, float* fac) {
  SLATE_SET_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 32: return launch_diag<32>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, bw, upd, fac);
    case 64: return launch_diag<64>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, bw, upd, fac);
    case 96: return launch_diag<96>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, bw, upd, fac);
    case 128: return launch_diag<128>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, bw, upd, fac);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch (b) over rows nb .. M-1; M is a multiple of nb and M > nb; uinv is
// U^-1 as K0 writes it, [nb, nb] row-major.
extern "C" int slate_chol_panel_below(int device, void* stream,
                                      const float* col, long long cs0,
                                      long long cs1, const float* left,
                                      long long ls0, long long ls1,
                                      const float* lead, long long ds0,
                                      long long ds1, int K, int nb, int M,
                                      const float* uinv, float* upd,
                                      float* fac) {
  SLATE_SET_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 32: return launch_below<32>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, M, uinv, upd, fac);
    case 64: return launch_below<64>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, M, uinv, upd, fac);
    case 96: return launch_below<96>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, M, uinv, upd, fac);
    case 128: return launch_below<128>(s, col, cs0, cs1, left, ls0, ls1, lead, ds0, ds1, K, M, uinv, upd, fac);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
