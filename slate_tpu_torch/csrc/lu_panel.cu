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
// so the hand-off goes through global memory between launches on one stream:
//   (a) lu_panel_diag: one block of 256 threads copies row tile 0 into shared
//       memory, factors it there (lu_factor_smem) and writes it;
//   then, when W > nb, the wrapper launches K0 (tri_inv.cu) on triu(tile 0),
//   which writes U^-1 to a tile of its own;
//   (b) lu_panel_below: one block of 128 threads per 32-row strip of the rows
//       below stages its strip in shared memory and writes strip @ U^-1.
// K0 runs as its own launch, so that each kernel's launch count is the
// launches its own wrapper made.
//
// Bound on this card: 2 nb^3 / 3 flops for the tile, nb^3 / 3 for U^-1 and
// 2 (W - nb) nb^2 for the rows below, against 4 * 2 W nb bytes (the panel read
// once, the factor written once): 2 nb / 8 = 32 flops a byte at nb = 128,
// above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so bound by f32
// operations. The products are FFMA on the CUDA cores (the reference asks for
// Precision.HIGHEST, so never TF32).
//
// Design: the tile's column loop runs in bw-row slabs as the reference's does
// (the slab's rows eliminate against themselves; the tile's rows below the
// slab get the block solve against the slab's U^-1, then one rank-bw trailing
// update), all in shared memory (lu_factor_smem, lu_factor.cuh). Launch (a)
// is one block on one SM while the rest of the card waits, which is what a
// faster version removes first; (b) is the strip shape of K2's second launch.
#include "common.cuh"
#include "lu_factor.cuh"
#include "tri_inv.cuh"

static size_t diag_smem_bytes(int nb, int bw) {
  return sizeof(float) * ((size_t)nb * (nb + 1) + (size_t)bw * (bw + 1) +
                          (size_t)(nb - bw) * bw);
}

// (a): row tile 0 of the panel, factored, into rows 0 .. nb-1 of out.
__global__ void __launch_bounds__(256)
lu_panel_diag_kernel(const float* __restrict__ p, long long ps0, long long ps1,
                     int nb, int bw, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lds = nb + 1;
  float* S = smem;                 // nb x lds: the tile
  float* Dinv = S + nb * lds;      // bw x (bw + 1): the slab's D^-1
  float* T = Dinv + bw * (bw + 1); // (nb - bw) x bw: l21 of the slab
  for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
    const int r = idx / nb, c = idx % nb;
    S[r * lds + c] = p[r * ps0 + c * ps1];
  }
  __syncthreads();
  lu_factor_smem(S, lds, nb, bw, Dinv, T);
  for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
    out[idx] = S[(idx / nb) * lds + idx % nb];
  }
}

constexpr int STRIP = 32;  // rows below the tile per block
constexpr int KC = 32;     // rows of U^-1 staged in shared memory at a time

template <int NB>
constexpr size_t below_smem_bytes() {
  return sizeof(float) * (STRIP * (NB + 1) + KC * (NB + 1));
}

// (b): rows NB + STRIP * blockIdx.x .. + STRIP of out = panel rows @ U^-1.
// Each of the 128 threads keeps a 4 x NB/16 tile of the product in registers.
template <int NB>
__global__ void __launch_bounds__(128)
lu_panel_below_kernel(const float* __restrict__ p, long long ps0,
                      long long ps1, const float* __restrict__ uinv,
                      float* __restrict__ out) {
  constexpr int TY = 8, RM = STRIP / TY, CN = NB / 16, LDP = NB + 1;
  extern __shared__ float smem[];
  float* Ps = smem;                 // STRIP x LDP: this strip of the panel
  float* Bs = Ps + STRIP * LDP;     // KC x (NB + 1): a slice of U^-1
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row0 = NB + (long long)STRIP * blockIdx.x;
  for (int idx = tid; idx < STRIP * NB; idx += 128) {
    const int r = idx / NB, c = idx % NB;
    Ps[r * LDP + c] = p[(row0 + r) * ps0 + c * ps1];
  }
  float acc[RM][CN] = {};
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
      out[(row0 + ty + i * TY) * NB + tx + j * 16] = acc[i][j];
    }
  }
}

template <int NB>
int launch_below(cudaStream_t stream, const float* p, long long ps0,
                 long long ps1, int W, const float* uinv, float* out) {
  constexpr size_t smem = below_smem_bytes<NB>();
  SLATE_SET_SMEM(lu_panel_below_kernel<NB>, smem);
  lu_panel_below_kernel<NB><<<(W - NB) / STRIP, 128, smem, stream>>>(
      p, ps0, ps1, uinv, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch (a): nb <= 128, nb % bw == 0; out is [W, nb] row-major and (a)
// writes its rows 0 .. nb-1.
extern "C" int slate_lu_panel_diag(int device, void* stream, const float* p,
                                   long long ps0, long long ps1, int nb,
                                   int bw, float* out) {
  SLATE_SET_DEVICE(device);
  if (nb < 1 || nb > 128 || bw < 1 || nb % bw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = diag_smem_bytes(nb, bw);
  SLATE_SET_SMEM(lu_panel_diag_kernel, smem);
  lu_panel_diag_kernel<<<1, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      p, ps0, ps1, nb, bw, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch (b) over rows nb .. W-1 (W a multiple of nb, W > nb); uinv is U^-1
// as K0 writes it, [nb, nb] row-major.
extern "C" int slate_lu_panel_below(int device, void* stream, const float* p,
                                    long long ps0, long long ps1, int nb,
                                    int W, const float* uinv, float* out) {
  SLATE_SET_DEVICE(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 32: return launch_below<32>(s, p, ps0, ps1, W, uinv, out);
    case 64: return launch_below<64>(s, p, ps0, ps1, W, uinv, out);
    case 96: return launch_below<96>(s, p, ps0, ps1, W, uinv, out);
    case 128: return launch_below<128>(s, p, ps0, ps1, W, uinv, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
