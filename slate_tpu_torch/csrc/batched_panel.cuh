// The ragged batched panel step of K7 (lu_panel_batched.cu): K3's
// left-looking step over a batch of problems, each computing only its own
// live row tiles (the reference's _lu_panel_batched_kernel,
// slate_tpu/internal/pallas_lu.py:228).
//
//   col  [B, M, NB]  A[:, k0:, k0:k0+nb]     left [B, M, K]  A[:, k0:, :k0]
//   lead [B, K, NB]  the packed U block column A[:, :k0, k0:k0+nb]
//                    (storage T, any strides)
//   tiles [B] int32  live tile counts: row tile i of problem b is live iff
//                    k + i < tiles[b]
//   upd  [B, M, NB]  col - left @ lead, the pre-factor panel (storage T)
//   fac  [B, M, NB]  row tile 0 factored (packed L\U), the live tiles below
//                    it upd @ U^-1 (U = triu of the LU tile)
//   uinv [B, NB, NB] f32 scratch: U^-1 of each live problem
//
// A dead tile is copied from col into upd and fac bit for bit and reads no
// left: identity-augmented packing makes the input its own factor there.
// T is f32 or bf16; loads widen to f32, every sum and the whole tile factor
// run in f32, and only the stores round (storage.cuh). U^-1 is formed from
// the f32 factor, as the reference carries it in f32 scratch.
//
// The hazard: the Pallas grid runs (b, i, j) in order, carrying the K-sum in
// one VMEM scratch and U^-1 from row tile 0 to the later tiles in another.
// CUDA blocks run in no order, so per problem the step is two launches on
// one stream, with U^-1 handed over in global memory:
//   (a) panel_batched_diag: one block of 256 threads a problem: the update
//       of row tile 0 over the whole K loop, the LU in shared memory, then
//       U^-1 with K0's back substitution (tri_inv.cuh);
//   (b) panel_batched_below: one block of 128 threads per (32-row strip,
//       problem): its update over the whole K loop, then upd @ U^-1.
// Launch (b) only exists when M > NB. Liveness is read on the device from
// tiles; the host never reads it back.
#pragma once

#include "common.cuh"
#include "gemm_acc.cuh"
#include "lu_factor.cuh"
#include "storage.cuh"
#include "tri_inv.cuh"

namespace batched_panel {

constexpr int STRIP = 32;  // rows of a below-diagonal block

// One operand of a problem: element (r, c) of problem b at
// p[b * sb + r * s0 + c * s1].
template <class T>
struct Operand {
  const T* p;
  long long sb, s0, s1;
};

template <class T>
struct Args {
  Operand<T> col, left, lead;
  const int* tiles;
  int k, K, M, bw;
  T* upd;       // [B, M, NB] row-major
  T* fac;       // [B, M, NB] row-major
  float* uinv;  // [B, NB, NB] row-major
};

// Rows row0 .. row0+rows-1 of problem b's col into upd and fac, bit for bit.
template <class T, int NB>
__device__ inline void copy_dead(const Args<T>& a, int b, long long row0,
                                 int rows) {
  const T* col = a.col.p + b * a.col.sb;
  const long long out0 = ((long long)b * a.M + row0) * NB;
  for (int idx = threadIdx.x; idx < rows * NB; idx += blockDim.x) {
    const int r = idx / NB, c = idx % NB;
    const T* src = col + (row0 + r) * a.col.s0 + c * a.col.s1;
    copy_bits(a.upd + out0 + idx, src);
    copy_bits(a.fac + out0 + idx, src);
  }
}

// Shared memory of launch (a), in floats: the tile, the staging slices, U^-1
// and lu_factor_smem's scratch.
__host__ __device__ inline size_t diag_smem_floats(int nb, int bw) {
  return (size_t)nb * (nb + 1) * 2 + (size_t)nb * (KC + 1) +
         (size_t)KC * (nb + 1) + (size_t)bw * (bw + 1) +
         (size_t)(nb - bw) * bw;
}

template <int NB>
constexpr size_t below_smem_bytes() {
  return sizeof(float) * (STRIP * (KC + 1) + KC * (NB + 1) + STRIP * (NB + 1));
}

// (a): row tile 0 of problem blockIdx.x.
template <class T, int NB>
__global__ void __launch_bounds__(256) panel_batched_diag(Args<T> a) {
  constexpr int TY = 16, RM = NB / TY, CN = NB / 16, LDS = NB + 1;
  const int b = blockIdx.x;
  if (a.k >= a.tiles[b]) {  // the whole problem is past its last tile
    copy_dead<T, NB>(a, b, 0, NB);
    return;
  }
  extern __shared__ float smem[];
  float* S = smem;                 // NB x LDS: upd_0, then its factor
  float* X = S + NB * LDS;         // NB x LDS: U^-1
  float* As = X + NB * LDS;        // NB x (KC+1)
  float* Bs = As + NB * (KC + 1);  // KC x (NB+1)
  float* Dinv = Bs + KC * (NB + 1);            // bw x (bw+1)
  float* Tt = Dinv + a.bw * (a.bw + 1);        // (NB-bw) x bw
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* col = a.col.p + b * a.col.sb;
  const long long out0 = (long long)b * a.M * NB;
  float acc[RM][CN] = {};
  gemm_acc<T, RM, CN, TY>(acc, a.left.p + b * a.left.sb, a.left.s0,
                          a.left.s1, a.lead.p + b * a.lead.sb, a.lead.s0,
                          a.lead.s1, a.K, As, Bs);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = ty + i * TY, c = tx + j * 16;
      const float v = to_f32(col[r * a.col.s0 + c * a.col.s1]) - acc[i][j];
      a.upd[out0 + r * NB + c] = from_f32<T>(v);
      S[r * LDS + c] = v;
    }
  }
  __syncthreads();
  lu_factor_smem(S, LDS, NB, a.bw, Dinv, Tt);
  upper_tri_inv_smem(S, LDS, 1, X, LDS, NB);  // U = triu of the packed tile
  __syncthreads();
  float* uinv = a.uinv + (long long)b * NB * NB;
  for (int idx = threadIdx.x; idx < NB * NB; idx += blockDim.x) {
    const int r = idx / NB, c = idx % NB;
    a.fac[out0 + idx] = from_f32<T>(S[r * LDS + c]);
    uinv[idx] = X[r * LDS + c];
  }
}

// (b): rows NB + STRIP*blockIdx.x .. +STRIP of problem blockIdx.y.
template <class T, int NB>
__global__ void __launch_bounds__(128) panel_batched_below(Args<T> a) {
  constexpr int TY = 8, RM = STRIP / TY, CN = NB / 16, LDP = NB + 1;
  const int b = blockIdx.y;
  const long long row0 = NB + (long long)STRIP * blockIdx.x;
  if (a.k + row0 / NB >= a.tiles[b]) {  // a dead row tile
    copy_dead<T, NB>(a, b, row0, STRIP);
    return;
  }
  extern __shared__ float smem[];
  float* As = smem;                   // STRIP x (KC+1)
  float* Bs = As + STRIP * (KC + 1);  // KC x (NB+1)
  float* Ps = Bs + KC * (NB + 1);     // STRIP x LDP: this strip of upd, f32
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* col = a.col.p + b * a.col.sb;
  const long long out0 = (long long)b * a.M * NB;
  float acc[RM][CN] = {};
  gemm_acc<T, RM, CN, TY>(acc, a.left.p + b * a.left.sb + row0 * a.left.s0,
                          a.left.s0, a.left.s1, a.lead.p + b * a.lead.sb,
                          a.lead.s0, a.lead.s1, a.K, As, Bs);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int r = ty + i * TY, c = tx + j * 16;
      const float v =
          to_f32(col[(row0 + r) * a.col.s0 + c * a.col.s1]) - acc[i][j];
      a.upd[out0 + (row0 + r) * NB + c] = from_f32<T>(v);
      Ps[r * LDP + c] = v;
      acc[i][j] = 0.f;
    }
  }
  // fac strip = Ps @ U^-1, U^-1 staged KC rows at a time
  const float* uinv = a.uinv + (long long)b * NB * NB;
  for (int k0 = 0; k0 < NB; k0 += KC) {
    for (int idx = tid; idx < KC * NB; idx += 128) {
      const int k = idx / NB, c = idx % NB;
      Bs[k * (NB + 1) + c] = uinv[(k0 + k) * NB + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float x[RM], y[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) x[i] = Ps[(ty + i * TY) * LDP + k0 + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) y[j] = Bs[k * (NB + 1) + tx + j * 16];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      a.fac[out0 + (row0 + ty + i * TY) * NB + tx + j * 16] =
          from_f32<T>(acc[i][j]);
    }
  }
}

inline bool shape_ok(int nb, int bw) {
  return (nb == 32 || nb == 64 || nb == 96 || nb == 128) && bw >= 1 &&
         nb % bw == 0;
}

// *fits = 1 when a panel of width nb at slab width bw fits: nb in {32, 64,
// 96, 128} (an 8 x 8 register tile a thread at 128), bw divides nb, and
// launch (a)'s shared memory within one block's opt-in limit; else 0.
inline int fits(int device, int nb, int bw, int* out) {
  int limit = 0;
  SLATE_RETURN_IF_ERROR(cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  *out = shape_ok(nb, bw) &&
         sizeof(float) * diag_smem_floats(nb, bw) <= (size_t)limit;
  return 0;
}

template <class T, int NB>
int launch_nb(bool below, int B, const Args<T>& a, cudaStream_t s) {
  if (!below) {
    const size_t smem = sizeof(float) * diag_smem_floats(NB, a.bw);
    SLATE_SET_SMEM((panel_batched_diag<T, NB>), smem);
    panel_batched_diag<T, NB><<<B, 256, smem, s>>>(a);
  } else {
    constexpr size_t smem = below_smem_bytes<NB>();
    SLATE_SET_SMEM((panel_batched_below<T, NB>), smem);
    const dim3 grid((a.M - NB) / STRIP, B);
    panel_batched_below<T, NB><<<grid, 128, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_t(bool below, int B, int nb, const Args<T>& a, cudaStream_t s) {
  switch (nb) {
    case 32: return launch_nb<T, 32>(below, B, a, s);
    case 64: return launch_nb<T, 64>(below, B, a, s);
    case 96: return launch_nb<T, 96>(below, B, a, s);
    case 128: return launch_nb<T, 128>(below, B, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch of the step: (a) when below is 0, (b) otherwise (M > nb, a
// multiple of nb). bf16 is 0 for f32 storage, 1 for bf16; strides in
// elements. Past the shape limits the launch is refused with an error code.
inline int launch(int device, void* stream, int bf16, int below,
                  const void* col, long long cb, long long cs0, long long cs1,
                  const void* left, long long lb, long long ls0,
                  long long ls1, const void* lead, long long db,
                  long long ds0, long long ds1, const int* tiles, int B,
                  int k, int K, int M, int nb, int bw, void* upd, void* fac,
                  float* uinv) {
  SLATE_SET_DEVICE(device);
  if (!shape_ok(nb, bw) || B < 1 || M < nb || M % nb ||
      (below && M == nb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    const Args<T> a{{static_cast<const T*>(col), cb, cs0, cs1},
                    {static_cast<const T*>(left), lb, ls0, ls1},
                    {static_cast<const T*>(lead), db, ds0, ds1},
                    tiles, k, K, M, bw, static_cast<T*>(upd),
                    static_cast<T*>(fac), uinv};
    return launch_t<T>(below, B, nb, a, s);
  }
  using T = float;
  const Args<T> a{{static_cast<const T*>(col), cb, cs0, cs1},
                  {static_cast<const T*>(left), lb, ls0, ls1},
                  {static_cast<const T*>(lead), db, ds0, ds1},
                  tiles, k, K, M, bw, static_cast<T*>(upd),
                  static_cast<T*>(fac), uinv};
  return launch_t<T>(below, B, nb, a, s);
}

}  // namespace batched_panel
