// The staged product of K7's update (batched_panel.cuh): a block's output
// tile of A @ B over a K loop, with KC-deep slices of A and B staged in
// shared memory and the sum in f32 registers. A and B are f32 or bf16 in
// memory (storage.cuh), any strides.
#pragma once

#include "storage.cuh"

constexpr int KC = 32;  // depth of the K slice staged in shared memory

// acc[i][j] += sum_{k < K} A(ty + i*TY, k) * B(k, tx + 16*j), widened to
// f32, with A(r, k) = A[r*as0 + k*as1] and B(k, c) = B[k*bs0 + c*bs1] in
// global memory. The block has 16*TY threads (tx = tid % 16, ty = tid / 16)
// and covers a BM x NB tile, BM = RM*TY, NB = 16*CN. As holds BM x (KC+1)
// floats, Bs KC x (NB+1) (padded so that every load and read is free of bank
// conflicts); the staging loads walk whichever index is unit-stride, and the
// ragged end of K reads as 0.
template <class T, int RM, int CN, int TY>
__device__ inline void gemm_acc(float (&acc)[RM][CN], const T* __restrict__ A,
                                long long as0, long long as1,
                                const T* __restrict__ B, long long bs0,
                                long long bs1, int K, float* As, float* Bs) {
  constexpr int BM = RM * TY, NB = CN * 16, NT = 16 * TY;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += KC) {
    if (as1 == 1) {
      for (int idx = tid; idx < BM * KC; idx += NT) {
        const int r = idx / KC, k = idx % KC;
        As[r * (KC + 1) + k] =
            (k0 + k < K) ? to_f32(A[r * as0 + (k0 + k)]) : 0.f;
      }
    } else {
      for (int idx = tid; idx < BM * KC; idx += NT) {
        const int r = idx % BM, k = idx / BM;
        As[r * (KC + 1) + k] =
            (k0 + k < K) ? to_f32(A[r * as0 + (k0 + k) * as1]) : 0.f;
      }
    }
    if (bs1 == 1) {
      for (int idx = tid; idx < KC * NB; idx += NT) {
        const int k = idx / NB, c = idx % NB;
        Bs[k * (NB + 1) + c] =
            (k0 + k < K) ? to_f32(B[(k0 + k) * bs0 + c]) : 0.f;
      }
    } else {
      for (int idx = tid; idx < KC * NB; idx += NT) {
        const int k = idx % KC, c = idx / KC;
        Bs[k * (NB + 1) + c] =
            (k0 + k < K) ? to_f32(B[(k0 + k) * bs0 + c * bs1]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float a[RM], b[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[(ty + i * TY) * (KC + 1) + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = Bs[k * (NB + 1) + tx + j * 16];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}
