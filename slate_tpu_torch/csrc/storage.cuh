// Storage types of the batched serving kernels (K6 chol_panel_batched, K7
// lu_panel_batched, K8 qr_panel_batched): f32 or bf16 in memory, f32 in
// every sum. Loads widen to f32, stores round to nearest even (as a
// PyTorch or JAX cast does), and a dead tile is copied as raw storage bits,
// never through f32 arithmetic: x - 0 * y is not x when y is NaN.
#pragma once

#include <cuda_bf16.h>

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The unsigned integer of a storage element's width, for bit copies.
template <class T> struct StorageBits;
template <> struct StorageBits<float> { using type = unsigned int; };
template <> struct StorageBits<__nv_bfloat16> { using type = unsigned short; };

// dst[i] = src[i], bit for bit.
template <class T>
__device__ inline void copy_bits(T* dst, const T* src) {
  using U = typename StorageBits<T>::type;
  *reinterpret_cast<U*>(dst) = *reinterpret_cast<const U*>(src);
}
