// Hopper building blocks of the split-precision product on the tensor
// cores (3xTF32), used by K2's wide update (chol_panel.cu): TMA loads into
// 128-byte-swizzled shared memory, mbarriers, the tf32 warpgroup product
// (wgmma) and the split of an f32 operand into two tf32 parts.
//
// Why a split: the reference multiplies in f32 (Precision.HIGHEST), and one
// TF32 product keeps 11 bits of each operand, which the tolerances reject.
// With a = a_hi + a_lo, a_hi = rna_tf32(a), a_lo = rna_tf32(a - a_hi), the
// sum a_hi b_hi + a_hi b_lo + a_lo b_hi keeps ~22 bits of each operand (the
// dropped a_lo b_lo is below 2^-22 |a b|): about an f32 product's error, at
// three tensor-core passes (3 x 2 M N K / 494.7 TFLOP/s against 2 M N K / 67
// TFLOP/s on the CUDA cores). It is the counterpart of what
// Precision.HIGHEST does on the TPU (a multi-pass bf16 product).
//
// The tensor cores round their own f32 accumulation toward zero, a bias
// that grows with the number of steps. So a caller sums one staged K slice
// (TC_BK deep: 3 x TC_BK / 8 steps) into a fresh wgmma accumulator and adds
// it to a running f32 sum with ordinary FADDs, which round to nearest.
//
// Nothing here links the driver library: the tensor-map encoder is reached
// through cudaGetDriverEntryPoint.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

constexpr int TC_BK = 32;   // a staged K slice: 32 floats, one 128-byte row

// Shared-memory address of a generic pointer into shared memory.
__device__ inline uint32_t tc_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void tc_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc_smem(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ inline void tc_bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void tc_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc_smem(bar))
               : "memory");
}

// This thread's arrival, and `bytes` more for the phase's TMA copies.
__device__ inline void tc_bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          tc_smem(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// phase that has not completed after ~10 s is a fault of the pipeline:
// trap, so that the launch fails instead of hanging the card.
__device__ inline void tc_bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc_smem(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (unsigned spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && spins % 1024 == 1023) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (t0 == 0) {
        t0 = t;
      } else if (t - t0 > 10000000000ll) {
        __trap();
      }
    }
  }
}

// The box at (c0, c1) (c0 the unit-stride coordinate) of the tensor map
// into shared memory at dst, completing on bar.
__device__ inline void tc_tma_load(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma's operand reads).
__device__ inline void tc_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `threads` threads (whole warps) on hardware barrier `id`
// (0 is __syncthreads').
__device__ inline void tc_named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Row r, element k of a 128-byte-swizzled tile of rows of TC_BK floats (the
// layout of TMA's CU_TENSOR_MAP_SWIZZLE_128B, 1024-byte aligned): the
// 16-byte group k / 4 of row r sits at group (k / 4) ^ (r % 8).
__host__ __device__ inline int tc_swizzled(int r, int k) {
  return r * TC_BK + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// wgmma's descriptor of a K-major operand tile in that layout: 8-row groups
// 1024 bytes apart, 128-byte swizzle. A k8 step further along K is the
// start address plus 32 bytes (2 in the descriptor's 16-byte units).
__device__ inline uint64_t tc_desc(const float* tile) {
  const uint64_t a = tc_smem(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ inline float tc_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// hi = rna_tf32(x), lo = rna_tf32(x - hi). A non-finite x gives a
// non-finite product, as in f32, though it may be NaN where f32 gives Inf
// (Inf - Inf in lo, or Inf times a zero lo).
__device__ inline void tc_split(float x, float& hi, float& lo) {
  hi = tc_rna(x);
  lo = tc_rna(x - hi);
}

__device__ inline void tc_split4(const float* raw, float* hi, float* lo,
                                 int q) {
  const float4 v = reinterpret_cast<const float4*>(raw)[q];
  float4 h, l;
  tc_split(v.x, h.x, l.x);
  tc_split(v.y, h.y, l.y);
  tc_split(v.z, h.z, l.z);
  tc_split(v.w, h.w, l.w);
  reinterpret_cast<float4*>(hi)[q] = h;
  reinterpret_cast<float4*>(lo)[q] = l;
}

__device__ inline void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void tc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ inline void tc_wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulator across the
// asynchronous product.
__device__ inline void tc_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for a 64 x 128 output and one k8 step: A (64 x 8) from
// registers, a[0..3] this thread's tf32 elements at rows 16 warp + lane / 4
// (+8 for a[1], a[3]), columns lane % 4 (+4 for a[2], a[3]); B^T (128 x 8)
// K-major in shared memory (tc_desc); scale_d = 0 overwrites d. The
// accumulator layout: d[4 j + 2 h + v] is row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + v of the warpgroup's 64 x 128 tile. A's
// registers must stay untouched until the product completes (tc_fence_regs
// after the wait).
__device__ inline void tc_wgmma_m64n128k8_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keep A's registers live, unmoved, until the products that read them have
// completed.
template <int N>
__device__ inline void tc_fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ---- host side

// A 2-D tensor map of f32 rows (`rows` of `cols` unit-stride elements,
// `ld` elements apart) read in boxes of 128 rows x TC_BK, 128-byte
// swizzled, zeros past the edges. Returns false where TMA cannot describe
// the operand (see tc_tma_ok) or the encoder is missing.
inline bool tc_tensor_map(CUtensorMap* map, const float* base, long long rows,
                          long long cols, long long ld) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                             void*, const cuuint64_t*, const cuuint64_t*,
                             const cuuint32_t*, const cuuint32_t*,
                             CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion,
                             CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return static_cast<Encode>(nullptr);
    }
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {TC_BK, 128};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes an operand whose element (r, k) is p[r * ld + k * s_k] when it
// is unit-stride along k, its base 16-byte aligned and its row stride a
// multiple of 16 bytes.
inline bool tc_tma_ok(const float* p, long long s_k, long long ld) {
  return s_k == 1 && ld > 0 && (ld * (long long)sizeof(float)) % 16 == 0 &&
         ld < (1ll << 37) && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
