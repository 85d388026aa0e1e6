// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads bf16 or f32 (flash-decode's int8 mode an int8 cache
// and its f16 scales) and accumulates in f32.  Conversions go through the
// CUDA intrinsics only: torch.utils.cpp_extension compiles with
// -D__CUDA_NO_BFLOAT16_CONVERSIONS__ and -D__CUDA_NO_HALF_CONVERSIONS__,
// which remove the implicit ones.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes passed from Python (see kernels/build.py: DTYPE_CODES)
#define REPRO_F32 0
#define REPRO_BF16 1

namespace repro {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Full-warp sum; every lane ends with the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Full-warp max; every lane ends with it.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The 16 bytes of `u` as floats: 4 of float, or 8 of bfloat16.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 p;
    memcpy(&p, &w[i], 4);
    const float2 v = __bfloat1622float2(p);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// The 16 bytes of `u` as 16 int8 values, exactly, without a conversion
// instruction (those run at a quarter of the FMA rate): each byte, offset by
// 128, goes into the low mantissa byte of 2^23 (0x4B000000), and one
// subtraction of 2^23 + 128 leaves its value.
template <> __device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned b = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  }
}

// 16-byte global -> shared copy that bypasses registers (cp.async, sm_80+).
// With `valid` false it reads nothing and fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
// A 4- or 8-byte copy of the same kind (cp.async.ca: those widths go
// through L1), aligned to its width.
template <int kBytes>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem, bool valid) {
  static_assert(kBytes == 4 || kBytes == 8, "cp.async copies 4, 8 or 16 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(gmem), "n"(kBytes), "r"(valid ? kBytes : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `pending` (0..2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bf16 m16n8k16 tensor-core product with f32 accumulators, d += a * b.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of row
// i % 8 of matrix i / 8.  With kTrans each matrix arrives transposed.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Two 8x8 b16 matrices from shared memory, each arriving transposed; lanes
// 0-15 give the addresses of rows 0-7 of the first and of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& r0, unsigned& r1,
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(a));
}

// A kernel instance's dynamic shared-memory limit on each device, raised
// with cudaFuncSetAttribute only when a launch needs more than was set
// before: the launchers keep one `static` per instance, so a launch that
// fits makes no API call (the eager decode step is bound by host time).
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::atomic<int> set[kDevices] = {};

  template <typename K>
  cudaError_t raise(K kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && bytes <= set[dev].load(std::memory_order_relaxed))
      return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < kDevices)
      set[dev].store(bytes, std::memory_order_relaxed);
    return err;
  }
};

}  // namespace repro

// Launch a lambda-free template over the two supported element types.
#define REPRO_DISPATCH_DTYPE(code, T, ...)          \
  do {                                              \
    if ((code) == REPRO_F32) {                      \
      using T = float;                              \
      __VA_ARGS__;                                  \
    } else if ((code) == REPRO_BF16) {              \
      using T = __nv_bfloat16;                      \
      __VA_ARGS__;                                  \
    } else {                                        \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                               \
  } while (0)
