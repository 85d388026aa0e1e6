// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads bf16 or f32 and accumulates in f32.  Conversions go
// through the CUDA intrinsics only: PyTorch's extension builder compiles
// with -D__CUDA_NO_BFLOAT16_CONVERSIONS__, which removes the implicit ones.
#pragma once

#include <cuda_bf16.h>
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
