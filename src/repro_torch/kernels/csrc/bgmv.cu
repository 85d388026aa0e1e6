// BGMV: batched-gather LoRA for decode-sized batches.
//
// Replaces the TPU kernel src/repro/kernels/bgmv.py::bgmv (_bgmv_kernel,
// pallas_call at bgmv.py:54), which ran one grid step per token and let the
// scalar-prefetched adapter id steer the DMA of A[id] and B[id].
//
// What bounds it here: at decode size (T <= 4N tokens) the work is tiny:
// T * (d*r + r*o) multiply-adds over well under a megabyte of activations and
// adapter weights, so the kernel is bound by launch latency and by the
// dependent shrink -> expand chain, not by bytes or FLOPs.
//
// Design: one block per (token, 256-wide o-tile), so even T = 8 gives tens of
// blocks.  Each block gathers its token's adapter by id and computes the
// shrink h = x[t] @ A[id] in f32 with a block reduction (h stays f32 in shared
// memory, as in Pallas, bgmv.py:29-32), then expands its o-tile.  Blocks of
// the same token recompute the shrink from L2 instead of a second launch.  An
// id outside [0, n) writes zeros and reads no weights (the Pallas index map
// clamped to adapter 0 and masked; nothing here reads A[-1]).
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kOTile = kThreads;  // one output column per thread
constexpr int kMaxRank = 64;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const TX* __restrict__ x, const TW* __restrict__ a,
            const TW* __restrict__ b, const int* __restrict__ idx,
            TX* __restrict__ y, int d, int r, int o, int n, float scale) {
  const int t = blockIdx.x;
  const int oc = blockIdx.y * kOTile + threadIdx.x;
  const int id = idx[t];
  if (id < 0 || id >= n) {
    if (oc < o) y[(size_t)t * o + oc] = repro::from_float<TX>(0.f);
    return;
  }
  __shared__ float part[kThreads];
  __shared__ float h[kMaxRank];

  // Shrink.  Walk the flattened (d, r) matrix A[id] with a stride that is a
  // multiple of r, so thread i always owns lane i % r and reads A contiguously.
  const TX* xt = x + (size_t)t * d;
  const TW* at = a + (size_t)id * d * r;
  const int stride = r * (kThreads / r);
  float acc = 0.f;
  if (threadIdx.x < stride) {
    for (int e = threadIdx.x; e < d * r; e += stride)
      acc += repro::to_float(xt[e / r]) * repro::to_float(at[e]);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < r) {
    float s = 0.f;
    for (int k = threadIdx.x; k < stride; k += r) s += part[k];
    h[threadIdx.x] = s;
  }
  __syncthreads();

  // Expand this block's o-tile.
  if (oc < o) {
    const TW* bt = b + (size_t)id * r * o;
    float s = 0.f;
    for (int j = 0; j < r; ++j) s += h[j] * repro::to_float(bt[(size_t)j * o + oc]);
    y[(size_t)t * o + oc] = repro::from_float<TX>(s * scale);
  }
}

}  // namespace

extern "C" int repro_bgmv(const void* x, const void* a, const void* b,
                          const void* idx, void* y, int t, int d, int r, int o,
                          int n, float scale, int x_dtype, int w_dtype,
                          void* stream) {
  if (t <= 0 || o <= 0) return 0;
  if (r < 1 || r > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(t, (o + kOTile - 1) / kOTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(x_dtype, TX, REPRO_DISPATCH_DTYPE(w_dtype, TW,
      bgmv_kernel<TX, TW><<<grid, kThreads, 0, st>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(a),
          static_cast<const TW*>(b), static_cast<const int*>(idx),
          static_cast<TX*>(y), d, r, o, n, scale)));
  return static_cast<int>(cudaPeekAtLastError());
}
