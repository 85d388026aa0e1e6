// SGMV: segmented LoRA for prefill-sized batches, dense or ragged-rank.
//
// Replaces the TPU kernels of src/repro/kernels/sgmv.py::_grouped_matmul:
// _sgmv_kernel (dense, pallas_call at sgmv.py:77) and _sgmv_ragged_kernel
// (ragged, pallas_call at sgmv.py:89).  Pallas bucketed tokens into an
// (N, cap, d) buffer and ran a dense grouped matmul over it; here the wrapper
// sorts token ids on the device instead (kernels/sgmv.py), and the kernel
// walks each adapter's segment of the sorted order.
//
// What bounds it here: the work is T * (d*r + r*o) multiply-adds on T*(d+o)
// activation elements; with r <= 64 that is a few FLOPs per byte, so the
// kernel is bound by bytes (reading x, writing y), far below the tensor cores.
//
// Design: one block per (segment row-tile of 16 tokens, 256-wide o-tile).
// The block gathers its rows through `perm`, runs the shrink over d in chunks
// staged in shared memory (f32), keeps h = x @ A (16 x r, f32) in shared
// memory, expands its o-tile and scatters the rows back to token order.  The
// grid is sized by the upper bound ceil(T/16) tiles per segment, so no host
// sync is needed to learn the segment sizes; blocks past their segment's end
// exit at once.  Tokens with no adapter (segment n) are written as zeros.
//
// The capacity contract of the TPU kernel stays: a token whose rank inside
// its adapter (arrival order) is >= cap gets exactly 0 (sgmv.py:121-127).  It
// is the one mask on the rank in `live` below.
//
// Ragged mode (`ranks` != NULL): lanes j >= ranks[i] of A's columns and B's
// rows are loaded as 0 before both products, so the arithmetic is the dense
// kernel's on a mask_ragged bank value for value, and the two agree bitwise.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kOTile = kThreads;
constexpr int kDChunk = 64;
constexpr int kMaxRank = 64;
constexpr int kOutPerThread = kRows * kMaxRank / kThreads;  // 4

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
sgmv_kernel(const TX* __restrict__ x, const TW* __restrict__ a,
            const TW* __restrict__ b, const int* __restrict__ perm,
            const int* __restrict__ seg, const int* __restrict__ ranks,
            TX* __restrict__ y, int d, int r, int o, int n, int cap,
            float scale) {
  const int g = blockIdx.y;  // segment: adapter g, or g == n for no adapter
  const int start = seg[g];
  const int count = seg[g + 1] - start;
  const int row0 = blockIdx.x * kRows;
  if (row0 >= count) return;
  const int rows = min(kRows, count - row0);
  const int oc = blockIdx.z * kOTile + threadIdx.x;

  __shared__ int tok[kRows];
  __shared__ bool live[kRows];
  __shared__ float xs[kRows][kDChunk];
  __shared__ float as[kDChunk * kMaxRank];
  __shared__ float h[kRows][kMaxRank];

  if (threadIdx.x < kRows) {
    const int i = threadIdx.x;
    tok[i] = i < rows ? perm[start + row0 + i] : 0;
    // rank inside the segment = row0 + i; the capacity contract is this mask
    live[i] = i < rows && g < n && row0 + i < cap;
  }
  __syncthreads();

  if (g >= n || row0 >= cap) {  // no live row in this tile: write zeros
    if (oc < o)
      for (int i = 0; i < rows; ++i)
        y[(size_t)tok[i] * o + oc] = repro::from_float<TX>(0.f);
    return;
  }
  const int rank = ranks ? min(ranks[g], r) : r;
  const TW* ag = a + (size_t)g * d * r;
  const TW* bg = b + (size_t)g * r * o;

  // Shrink: h[i][j] = sum_k x[tok[i], k] * A[g, k, j], over d in chunks.
  float acc[kOutPerThread];
#pragma unroll
  for (int u = 0; u < kOutPerThread; ++u) acc[u] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kDChunk) {
    const int kn = min(kDChunk, d - k0);
    for (int e = threadIdx.x; e < kRows * kDChunk; e += kThreads) {
      const int i = e / kDChunk, k = e % kDChunk;
      xs[i][k] = (i < rows && k < kn)
                     ? repro::to_float(x[(size_t)tok[i] * d + k0 + k])
                     : 0.f;
    }
    for (int e = threadIdx.x; e < kn * r; e += kThreads) {
      const int j = e % r;
      as[e] = j < rank ? repro::to_float(ag[(size_t)k0 * r + e]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kOutPerThread; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = e / r, j = e % r;
      if (i < kRows) {
        float s = acc[u];
        for (int k = 0; k < kn; ++k) s += xs[i][k] * as[k * r + j];
        acc[u] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kOutPerThread; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int i = e / r, j = e % r;
    if (i < kRows) h[i][j] = acc[u];
  }
  __syncthreads();

  // Expand this block's o-tile and scatter back to token order.
  if (oc >= o) return;
  float out[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) out[i] = 0.f;
  for (int j = 0; j < r; ++j) {
    const float bv = j < rank ? repro::to_float(bg[(size_t)j * o + oc]) : 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) out[i] += h[i][j] * bv;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows)
      y[(size_t)tok[i] * o + oc] =
          repro::from_float<TX>(live[i] ? out[i] * scale : 0.f);
}

}  // namespace

extern "C" int repro_sgmv(const void* x, const void* a, const void* b,
                          const void* perm, const void* seg, const void* ranks,
                          void* y, int t, int d, int r, int o, int n, int cap,
                          float scale, int x_dtype, int w_dtype, void* stream) {
  if (t <= 0 || o <= 0) return 0;
  if (r < 1 || r > kMaxRank || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + kRows - 1) / kRows, n + 1, (o + kOTile - 1) / kOTile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(x_dtype, TX, REPRO_DISPATCH_DTYPE(w_dtype, TW,
      sgmv_kernel<TX, TW><<<grid, kThreads, 0, st>>>(
          static_cast<const TX*>(x), static_cast<const TW*>(a),
          static_cast<const TW*>(b), static_cast<const int*>(perm),
          static_cast<const int*>(seg), static_cast<const int*>(ranks),
          static_cast<TX*>(y), d, r, o, n, cap, scale)));
  return static_cast<int>(cudaPeekAtLastError());
}
