// BGMV: batched-gather LoRA for decode-sized batches.
//
// Replaces the TPU kernel src/repro/kernels/bgmv.py::bgmv (_bgmv_kernel,
// pallas_call at bgmv.py:54), which ran one grid step per token and let the
// scalar-prefetched adapter id steer the DMA of A[id] and B[id].
//
// What bounds it here: at decode size (T <= 4N tokens) the work is tiny:
// T * (d*r + r*o) multiply-adds over well under a megabyte of activations and
// adapter weights (0.147 us of bytes at T 8, d = o = 3072, r 8), so the
// kernel is bound by latency: the launch, and the chain of dependent memory
// round trips (id -> A[id] -> h -> B[id] -> y).
//
// Design: one thread-block cluster per token, of C <= 8 blocks along o
// (plan(): 8 x 384 columns at o 3072, 8 x 128 at o 1024).
// The shrink is split across the cluster and summed through distributed
// shared memory (lora.cuh::cluster_shrink, which the fused flash-decode+LoRA
// epilogue shares): every block ends with the same f32 h, as the Pallas
// kernel keeps h in f32 (bgmv.py:29-32).
// Each block then expands its o-tile with 16-byte loads of B's rows, the
// first eight rows loaded before the shrink so that their round trip
// overlaps it, and 16-byte stores.  Where a pointer is not 16-byte aligned
// or a width not a multiple of the vector, the kernel takes its scalar path
// (the same code with one element a load).  An id outside [0, n) writes zeros and reads no
// weights (the Pallas index map clamped to adapter 0 and masked; nothing here
// reads A[-1]).  The first design (PR 11) had one block per (token, 256-wide
// o-tile), each recomputing the whole shrink with 2-byte loads and one
// accumulator a thread: 38.56 us at T 8, d = o = 3072, r 8 (PERF.md).
#include "common.cuh"
#include "kernels.h"
#include "lora.cuh"

namespace {

using namespace repro::lora;

constexpr int kOPerBlock = 128;  // columns of o a block, at least, and rows
constexpr int kDPerBlock = 512;  // of d, before the cluster grows

// The block's part of the kernel once id is known: shrink its slice, sum the
// cluster's partials (cluster_shrink), expand its o-tile.  VA / VB:
// elements a load of A / B (16 bytes, or 1 on the scalar path).
template <typename TX, typename TW, int VA, int VB>
__device__ __forceinline__ void bgmv_block(
    cg::cluster_group& cluster, const TX* xr, float* xs, const TW* as,
    int rows, const TW* bt, TX* yt, int r, int o, int o0, int o1, float scale,
    ShrinkSmem& sm) {
  // The first rows of B for this thread's first columns and the first
  // batch of A go out before x is staged: three round trips in flight at
  // once.
  const int ncv = (o1 - o0 + VB - 1) / VB;
  BRows<TW, VB> first;
  if (threadIdx.x < ncv) first.load(bt, o, o0 + threadIdx.x * VB, 0, r);
  Shrink<TW, VA> sh;
  sh.issue(as, rows, r);
  cluster_shrink(cluster, sh, xr, rows, as, r, xs, sm);
  const float* h = sm.h;

  for (int cv = threadIdx.x; cv < ncv; cv += kThreads) {
    const int col = o0 + cv * VB;
    float out[VB];
#pragma unroll
    for (int e = 0; e < VB; ++e) out[e] = 0.f;
    if (cv == static_cast<int>(threadIdx.x)) {
      first.add(h, 0, r, out);
    } else {
      BRows<TW, VB> rows0;
      rows0.load(bt, o, col, 0, r);
      rows0.add(h, 0, r, out);
    }
    for (int l0 = kRowBatch; l0 < r; l0 += kRowBatch) {
      BRows<TW, VB> more;
      more.load(bt, o, col, l0, r);
      more.add(h, l0, r, out);
    }
    store<TX, VB>(yt + col, out, scale);
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const TX* __restrict__ x, const TW* __restrict__ a,
            const TW* __restrict__ b, const int* __restrict__ idx,
            TX* __restrict__ y, int d, int r, int o, int n, float scale,
            int d_tile, int o_tile, bool vec_a, bool vec_b) {
  constexpr int kVW = 16 / sizeof(TW);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.y;
  const int id = idx[t];
  const int o0 = min(c * o_tile, o), o1 = min(o0 + o_tile, o);
  const int i0 = min(c * d_tile, d), rows = min(i0 + d_tile, d) - i0;
  TX* yt = y + (size_t)t * o;
  if (id < 0 || id >= n) {  // the whole cluster (one token) leaves here
    for (int i = o0 + threadIdx.x; i < o1; i += kThreads)
      yt[i] = repro::from_float<TX>(0.f);
    return;
  }
  cluster_arrive();
  extern __shared__ float xs[];  // [d_tile]
  __shared__ ShrinkSmem sm;
  const TX* xr = x + (size_t)t * d + i0;
  const TW* as = a + ((size_t)id * d + i0) * r;
  const TW* bt = b + (size_t)id * r * o;
  if (vec_a && vec_b)
    bgmv_block<TX, TW, kVW, kVW>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, sm);
  else if (vec_a)
    bgmv_block<TX, TW, kVW, 1>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, sm);
  else if (vec_b)
    bgmv_block<TX, TW, 1, kVW>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, sm);
  else
    bgmv_block<TX, TW, 1, 1>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, sm);
}

// The launch for one token: a cluster of up to kMaxCluster blocks; block c
// shrinks rows [c * d_tile, (c + 1) * d_tile) of d and expands columns
// [c * o_tile, (c + 1) * o_tile) of o, clipped to d and o.  Tiles are
// multiples of kAlign, so each block's slice of A starts on 16 bytes.
struct Plan {
  int cluster, d_tile, o_tile;
};

Plan plan(int d, int o) {
  auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
  const int c = min(kMaxCluster, max(1, max(cdiv(o, kOPerBlock), cdiv(d, kDPerBlock))));
  return {c, cdiv(cdiv(d, c), kAlign) * kAlign, cdiv(cdiv(o, c), kAlign) * kAlign};
}

template <typename TX, typename TW>
int launch(const void* x, const void* a, const void* b, const void* idx,
           void* y, int t, int d, int r, int o, int n, float scale,
           cudaStream_t st) {
  constexpr int kVW = 16 / sizeof(TW);
  const auto [cluster, d_tile, o_tile] = plan(d, o);
  // 16-byte loads of A need A[id]'s slices aligned: the base, a whole
  // adapter and a slice start (a multiple of kAlign rows) are multiples of
  // 16 bytes.  Those of B and stores of y need the base and every row.
  const bool vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     (size_t)d * r * sizeof(TW) % 16 == 0;
  const bool vec_b = (reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(y)) % 16 == 0 &&
                     o % kVW == 0;
  const int smem = d_tile * static_cast<int>(sizeof(float));
  auto kernel = bgmv_kernel<TX, TW>;
  static repro::SmemLimit limit;
  cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_clusters(kernel, dim3(cluster, t), kThreads, cluster, smem, st, false,
                        static_cast<const TX*>(x), static_cast<const TW*>(a),
                        static_cast<const TW*>(b), static_cast<const int*>(idx),
                        static_cast<TX*>(y), d, r, o, n, scale, d_tile, o_tile,
                        vec_a, vec_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaPeekAtLastError());
}

}  // namespace

extern "C" int repro_bgmv(const void* x, const void* a, const void* b,
                          const void* idx, void* y, int t, int d, int r, int o,
                          int n, float scale, int x_dtype, int w_dtype,
                          void* stream) {
  if (t <= 0 || o <= 0) return 0;
  if (r < 1 || r > kMaxRank || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(x_dtype, TX, REPRO_DISPATCH_DTYPE(w_dtype, TW,
      rc = (launch<TX, TW>(x, a, b, idx, y, t, d, r, o, n, scale, st))));
  return rc;
}
