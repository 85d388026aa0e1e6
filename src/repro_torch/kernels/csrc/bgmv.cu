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
// The shrink is split across the cluster: block c stages only its d/C slice
// of x[t] in shared memory (f32) and computes the partial h_c = x[t, slice]
// @ A[id][slice, :] in f32, reading the flattened slice of A with 16-byte
// loads, a batch of them issued before their products are summed (at r = 8
// in bf16 a row of A is one 16-byte vector).  The partials are summed
// through distributed shared memory: each block stores its partial into
// every block's shared memory (map_shared_rank), and after one cluster
// barrier every block sums the C partials in the same order, so every block
// holds the same f32 h, as the Pallas kernel keeps h in f32 (bgmv.py:29-32).
// Each block then expands its o-tile with 16-byte loads of B's rows, the
// first eight rows loaded before the shrink so that their round trip
// overlaps it, and 16-byte stores.  Where a pointer is not 16-byte aligned
// or a width not a multiple of the vector, the kernel takes its scalar path
// (the same code with one element a load).  An id outside [0, n) writes zeros and reads no
// weights (the Pallas index map clamped to adapter 0 and masked; nothing here
// reads A[-1]).  The first design (PR 11) had one block per (token, 256-wide
// o-tile), each recomputing the whole shrink with 2-byte loads and one
// accumulator a thread: 38.56 us at T 8, d = o = 3072, r 8 (PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"
#include "kernels.h"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRank = 64;
constexpr int kMaxCluster = 8;   // blocks of a cluster, portable
constexpr int kAlign = 8;        // d_tile and o_tile are multiples (elements)
constexpr int kOPerBlock = 128;  // columns of o a block, at least, and rows
constexpr int kDPerBlock = 512;  // of d, before the cluster grows
constexpr int kBatch = 4;        // vectors of A in flight a thread
constexpr int kRowBatch = 8;     // rows of B in flight a thread
constexpr int kMaxVec = 8;       // elements of a 16-byte vector, at most
constexpr int kFold = 16;        // threads a lane in the first round of the fold

// One load of V elements of T: a 16-byte vector, or (V == 1) one element.
template <typename T, int V>
struct Raw {
  uint4 u;
  __device__ __forceinline__ void load(const T* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* f) const { repro::unpack16<T>(u, f); }
};
template <typename T>
struct Raw<T, 1> {
  T u;
  __device__ __forceinline__ void load(const T* p) { u = p[0]; }
  __device__ __forceinline__ void get(float* f) const { f[0] = repro::to_float(u); }
};

__device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Stage x[t, i0:i0+rows] in shared memory as f32 (16-byte loads where the
// slice is aligned).
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* xr, int rows, float* xs) {
  constexpr int kV = 16 / sizeof(TX);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(xr) % 16 == 0) {
    done = rows / kV * kV;
    for (int k = threadIdx.x; k < rows / kV; k += kThreads) {
      float f[kV];
      repro::unpack16<TX>(__ldg(reinterpret_cast<const uint4*>(xr) + k), f);
#pragma unroll
      for (int e = 0; e < kV; ++e) xs[k * kV + e] = f[e];
    }
  }
  for (int i = done + threadIdx.x; i < rows; i += kThreads)
    xs[i] = repro::to_float(xr[i]);
}

// This block's partial shrink, h_c[l] = sum over its slice of x * A[:, l].
// The slice of A (rows x r, contiguous) is read as vectors of V elements;
// thread j of the first `na` takes vectors j, j + na, ..., where na * V is
// a multiple of r, so each of its V accumulators always meets the same lane
// (flat position f = j * V + u, lane f % r).  issue() puts the first batch
// of loads in flight (before x is staged, so that both round trips
// overlap); finish() sums the products, reads a vector that runs past the
// slice's end element by element, and sums the partials by lane in shared
// memory in two rounds, in a fixed order: thread (l, j) of the first
// kFold * r sums groups j, j + kFold, ... of lane l, then thread l sums the
// kFold sums and returns h_c[l] (threads >= r return 0).
template <typename TW, int V>
struct Shrink {
  Raw<TW, V> raw[kBatch];
  int na, elems, nfull;

  __device__ __forceinline__ void load(const TW* as, int k) {
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (k + b * na < nfull) raw[b].load(as + (size_t)(k + b * na) * V);
  }

  __device__ __forceinline__ void issue(const TW* as, int rows, int r) {
    const int lcm_blocks = r / gcd(r, V);  // vectors that span whole rows
    na = kThreads / lcm_blocks * lcm_blocks;
    elems = rows * r;
    nfull = elems / V;
    if (static_cast<int>(threadIdx.x) < na) load(as, threadIdx.x);
  }

  __device__ __forceinline__ float finish(const TW* as, const float* xs,
                                          int r, float* part) {
    const int tid = threadIdx.x;
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    if (tid < na) {
      for (int k = tid; k < nfull; k += kBatch * na) {
        if (k != tid) load(as, k);  // the first batch is in flight already
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int kk = k + b * na;
          if (kk < nfull) {
            float a[V];
            raw[b].get(a);
            int row = kk * V / r, lane = kk * V - row * r;
#pragma unroll
            for (int u = 0; u < V; ++u) {
              acc[u] += xs[row] * a[u];
              if (++lane == r) {
                lane = 0;
                ++row;
              }
            }
          }
        }
      }
      // the tail: elements [nfull * V, elems), on the thread that owns
      // vector nfull
      if (nfull * V < elems && tid == nfull % na) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int e = nfull * V + u;
          if (e < elems) acc[u] += xs[e / r] * repro::to_float(as[e]);
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u) part[tid * V + u] = acc[u];
    }
    __syncthreads();
    __shared__ float sums[kThreads];
    const int nb = na * V / r;  // groups of r in part
    const int fold = min(kFold, kThreads / r);
    if (tid < fold * r) {
      const int l = tid % r;
      float s = 0.f;
      for (int g = tid / r; g < nb; g += fold) s += part[g * r + l];
      sums[tid] = s;
    }
    __syncthreads();
    float s = 0.f;
    if (tid < r)
      for (int j = 0; j < fold; ++j) s += sums[j * r + tid];
    return s;
  }
};

// Rows l0 .. l0 + kRowBatch - 1 (those < r) of B's columns [col, col + V).
template <typename TW, int V>
struct BRows {
  Raw<TW, V> row[kRowBatch];
  __device__ __forceinline__ void load(const TW* bt, int o, int col, int l0, int r) {
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j)
      if (l0 + j < r) row[j].load(bt + (size_t)(l0 + j) * o + col);
  }
  __device__ __forceinline__ void add(const float* h, int l0, int r, float* out) const {
#pragma unroll
    for (int j = 0; j < kRowBatch; ++j) {
      if (l0 + j < r) {
        float bv[V];
        row[j].get(bv);
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] += h[l0 + j] * bv[e];
      }
    }
  }
};

// y[t, col:col+V] = scale * out, as V values of TX (one store of V * size
// bytes where V > 1).
template <typename TX, int V>
__device__ __forceinline__ void store(TX* y, const float* out, float scale) {
  if constexpr (V == 1) {
    y[0] = repro::from_float<TX>(out[0] * scale);
  } else {
    constexpr int kBytes = V * sizeof(TX);   // 8, 16 or 32
    alignas(16) TX v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = repro::from_float<TX>(out[e] * scale);
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(y) = *reinterpret_cast<const uint2*>(v);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(y)[i] = reinterpret_cast<const uint4*>(v)[i];
    }
  }
}

// The block's part of the kernel once id is known: shrink its slice, sum the
// cluster's partials, expand its o-tile.  VA / VB: elements a load of A / B
// (16 bytes, or 1 on the scalar path).
template <typename TX, typename TW, int VA, int VB>
__device__ __forceinline__ void bgmv_block(
    cg::cluster_group& cluster, const TX* xr, float* xs, const TW* as,
    int rows, const TW* bt, TX* yt, int r, int o, int o0, int o1, float scale,
    float* part, float (*parts)[kMaxRank], float* h) {
  // The first rows of B for this thread's first columns and the first
  // batch of A go out before x is staged: three round trips in flight at
  // once.
  const int ncv = (o1 - o0 + VB - 1) / VB;
  BRows<TW, VB> first;
  if (threadIdx.x < ncv) first.load(bt, o, o0 + threadIdx.x * VB, 0, r);
  Shrink<TW, VA> sh;
  sh.issue(as, rows, r);
  stage_x(xr, rows, xs);
  __syncthreads();

  // Push this block's partial into row `rank` of every block's `parts`
  // (distributed shared memory; stores need no round trip), then one
  // cluster barrier: after it every block holds all partials locally, and
  // no block touches another's memory again, so none has to wait to leave.
  // The wait first completes the phase every block arrived at on entry: no
  // block's shared memory is written before that block has started.
  const float hc = sh.finish(as, xs, r, part);
  const unsigned rank = cluster.block_rank(), n_blocks = cluster.num_blocks();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x < r)
    for (unsigned c = 0; c < n_blocks; ++c)
      cluster.map_shared_rank(&parts[rank][0], c)[threadIdx.x] = hc;
  cluster.sync();  // every partial has arrived everywhere
  if (threadIdx.x < r) {
    float s = 0.f;
    for (unsigned c = 0; c < n_blocks; ++c) s += parts[c][threadIdx.x];
    h[threadIdx.x] = s;
  }
  __syncthreads();  // h is complete

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
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ float xs[];  // [d_tile]
  __shared__ float part[kThreads * kMaxVec];
  __shared__ float parts[kMaxCluster][kMaxRank];  // h_c of every block c
  __shared__ float h[kMaxRank];
  const TX* xr = x + (size_t)t * d + i0;
  const TW* as = a + ((size_t)id * d + i0) * r;
  const TW* bt = b + (size_t)id * r * o;
  if (vec_a && vec_b)
    bgmv_block<TX, TW, kVW, kVW>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, part, parts, h);
  else if (vec_a)
    bgmv_block<TX, TW, kVW, 1>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, part, parts, h);
  else if (vec_b)
    bgmv_block<TX, TW, 1, kVW>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, part, parts, h);
  else
    bgmv_block<TX, TW, 1, 1>(cluster, xr, xs, as, rows, bt, yt, r, o, o0, o1, scale, part, parts, h);
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, t);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x),
                           static_cast<const TW*>(a), static_cast<const TW*>(b),
                           static_cast<const int*>(idx), static_cast<TX*>(y),
                           d, r, o, n, scale, d_tile, o_tile, vec_a, vec_b);
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
