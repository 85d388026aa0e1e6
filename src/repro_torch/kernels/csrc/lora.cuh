// The LoRA shrink of one row, split across a thread-block cluster, and the
// pieces of the expand that BGMV, SGMV and the fused flash-decode+LoRA
// epilogue share.
//
// One cluster of C blocks (128 threads each) computes h = x[row] @ A[id]
// (rank r <= 64, kept in f32 as the Pallas kernels keep it,
// src/repro/kernels/bgmv.py:29-32).  Block c stages only its slice of x
// in shared memory (f32) and sums the products over that slice of d with
// 16-byte loads of A's contiguous rows (Shrink), a batch of them in
// flight before their products are summed.  The partials are summed
// through distributed shared memory by cluster_sum, the port's one
// exchange (SGMV sums its tiles' partial h with it too): each block
// stores its partial into every block's shared memory (map_shared_rank),
// and after one cluster barrier every block sums the C partials in the
// same order, so every block holds the same f32 h (cluster_shrink).  A
// slice that is not 16-byte aligned, or a rank that does not fill whole
// vectors, takes the scalar path: the same code with one element a load
// (V == 1).
//
// Protocol of cluster_sum: a block that takes part arrives at the cluster
// barrier (cluster_arrive) on entry, before any other work; cluster_sum
// waits on that phase before it writes into another block's shared
// memory, so no block's memory is written before that block has started.
// After the second barrier no block touches another's memory again, so
// none has to wait to leave.  Every block of a cluster must take part, or
// none (the callers decide from data that is the same for the whole
// cluster: one token, one row, one tile).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace repro {
namespace lora {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;    // threads of a block that runs the shrink
constexpr int kMaxRank = 64;
constexpr int kMaxCluster = 8;   // blocks of a cluster, portable
constexpr int kAlign = 8;        // slice starts are multiples (elements)
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
  __device__ __forceinline__ void get(float* f) const { unpack16<T>(u, f); }
};
template <typename T>
struct Raw<T, 1> {
  T u;
  __device__ __forceinline__ void load(const T* p) { u = p[0]; }
  __device__ __forceinline__ void get(float* f) const { f[0] = to_float(u); }
};

__host__ __device__ __forceinline__ int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Stage x[row, i0:i0+rows] in shared memory as f32 (16-byte loads where the
// slice is aligned).
template <typename TX>
__device__ __forceinline__ void stage_x(const TX* xr, int rows, float* xs) {
  constexpr int kV = 16 / sizeof(TX);
  int done = 0;
  if (reinterpret_cast<uintptr_t>(xr) % 16 == 0) {
    done = rows / kV * kV;
    for (int k = threadIdx.x; k < rows / kV; k += kThreads) {
      float f[kV];
      unpack16<TX>(__ldg(reinterpret_cast<const uint4*>(xr) + k), f);
#pragma unroll
      for (int e = 0; e < kV; ++e) xs[k * kV + e] = f[e];
    }
  }
  for (int i = done + threadIdx.x; i < rows; i += kThreads)
    xs[i] = to_float(xr[i]);
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
          if (e < elems) acc[u] += xs[e / r] * to_float(as[e]);
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// The cluster's sum of `count` floats that every block holds: element e is
// the u-th value of thread e % blockDim.x (e = threadIdx.x + u * blockDim.x,
// u < kPer), get(u).  Each block pushes its elements into slot `rank` of
// every block's `slots` (cluster x count floats of shared memory), and
// after one cluster barrier out[e] is the sum of the blocks' elements e in
// block order, the same f32 in every block.  The caller arrived at the
// cluster barrier on entry (cluster_arrive); out may be memory that get()
// was computed from.
template <int kPer, typename Get>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            float* slots, int count, Get get,
                                            float* out) {
  const unsigned rank = cluster.block_rank(), n_blocks = cluster.num_blocks();
  // the phase every block arrived at on entry: all of them have started
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (unsigned c = 0; c < n_blocks; ++c) {
    float* dst = cluster.map_shared_rank(slots + rank * count, c);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * blockDim.x;
      if (e < count) dst[e] = get(u);
    }
  }
  cluster.sync();  // every partial has arrived everywhere
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    float s = 0.f;
    for (unsigned c = 0; c < n_blocks; ++c) s += slots[c * count + e];
    out[e] = s;
  }
  __syncthreads();  // the sum is complete
}

// Shared memory of cluster_shrink.
struct ShrinkSmem {
  float part[kThreads * kMaxVec];
  float parts[kMaxCluster * kMaxRank];  // h_c of every block c
  float h[kMaxRank];                    // the cluster's h
};

// The cluster's h = x[row] @ A[id] into sm.h, after the caller arrived at
// the cluster barrier on entry and called sh.issue(as, rows, r) (and put
// whatever loads of its own in flight): stage this block's slice of x
// (rows elements at xr) into xs, sum its partial over the slice of A at
// as, and sum the cluster's partials (cluster_sum).
template <typename TX, typename TW, int V>
__device__ __forceinline__ void cluster_shrink(cg::cluster_group& cluster,
                                               Shrink<TW, V>& sh,
                                               const TX* xr, int rows,
                                               const TW* as, int r, float* xs,
                                               ShrinkSmem& sm) {
  stage_x(xr, rows, xs);
  __syncthreads();
  const float hc = sh.finish(as, xs, r, sm.part);
  cluster_sum<1>(cluster, sm.parts, r, [&](int) { return hc; }, sm.h);
}

// Rows l0 .. l0 + R - 1 (those < r) of B's columns [col, col + V), B's
// rows `ld` elements apart.
template <typename TW, int V, int R = kRowBatch>
struct BRows {
  Raw<TW, V> row[R];
  __device__ __forceinline__ void load(const TW* bt, size_t ld, int col,
                                       int l0, int r) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (l0 + j < r) row[j].load(bt + (size_t)(l0 + j) * ld + col);
  }
  __device__ __forceinline__ void add(const float* h, int l0, int r, float* out) const {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (l0 + j < r) {
        float bv[V];
        row[j].get(bv);
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] += h[l0 + j] * bv[e];
      }
    }
  }
};

// y[0:V] = scale * out, as V values of TX (one store of V * size bytes
// where V > 1).
template <typename TX, int V>
__device__ __forceinline__ void store(TX* y, const float* out, float scale) {
  if constexpr (V == 1) {
    y[0] = from_float<TX>(out[0] * scale);
  } else {
    constexpr int kBytes = V * sizeof(TX);   // 8, 16 or 32
    alignas(16) TX v[V];
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = from_float<TX>(out[e] * scale);
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(y) = *reinterpret_cast<const uint2*>(v);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(y)[i] = reinterpret_cast<const uint4*>(v)[i];
    }
  }
}

// Launch `kernel` on a grid of `grid` blocks of `threads`, in clusters of
// `cluster` blocks along x (0: no clusters), with `smem` bytes of dynamic
// shared memory.
// With `after` the launch is the programmatic dependent of the kernel
// before it on the stream: it may start before that kernel ends, and must
// run griddepcontrol.wait before it reads that kernel's output.
template <typename K, typename... Args>
cudaError_t launch_clusters(K kernel, dim3 grid, int threads, int cluster,
                            int smem, cudaStream_t st, bool after,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n_attrs = 0;
  if (cluster > 0) {
    attr[n_attrs].id = cudaLaunchAttributeClusterDimension;
    attr[n_attrs].val.clusterDim.x = cluster;
    attr[n_attrs].val.clusterDim.y = 1;
    attr[n_attrs].val.clusterDim.z = 1;
    ++n_attrs;
  }
  if (after) {
    attr[n_attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attrs].val.programmaticStreamSerializationAllowed = 1;
    ++n_attrs;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attrs;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace lora
}  // namespace repro
