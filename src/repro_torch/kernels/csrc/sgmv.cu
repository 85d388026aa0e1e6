// SGMV: segmented LoRA for prefill-sized batches, dense or ragged-rank.
//
// Replaces the TPU kernels of src/repro/kernels/sgmv.py::_grouped_matmul:
// _sgmv_kernel (dense, pallas_call at sgmv.py:77) and _sgmv_ragged_kernel
// (ragged, pallas_call at sgmv.py:89).  Pallas bucketed tokens into an
// (N, cap, d) buffer and ran a dense grouped matmul over it; here a first
// kernel sorts the tokens by adapter (sgmv_segments_kernel) and the second
// walks each adapter's segment of the sorted order (sgmv_kernel).
//
// What bounds it here: the work is T * (d*r + r*o) multiply-adds on T*(d+o)
// activation elements; with r <= 64 that is a few FLOPs per byte, so the
// kernel is bound by bytes (reading x, writing y: 3.875 us at T 1024,
// d = o = 3072, r 8, bf16), far below the tensor cores.
//
// The sort: one block counts each warp's tokens by adapter (ids outside
// [0, n) count as segment n), scans the counts into the segment starts
// `seg` (n + 2) and each warp's offset inside each segment, then writes
// perm (sorted position -> token).  Inside a segment tokens keep their
// arrival order, so position p - seg[g] is a token's rank in its adapter,
// which the capacity contract reads.  One launch, no host sync: 3.0 us at
// T 1024, where torch.sort + searchsorted took 33-36 us in graph replay.
//
// The product: one thread-block cluster of C <= 8 blocks per (segment,
// tile of kTile = 64 of its tokens).  The grid holds
// ceil(T / kTile) + n + 1 clusters, the most tiles the segments can have;
// each cluster finds its (segment, first row) from `seg` with a warp scan,
// and clusters past the last tile leave at once.  Block c of a cluster
// gathers its d/C slice of the tile's x rows through perm, and the
// matching rows of A[g], with 16-byte cp.async copies into a ring of
// shared-memory chunks of 128 elements of d (x's chunks XOR-swizzled), all
// of them in flight at once where they fit, and computes a partial h
// (kTile x r, f32): on tensor cores (m16n8k16, bf16 in, f32 accumulate,
// ldmatrix) where x and the bank are both bf16, and with f32 FMAs
// otherwise (never TF32: f32 SGMV holds 2e-5).  The cluster sums the
// partials through distributed shared memory in block order
// (lora.cuh::cluster_sum), so every block holds the same f32 h; block c
// then expands its o/C columns in f32 with 16-byte loads of B (the first
// rows loaded before the shrink) and 16-byte stores of the y rows,
// scattered back to token order through perm.  Two blocks share an SM (128 registers a thread).  A pointer or
// width off the 16-byte vector takes the scalar path: the same
// shared-memory layout filled element by element, so the arithmetic does
// not change.  What bounds it is the latency of one block's chain of
// round trips (seg, perm, x, the cluster barrier, B, y), not bytes: 20.1
// us at T 1024 against a 3.875 us bound (PERF.md, with one block's
// phases as timed on an H100).
//
// The capacity contract of the TPU kernel stays: a token whose rank inside
// its adapter (arrival order) is >= cap gets exactly 0 (sgmv.py:121-127);
// a tile wholly past cap, and segment n (no adapter), write zeros without a
// shrink.
//
// Ragged mode (`ranks` != NULL): lanes j >= ranks[i] of A's columns enter
// both products as 0 (B's fragments or values zeroed at use, B's rows
// skipped), so the arithmetic is the dense kernel's on a mask_ragged bank
// value for value, and the two agree bitwise.
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "kernels.h"
#include "lora.cuh"

namespace {

namespace lr = repro::lora;
namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // tokens a cluster
constexpr int kK = 128;          // elements of d a ring chunk
constexpr int kMaxStages = 8;    // chunks in flight, at most
constexpr int kStageBudget = 64 * 1024;  // bytes of the ring, about
constexpr int kSmemMax = 200 * 1024;     // bytes of shared memory a block
constexpr int kRG = 4;           // rows a thread expands
constexpr int kSortThreads = 1024;

// ----------------------------------------------------------------------- //
// the sort
// ----------------------------------------------------------------------- //

__device__ __forceinline__ int seg_key(int id, int n) {
  return id >= 0 && id < n ? id : n;
}

// cnt: (warps + 1) x (n + 1) ints of dynamic shared memory.  Warp w owns
// tokens [w * per, (w + 1) * per), 32 at a time; row `warps` of cnt ends as
// the segment starts.
__global__ void __launch_bounds__(kSortThreads)
sgmv_segments_kernel(const int* __restrict__ idx, int* __restrict__ perm,
                     int* __restrict__ seg, int t, int n) {
  extern __shared__ int cnt[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32,
            lane = threadIdx.x % 32;
  const int nk = n + 1;
  for (int i = threadIdx.x; i < (warps + 1) * nk; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int per = ((t + warps - 1) / warps + 31) / 32 * 32;
  const int t0 = warp * per, t1 = min(t0 + per, t);
  int* mine = cnt + warp * nk;
  const unsigned lt = (1u << lane) - 1u;
  for (int base = t0; base < t1; base += 32) {
    const int i = base + lane;
    const int key = i < t1 ? seg_key(idx[i], n) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (i < t1 && (same & lt) == 0) mine[key] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // each key's count over the warps before w (exclusive), and its total
  int* start = cnt + warps * nk;
  for (int key = threadIdx.x; key < nk; key += blockDim.x) {
    int s = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = cnt[w * nk + key];
      cnt[w * nk + key] = s;
      s += c;
    }
    start[key] = s;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the totals: the segment starts
    int run = 0;
    for (int k0 = 0; k0 < nk; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < nk ? start[k] : 0;
      int inc = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += u;
      }
      if (k < nk) {
        start[k] = run + inc - v;
        seg[k] = run + inc - v;
      }
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) seg[nk] = run;
  }
  __syncthreads();
  for (int base = t0; base < t1; base += 32) {
    const int i = base + lane;
    const int key = i < t1 ? seg_key(idx[i], n) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (i < t1) {
      perm[start[key] + mine[key] + __popc(same & lt)] = i;
    }
    __syncwarp();
    if (i < t1 && (same & lt) == 0) mine[key] += __popc(same);
    __syncwarp();
  }
}

// ----------------------------------------------------------------------- //
// the product
// ----------------------------------------------------------------------- //

// Wait until at most `pending` (0..7) of this thread's cp.async groups are
// in flight.
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

struct Args {
  const int* perm;
  const int* seg;
  const int* ranks;
  int t, d, r, o, n, cap;
  float scale;
  int cluster, d_tile, o_tile, stages, rp;  // rp: r padded (8s on the mma path)
  bool vec_x, vec_a, vec_b;
};

// Shared-memory layout (dynamic) of one instance.
template <typename TX, typename TW>
struct Layout {
  static constexpr bool kMma = std::is_same<TX, __nv_bfloat16>::value &&
                               std::is_same<TW, __nv_bfloat16>::value;
  static constexpr int kVX = 16 / sizeof(TX);
  static constexpr int kVW = 16 / sizeof(TW);
  static constexpr int kXChunks = kK / kVX;  // 16-byte chunks of an x row
  __host__ __device__ static int x_bytes() { return kTile * kK * sizeof(TX); }
  __host__ __device__ static int a_bytes(int rp) { return kK * rp * sizeof(TW); }
  __host__ __device__ static int stage_bytes(int rp) { return x_bytes() + a_bytes(rp); }
  // k-parts the mma path splits each chunk's k-steps into
  __host__ __device__ static int kparts(int rp) {
    const int pairs = (kTile / 16) * (rp / 8);
    return kMma && pairs <= kWarps ? kWarps / pairs : 1;
  }
  __host__ __device__ static int bytes(int stages, int rp, int cluster) {
    return stages * stage_bytes(rp) + kparts(rp) * kTile * rp * 4 +
           cluster * kTile * rp * 4;
  }
  // x's element (row i, k) inside a chunk: 16-byte chunks XOR-swizzled by
  // row, so that ldmatrix's eight rows of one chunk hit distinct banks
  __device__ static int x_at(int i, int k) {
    return (i * kXChunks + ((k / kVX) ^ (i % 8))) * kVX + k % kVX;
  }
};

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads, 2)
sgmv_kernel(const TX* __restrict__ x, const TW* __restrict__ a,
            const TW* __restrict__ b, TX* __restrict__ y, Args p) {
  using L = Layout<TX, TW>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cid = blockIdx.x / p.cluster;  // this cluster's tile
  const int c = blockIdx.x % p.cluster;    // this block's rank in it
  __shared__ int s_where[2];               // segment, first row
  __shared__ int tok[kTile];
  __shared__ bool live[kTile];

  // Find the tile: segment g has ceil(count / kTile) tiles, in order.
  if (warp == 0) {
    int base = 0, g_hit = -1, row0 = 0;
    for (int g0 = 0; g0 <= p.n && g_hit < 0; g0 += 32) {
      const int g = g0 + lane;
      const int tiles = g <= p.n ? (p.seg[g + 1] - p.seg[g] + kTile - 1) / kTile : 0;
      int inc = tiles;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += u;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, cid >= base + inc - tiles &&
                                                          cid < base + inc);
      if (hit) {
        const int src = __ffs(hit) - 1;
        g_hit = g0 + src;
        row0 = (cid - base - __shfl_sync(0xffffffffu, inc - tiles, src)) * kTile;
      }
      base += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) {
      s_where[0] = g_hit;
      s_where[1] = row0;
    }
  }
  __syncthreads();
  const int g = s_where[0], row0 = s_where[1];
  if (g < 0) return;  // past the last tile: the whole cluster leaves
  const int start = p.seg[g];
  const int rows = min(kTile, p.seg[g + 1] - start - row0);
  if (tid < kTile) {
    tok[tid] = tid < rows ? p.perm[start + row0 + tid] : 0;
    // rank inside the segment = row0 + i; the capacity contract is this mask
    live[tid] = tid < rows && g < p.n && row0 + tid < p.cap;
  }
  __syncthreads();
  const int o0 = min(c * p.o_tile, p.o), o1 = min(o0 + p.o_tile, p.o);

  if (g >= p.n || row0 >= p.cap) {  // no live row in this tile: zeros
    for (int e = tid; e < rows * (o1 - o0); e += kThreads) {
      const int i = e / (o1 - o0), col = o0 + e % (o1 - o0);
      y[(size_t)tok[i] * p.o + col] = repro::from_float<TX>(0.f);
    }
    return;
  }
  lr::cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = p.ranks ? min(p.ranks[g], p.r) : p.r;
  const int rp = p.rp;
  const TW* ag = a + (size_t)g * p.d * p.r;
  const TW* bg = b + (size_t)g * p.r * p.o;
  const int i0 = min(c * p.d_tile, p.d), i1 = min(i0 + p.d_tile, p.d);
  const int n_chunks = (i1 - i0 + kK - 1) / kK;

  extern __shared__ __align__(16) unsigned char smem[];
  auto xs_of = [&](int q) {
    return reinterpret_cast<TX*>(smem + (q % p.stages) * L::stage_bytes(rp));
  };
  auto as_of = [&](int q) {
    return reinterpret_cast<TW*>(smem + (q % p.stages) * L::stage_bytes(rp) +
                                 L::x_bytes());
  };
  float* kpart = reinterpret_cast<float*>(smem + p.stages * L::stage_bytes(rp));
  float* parts = kpart + L::kparts(rp) * kTile * rp;  // [cluster][kTile][rp]
  float* h = kpart;  // [kTile][rp], after the partials are pushed

  // Chunk q: x[tok[i], i0 + q*kK + k] and A[g][i0 + q*kK + k, :], k < kK,
  // zero past i1 and past the tile's rows.
  auto load = [&](int q) {
    const int k0 = i0 + q * kK;
    TX* xs = xs_of(q);
    TW* as = as_of(q);
    if (p.vec_x) {
      for (int e = tid; e < kTile * L::kXChunks; e += kThreads) {
        const int i = e / L::kXChunks, ch = e % L::kXChunks;
        const int col = k0 + ch * L::kVX;
        const bool ok = i < rows && col < i1;
        repro::cp_async16(xs + L::x_at(i, ch * L::kVX),
                          ok ? x + (size_t)tok[i] * p.d + col : x, ok);
      }
    } else {
      for (int e = tid; e < kTile * kK; e += kThreads) {
        const int i = e / kK, k = e % kK;
        const bool ok = i < rows && k0 + k < i1;
        xs[L::x_at(i, k)] = ok ? x[(size_t)tok[i] * p.d + k0 + k]
                               : repro::from_float<TX>(0.f);
      }
    }
    if (p.vec_a) {  // rows of r elements, r a multiple of the vector, rp == r
      const int nv = p.r / L::kVW;
      for (int e = tid; e < kK * nv; e += kThreads) {
        const int k = e / nv, v = e % nv;
        const bool ok = k0 + k < i1;
        repro::cp_async16(as + k * rp + v * L::kVW,
                          ok ? ag + (size_t)(k0 + k) * p.r + v * L::kVW : ag, ok);
      }
    } else {
      for (int e = tid; e < kK * rp; e += kThreads) {
        const int k = e / rp, j = e % rp;
        const bool ok = k0 + k < i1 && j < p.r;
        as[e] = ok ? ag[(size_t)(k0 + k) * p.r + j] : repro::from_float<TW>(0.f);
      }
    }
  };
  for (int q = 0; q < p.stages; ++q) {  // every slot's copies in flight
    if (q < n_chunks) load(q);
    repro::cp_async_commit();
  }
  // the first rows of B for this thread's first expand item go out before
  // the shrink, which overlaps their round trip
  constexpr int kVW = L::kVW;
  lr::BRows<TW, kVW> first_v;
  lr::BRows<TW, 1> first_s;
  const int ncv = (o1 - o0) / (p.vec_b ? kVW : 1);
  if (tid < ncv * (kTile / kRG)) {
    const int col = o0 + (tid % ncv) * (p.vec_b ? kVW : 1);
    if (p.vec_b)
      first_v.load(bg, p.o, col, 0, rank);
    else
      first_s.load(bg, p.o, col, 0, rank);
  }

  // The partial h over this block's slice.  mma: warp item (pair, kpart),
  // pair = (16-row block, 8-lane block); kpart takes k-steps ks with
  // ks % kparts == kpart.  FMA: thread output e = tid + u * kThreads.
  const int kparts = L::kparts(rp);
  const int pairs = (kTile / 16) * (rp / 8);
  constexpr int kMaxItems = (kTile / 16) * (lr::kMaxRank / 8) / kWarps;
  constexpr int kMaxOut = kTile * lr::kMaxRank / kThreads;
  float acc[kMaxItems][4];  // mma fragments
  float facc[kMaxOut];      // FMA outputs
#pragma unroll
  for (int u = 0; u < kMaxItems; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) facc[u] = 0.f;

  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait_upto(p.stages - 1);
    __syncthreads();
    const TX* xs = xs_of(q);
    const TW* as = as_of(q);
    if constexpr (L::kMma) {
#pragma unroll
      for (int u = 0; u < kMaxItems; ++u) {
        const int item = warp + u * kWarps;
        if (item < pairs * kparts) {
          const int pair = item % pairs, kp = item / pairs;
          const int mb = pair % (kTile / 16), nb = pair / (kTile / 16);
          const int ncol = nb * 8 + lane / 4;  // this lane's column of B
          for (int ks = kp; ks < kK / 16; ks += kparts) {
            unsigned af[4];
            repro::ldmatrix_x4<false>(af, xs + L::x_at(mb * 16 + lane % 16,
                                         ks * 16 + (lane / 16) * 8));
            unsigned b0, b1;
            repro::ldmatrix_x2_trans(b0, b1, as + (ks * 16 + lane % 16) * rp + nb * 8);
            if (ncol >= rank) b0 = b1 = 0u;  // ragged lanes enter as 0
            repro::mma_bf16(acc[u], af, b0, b1);
          }
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kMaxOut; ++u) {
        const int e = tid + u * kThreads;
        if (e < kTile * rp) {
          const int i = e / rp, j = e % rp;
          float s = facc[u];
          if (j < rank)
            for (int k = 0; k < kK; ++k)
              s += repro::to_float(xs[L::x_at(i, k)]) * repro::to_float(as[k * rp + j]);
          facc[u] = s;
        }
      }
    }
    __syncthreads();  // the slot is free: refill it
    if (q + p.stages < n_chunks) load(q + p.stages);
    repro::cp_async_commit();
  }
  repro::cp_async_wait(0);

  // kpart[kp][i][j]: each k-part's partial, then their sum, pushed.
  if constexpr (L::kMma) {
#pragma unroll
    for (int u = 0; u < kMaxItems; ++u) {
      const int item = warp + u * kWarps;
      if (item < pairs * kparts) {
        const int pair = item % pairs, kp = item / pairs;
        const int mb = pair % (kTile / 16), nb = pair / (kTile / 16);
        const int i = mb * 16 + lane / 4, j = nb * 8 + 2 * (lane % 4);
        float* kq = kpart + kp * kTile * rp;
        kq[i * rp + j] = acc[u][0];
        kq[i * rp + j + 1] = acc[u][1];
        kq[(i + 8) * rp + j] = acc[u][2];
        kq[(i + 8) * rp + j + 1] = acc[u][3];
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kMaxOut; ++u) {
      const int e = tid + u * kThreads;
      if (e < kTile * rp) kpart[e] = facc[u];
    }
  }
  __syncthreads();
  float mine[kMaxOut];
#pragma unroll
  for (int u = 0; u < kMaxOut; ++u) {
    const int e = tid + u * kThreads;
    float s = 0.f;
    if (e < kTile * rp)
      for (int kp = 0; kp < kparts; ++kp) s += kpart[kp * kTile * rp + e];
    mine[u] = s;
  }
  lr::cluster_sum<kMaxOut>(cluster, parts, kTile * rp,
                           [&](int u) { return mine[u]; }, h);

  // Expand columns [o0, o1) of the tile's rows, kRG rows a thread.
  auto expand = [&](auto vb, const lr::BRows<TW, decltype(vb)::value>& first) {
    constexpr int VB = decltype(vb)::value;
    for (int item = tid; item < ncv * (kTile / kRG); item += kThreads) {
      const int cv = item % ncv, rg = item / ncv;
      if (rg * kRG >= rows) continue;
      const int col = o0 + cv * VB;
      float out[kRG][VB];
#pragma unroll
      for (int i = 0; i < kRG; ++i)
#pragma unroll
        for (int e = 0; e < VB; ++e) out[i][e] = 0.f;
      for (int l0 = 0; l0 < rank; l0 += lr::kRowBatch) {
        lr::BRows<TW, VB> br;
        if (l0 == 0 && item == tid)
          br = first;
        else
          br.load(bg, p.o, col, l0, rank);
#pragma unroll
        for (int j = 0; j < lr::kRowBatch; ++j) {
          if (l0 + j < rank) {
            float bv[VB];
            br.row[j].get(bv);
#pragma unroll
            for (int i = 0; i < kRG; ++i) {
              const float hv = h[(rg * kRG + i) * rp + l0 + j];
#pragma unroll
              for (int e = 0; e < VB; ++e) out[i][e] += hv * bv[e];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRG; ++i) {
        const int row = rg * kRG + i;
        if (row < rows) {
          if (!live[row])
#pragma unroll
            for (int e = 0; e < VB; ++e) out[i][e] = 0.f;
          lr::store<TX, VB>(y + (size_t)tok[row] * p.o + col, out[i], p.scale);
        }
      }
    }
  };
  if (p.vec_b)
    expand(std::integral_constant<int, kVW>(), first_v);
  else
    expand(std::integral_constant<int, 1>(), first_s);
}

// The cluster of one tile: C <= 8 blocks; block c shrinks rows [c * d_tile,
// (c + 1) * d_tile) of d and expands columns [c * o_tile, (c + 1) * o_tile)
// of o, clipped.  d_tile is a multiple of 16 (the mma k-step; slices start
// on 16 bytes), o_tile of 8.
template <typename TX, typename TW>
int launch(const void* x, const void* a, const void* b, void* y, Args p,
           cudaStream_t st) {
  using L = Layout<TX, TW>;
  auto cdiv = [](int u, int v) { return (u + v - 1) / v; };
  p.rp = L::kMma ? cdiv(p.r, 8) * 8 : p.r;
  p.cluster = std::min(lr::kMaxCluster,
                       std::max(1, std::max(cdiv(p.o, 256), cdiv(p.d, 256))));
  // each block receives every block's partial (cluster * kTile * rp
  // floats): fewer blocks where those would not fit beside a 2-stage ring
  while (p.cluster > 1 && L::bytes(2, p.rp, p.cluster) > kSmemMax) --p.cluster;
  p.d_tile = cdiv(cdiv(p.d, p.cluster), 16) * 16;
  p.o_tile = cdiv(cdiv(p.o, p.cluster), 8) * 8;
  p.vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && p.d % L::kVX == 0;
  p.vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && p.r % L::kVW == 0 &&
            p.rp == p.r;
  p.vec_b = (reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y)) %
                    16 == 0 &&
            p.o % L::kVW == 0;
  p.stages = std::max(2, std::min({kMaxStages, cdiv(p.d_tile, kK),
                                   kStageBudget / L::stage_bytes(p.rp)}));
  const int smem = L::bytes(p.stages, p.rp, p.cluster);
  auto kernel = sgmv_kernel<TX, TW>;
  static repro::SmemLimit limit;
  cudaError_t err = limit.raise(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int clusters = cdiv(p.t, kTile) + p.n + 1;
  err = lr::launch_clusters(kernel, dim3(clusters * p.cluster), kThreads,
                            p.cluster, smem, st, false, static_cast<const TX*>(x),
                            static_cast<const TW*>(a), static_cast<const TW*>(b),
                            static_cast<TX*>(y), p);
  return static_cast<int>(err);
}

int launch_segments(const void* idx, void* perm, void* seg, int t, int n,
                    cudaStream_t st) {
  // (warps + 1) x (n + 1) counters, within the block's shared memory
  constexpr int kBudget = 200 * 1024;
  const int warps = std::min(kSortThreads / 32, kBudget / (4 * (n + 1)) - 1);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (warps + 1) * (n + 1) * 4;
  static repro::SmemLimit limit;
  cudaError_t err = limit.raise(sgmv_segments_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sgmv_segments_kernel<<<1, warps * 32, smem, st>>>(
      static_cast<const int*>(idx), static_cast<int*>(perm),
      static_cast<int*>(seg), t, n);
  return static_cast<int>(cudaPeekAtLastError());
}

}  // namespace

extern "C" int repro_sgmv_segments(const void* idx, void* perm, void* seg,
                                   int t, int n, void* stream) {
  if (t <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_segments(idx, perm, seg, t, n, static_cast<cudaStream_t>(stream));
}

extern "C" int repro_sgmv(const void* x, const void* a, const void* b,
                          const void* idx, void* perm, void* seg,
                          const void* ranks, void* y, int t, int d, int r,
                          int o, int n, int cap, float scale, int x_dtype,
                          int w_dtype, void* stream) {
  if (t <= 0 || o <= 0) return 0;
  if (r < 1 || r > lr::kMaxRank || n < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = launch_segments(idx, perm, seg, t, n, st);
  if (rc) return rc;
  Args p = {static_cast<const int*>(perm), static_cast<const int*>(seg),
            static_cast<const int*>(ranks), t, d, r, o, n, cap, scale};
  REPRO_DISPATCH_DTYPE(x_dtype, TX, REPRO_DISPATCH_DTYPE(w_dtype, TW,
      rc = (launch<TX, TW>(x, a, b, y, p, st))));
  if (rc) return rc;
  return static_cast<int>(cudaPeekAtLastError());
}
