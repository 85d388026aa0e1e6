// Flash-decode: single-query GQA attention over a contiguous KV cache, and
// the same with a multi-adapter LoRA delta fused into its epilogue.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode.py:
// flash_decode (_fd_kernel, pallas_call at :95) and flash_decode_lora
// (_fd_lora_kernel, pallas_call at :205).  Pallas walked the KV blocks of
// one batch row in order on one core, carrying the online-softmax state
// (m, l, acc) in VMEM scratch from grid step to grid step; the fused kernel
// added scale * x @ A[id] @ B[id] on the last block, A[id] and B[id] DMAed
// by index maps that clamped id to >= 0.
//
// What bounds it here: each query head reads its whole KV row once and does
// 4*D FLOPs per position against 2*D*bytes of K and V, so the kernel is bound
// by the bytes of K and V it streams (at B=8, S=512, KV=8, D=128 in bf16,
// 16.8 MB: about 5 us at 3.35 TB/s).  Streaming at that rate across 132 SMs
// with about 1 us of memory latency needs about 25 KB in flight on each SM.
// The LoRA delta adds the bytes of x and of each used adapter's A and B (at
// dx=3072, r=8: 0.1 MB per adapter).
//
// Design: split-KV.  Blocks cannot carry state from one to the next, and one
// block per (row, kv-head) would leave most of the 132 SMs idle at decode
// batch sizes, so the sequence is cut into n_splits chunks of whole tiles
// (flash_decode.py::split_plan) and one block per (split, kv-head, row)
// covers the G query heads that share that KV head (query head h reads KV
// head h / G), so K and V are read once for all G.  Past a pass's heads a
// block (kMaxG, 8, which size the per-head arrays of every pass but one;
// kMaxG256, 16, on the bf16 pass at D 256, whose heads are the 16 rows of
// its products), a KV head's G heads are cut into groups on grid y, one
// block per (split, kv-head, group, row), and each group reads the KV
// head's K and V.  So recurrentgemma-9b's 16 heads on 1 KV head (D 256)
// read them once; at 24 heads, twice.  Those launches run instances of
// their own (kGroups), so that a launch of one group runs the code it ran
// before.  The combine works per (row, head) and does not see the groups.
//
// The split pass streams its chunk through shared memory in tiles of kP
// positions (16 KB of K and 16 KB of V at D 128 in bf16) with 16-byte
// cp.async copies, in a ring of as many stages as the chunk has tiles (at
// most three), all issued before anything waits, so an SM with two or three
// blocks keeps 100-200 KB in flight.  Rows of K and V are 16-byte chunks
// whose slot is XOR-swizzled by position, so that eight lanes (or an
// ldmatrix phase) reading one chunk of eight positions hit distinct banks.
// Positions past the chunk's end or the row's length are filled with zeros
// by the copy (never read from memory) and masked out of the softmax; a
// length >= S means all of S; a block past its row's length writes an empty
// partial, and a length of 0 gives 0, as the Pallas kernel does.
//
// In bf16 (D 16-128) the tile is computed on tensor cores (split_mma): each
// of the block's four warps owns a quarter of every tile's positions, copies
// its own rows and runs its own online softmax, so the tile loop has no
// block barrier.  S = Q K^T is an m16n8k16 product with the G query heads as
// rows (padded to 16); (m, l) are updated once per tile from the score
// fragments with quad shuffles; P, split in the same registers into
// bf16(P) and bf16(P - bf16(P)), is the A operand of two products O += P V
// into one accumulator (about 16 bits of P, where the Pallas kernel keeps
// f32), V's fragments coming from ldmatrix.trans.  The warps merge by
// log-sum-exp at the end of the chunk.
//
// In bf16 at D 256 a tile is 32 positions, a warp's quarter 8, under a
// 16-position k-block, and an accumulator of all 256 columns would take
// 128 registers a thread: that pass (split_mma_d256) splits the work
// between the warps by positions for S and by columns for P V.  Each warp
// copies the K rows of its 8 positions and V's 64 columns it accumulates,
// computes its positions' scores for up to 16 heads (the A operand's 16
// rows) and puts them in shared memory; after one block barrier a tile
// every warp runs the same online softmax over all 32 positions, so (m, l)
// agree across the warps and need no merge, and adds P V on its columns
// (32 accumulator registers).  One block reads a KV head's K and V once
// for up to 16 heads; it streams 1 KB a position, the pass's bound.
//
// In f32, in the int8 mode at D 256, and in bf16 at D 8 (a row is under
// one k-step; its 16 bytes are one chunk), the same ring feeds a CUDA-core
// pass (split_scalar): threads that own positions compute the scores, one
// warp per head updates the softmax once per tile, threads that own
// (d-chunk, position group) accumulate P V in registers.  The first
// design had each warp take one position at a time with 2-byte loads, a
// shuffle reduction and two expf per head per position: 29.70 us at the
// serving shape, 3x SDPA (PERF.md); bf16 at D 256 ran this pass before
// split_mma_d256 (4.27x SDPA at recurrentgemma-9b's 16 heads over 2048
// rows at B 128, where two head groups of 8 read K and V twice).
//
// Head dims: the passes are instantiated at D = 8, 16, ..., 256 (the int8
// mode from 16).  The Pallas kernel takes any D (its block is the whole
// (block_s, KV, D) slab); here a head dim d without an instance runs the
// instance of the next larger D, padded: the ring is zeroed once and each
// row's d elements are copied into the first d of its D (in pieces of 16,
// 8 or 4 bytes by cp.async, or 2 and 1 through registers, as the row's
// byte width allows), q is zero past d, the scale is 1/sqrt(d), and only
// d elements of each partial are written; the pass is the one D's
// instance takes (tensor cores in bf16 at D 16-256).  The instantiated
// dims' instances are the code they were (kPad = false).
//
// Head dims past 256 (up to kWideMaxHeadDim, 1024) take a wide path of
// kernels of their own (fd_split_wide_kernel, fd_int8_max_wide_kernel,
// fd_combine_wide_kernel), so that no instance above changes: a register
// file and a ring sized by D would not fit one block there.  The split
// pass reads K and V straight from global memory in tiles of kWideP (32)
// positions, on CUDA cores: one warp a position dots q with K over d (lane
// l the elements l, l + 32, ...; a shuffle sum), one lane a position runs
// the softmax of a head, and each thread owns elements t, t + 128, ... of
// d for every head in P V.  q is staged in shared memory as f32 (32 KB at
// 8 heads of 1024).  Each mode keeps the arithmetic it has below 256: f32
// accumulation; the int8 mode with bf16 q rounds P times v_scale against
// each split's running max; with f32 q a pre-pass finds the row's max and
// q . k is summed in f64 and rounded once, both passes calling one
// function (wide_dot), so that their scores agree.  The combine is the
// plain one, which loops over any dh; the fused one gets an instance with
// a 1024-element delta.
//
// The int8 mode (fd_split_int8_kernel) reads an int8 cache with one f16
// scale per (position, KV head), the layout of the JAX package's int8 KV
// cache (quantize_kv, src/repro/models/attention.py:226-241; its decode,
// :271-314, is plain jnp, no Pallas kernel).  It halves the bytes of K and
// V (at B 8, S 32768, KV 8, D 128: 537 MB a layer, against 1.07 GB in
// bf16; the scales add 8.4 MB), which bound the pass.  Its tiles are 16 KB
// of int8 (128 positions at D <= 128).  With bf16 q at D 32-128 it runs on
// tensor cores (split_mma_int8): split_mma's warp layout, each lane turning
// the int8 bytes it reads into bf16 fragments in registers, so no tile is
// dequantized in shared memory; with f32 q, and at D 16 and 256, on CUDA
// cores (split_scalar).  The scores are scaled by the position's k scale;
// P, times the position's v scale and rounded to bf16 (as the JAX package
// rounds it, against the row's global max), multiplies V; the sum of the
// f32 P divides, in the unchanged combine.  With q in bf16 (the serving
// path, held at bf16's tolerance) the pass rounds against each split's
// running max; with q in f32 a pre-pass (fd_int8_max_kernel) first finds
// each split's largest score, and the split pass rounds against the max
// over the splits from its first tile on, as the JAX arithmetic does (the
// combine's rescale factors are then all 1).
// The scales, 2 bytes KV apart, do not fit the 16-byte copies: they are
// plain loads, issued ahead of the scores that need them.
//
// A second kernel, one block per (row, head), merges the splits by
// log-sum-exp and writes q's dtype.  The slices of a sequence-sharded cache
// (the JAX package's decode_attention_sharded, plain jnp) combine by each
// slice's log-sum-exp: a call that asks for it (an lse buffer given to
// repro_flash_decode or repro_flash_decode_int8) runs the same
// split pass and a combine kernel of its own (fd_combine_lse_kernel),
// which also writes m + log l per (row, head) and leaves the output in
// f32, so that no other instance's code changes.  The fused kernel
// launches a LoRA shrink between the two (fd_lora_shrink_kernel): one
// thread-block cluster of C <= 8 blocks per row, block c shrinking its
// dx/C slice of h = x[row] @ A[id] with 16-byte loads of A and the
// cluster summing the partials through distributed shared memory in one
// fixed order (lora.cuh::cluster_shrink, BGMV's), into an f32 scratch, as
// the Pallas epilogue keeps h in f32.  The shrink and the combine (with
// kLora) are each the programmatic dependent of the launch before, and the
// split pass's fused instance (kEarly) lets the shrink start at once: the
// shrink runs beside the split pass, then waits for it; the combine puts
// its rows of B in flight, waits for the shrink, and then reads h, merges
// its head and adds scale * h @ B[id][:, head*D:(head+1)*D] (rows spread
// over the block's threads, 16-byte loads) to the f32 attention before the
// one cast.  With the shrink inside a clustered combine (one block per
// (row, head) computing it) most of batch 32's 768 combine blocks ran it
// after the split pass (PERF.md).  Plain flash-decode launches its two
// kernels as before.  A row whose id is outside [0, N) skips the shrink
// and the add, so an all-base batch is bitwise the plain kernel's output.
#include <type_traits>

#include "common.cuh"
#include "kernels.h"
#include "lora.cuh"

namespace {

namespace lr = repro::lora;

constexpr int kThreads = 128;        // split pass
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxStages = 3;
constexpr int kTileBytes = 16384;    // of K in one tile (as many of V)
constexpr int kCombineThreads = 128;
constexpr int kShrinkRows = 512;     // rows of dx a shrink block, at least
constexpr int kMaxHeadDim = 256;
constexpr int kWideMaxHeadDim = 1024;  // the wide path's (past kMaxHeadDim)
constexpr int kWideP = 32;             // positions in one of its tiles
constexpr int kWideE = kWideMaxHeadDim / kThreads;  // d elements a thread
// The fused combine starts while the split pass runs and should fit on an
// SM beside two split blocks of up to 216 registers a thread (bf16, D
// 128): 6 blocks an SM holds it to 80 registers, 10240 a block.
constexpr int kLoraCombineBlocks = 6;
constexpr float kNegInf = -1.0e30f;  // finite, as in Pallas: exp(m - m) stays 1

constexpr int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Head groups: the G = h / kv query heads that share a KV head are cut
// into ceil(G / max_g) groups of at most max_g (kMaxG; kMaxG256 on the
// bf16 pass at D 256, split_mma_d256), sizes differing by at most one,
// and grid y is (KV head, group).  A block's heads are heads [first,
// first + g_n) of its KV head's G.  The split passes are instantiated with
// kGroups only for G > max_g: a G <= max_g launch (one block per KV head
// on grid y) runs the code it ran before head groups, whose time they
// must not move; its expressions are kept as they were, since a rewrite
// that computes the same values moved its registers and time.
constexpr int kMaxG256 = 16;  // query heads a block of split_mma_d256

// Whether (T, D) takes split_mma_d256: bf16 at D 256 (D 129-255 padded
// onto it).
template <typename T, int D>
constexpr bool kMmaD256 =
    std::is_same<T, __nv_bfloat16>::value && D == kMaxHeadDim;

__host__ __device__ constexpr int head_groups(int g, int max_g = kMaxG) {
  return (g + max_g - 1) / max_g;
}

template <bool kGroups, int kMax = kMaxG>
__device__ __forceinline__ int groups_per_kv_head(int h, int kv) {
  if constexpr (kGroups) return head_groups(h / kv, kMax);
  else return 1;
}

struct HeadGroup {
  int first, g_n;
};

template <bool kGroups, int kMax = kMaxG>
__device__ __forceinline__ HeadGroup head_group(int y, int h, int kv) {
  const int g_all = h / kv;
  if constexpr (!kGroups) {
    return {0, g_all};
  } else {
    const int n_grp = head_groups(g_all, kMax);
    const int grp = y % n_grp, first = grp * g_all / n_grp;
    return {first, (grp + 1) * g_all / n_grp - first};
  }
}

// The tile geometry of one (dtype, head dim) instance.  kP is mirrored by
// flash_decode.py::tile_positions, which cuts chunks into whole tiles.
template <typename T, int D>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;   // 16-byte chunks a row
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kP = clampi(kTileBytes / kRowBytes, 16, 128);
  static constexpr int kBytes = kP * kRowBytes;    // K (or V) of one tile
  static constexpr int kKS = kThreads / kP;        // threads a position (scores)
  static constexpr int kPG = kThreads / kChunks;   // position groups (P.V)
  static constexpr int kWarpPG = kChunks >= 32 ? 1 : 32 / kChunks;
  static constexpr int kParts = kPG / kWarpPG;     // P.V partials after shuffles
  static constexpr int kSw = kChunks < 8 ? kChunks : 8;
  // the tensor-core pass: bf16, and 16-position k-blocks for each warp
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value &&
                               D >= 16 && kP % (16 * kWarps) == 0;
  static_assert(kChunks >= 1 && kChunks % kKS == 0 && kP % kPG == 0, "tile");
  static_assert(kParts * kMaxG * D * 4 <= 2 * kBytes, "reduction fits the ring");
  // Shared-memory slot of chunk c of position p: the chunk index is XORed
  // with bits of p so that chunk c of 8 consecutive positions lands in 8
  // distinct 16-byte bank groups (a row is kRowBytes, often a multiple of
  // the 128-byte bank line).
  __device__ static int slot(int p, int c) {
    return p * kChunks + (c ^ ((p / (8 / kSw)) % kSw));
  }
};

// Issue the copies of rows [r0, r0 + kRows) of one tile of K and V (tile
// position p is sequence position p0 + p; those at or past `end` are
// zero-filled) into the ring slot at `ks` (K, then V), thread t of nt.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* ks, const T* k, const T* v,
                                          size_t base, size_t stride, int p0,
                                          int end, int r0, int t, int nt) {
  using G = Tile<T, D>;
#pragma unroll
  for (int i = t; i < kRows * G::kChunks; i += nt) {
    const int p = r0 + i / G::kChunks, c = i % G::kChunks;
    const bool valid = p0 + p < end;
    const size_t off = base + (valid ? (size_t)(p0 + p) * stride : 0) + c * G::kVec;
    const int sl = G::slot(p, c) * G::kVec;
    repro::cp_async16(ks + sl, k + off, valid);
    repro::cp_async16(ks + G::kP * D + sl, v + off, valid);
  }
}

// Padded instances: a head dim d that has no instance runs the next larger
// one, D, whose tiles keep their D-element rows.  zero_ring clears the
// ring once, before any copy (the caller then waits at a block barrier);
// load_tile_pad writes only the first d elements of each row, so the rest
// stay zero and the products over D equal those over d.
template <typename KV, int D>
__device__ __forceinline__ void zero_ring(unsigned char* ring, int stages,
                                          int t, int nt) {
  uint4* w = reinterpret_cast<uint4*>(ring);
  for (int i = t; i < stages * 2 * Tile<KV, D>::kBytes / 16; i += nt)
    w[i] = make_uint4(0u, 0u, 0u, 0u);
}

// load_tile for rows of d < D elements (base and stride count d-element
// rows).  A row's d * sizeof(KV) bytes need not be a multiple of 16, nor
// its start aligned to 16: each row goes in pieces of w bytes, the largest
// power of two up to 16 that divides the row's bytes (k and v are 16-byte
// aligned, so every piece is aligned to w); pieces of 16, 8 or 4 bytes by
// cp.async, of 2 or 1 through registers.  A piece lies inside one of the
// row's 16-byte chunks, so the chunks keep their swizzled slots.
template <typename KV, int D, int kRows>
__device__ __forceinline__ void load_tile_pad(KV* ks, const KV* k,
                                              const KV* v, size_t base,
                                              size_t stride, int p0, int end,
                                              int r0, int t, int nt, int d) {
  using G = Tile<KV, D>;
  const int row_bytes = d * static_cast<int>(sizeof(KV));
  const int w = min(row_bytes & -row_bytes, 16);
  const int n_pc = row_bytes / w;
  const char* kg = reinterpret_cast<const char*>(k);
  const char* vg = reinterpret_cast<const char*>(v);
  char* kd = reinterpret_cast<char*>(ks);
  char* vd = kd + G::kBytes;
  for (int i = t; i < kRows * n_pc; i += nt) {
    const int p = r0 + i / n_pc, b = (i % n_pc) * w;
    const bool valid = p0 + p < end;
    const size_t off =
        (base + (valid ? (size_t)(p0 + p) * stride : 0)) * sizeof(KV) + b;
    const int sl = G::slot(p, b / 16) * 16 + b % 16;
    if (w == 16) {
      repro::cp_async16(kd + sl, kg + off, valid);
      repro::cp_async16(vd + sl, vg + off, valid);
    } else if (w == 8) {
      repro::cp_async_small<8>(kd + sl, kg + off, valid);
      repro::cp_async_small<8>(vd + sl, vg + off, valid);
    } else if (w == 4) {
      repro::cp_async_small<4>(kd + sl, kg + off, valid);
      repro::cp_async_small<4>(vd + sl, vg + off, valid);
    } else if (w == 2) {
      const uint16_t zero = 0;
      *reinterpret_cast<uint16_t*>(kd + sl) =
          valid ? *reinterpret_cast<const uint16_t*>(kg + off) : zero;
      *reinterpret_cast<uint16_t*>(vd + sl) =
          valid ? *reinterpret_cast<const uint16_t*>(vg + off) : zero;
    } else {
      kd[sl] = valid ? kg[off] : 0;
      vd[sl] = valid ? vg[off] : 0;
    }
  }
}

// The split pass on CUDA cores (f32, bf16 at D 8, and the int8 mode):
// all 128 threads work on each tile together, four barriers a tile.  q is
// T; K and V are KV, T itself or int8 with the f16 scales k_scale and
// v_scale of (bsz, s, kv) (kQuant).  With kPad the head dim is d < D (a
// padded instance: zero_ring, load_tile_pad; q, the scale and the
// partials take d).  With kGlobalMax (the int8 mode with q in f32) each
// head's softmax runs against the row's global max, fd_int8_max_kernel's
// partials in max_part, from the first tile on, and each score's q . k is
// summed in f64 and rounded to f32 once (ScoreT), with the scale
// 1/sqrt(d) rounded once from f64: each product of an f32 and an int8
// value is exact in f64, so the score is the f32 value that no order of
// summation changes, which the plain version computes with exact_dot.
template <typename T, typename KV, int D, bool kGroups, bool kPad = false,
          bool kGlobalMax = false>
__device__ __forceinline__ void split_scalar(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, const __half* __restrict__ k_scale,
    const __half* __restrict__ v_scale, const int* __restrict__ length,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int s, int h, int kv, int n_splits,
    int chunk, int stages, int d = D,
    const float* __restrict__ max_part = nullptr) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using G = Tile<KV, D>;
  using ScoreT = typename std::conditional<kGlobalMax, double, float>::type;
  constexpr int kP = G::kP, kVec = G::kVec, kChunks = G::kChunks;
  static_assert(kP <= kThreads, "one thread a position loads the scales");
  const int split = blockIdx.x,
            kvh = blockIdx.y / groups_per_kv_head<kGroups>(h, kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<kGroups>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale =
      kGlobalMax ? static_cast<float>(1.0 / sqrt(static_cast<double>(d)))
                 : rsqrtf(static_cast<float>(kPad ? d : D));
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kP - 1) / kP : 0;

  extern __shared__ __align__(16) unsigned char fd_ring[];
  __shared__ __align__(16) float qs[kMaxG][D];
  __shared__ ScoreT sc[G::kKS][kMaxG][kP];
  __shared__ float pr[kMaxG][kP];
  __shared__ float corr_s[kMaxG];
  __shared__ float tile_scale[kQuant ? 2 : 1][kQuant ? kP : 1];  // k, v
  KV* ring = reinterpret_cast<KV*>(fd_ring);
  auto k_slot = [&](int i) { return ring + (size_t)(i % stages) * 2 * kP * D; };

  const size_t base = ((size_t)row * s * kv + kvh) * (kPad ? d : D);
  const size_t stride = (size_t)kv * (kPad ? d : D);
  auto load = [&](int i) {
    if constexpr (kPad)
      load_tile_pad<KV, D, kP>(k_slot(i), k, v, base, stride, s0 + i * kP,
                               s1, 0, tid, kThreads, d);
    else
      load_tile<KV, D, kP>(k_slot(i), k, v, base, stride, s0 + i * kP, s1,
                           0, tid, kThreads);
  };
  if constexpr (kPad) {
    zero_ring<KV, D>(fd_ring, stages, tid, kThreads);
    __syncthreads();
  }
  for (int i = 0; i < stages; ++i) {  // every slot's copies in flight
    if (i < n_tiles) load(i);
    repro::cp_async_commit();
  }
  if constexpr (kPad) {
    for (int i = tid; i < g_n * D; i += kThreads) {
      const int e = i % D;
      qs[i / D][e] = e < d ? repro::to_float(
                                 q[((size_t)row * h + kvh * (h / kv) +
                                    hg.first + i / D) * d + e])
                           : 0.f;
    }
  } else {
    for (int i = tid; i < g_n * D; i += kThreads)
      qs[i / D][i % D] =
          repro::to_float(q[((size_t)row * h + kvh * (h / kv) + hg.first) * D +
                            i]);
  }

  // Softmax state of the heads this warp owns (w, w + kWarps), and the P.V
  // accumulator of this thread's (d-chunk, position group) for every head.
  float m[kMaxG / kWarps], l[kMaxG / kWarps];
#pragma unroll
  for (int j = 0; j < kMaxG / kWarps; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  if constexpr (kGlobalMax) {
    // each head's max over the splits' maxima: P is rounded to bf16
    // against it, as the JAX package rounds it against the row's max
#pragma unroll
    for (int j = 0; j < kMaxG / kWarps; ++j) {
      const int g = warp + kWarps * j;
      if (g < g_n) {
        const float* mp =
            max_part +
            ((size_t)row * h + kvh * (h / kv) + hg.first + g) * n_splits;
        float mx = kNegInf;
        for (int i = lane; i < n_splits; i += 32) mx = fmaxf(mx, mp[i]);
        m[j] = repro::warp_max(mx);
      }
    }
  }
  float acc[kMaxG][kVec];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  const int sp = tid % kP, sks = tid / kP;           // score pass
  const int vc = tid % kChunks, vpg = tid / kChunks;  // P.V pass

  for (int it = 0; it < n_tiles; ++it) {
    // int8: position tid's scales (0 past the chunk), in flight during the
    // scores, which do not need them
    float k_sc = 0.f, v_sc = 0.f;
    if constexpr (kQuant) {
      const int p = s0 + it * kP + tid;
      if (tid < kP && p < s1) {
        const size_t i = ((size_t)row * s + p) * kv + kvh;
        k_sc = __half2float(k_scale[i]);
        v_sc = __half2float(v_scale[i]);
      }
    }
    repro::cp_async_wait(stages - 1);  // this thread's copies of tile `it`
    __syncthreads();                   // everyone's
    const KV* kt = k_slot(it);
    const KV* vt = kt + kP * D;
    const int n_valid = min(kP, s1 - (s0 + it * kP));

    // Scores: thread (sp, sks) dots chunks sks, sks + kKS, ... of K[sp].
    {
      ScoreT part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks / G::kKS; ++i) {
        const int c = sks + G::kKS * i;
        float kf[kVec];
        repro::unpack16<KV>(
            *reinterpret_cast<const uint4*>(kt + G::slot(sp, c) * kVec), kf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_n) {
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              part[g] += static_cast<ScoreT>(qs[g][c * kVec + e]) * kf[e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < g_n) sc[sks][g][sp] = part[g];
    }
    if constexpr (kQuant) {
      if (tid < kP) {
        tile_scale[0][tid] = k_sc;
        tile_scale[1][tid] = v_sc;
      }
    }
    __syncthreads();

    // Online softmax, once per tile: warp w updates heads w, w + kWarps.
#pragma unroll
    for (int j = 0; j < kMaxG / kWarps; ++j) {
      const int g = warp + kWarps * j;
      if (g < g_n) {
        constexpr int kPer = (kP + 31) / 32;
        float sv[kPer];
        float mx = kNegInf;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int p = lane + 32 * i;
          float x = kNegInf;
          if (p < n_valid) {
            if constexpr (kGlobalMax) {
              double xd = 0.0;
#pragma unroll
              for (int u = 0; u < G::kKS; ++u) xd += sc[u][g][p];
              x = static_cast<float>(xd);
            } else {
              x = 0.f;
#pragma unroll
              for (int u = 0; u < G::kKS; ++u) x += sc[u][g][p];
            }
            x *= scale;
            if constexpr (kQuant) x *= tile_scale[0][p];
          }
          sv[i] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new =
            kGlobalMax ? m[j] : fmaxf(m[j], repro::warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int p = lane + 32 * i;
          const float e = p < n_valid ? expf(sv[i] - m_new) : 0.f;
          if (p < kP) {
            // int8: P times the v scale, rounded to bf16 (l sums the f32 P)
            if constexpr (kQuant)
              pr[g][p] = __bfloat162float(__float2bfloat16(e * tile_scale[1][p]));
            else
              pr[g][p] = e;
          }
          sum += e;
        }
        const float corr = expf(m[j] - m_new);
        l[j] = l[j] * corr + repro::warp_sum(sum);
        m[j] = m_new;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // P.V: thread (vc, vpg) owns d-chunk vc and positions vpg + kPG * i.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < g_n) {
        const float c = corr_s[g];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] *= c;
      }
    }
#pragma unroll
    for (int i = 0; i < kP / G::kPG; ++i) {
      const int p = vpg + G::kPG * i;
      if (p < n_valid) {
        float vf[kVec];
        repro::unpack16<KV>(
            *reinterpret_cast<const uint4*>(vt + G::slot(p, vc) * kVec), vf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < g_n) {
            const float pg = pr[g][p];
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[g][e] += pg * vf[e];
          }
        }
      }
    }
    __syncthreads();  // the slot is free: refill it
    if (it + stages < n_tiles) load(it + stages);
    repro::cp_async_commit();
  }
  repro::cp_async_wait(0);

  // Sum the position groups: within a warp by shuffles (lanes vc + kChunks *
  // i), then across warps through shared memory (the ring, now free), in a
  // fixed order.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int off = kChunks; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  float* red = reinterpret_cast<float*>(fd_ring);  // [kParts][g_n][D]
  __syncthreads();
  if (vpg % G::kWarpPG == 0) {
    const int part = vpg / G::kWarpPG;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < g_n)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          red[(part * g_n + g) * D + vc * kVec + e] = acc[g][e];
  }
  __syncthreads();
  const size_t hp0 =
      ((size_t)row * h + kvh * (h / kv) + hg.first) * n_splits + split;
  for (int i = tid; i < g_n * D; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < G::kParts; ++u) a += red[u * g_n * D + i];
    const int g = i / D;
    if constexpr (kPad) {
      if (i % D < d) acc_part[(hp0 + (size_t)g * n_splits) * d + i % D] = a;
    } else {
      acc_part[(hp0 + (size_t)g * n_splits) * D + i % D] = a;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxG / kWarps; ++j) {
    const int g = warp + kWarps * j;
    if (g < g_n && lane == 0) {
      m_part[hp0 + (size_t)g * n_splits] = m[j];
      l_part[hp0 + (size_t)g * n_splits] = l[j];
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat162 p) {
  unsigned u;
  memcpy(&u, &p, 4);
  return u;
}

// Two floats as a bf16 pair `hi` and the bf16 pair of what rounding left
// out, `lo`: hi + lo carries about 16 bits of each.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The split pass on tensor cores (bf16, D 16-128).  Each warp owns a
// quarter of every tile's positions and runs its own pipeline and its own
// online softmax, so the tile loop has no block barrier: it copies its rows
// of K and V (cp.async), computes S = Q K^T with m16n8k16 products (rows:
// the G query heads, padded to 16; columns: its positions), updates
// (m, l) once per tile from the fragments (quad shuffles), rescales its
// accumulator, and adds P V with P split into two bf16 operands from the
// same registers.  The four warps' states merge by log-sum-exp at the end.
// kPad: as split_scalar's.
template <int D, bool kGroups, bool kPad = false>
__device__ __forceinline__ void split_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int s, int h, int kv, int n_splits,
    int chunk, int stages, int d = D) {
  using T = __nv_bfloat16;
  using G = Tile<T, D>;
  constexpr int kP = G::kP, kVec = G::kVec;
  constexpr int kPW = kP / kWarps;  // positions a warp per tile
  constexpr int kNB = kPW / 8;      // score n-blocks a warp per tile
  constexpr int kKS = D / 16;       // k-steps of Q K^T
  constexpr int kDB = D / 8;        // n-blocks of the output
  static_assert(kPW % 16 == 0 && kDB % 2 == 0, "mma tile");
  static_assert(kWarps * kMaxG * D * 4 <= 2 * G::kBytes, "merge fits the ring");
  const int split = blockIdx.x,
            kvh = blockIdx.y / groups_per_kv_head<kGroups>(h, kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<kGroups>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row (head), column pair
  const float scale = rsqrtf(static_cast<float>(kPad ? d : D));
  // q's loads go out first: nothing waits on them until the tiles' copies
  // are in flight
  constexpr int kQPer = kMaxG * D / kThreads;
  T qv[kQPer];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    if constexpr (kPad)
      qv[j] = i / D < g_n && i % D < d
                  ? q[((size_t)row * h + kvh * (h / kv) + hg.first + i / D) *
                          d + i % D]
                  : __float2bfloat16(0.f);
    else
      qv[j] = i / D < g_n
                  ? q[((size_t)row * h + kvh * (h / kv) + hg.first) * D + i]
                  : __float2bfloat16(0.f);
  }
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kP - 1) / kP : 0;

  extern __shared__ __align__(16) unsigned char fd_ring[];
  __shared__ __align__(16) T qs[kMaxG][D];
  __shared__ float wm[kWarps][kMaxG], wl[kWarps][kMaxG];
  T* ring = reinterpret_cast<T*>(fd_ring);
  const size_t base = ((size_t)row * s * kv + kvh) * (kPad ? d : D);
  const size_t stride = (size_t)kv * (kPad ? d : D);
  const int w0 = warp * kPW;  // this warp's first row in a tile
  auto k_slot = [&](int i) { return ring + (size_t)(i % stages) * 2 * kP * D; };
  auto load = [&](int i) {  // this warp's rows of tile i
    if constexpr (kPad)
      load_tile_pad<T, D, kPW>(k_slot(i), k, v, base, stride, s0 + i * kP,
                               s1, w0, lane, 32, d);
    else
      load_tile<T, D, kPW>(k_slot(i), k, v, base, stride, s0 + i * kP, s1,
                           w0, lane, 32);
  };
  if constexpr (kPad) {
    zero_ring<T, D>(fd_ring, stages, tid, kThreads);
    __syncthreads();
  }
  for (int i = 0; i < stages; ++i) {  // every slot's copies in flight
    if (i < n_tiles) load(i);
    repro::cp_async_commit();
  }

  // Q as the A operand: row g is query head kvh * G + first + g, zero
  // past g_n.
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    qs[i / D][i % D] = qv[j];
  }
  __syncthreads();
  unsigned qa[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    memcpy(&qa[ks][0], &qs[gq][ks * 16 + 2 * tq], 4);
    memcpy(&qa[ks][2], &qs[gq][ks * 16 + 8 + 2 * tq], 4);
    qa[ks][1] = qa[ks][3] = 0u;  // rows 8-15
  }

  float m = kNegInf, l = 0.f;  // head gq over this warp's positions
  float o[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait(stages - 1);  // this lane's copies of tile `it`
    __syncwarp();                      // and the warp's
    const T* kt = k_slot(it);
    const T* vt = kt + kP * D;
    const int pos0 = s0 + it * kP + w0;

    // S = Q K^T over this warp's kPW positions: ldmatrix gives the K^T
    // fragments of two n-blocks a k-step.
    float sc[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNB; nb += 2) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        unsigned b[4];
        const int p = w0 + nb * 8 + (lane / 16) * 8 + lane % 8;
        repro::ldmatrix_x4<false>(b, kt + G::slot(p, 2 * ks + (lane / 8) % 2) * kVec);
        repro::mma_bf16(sc[nb], qa[ks], b[0], b[1]);
        repro::mma_bf16(sc[nb + 1], qa[ks], b[2], b[3]);
      }
    }

    // Online softmax, once per tile: a quad holds one head's row.
    float mx = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = pos0 + nb * 8 + 2 * tq + j < s1;
        sc[nb][j] = ok ? sc[nb][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[nb][j]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = pos0 + nb * 8 + 2 * tq + j < s1;
        sc[nb][j] = ok ? expf(sc[nb][j] - m_new) : 0.f;
        sum += sc[nb][j];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      o[db][0] *= corr;
      o[db][1] *= corr;
    }

    // O += P V: the score fragments of two n-blocks are the A fragment of
    // one 16-position k-block; V's B fragments come transposed.  P goes in
    // as two bf16 operands, P_hi = bf16(P) and P_lo = bf16(P - P_hi), into
    // the same accumulator, so it keeps about 16 bits (the Pallas kernel
    // keeps it f32) and agrees with l, which sums the f32 P.
#pragma unroll
    for (int kb = 0; kb < kNB / 2; ++kb) {
      unsigned hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
      split_bf16(sc[2 * kb][0], sc[2 * kb][1], hi[0], lo[0]);
      split_bf16(sc[2 * kb + 1][0], sc[2 * kb + 1][1], hi[2], lo[2]);
      const int p = w0 + kb * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int db = 0; db < kDB; db += 2) {
        unsigned b[4];
        repro::ldmatrix_x4<true>(b, vt + G::slot(p, db + lane / 16) * kVec);
        repro::mma_bf16(o[db], hi, b[0], b[1]);
        repro::mma_bf16(o[db + 1], hi, b[2], b[3]);
        repro::mma_bf16(o[db], lo, b[0], b[1]);
        repro::mma_bf16(o[db + 1], lo, b[2], b[3]);
      }
    }
    __syncwarp();  // the warp's rows of this slot are free: refill it
    if (it + stages < n_tiles) load(it + stages);
    repro::cp_async_commit();
  }
  repro::cp_async_wait(0);

  // Merge the four warps by log-sum-exp through shared memory (the ring).
  __syncthreads();
  float* red = reinterpret_cast<float*>(fd_ring);  // [kWarps][kMaxG][D]
  if (gq < g_n) {
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      red[(warp * kMaxG + gq) * D + db * 8 + 2 * tq] = o[db][0];
      red[(warp * kMaxG + gq) * D + db * 8 + 2 * tq + 1] = o[db][1];
    }
    if (tq == 0) {
      wm[warp][gq] = m;
      wl[warp][gq] = l;
    }
  }
  __syncthreads();
  const size_t hp0 =
      ((size_t)row * h + kvh * (h / kv) + hg.first) * n_splits + split;
  if (tid < g_n) {  // each head's max, the warps' weights, the sum
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, wm[w][tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wm[w][tid] = expf(wm[w][tid] - mw);
      ls += wl[w][tid] * wm[w][tid];
    }
    m_part[hp0 + (size_t)tid * n_splits] = mw;
    l_part[hp0 + (size_t)tid * n_splits] = ls;
  }
  __syncthreads();
  for (int i = tid; i < g_n * D; i += kThreads) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * kMaxG + g) * D + i % D] * wm[w][g];
    if constexpr (kPad) {
      if (i % D < d) acc_part[(hp0 + (size_t)g * n_splits) * d + i % D] = a;
    } else {
      acc_part[(hp0 + (size_t)g * n_splits) * D + i % D] = a;
    }
  }
}

// One piece of w bytes (16, 8 or 4 by cp.async, 2 or 1 through registers;
// load_tile_pad's pieces) from src to dst, zeros where !valid.
__device__ __forceinline__ void copy_piece(char* dst, const char* src, int w,
                                           bool valid) {
  if (w == 16) {
    repro::cp_async16(dst, src, valid);
  } else if (w == 8) {
    repro::cp_async_small<8>(dst, src, valid);
  } else if (w == 4) {
    repro::cp_async_small<4>(dst, src, valid);
  } else if (w == 2) {
    const uint16_t zero = 0;
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : zero;
  } else {
    *dst = valid ? *src : 0;
  }
}

// Issue the copies of one warp's share of a split_mma_d256 tile into the
// ring slot at ks: the K rows whose scores the warp computes (positions
// [kPW w, kPW (w + 1))), whole, and the 16-byte chunks of V whose columns
// it accumulates ([kCW w, kCW (w + 1))) at every position of the tile.
// Tile position p is sequence position p0 + p; those at or past `end` are
// zero-filled.  With kPad the rows hold d < D elements (base and stride
// count d-element rows) and go in load_tile_pad's pieces, so that the
// rest of each row keeps the zeros of zero_ring.
template <bool kPad>
__device__ __forceinline__ void load_share_d256(
    __nv_bfloat16* ks, const __nv_bfloat16* k, const __nv_bfloat16* v,
    size_t base, size_t stride, int p0, int end, int warp, int lane, int d) {
  using T = __nv_bfloat16;
  using G = Tile<T, kMaxHeadDim>;
  constexpr int kPW = G::kP / kWarps, kCW = G::kChunks / kWarps;
  static_assert(G::kChunks == 32, "a lane a chunk of a K row");
  T* vs = ks + G::kP * kMaxHeadDim;
  if constexpr (!kPad) {
#pragma unroll
    for (int j = 0; j < kPW; ++j) {  // K: row kPW w + j, chunk `lane`
      const int p = warp * kPW + j;
      const bool valid = p0 + p < end;
      const size_t off =
          base + (valid ? (size_t)(p0 + p) * stride : 0) + lane * G::kVec;
      repro::cp_async16(ks + G::slot(p, lane) * G::kVec, k + off, valid);
    }
#pragma unroll
    for (int j = 0; j < G::kP * kCW / 32; ++j) {  // V: kCW chunks a row
      const int i = lane + 32 * j;
      const int p = i / kCW, c = warp * kCW + i % kCW;
      const bool valid = p0 + p < end;
      const size_t off =
          base + (valid ? (size_t)(p0 + p) * stride : 0) + c * G::kVec;
      repro::cp_async16(vs + G::slot(p, c) * G::kVec, v + off, valid);
    }
  } else {
    const int row_bytes = d * static_cast<int>(sizeof(T));
    const int w = min(row_bytes & -row_bytes, 16);
    const char* kg = reinterpret_cast<const char*>(k);
    const char* vg = reinterpret_cast<const char*>(v);
    char* kd = reinterpret_cast<char*>(ks);
    char* vd = reinterpret_cast<char*>(vs);
    auto row_off = [&](int p, bool valid) {
      return (base + (valid ? (size_t)(p0 + p) * stride : 0)) * sizeof(T);
    };
    const int n_pc = row_bytes / w;
    for (int i = lane; i < kPW * n_pc; i += 32) {
      const int p = warp * kPW + i / n_pc, b = (i % n_pc) * w;
      const bool valid = p0 + p < end;
      copy_piece(kd + G::slot(p, b / 16) * 16 + b % 16,
                 kg + row_off(p, valid) + b, w, valid);
    }
    const int b0 = warp * kCW * 16;  // this warp's bytes of a V row
    const int n_v = max(0, min(kCW * 16, row_bytes - b0)) / w;
    for (int i = lane; i < G::kP * n_v; i += 32) {
      const int p = i / n_v, b = b0 + (i % n_v) * w;
      const bool valid = p0 + p < end;
      copy_piece(vd + G::slot(p, b / 16) * 16 + b % 16,
                 vg + row_off(p, valid) + b, w, valid);
    }
  }
}

// The split pass on tensor cores at D 256 in bf16, for up to kMaxG256 (16)
// query heads a block, so that recurrentgemma-9b's 16 heads on one KV head
// read its K and V once.  Bound: the bytes of K and V (1 KB a position at
// D 256), at most 2 * 16 FLOPs a byte; the design keeps those bytes
// streaming and all arithmetic on tensor cores:
// - A tile is 32 positions (16 KB of K, as many of V), in split_mma's
//   swizzled ring of up to three stages (96 KB), two blocks an SM: up to
//   192 KB of copies in flight on an SM.
// - Each of the four warps copies and reads only its own share of a tile
//   (load_share_d256): the K rows of its 8 positions, whose scores it
//   computes, and V's columns [64 w, 64 (w + 1)) at all 32 positions,
//   which it accumulates.  So a warp refills its share of a slot as soon
//   as it is done with it (no barrier), as in split_mma.
// - S = Q K^T for the warp's 8 positions: m16n8k16 with the heads as the
//   16 rows (all 16 live at G 16; zero past g_n), Q's A fragments held in
//   64 registers (ldmatrix from shared memory once), K^T's from ldmatrix,
//   the 16 k-steps on two accumulators.
// - The scaled, masked scores go to shared memory (16 x 32 f32, double-
//   buffered by tile parity), one block barrier a tile, and every warp
//   reads back all 32 positions' scores in its A fragments' order and runs
//   the same online softmax for both row halves (quad shuffles), so (m, l)
//   agree across warps bit for bit and the warps need no merge at the end.
// - O += P V on the warp's 64 columns: 8 n-blocks, 32 f32 registers, P
//   split into bf16 hi and lo operands (split_bf16), V's fragments from
//   ldmatrix.trans.
// - Each warp writes its columns of the partials; warp 0 writes (m, l).
// A block streams about 19-21 GB/s of K and V, whatever the card's load
// and whether its work is cut four or eight ways (PERF.md): the card's
// 3.35 TB/s is about 25 GB/s an SM, so every SM must hold blocks, and
// split_plan_d256 chooses the splits.
// kPad: as split_mma's (zero_ring, rows of d elements, the scale and the
// partials at d).
template <bool kGroups, bool kPad = false>
__device__ __forceinline__ void split_mma_d256(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int s, int h, int kv, int n_splits,
    int chunk, int stages, int d = kMaxHeadDim) {
  using T = __nv_bfloat16;
  constexpr int D = kMaxHeadDim;
  using G = Tile<T, D>;
  constexpr int kP = G::kP, kVec = G::kVec;
  constexpr int kPW = kP / kWarps;          // positions whose scores a warp computes
  constexpr int kCW = G::kChunks / kWarps;  // n-blocks of 8 columns a warp accumulates
  constexpr int kKS = D / 16;               // k-steps of Q K^T
  constexpr int kKB = kP / 16;              // k-blocks of P V
  constexpr int kSP = kP + 8;               // score row stride: rows 8 banks apart
  static_assert(kPW == 8 && kCW % 2 == 0 && kKS % 2 == 0 && kKB >= 1,
                "d256 mma tile");
  const int split = blockIdx.x,
            kvh = blockIdx.y / groups_per_kv_head<kGroups, kMaxG256>(h, kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<kGroups, kMaxG256>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment rows gq, gq + 8; column pair
  const float scale = rsqrtf(static_cast<float>(kPad ? d : D));
  // q's loads go out first: nothing waits on them until the tiles' copies
  // are in flight
  constexpr int kQPer = kMaxG256 * D / kThreads;
  T qv[kQPer];
  const size_t q0 = (size_t)row * h + kvh * (h / kv) + hg.first;
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    if constexpr (kPad)
      qv[j] = i / D < g_n && i % D < d ? q[(q0 + i / D) * d + i % D]
                                       : __float2bfloat16(0.f);
    else
      qv[j] = i / D < g_n ? q[q0 * D + i] : __float2bfloat16(0.f);
  }
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kP - 1) / kP : 0;

  extern __shared__ __align__(16) unsigned char fd_ring[];
  // rows 528 bytes apart: ldmatrix's eight rows of one column hit distinct
  // 16-byte bank groups
  __shared__ __align__(16) T qs[kMaxG256][D + 8];
  __shared__ __align__(16) float sc_s[2][kMaxG256][kSP];
  T* ring = reinterpret_cast<T*>(fd_ring);
  const size_t base = ((size_t)row * s * kv + kvh) * (kPad ? d : D);
  const size_t stride = (size_t)kv * (kPad ? d : D);
  const int w0 = warp * kPW;  // this warp's first score position in a tile
  const int c0 = warp * kCW;  // and its first chunk of V
  auto k_slot = [&](int i) { return ring + (size_t)(i % stages) * 2 * kP * D; };
  auto load = [&](int i) {
    load_share_d256<kPad>(k_slot(i), k, v, base, stride, s0 + i * kP, s1,
                          warp, lane, d);
  };
  if constexpr (kPad) {
    zero_ring<T, D>(fd_ring, stages, tid, kThreads);
    __syncthreads();
  }
  for (int i = 0; i < stages; ++i) {  // every slot's copies in flight
    if (i < n_tiles) load(i);
    repro::cp_async_commit();
  }

  // Q as the A operand: row g is query head kvh * G + first + g, zero
  // past g_n; one ldmatrix a k-step gives rows 0-15.
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    qs[i / D][i % D] = qv[j];
  }
  __syncthreads();
  unsigned qa[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    repro::ldmatrix_x4<false>(qa[ks], &qs[lane % 16][ks * 16 + (lane / 16) * 8]);

  // heads gq (r 0) and gq + 8 (r 1) over every position so far
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kCW][4];
#pragma unroll
  for (int db = 0; db < kCW; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait(stages - 1);  // this lane's copies of tile `it`
    __syncwarp();                      // and the warp's
    const T* kt = k_slot(it);
    const T* vt = kt + kP * D;
    const int n_valid = min(kP, s1 - (s0 + it * kP));
    float* sw = &sc_s[it & 1][0][0];

    // S = Q K^T over the warp's 8 positions: ldmatrix gives the K^T
    // fragments of two k-steps, each on its own accumulator.
    {
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < kKS; ks += 2) {
        unsigned b[4];
        repro::ldmatrix_x4<false>(
            b, kt + G::slot(w0 + lane % 8, 2 * ks + lane / 8) * kVec);
        repro::mma_bf16(sa, qa[ks], b[0], b[1]);
        repro::mma_bf16(sb, qa[ks + 1], b[2], b[3]);
      }
      const int p = w0 + 2 * tq;
      const bool ok0 = p < n_valid, ok1 = p + 1 < n_valid;
      *reinterpret_cast<float2*>(sw + gq * kSP + p) =
          make_float2(ok0 ? (sa[0] + sb[0]) * scale : kNegInf,
                      ok1 ? (sa[1] + sb[1]) * scale : kNegInf);
      *reinterpret_cast<float2*>(sw + (gq + 8) * kSP + p) =
          make_float2(ok0 ? (sa[2] + sb[2]) * scale : kNegInf,
                      ok1 ? (sa[3] + sb[3]) * scale : kNegInf);
    }
    __syncthreads();  // every warp's scores of this tile

    // Online softmax, once per tile, the same in every warp: x[r][kb][j]
    // holds row r's scores at positions 16 kb + 8 (j / 2) + 2 tq + j % 2,
    // the A fragments' columns.
    float x[2][kKB][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          const float2 t = *reinterpret_cast<const float2*>(
              sw + (gq + 8 * r) * kSP + kb * 16 + j2 * 8 + 2 * tq);
          x[r][kb][2 * j2] = t.x;
          x[r][kb][2 * j2 + 1] = t.y;
        }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, x[r][kb][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = kb * 16 + (j / 2) * 8 + 2 * tq + j % 2;
          x[r][kb][j] = p < n_valid ? expf(x[r][kb][j] - m_new) : 0.f;
          sum += x[r][kb][j];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int db = 0; db < kCW; ++db) {
      o[db][0] *= corr[0];
      o[db][1] *= corr[0];
      o[db][2] *= corr[1];
      o[db][3] *= corr[1];
    }

    // O += P V over the warp's 64 columns: P of one 16-position k-block as
    // two bf16 A operands, P_hi = bf16(P) and P_lo = bf16(P - P_hi), into
    // the same accumulator (split_mma's); V's B fragments come transposed.
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
      unsigned hi[4], lo[4];
      split_bf16(x[0][kb][0], x[0][kb][1], hi[0], lo[0]);
      split_bf16(x[1][kb][0], x[1][kb][1], hi[1], lo[1]);
      split_bf16(x[0][kb][2], x[0][kb][3], hi[2], lo[2]);
      split_bf16(x[1][kb][2], x[1][kb][3], hi[3], lo[3]);
      const int p = kb * 16 + ((lane / 8) % 2) * 8 + lane % 8;
#pragma unroll
      for (int db = 0; db < kCW; db += 2) {
        unsigned b[4];
        repro::ldmatrix_x4<true>(b, vt + G::slot(p, c0 + db + lane / 16) * kVec);
        repro::mma_bf16(o[db], hi, b[0], b[1]);
        repro::mma_bf16(o[db + 1], hi, b[2], b[3]);
        repro::mma_bf16(o[db], lo, b[0], b[1]);
        repro::mma_bf16(o[db + 1], lo, b[2], b[3]);
      }
    }
    __syncwarp();  // the warp's share of this slot is free: refill it
    if (it + stages < n_tiles) load(it + stages);
    repro::cp_async_commit();
  }
  repro::cp_async_wait(0);

  // The partials: each warp its 64 columns of heads gq and gq + 8; (m, l)
  // are every warp's, written by warp 0.
  const size_t hp0 = q0 * n_splits + split;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = gq + 8 * r;
    if (g < g_n) {
      float* dst = acc_part + (hp0 + (size_t)g * n_splits) * (kPad ? d : D);
#pragma unroll
      for (int db = 0; db < kCW; ++db) {
        const int col = (c0 + db) * 8 + 2 * tq;
        if constexpr (kPad) {
          if (col < d) dst[col] = o[db][2 * r];
          if (col + 1 < d) dst[col + 1] = o[db][2 * r + 1];
        } else {
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(o[db][2 * r], o[db][2 * r + 1]);
        }
      }
      if (warp == 0 && tq == 0) {
        m_part[hp0 + (size_t)g * n_splits] = m[r];
        l_part[hp0 + (size_t)g * n_splits] = l[r];
      }
    }
  }
}

// Four int8 values (the bytes of w) as two bf16 pairs, exactly: lo holds
// bytes 0 and 1, hi bytes 2 and 3, the lower byte in the lower half.  Each
// byte goes through unpack16's f32 trick; an integer of at most 8
// significant bits is its f32's upper half in bf16.
__device__ __forceinline__ void int8x4_to_bf16(unsigned w, unsigned& lo,
                                               unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// kBytes (4, 8, or a multiple of 16) bytes of row r of an int8 tile from
// byte b (a multiple of kBytes), as words.
template <int D, int kBytes>
__device__ __forceinline__ void load_row_bytes(unsigned* w, const int8_t* tile,
                                               int r, int b) {
  using G = Tile<int8_t, D>;
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(tile + G::slot(r, b / 16 + i) * 16);
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(tile + G::slot(r, b / 16) * 16 + b % 16);
    w[0] = u.x;
    w[1] = u.y;
  } else {
    static_assert(kBytes == 4, "row bytes");
    w[0] = *reinterpret_cast<const unsigned*>(tile + G::slot(r, b / 16) * 16 + b % 16);
  }
}

// The int8 mode on tensor cores (q in bf16, D 32-128): split_mma's layout
// over int8 tiles of 128 positions, one of each warp's 32 positions a lane.
// Nothing is dequantized in shared memory: each lane converts the int8
// bytes it reads into bf16 fragments (int8 values are exact in bf16), and
// the order of the contracted axes is free, so each lane reads whole words:
//   S = Q K^T, k-step ks: lane (g, t) takes K's d = t*D/4 + 4ks + {0..3}
//   (and Q's the same d), so a quad reads a row's D bytes in D/4-byte runs;
//   O = P V: output block db, column n is d = n*D/8 + db, so lane (g, t)
//   reads d = g*D/8 .. g*D/8 + D/8 - 1 of its four positions of each
//   16-position k-block and pairs their bytes with byte permutes.
// Scores are scaled by the position's k scale; P, times the position's v
// scale, is rounded once to bf16 (the JAX package's rounding) as the A
// operand; l sums the f32 P.  Each lane loads its position's two scales
// three tiles ahead (plain loads: 2 bytes, KV apart) and the warp shares
// them by shuffles.  kPad: as split_scalar's.
template <int D, bool kGroups, bool kPad = false>
__device__ __forceinline__ void split_mma_int8(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const __half* __restrict__ k_scale,
    const __half* __restrict__ v_scale, const int* __restrict__ length,
    float* __restrict__ m_part, float* __restrict__ l_part,
    float* __restrict__ acc_part, int s, int h, int kv, int n_splits,
    int chunk, int stages, int d = D) {
  using T = __nv_bfloat16;
  using G = Tile<int8_t, D>;
  constexpr int kP = G::kP;
  constexpr int kPW = kP / kWarps;  // positions a warp per tile: a lane each
  constexpr int kNB = kPW / 8;      // score n-blocks a warp per tile
  constexpr int kKS = D / 16;       // k-steps of Q K^T
  constexpr int kDB = D / 8;        // n-blocks of the output
  constexpr int kRowT = D / 4;      // bytes of a K row a lane reads
  constexpr int kColT = D / 8;      // bytes of a V row a lane reads
  static_assert(kPW == 32 && kNB % 2 == 0 && kColT % 4 == 0, "int8 mma tile");
  static_assert(kWarps * kMaxG * D * 4 <= 2 * G::kBytes, "merge fits the ring");
  const int split = blockIdx.x,
            kvh = blockIdx.y / groups_per_kv_head<kGroups>(h, kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<kGroups>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row (head), column pair
  const float scale = rsqrtf(static_cast<float>(kPad ? d : D));
  constexpr int kQPer = kMaxG * D / kThreads;
  T qv[kQPer];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    if constexpr (kPad)
      qv[j] = i / D < g_n && i % D < d
                  ? q[((size_t)row * h + kvh * (h / kv) + hg.first + i / D) *
                          d + i % D]
                  : __float2bfloat16(0.f);
    else
      qv[j] = i / D < g_n
                  ? q[((size_t)row * h + kvh * (h / kv) + hg.first) * D + i]
                  : __float2bfloat16(0.f);
  }
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kP - 1) / kP : 0;

  extern __shared__ __align__(16) unsigned char fd_ring[];
  __shared__ __align__(16) T qs[kMaxG][D];
  __shared__ float wm[kWarps][kMaxG], wl[kWarps][kMaxG];
  int8_t* ring = reinterpret_cast<int8_t*>(fd_ring);
  const size_t base = ((size_t)row * s * kv + kvh) * (kPad ? d : D);
  const size_t stride = (size_t)kv * (kPad ? d : D);
  const int w0 = warp * kPW;  // this warp's first row in a tile
  auto k_slot = [&](int i) { return ring + (size_t)(i % stages) * 2 * kP * D; };
  auto load = [&](int i) {  // this warp's rows of tile i
    if constexpr (kPad)
      load_tile_pad<int8_t, D, kPW>(k_slot(i), k, v, base, stride,
                                    s0 + i * kP, s1, w0, lane, 32, d);
    else
      load_tile<int8_t, D, kPW>(k_slot(i), k, v, base, stride, s0 + i * kP,
                                s1, w0, lane, 32);
  };
  // this lane's position's scales in tile i, 0 past the chunk, kept as f16
  // until used so that the loads stay in flight
  auto load_scales = [&](int i, __half& ks, __half& vs) {
    const int p = s0 + i * kP + w0 + lane;
    ks = vs = __float2half(0.f);
    if (i < n_tiles && p < s1) {
      const size_t at = ((size_t)row * s + p) * kv + kvh;
      ks = k_scale[at];
      vs = v_scale[at];
    }
  };
  if constexpr (kPad) {
    zero_ring<int8_t, D>(fd_ring, stages, tid, kThreads);
    __syncthreads();
  }
  for (int i = 0; i < stages; ++i) {  // every slot's copies in flight
    if (i < n_tiles) load(i);
    repro::cp_async_commit();
  }
  __half ksq[3], vsq[3];  // tiles it, it + 1, it + 2
#pragma unroll
  for (int i = 0; i < 3; ++i) load_scales(i, ksq[i], vsq[i]);

  // Q as the A operand, in the K side's order of d: a0 holds d = t*D/4 +
  // 4ks + {0, 1}, a2 d + {2, 3}; rows 8-15 (a1, a3) zero.
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int i = tid + j * kThreads;
    qs[i / D][i % D] = qv[j];
  }
  __syncthreads();
  unsigned qa[kKS][2];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    memcpy(&qa[ks][0], &qs[gq][tq * kRowT + 4 * ks], 4);
    memcpy(&qa[ks][1], &qs[gq][tq * kRowT + 4 * ks + 2], 4);
  }

  float m = kNegInf, l = 0.f;  // head gq over this warp's positions
  float o[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait(stages - 1);  // this lane's copies of tile `it`
    __syncwarp();                      // and the warp's
    const int8_t* kt = k_slot(it);
    const int8_t* vt = kt + kP * D;
    const int pos0 = s0 + it * kP + w0;
    const float ksc = __half2float(ksq[0]), vsc = __half2float(vsq[0]);

    // S = Q K^T: n-block nb's column g is position w0 + 8nb + g.
    float sc[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
      unsigned kw[kRowT / 4];
      load_row_bytes<D, kRowT>(kw, kt, w0 + nb * 8 + gq, tq * kRowT);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        unsigned b0, b1;
        int8x4_to_bf16(kw[ks], b0, b1);
        const unsigned a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        repro::mma_bf16(sc[nb], a, b0, b1);
      }
    }

    // Online softmax, once per tile: a quad holds one head's row; the
    // score of column c is scaled by the k scale of lane c's position.
    float mx = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nb * 8 + 2 * tq + j;
        const float kc = __shfl_sync(0xffffffffu, ksc, c);
        sc[nb][j] = pos0 + c < s1 ? sc[nb][j] * scale * kc : kNegInf;
        mx = fmaxf(mx, sc[nb][j]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = pos0 + nb * 8 + 2 * tq + j < s1;
        sc[nb][j] = ok ? expf(sc[nb][j] - m_new) : 0.f;
        sum += sc[nb][j];
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      o[db][0] *= corr;
      o[db][1] *= corr;
    }

    // O += P V over 16-position k-blocks: k index c is position w0 + 16kb
    // + c; the lane's A elements are positions 2t, 2t+1, 2t+8, 2t+9.
#pragma unroll
    for (int kb = 0; kb < kNB / 2; ++kb) {
      const int c = 16 * kb + 2 * tq;
      const float v0 = __shfl_sync(0xffffffffu, vsc, c);
      const float v1 = __shfl_sync(0xffffffffu, vsc, c + 1);
      const float v8 = __shfl_sync(0xffffffffu, vsc, c + 8);
      const float v9 = __shfl_sync(0xffffffffu, vsc, c + 9);
      const unsigned pa[4] = {
          pack_bf16(__floats2bfloat162_rn(sc[2 * kb][0] * v0, sc[2 * kb][1] * v1)), 0u,
          pack_bf16(__floats2bfloat162_rn(sc[2 * kb + 1][0] * v8, sc[2 * kb + 1][1] * v9)),
          0u};
      unsigned va[kColT / 4], vb[kColT / 4], vc[kColT / 4], vd[kColT / 4];
      load_row_bytes<D, kColT>(va, vt, w0 + c, gq * kColT);
      load_row_bytes<D, kColT>(vb, vt, w0 + c + 1, gq * kColT);
      load_row_bytes<D, kColT>(vc, vt, w0 + c + 8, gq * kColT);
      load_row_bytes<D, kColT>(vd, vt, w0 + c + 9, gq * kColT);
#pragma unroll
      for (int i = 0; i < kColT / 4; ++i) {
        // byte j of word i is d = g*D/8 + 4i + j, output block 4i + j:
        // pair the positions' bytes (2t with 2t+1, 2t+8 with 2t+9)
        unsigned b0[4], b1[4];
        int8x4_to_bf16(__byte_perm(va[i], vb[i], 0x5140), b0[0], b0[1]);
        int8x4_to_bf16(__byte_perm(va[i], vb[i], 0x7362), b0[2], b0[3]);
        int8x4_to_bf16(__byte_perm(vc[i], vd[i], 0x5140), b1[0], b1[1]);
        int8x4_to_bf16(__byte_perm(vc[i], vd[i], 0x7362), b1[2], b1[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) repro::mma_bf16(o[4 * i + e], pa, b0[e], b1[e]);
      }
    }
    __syncwarp();  // the warp's rows of this slot are free: refill it
    if (it + stages < n_tiles) load(it + stages);
    repro::cp_async_commit();
    ksq[0] = ksq[1];
    vsq[0] = vsq[1];
    ksq[1] = ksq[2];
    vsq[1] = vsq[2];
    load_scales(it + 3, ksq[2], vsq[2]);
  }
  repro::cp_async_wait(0);

  // Merge the four warps by log-sum-exp through shared memory (the ring);
  // accumulator column n of output block db is d = n*D/8 + db.
  __syncthreads();
  float* red = reinterpret_cast<float*>(fd_ring);  // [kWarps][kMaxG][D]
  if (gq < g_n) {
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      red[(warp * kMaxG + gq) * D + 2 * tq * kColT + db] = o[db][0];
      red[(warp * kMaxG + gq) * D + (2 * tq + 1) * kColT + db] = o[db][1];
    }
    if (tq == 0) {
      wm[warp][gq] = m;
      wl[warp][gq] = l;
    }
  }
  __syncthreads();
  const size_t hp0 =
      ((size_t)row * h + kvh * (h / kv) + hg.first) * n_splits + split;
  if (tid < g_n) {  // each head's max, the warps' weights, the sum
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, wm[w][tid]);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      wm[w][tid] = expf(wm[w][tid] - mw);
      ls += wl[w][tid] * wm[w][tid];
    }
    m_part[hp0 + (size_t)tid * n_splits] = mw;
    l_part[hp0 + (size_t)tid * n_splits] = ls;
  }
  __syncthreads();
  for (int i = tid; i < g_n * D; i += kThreads) {
    const int g = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[(w * kMaxG + g) * D + i % D] * wm[w][g];
    if constexpr (kPad) {
      if (i % D < d) acc_part[(hp0 + (size_t)g * n_splits) * d + i % D] = a;
    } else {
      acc_part[(hp0 + (size_t)g * n_splits) * D + i % D] = a;
    }
  }
}

// One block per (split, kv-head, head group, row): a tensor-core pass in
// bf16 (split_mma_d256 at D 256; split_mma where each warp's quarter of a
// tile is a multiple of 16 positions, D 16-128), else the CUDA-core pass.
// With kEarly (the fused kernel's instance) the LoRA shrink, launched as
// this grid's programmatic dependent, may start at once and run beside
// this pass.
template <typename T, int D, bool kEarly, bool kGroups>
__global__ void __launch_bounds__(kThreads, 2)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ length,
                float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, int s, int h, int kv,
                int n_splits, int chunk, int stages) {
  if constexpr (kEarly)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (kMmaD256<T, D>)
    split_mma_d256<kGroups>(q, k, v, length, m_part, l_part, acc_part, s, h,
                            kv, n_splits, chunk, stages);
  else if constexpr (Tile<T, D>::kMma)
    split_mma<D, kGroups>(q, k, v, length, m_part, l_part, acc_part, s, h,
                          kv, n_splits, chunk, stages);
  else
    split_scalar<T, T, D, kGroups>(q, k, v, nullptr, nullptr, length, m_part,
                                   l_part, acc_part, s, h, kv, n_splits,
                                   chunk, stages);
}

// The int8 mode's split pass: one block per (split, kv-head, head group,
// row) over an int8 cache and its f16 scales, q and the output in T: on
// tensor cores for bf16 q at D 32-128 (split_mma_int8), else on CUDA
// cores.  Launched for bf16 q at the instantiated head dims; q in f32 and
// padded head dims take fd_split_int8_any_kernel.
template <typename T, int D, bool kGroups>
__global__ void __launch_bounds__(kThreads, 2)
fd_split_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                     const int8_t* __restrict__ v,
                     const __half* __restrict__ k_scale,
                     const __half* __restrict__ v_scale,
                     const int* __restrict__ length,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int s, int h, int kv,
                     int n_splits, int chunk, int stages) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D >= 32 && D <= 128)
    split_mma_int8<D, kGroups>(q, k, v, k_scale, v_scale, length, m_part,
                               l_part, acc_part, s, h, kv, n_splits, chunk,
                               stages);
  else
    split_scalar<T, int8_t, D, kGroups>(q, k, v, k_scale, v_scale, length,
                                        m_part, l_part, acc_part, s, h, kv,
                                        n_splits, chunk, stages);
}

// A head dim d that has no instance, in plain flash-decode and in the
// fused kernel: the instance of the next larger D, padded (kPad), on the
// pass D's instance takes (bf16 d 129-255: split_mma_d256).  It lets a
// fused launch's shrink start at once, as kEarly does (without a
// programmatic dependent the instruction does nothing).
template <typename T, int D, bool kGroups>
__global__ void __launch_bounds__(kThreads, 2)
fd_split_pad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int s, int h, int kv,
                    int n_splits, int chunk, int stages, int d) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (kMmaD256<T, D>)
    split_mma_d256<kGroups, true>(q, k, v, length, m_part, l_part, acc_part,
                                  s, h, kv, n_splits, chunk, stages, d);
  else if constexpr (Tile<T, D>::kMma)
    split_mma<D, kGroups, true>(q, k, v, length, m_part, l_part, acc_part, s,
                                h, kv, n_splits, chunk, stages, d);
  else
    split_scalar<T, T, D, kGroups, true>(q, k, v, nullptr, nullptr, length,
                                         m_part, l_part, acc_part, s, h, kv,
                                         n_splits, chunk, stages, d);
}

// The int8 mode's split pass where fd_split_int8_kernel does not run it:
// q in f32 (on CUDA cores, against the row's global max from
// fd_int8_max_kernel, kGlobalMax), and head dims without an instance
// (kPad; bf16 q at D 32-128 on tensor cores).
template <typename T, int D, bool kGroups, bool kPad>
__global__ void __launch_bounds__(kThreads, 2)
fd_split_int8_any_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const __half* __restrict__ k_scale,
                         const __half* __restrict__ v_scale,
                         const int* __restrict__ length,
                         float* __restrict__ m_part,
                         float* __restrict__ l_part,
                         float* __restrict__ acc_part, int s, int h, int kv,
                         int n_splits, int chunk, int stages, int d,
                         const float* __restrict__ max_part) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if constexpr (!kF32 && D >= 32 && D <= 128)
    split_mma_int8<D, kGroups, kPad>(q, k, v, k_scale, v_scale, length,
                                     m_part, l_part, acc_part, s, h, kv,
                                     n_splits, chunk, stages, d);
  else
    split_scalar<T, int8_t, D, kGroups, kPad, kF32>(
        q, k, v, k_scale, v_scale, length, m_part, l_part, acc_part, s, h,
        kv, n_splits, chunk, stages, d, max_part);
}

// 16 bytes of an int8 row from byte 16c: one 16-byte load where the row's
// d bytes are a multiple of 16 (its start then 16-byte aligned), else
// byte by byte, zero past d.
__device__ __forceinline__ uint4 row_chunk(const int8_t* row, int c, int d,
                                           bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + 16 * c);
  unsigned w[4] = {0u, 0u, 0u, 0u};
  for (int e = 0; e < 16 && 16 * c + e < d; ++e)
    w[e / 4] |= (static_cast<unsigned>(row[16 * c + e]) & 0xffu) << (8 * (e % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The int8 mode's pre-pass for q in f32: each of the block's heads' largest
// score s = (q . k) / sqrt(d) * k_scale over its split's positions, into
// max_part (bsz, h, n_splits), q . k summed in f64 and rounded once, as
// split_scalar computes it with kGlobalMax, so the split pass's scores
// reach the max it takes over the splits and none passes it.  The JAX
// package rounds P * v_scale to bf16 against the row's global max
// (src/repro/models/attention.py:291-301); a split pass that rounds it
// against its running max (the bf16-q instances) departs from that by up
// to a bf16 step of P.  One thread a position, its K row read once, 16
// bytes at a time (row_chunk), the next chunk's load in flight while one
// is summed (a loop over the chunks, not unrolled: unrolled, its
// registers spilled); q in shared memory in f64; one block per (split,
// kv-head, head group, row) as the split pass.
template <int D, bool kGroups>
__global__ void __launch_bounds__(kThreads)
fd_int8_max_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                   const __half* __restrict__ k_scale,
                   const int* __restrict__ length, float* __restrict__ max_part,
                   int s, int h, int kv, int n_splits, int chunk, int d) {
  const int split = blockIdx.x,
            kvh = blockIdx.y / groups_per_kv_head<kGroups>(h, kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<kGroups>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const size_t head0 = (size_t)row * h + kvh * (h / kv) + hg.first;
  __shared__ double qs[kMaxG][D];
  __shared__ float wmax[kWarps][kMaxG];
  for (int i = tid; i < g_n * D; i += kThreads) {
    const int e = i % D;
    qs[i / D][e] = e < d ? static_cast<double>(q[(head0 + i / D) * d + e])
                         : 0.0;
  }
  __syncthreads();
  float mx[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mx[g] = kNegInf;
  const bool vec = d % 16 == 0;
  const int n_c = (d + 15) / 16;
  for (int p = s0 + tid; p < s1; p += kThreads) {
    const size_t at = ((size_t)row * s + p) * kv + kvh;
    const int8_t* kr = k + at * d;
    const float ksc = __half2float(k_scale[at]);
    double part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.0;
    uint4 next = row_chunk(kr, 0, d, vec);
#pragma unroll 1
    for (int c = 0; c < n_c; ++c) {  // the next chunk's load in flight
      const uint4 cur = next;
      if (c + 1 < n_c) next = row_chunk(kr, c + 1, d, vec);
      float kf[16];
      repro::unpack16<int8_t>(cur, kf);
      double kd[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) kd[e] = kf[e];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < g_n) {
#pragma unroll
          for (int e = 0; e < 16; ++e) part[g] += qs[g][16 * c + e] * kd[e];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      float x = static_cast<float>(part[g]);
      x *= scale;
      x *= ksc;
      if (g < g_n) mx[g] = fmaxf(mx[g], x);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    const float m = repro::warp_max(mx[g]);
    if (lane == 0) wmax[warp][g] = m;
  }
  __syncthreads();
  if (tid < g_n) {
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w][tid]);
    max_part[(head0 + tid) * n_splits + split] = m;
  }
}

// The wide path (head dims kMaxHeadDim + 1 .. kWideMaxHeadDim): an element
// of K or V as f32 (int8 values exactly).
template <typename KV>
__device__ __forceinline__ float wide_float(KV x) {
  if constexpr (std::is_same<KV, int8_t>::value) return static_cast<float>(x);
  else return repro::to_float(x);
}

// q . k of the position whose K row is kr, for the block's g_n heads (q in
// qs), by one warp: lane l sums elements l, l + 32, ... in ScoreT, then the
// warp sums its lanes by xor shuffles in a fixed order, every lane ending
// with each total.  The pre-pass and the split pass both call it, so with
// ScoreT double (each product of an f32 and an int8 value exact) they round
// the same f32 score.
template <typename KV, typename ScoreT>
__device__ __forceinline__ void wide_dot(const float (*qs)[kWideMaxHeadDim],
                                         const KV* __restrict__ kr, int d,
                                         int g_n, int lane,
                                         ScoreT (&part)[kMaxG]) {
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) part[g] = 0;
#pragma unroll 4
  for (int e = lane; e < d; e += 32) {
    const ScoreT kf = static_cast<ScoreT>(wide_float(kr[e]));
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < g_n) part[g] += static_cast<ScoreT>(qs[g][e]) * kf;
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < g_n)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
}

// q of the block's g_n heads (consecutive in q: head0, head0 + 1, ...) as
// f32 rows of d into qs.
template <typename T>
__device__ __forceinline__ void wide_load_q(float (*qs)[kWideMaxHeadDim],
                                            const T* __restrict__ q,
                                            size_t head0, int g_n, int d) {
  for (int i = threadIdx.x; i < g_n * d; i += blockDim.x)
    qs[i / d][i % d] = repro::to_float(q[head0 * d + i]);
}

// The wide split pass: one block per (split, kv-head, head group, row), as
// the passes above (every launch in head groups: a G <= kMaxG has one), K
// and V of d-element rows read from global memory, kWideP positions a
// tile.  KV is T, or int8 with the f16 scales k_scale and v_scale (kQuant);
// with kGlobalMax (the int8 mode with q in f32) each head's softmax runs
// against the row's max, fd_int8_max_wide_kernel's partials in max_part,
// and q . k is summed in f64 (split_scalar's contract).  It lets a fused
// launch's shrink start at once, as fd_split_pad_kernel does.
template <typename T, typename KV, bool kGlobalMax>
__global__ void __launch_bounds__(kThreads)
fd_split_wide_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                     const KV* __restrict__ v,
                     const __half* __restrict__ k_scale,
                     const __half* __restrict__ v_scale,
                     const int* __restrict__ length,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part, int s, int h, int kv,
                     int n_splits, int chunk, int d,
                     const float* __restrict__ max_part) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  using ScoreT = typename std::conditional<kGlobalMax, double, float>::type;
  const int split = blockIdx.x, kvh = blockIdx.y / head_groups(h / kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<true>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale =
      kGlobalMax ? static_cast<float>(1.0 / sqrt(static_cast<double>(d)))
                 : rsqrtf(static_cast<float>(d));
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const size_t head0 = (size_t)row * h + kvh * (h / kv) + hg.first;
  const size_t base = ((size_t)row * s * kv + kvh) * d;  // position 0's row
  const size_t stride = (size_t)kv * d;

  __shared__ __align__(16) float qs[kMaxG][kWideMaxHeadDim];
  __shared__ float sc[kMaxG][kWideP];
  __shared__ float pr[kMaxG][kWideP];
  __shared__ float corr_s[kMaxG];
  __shared__ float tile_scale[2][kWideP];  // k, v (int8)
  wide_load_q(qs, q, head0, g_n, d);

  // softmax state of the heads this warp owns (w, w + kWarps), and the
  // P.V accumulator of this thread's elements tid + kThreads * j
  float m[kMaxG / kWarps], l[kMaxG / kWarps];
#pragma unroll
  for (int j = 0; j < kMaxG / kWarps; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    if constexpr (kGlobalMax) {
      const int g = warp + kWarps * j;
      if (g < g_n) {
        const float* mp = max_part + (head0 + g) * n_splits;
        float mx = kNegInf;
        for (int i = lane; i < n_splits; i += 32) mx = fmaxf(mx, mp[i]);
        m[j] = repro::warp_max(mx);
      }
    }
  }
  float acc[kMaxG][kWideE];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kWideE; ++j) acc[g][j] = 0.f;
  __syncthreads();

  for (int p0 = s0; p0 < s1; p0 += kWideP) {
    const int n_valid = min(kWideP, s1 - p0);
    if constexpr (kQuant) {
      if (tid < kWideP) {
        float k_sc = 0.f, v_sc = 0.f;
        if (tid < n_valid) {
          const size_t i = ((size_t)row * s + p0 + tid) * kv + kvh;
          k_sc = __half2float(k_scale[i]);
          v_sc = __half2float(v_scale[i]);
        }
        tile_scale[0][tid] = k_sc;
        tile_scale[1][tid] = v_sc;
      }
    }
    // scores: warp w dots positions w, w + kWarps, ...
    for (int p = warp; p < n_valid; p += kWarps) {
      ScoreT part[kMaxG];
      wide_dot<KV, ScoreT>(qs, k + base + (size_t)(p0 + p) * stride, d, g_n,
                           lane, part);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < g_n && lane == g) sc[g][p] = static_cast<float>(part[g]);
    }
    __syncthreads();

    // online softmax, once per tile: lane p of warp w takes position p of
    // heads w, w + kWarps
#pragma unroll
    for (int j = 0; j < kMaxG / kWarps; ++j) {
      const int g = warp + kWarps * j;
      if (g < g_n) {
        float x = kNegInf;
        if (lane < n_valid) {
          x = sc[g][lane];
          x *= scale;
          if constexpr (kQuant) x *= tile_scale[0][lane];
        }
        const float m_new =
            kGlobalMax ? m[j] : fmaxf(m[j], repro::warp_max(x));
        const float e = lane < n_valid ? expf(x - m_new) : 0.f;
        // int8: P times the v scale, rounded to bf16 (l sums the f32 P)
        if constexpr (kQuant)
          pr[g][lane] = __bfloat162float(__float2bfloat16(e * tile_scale[1][lane]));
        else
          pr[g][lane] = e;
        const float corr = expf(m[j] - m_new);
        l[j] = l[j] * corr + repro::warp_sum(e);
        m[j] = m_new;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // P.V: this thread's elements of every head
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < g_n) {
        const float c = corr_s[g];
#pragma unroll
        for (int j = 0; j < kWideE; ++j) acc[g][j] *= c;
      }
    }
    for (int p = 0; p < n_valid; ++p) {
      const KV* vr = v + base + (size_t)(p0 + p) * stride;
      float vf[kWideE];
#pragma unroll
      for (int j = 0; j < kWideE; ++j) {
        const int e = tid + kThreads * j;
        vf[j] = e < d ? wide_float(vr[e]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < g_n) {
          const float pg = pr[g][p];
#pragma unroll
          for (int j = 0; j < kWideE; ++j) acc[g][j] += pg * vf[j];
        }
      }
    }
    __syncthreads();  // sc, pr and corr_s are rewritten by the next tile
  }

  const size_t hp0 = head0 * n_splits + split;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < g_n) {
#pragma unroll
      for (int j = 0; j < kWideE; ++j) {
        const int e = tid + kThreads * j;
        if (e < d) acc_part[(hp0 + (size_t)g * n_splits) * d + e] = acc[g][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxG / kWarps; ++j) {
    const int g = warp + kWarps * j;
    if (g < g_n && lane == 0) {
      m_part[hp0 + (size_t)g * n_splits] = m[j];
      l_part[hp0 + (size_t)g * n_splits] = l[j];
    }
  }
}

// The wide path's pre-pass for the int8 mode with q in f32: each of the
// block's heads' largest score (q . k) / sqrt(d) * k_scale over its
// split's positions, into max_part (bsz, h, n_splits), the score computed
// as fd_split_wide_kernel computes it with kGlobalMax (wide_dot in f64,
// rounded once, then the same two products).
__global__ void __launch_bounds__(kThreads)
fd_int8_max_wide_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k,
                        const __half* __restrict__ k_scale,
                        const int* __restrict__ length,
                        float* __restrict__ max_part, int s, int h, int kv,
                        int n_splits, int chunk, int d) {
  const int split = blockIdx.x, kvh = blockIdx.y / head_groups(h / kv),
            row = blockIdx.z;
  const HeadGroup hg = head_group<true>(blockIdx.y, h, kv);
  const int g_n = hg.g_n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const size_t head0 = (size_t)row * h + kvh * (h / kv) + hg.first;
  const size_t base = ((size_t)row * s * kv + kvh) * d;
  const size_t stride = (size_t)kv * d;
  __shared__ __align__(16) float qs[kMaxG][kWideMaxHeadDim];
  __shared__ float wmax[kWarps][kMaxG];
  wide_load_q(qs, q, head0, g_n, d);
  __syncthreads();
  float mx[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) mx[g] = kNegInf;
  for (int p = s0 + warp; p < s1; p += kWarps) {
    double part[kMaxG];
    wide_dot<int8_t, double>(qs, k + base + (size_t)p * stride, d, g_n, lane,
                             part);
    const float ksc = __half2float(k_scale[((size_t)row * s + p) * kv + kvh]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      float x = static_cast<float>(part[g]);
      x *= scale;
      x *= ksc;
      if (g < g_n) mx[g] = fmaxf(mx[g], x);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) wmax[warp][g] = mx[g];
  __syncthreads();
  if (tid < g_n) {
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wmax[w][tid]);
    max_part[(head0 + tid) * n_splits + split] = m;
  }
}

// The LoRA epilogue's operands: x (bsz, dx) in the attention dtype, a
// (n, dx, r) and b (n, r, h*dh) in the bank's dtype W, idx (bsz,) int32,
// h_part (bsz, r) f32 scratch for the shrink's h; block c of a row's
// shrink cluster shrinks rows [c * d_tile, (c + 1) * d_tile) of dx
// (16-byte loads of A where vec_a).
template <typename T, typename W>
struct LoraArgs {
  const T* x;
  const W* a;
  const W* b;
  const int* idx;
  float* h_part;
  int dx, r, n, h;
  float scale;
  int d_tile;
  bool vec_a, vec_b;
};

// The fused kernel's second launch: h_part[row] = x[row] @ A[id] in f32,
// one cluster of C blocks a row (lora.cuh::cluster_shrink).  Launched as
// the split pass's programmatic dependent, it runs beside the split pass,
// and lets the combine, its own dependent, launch at once.  Every block
// waits for the split pass before it exits, so that this grid's end,
// which the combine waits for, implies the split pass's.  A row whose id
// is outside [0, N) writes nothing (the combine reads no h for it).
template <typename T, typename W>
__global__ void __launch_bounds__(lr::kThreads)
fd_lora_shrink_kernel(LoraArgs<T, W> lora) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kVW = 16 / sizeof(W);
  const int row = blockIdx.y;
  const int id = lora.idx[row];
  if (id < 0 || id >= lora.n) {  // the whole cluster (one row)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    return;
  }
  lr::cluster_arrive();
  __shared__ lr::ShrinkSmem sm;
  extern __shared__ float xs[];  // [d_tile]
  lr::cg::cluster_group cluster = lr::cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int i0 = min(c * lora.d_tile, lora.dx);
  const int rows = min(i0 + lora.d_tile, lora.dx) - i0;
  const T* xr = lora.x + (size_t)row * lora.dx + i0;
  const W* as = lora.a + ((size_t)id * lora.dx + i0) * lora.r;
  if (lora.vec_a) {
    lr::Shrink<W, kVW> sh;
    sh.issue(as, rows, lora.r);
    lr::cluster_shrink(cluster, sh, xr, rows, as, lora.r, xs, sm);
  } else {
    lr::Shrink<W, 1> sh;
    sh.issue(as, rows, lora.r);
    lr::cluster_shrink(cluster, sh, xr, rows, as, lora.r, xs, sm);
  }
  if (c == 0 && static_cast<int>(threadIdx.x) < lora.r)
    lora.h_part[(size_t)row * lora.r + threadIdx.x] = sm.h[threadIdx.x];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The merge of one (row, head), hp = row * h + head: the splits by
// log-sum-exp in f32 (merge_stats: the largest m and 1 / sum; merge_head:
// the outputs); with delta, scale * delta[dd] is added before the cast.
struct MergeStats {
  float mx, inv;
};

// The largest m of the splits, and the sum of their l rescaled to it.
__device__ __forceinline__ float merge_sum(const float* mp, const float* lp,
                                           int n_splits, float& mx) {
  mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, mp[i]);
  float ls = 0.f;
  for (int i = 0; i < n_splits; ++i) ls += lp[i] * expf(mp[i] - mx);
  return ls;
}

__device__ __forceinline__ MergeStats merge_stats(const float* mp,
                                                  const float* lp,
                                                  int n_splits) {
  float mx;
  const float ls = merge_sum(mp, lp, n_splits, mx);
  return {mx, 1.f / fmaxf(ls, 1e-20f)};
}

template <typename T>
__device__ __forceinline__ void merge_head(const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          const float* __restrict__ acc_part,
                                          T* __restrict__ out, int n_splits,
                                          int dh, size_t hp, MergeStats st,
                                          const float* delta, float scale) {
  const float* mp = m_part + hp * n_splits;
  const float mx = st.mx, inv = st.inv;
  for (int dd = threadIdx.x; dd < dh; dd += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += acc_part[(hp * n_splits + i) * dh + dd] * expf(mp[i] - mx);
    float o = a * inv;
    if (delta) o += delta[dd] * scale;
    out[hp * dh + dd] = repro::from_float<T>(o);
  }
}

// The expand of one (row, head): delta[dd] = sum over l of h[l] * B[l, col0
// + dd] in f32, B's rows ld elements apart, with loads of V elements (16
// bytes, or 1 on the scalar path).  Thread item (column group cg, row
// group rg) sums rows [rg * rpg, (rg + 1) * rpg) of its V columns, a
// group's rows in flight together (kRows at a time); the groups' sums
// then add in group order.  issue() puts the first rows in flight before
// h is known.
template <typename W, int V>
struct Expand {
  static constexpr int kRows = 4;  // rows in flight a thread
  lr::BRows<W, V, kRows> first;
  int ncg, nrg, rpg;

  __device__ __forceinline__ void rows_of(int item, int r, int& l0,
                                          int& l1) const {
    l0 = min((item / ncg) * rpg, r);
    l1 = min(l0 + rpg, r);
  }

  __device__ __forceinline__ void issue(const W* bt, size_t ld, int dh,
                                        int r) {
    ncg = dh / V;
    nrg = max(1, static_cast<int>(blockDim.x) / ncg);
    rpg = (r + nrg - 1) / nrg;
    const int item = threadIdx.x;
    if (item < ncg * nrg) {
      int l0, l1;
      rows_of(item, r, l0, l1);
      if (l0 < l1) first.load(bt, ld, (item % ncg) * V, l0, l1);
    }
  }

  // part: nrg * dh floats; delta: dh floats
  __device__ __forceinline__ void finish(const W* bt, size_t ld, int dh,
                                         int r, const float* h, float* part,
                                         float* delta) {
    for (int item = threadIdx.x; item < ncg * nrg; item += blockDim.x) {
      int l0, l1;
      rows_of(item, r, l0, l1);
      const int col = (item % ncg) * V;
      float sum[V];
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] = 0.f;
      for (int l = l0; l < l1; l += kRows) {
        if (l == l0 && item == static_cast<int>(threadIdx.x)) {
          first.add(h, l, l1, sum);
        } else {
          lr::BRows<W, V, kRows> more;
          more.load(bt, ld, col, l, l1);
          more.add(h, l, l1, sum);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) part[(item / ncg) * dh + col + e] = sum[e];
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd < dh; dd += blockDim.x) {
      float t = 0.f;
      for (int g = 0; g < nrg; ++g) t += part[g * dh + dd];
      delta[dd] = t;
    }
    __syncthreads();
  }
};

// The fused combine of one (row, head): B's rows for this head go out
// before the wait; after it h (the shrink kernel's, the same f32 for every
// head of the row) and the merge's m and l are read together, then the
// expand and the merge with scale * delta.
template <typename T, typename W, int V, int kDeltaDim = kMaxHeadDim>
__device__ __forceinline__ void combine_lora(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ acc_part, T* __restrict__ out, int n_splits,
    int dh, const LoraArgs<T, W>& lora) {
  const size_t hp = blockIdx.x;
  const int row = static_cast<int>(hp / lora.h);
  const int head = static_cast<int>(hp % lora.h);
  const int id = lora.idx[row];
  const bool live = id >= 0 && id < lora.n;  // the same for the whole block
  const size_t ld = (size_t)lora.h * dh;     // B's row stride
  const W* bt = lora.b + (size_t)(live ? id : 0) * lora.r * ld +
                (size_t)head * dh;
  Expand<W, V> ex;
  if (live) ex.issue(bt, ld, dh, lora.r);
  // the shrink's h, and through the shrink's own wait the split pass's
  // partials: launched as the shrink's programmatic dependent, this grid
  // may have started before either ended
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float h_row[lr::kMaxRank];
  __shared__ float part[kCombineThreads * lr::kMaxVec];
  __shared__ float delta[kDeltaDim];
  if (live && static_cast<int>(threadIdx.x) < lora.r)
    h_row[threadIdx.x] =
        __ldcg(lora.h_part + (size_t)row * lora.r + threadIdx.x);
  const MergeStats st = merge_stats(m_part + hp * n_splits,
                                    l_part + hp * n_splits, n_splits);
  if (live) {
    __syncthreads();
    ex.finish(bt, ld, dh, lora.r, h_row, part, delta);
  }
  merge_head<T>(m_part, l_part, acc_part, out, n_splits, dh, hp, st,
                live ? delta : nullptr, lora.scale);
}

// One block per (row, head): merge the splits by log-sum-exp (merge_head);
// with kLora, add the row's LoRA delta for this head, scale * h @
// B[id][:, head], in f32 before the cast (combine_lora).  Plain
// flash-decode is the kLora = false instance.
template <typename T, typename W, bool kLora>
__global__ void __launch_bounds__(kCombineThreads, kLora ? kLoraCombineBlocks : 1)
fd_combine_kernel(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ acc_part, T* __restrict__ out,
                  int n_splits, int dh, LoraArgs<T, W> lora) {
  if constexpr (kLora) {
    if (lora.vec_b)
      combine_lora<T, W, 16 / sizeof(W)>(m_part, l_part, acc_part, out,
                                         n_splits, dh, lora);
    else
      combine_lora<T, W, 1>(m_part, l_part, acc_part, out, n_splits, dh,
                            lora);
  } else {
    const size_t hp = blockIdx.x;
    merge_head<T>(m_part, l_part, acc_part, out, n_splits, dh, hp,
                  merge_stats(m_part + hp * n_splits, l_part + hp * n_splits,
                              n_splits),
                  nullptr, 0.f);
  }
}

// fd_combine_kernel's plain merge, which also writes each (row, head)'s
// log-sum-exp, lse[hp] = m + log l of the merged max and sum (-inf at a
// length of 0: every split empty, l = 0): the flash-decode of one slice of
// a sequence-sharded cache, whose slices combine by it.  Its output stays
// f32, the merge before the cast, so that the slices combine before one
// rounding to q's dtype, as the JAX package combines its shards' f32
// partials.  A kernel of its own, so that fd_combine_kernel's instances
// keep their code; its merge is theirs (merge_sum and merge_head), so its
// output rounds to theirs bit for bit.
__global__ void __launch_bounds__(kCombineThreads)
fd_combine_lse_kernel(const float* __restrict__ m_part,
                      const float* __restrict__ l_part,
                      const float* __restrict__ acc_part,
                      float* __restrict__ out, float* __restrict__ lse,
                      int n_splits, int dh) {
  const size_t hp = blockIdx.x;
  float mx;
  const float ls = merge_sum(m_part + hp * n_splits, l_part + hp * n_splits,
                             n_splits, mx);
  if (threadIdx.x == 0) lse[hp] = mx + logf(ls);
  merge_head<float>(m_part, l_part, acc_part, out, n_splits, dh, hp,
                    MergeStats{mx, 1.f / fmaxf(ls, 1e-20f)}, nullptr, 0.f);
}

// The fused combine of the wide path: fd_combine_kernel's kLora instance
// with a delta of up to kWideMaxHeadDim elements (Expand's partials fit
// its kCombineThreads * kMaxVec floats at any dh <= 1024).
template <typename T, typename W>
__global__ void __launch_bounds__(kCombineThreads)
fd_combine_wide_kernel(const float* __restrict__ m_part,
                       const float* __restrict__ l_part,
                       const float* __restrict__ acc_part, T* __restrict__ out,
                       int n_splits, int dh, LoraArgs<T, W> lora) {
  if (lora.vec_b)
    combine_lora<T, W, 16 / sizeof(W), kWideMaxHeadDim>(
        m_part, l_part, acc_part, out, n_splits, dh, lora);
  else
    combine_lora<T, W, 1, kWideMaxHeadDim>(m_part, l_part, acc_part, out,
                                           n_splits, dh, lora);
}

// The split pass of the wide path: the pre-pass first for the int8 mode
// with q in f32.  Chunks must be whole tiles of kWideP positions.
template <typename T, bool kInt8>
cudaError_t launch_split_wide(const dim3& grid, cudaStream_t st,
                              const void* q, const void* k, const void* v,
                              const void* k_scale, const void* v_scale,
                              const void* length, void* m_part, void* l_part,
                              void* acc_part, int s, int h, int kv,
                              int n_splits, int chunk, int d,
                              void* max_part) {
  using KV = typename std::conditional<kInt8, int8_t, T>::type;
  constexpr bool kGlobalMax = kInt8 && std::is_same<T, float>::value;
  if (chunk % kWideP) return cudaErrorInvalidValue;
  if constexpr (kGlobalMax) {
    fd_int8_max_wide_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(k),
        static_cast<const __half*>(k_scale), static_cast<const int*>(length),
        static_cast<float*>(max_part), s, h, kv, n_splits, chunk, d);
    cudaError_t err = cudaPeekAtLastError();
    if (err != cudaSuccess) return err;
  }
  fd_split_wide_kernel<T, KV, kGlobalMax><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __half*>(k_scale),
      static_cast<const __half*>(v_scale), static_cast<const int*>(length),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), s, h, kv, n_splits, chunk, d,
      static_cast<const float*>(max_part));
  return cudaPeekAtLastError();
}

// The split pass of one (dtype, head dim) instance, over an int8 cache and
// its scales with kInt8, in head groups with kGroups, for a head dim d < D
// with kPad: chunks must be whole tiles; the ring has as many stages as a
// chunk has tiles, at most kMaxStages.  The int8 mode with q in f32 runs
// its pre-pass (fd_int8_max_kernel into max_part) first.  Returns the
// launch error, or cudaErrorInvalidValue.
template <typename T, int D, bool kEarly, bool kInt8, bool kGroups, bool kPad>
cudaError_t launch_split(const dim3& grid, cudaStream_t st, const void* q,
                         const void* k, const void* v, const void* k_scale,
                         const void* v_scale, const void* length,
                         void* m_part, void* l_part, void* acc_part, int s,
                         int h, int kv, int n_splits, int chunk, int d,
                         void* max_part) {
  using KV = typename std::conditional<kInt8, int8_t, T>::type;
  using G = Tile<KV, D>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (chunk % G::kP) return cudaErrorInvalidValue;
  const int stages = min(kMaxStages, chunk / G::kP);
  const int smem = stages * 2 * G::kBytes;
  static repro::SmemLimit limit;
  if constexpr (kInt8 && (kF32 || kPad)) {
    if constexpr (kF32) {
      fd_int8_max_kernel<D, kGroups><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q), static_cast<const int8_t*>(k),
          static_cast<const __half*>(k_scale), static_cast<const int*>(length),
          static_cast<float*>(max_part), s, h, kv, n_splits, chunk, d);
      cudaError_t err = cudaPeekAtLastError();
      if (err != cudaSuccess) return err;
    }
    cudaError_t err =
        limit.raise(fd_split_int8_any_kernel<T, D, kGroups, kPad>, smem);
    if (err != cudaSuccess) return err;
    fd_split_int8_any_kernel<T, D, kGroups, kPad><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const __half*>(k_scale),
        static_cast<const __half*>(v_scale), static_cast<const int*>(length),
        static_cast<float*>(m_part), static_cast<float*>(l_part),
        static_cast<float*>(acc_part), s, h, kv, n_splits, chunk, stages, d,
        static_cast<const float*>(max_part));
  } else if constexpr (kPad) {
    cudaError_t err = limit.raise(fd_split_pad_kernel<T, D, kGroups>, smem);
    if (err != cudaSuccess) return err;
    fd_split_pad_kernel<T, D, kGroups><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(length),
        static_cast<float*>(m_part), static_cast<float*>(l_part),
        static_cast<float*>(acc_part), s, h, kv, n_splits, chunk, stages, d);
  } else if constexpr (kInt8) {
    cudaError_t err = limit.raise(fd_split_int8_kernel<T, D, kGroups>, smem);
    if (err != cudaSuccess) return err;
    fd_split_int8_kernel<T, D, kGroups><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const int8_t*>(k),
        static_cast<const int8_t*>(v), static_cast<const __half*>(k_scale),
        static_cast<const __half*>(v_scale), static_cast<const int*>(length),
        static_cast<float*>(m_part), static_cast<float*>(l_part),
        static_cast<float*>(acc_part), s, h, kv, n_splits, chunk, stages);
  } else {
    cudaError_t err =
        limit.raise(fd_split_kernel<T, D, kEarly, kGroups>, smem);
    if (err != cudaSuccess) return err;
    fd_split_kernel<T, D, kEarly, kGroups><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(length),
        static_cast<float*>(m_part), static_cast<float*>(l_part),
        static_cast<float*>(acc_part), s, h, kv, n_splits, chunk, stages);
  }
  return cudaPeekAtLastError();
}

// The instance that runs head dim dh: dh itself where instantiated (8, 16,
// ..., 256; the int8 mode from 16, an int8 row of 8 bytes being half a
// 16-byte chunk), else the next larger, padded; 0 outside [1, 256] (past
// 256 the wide path runs dh unpadded, up to kWideMaxHeadDim).  Mirrored by
// flash_decode.py::instance_dim.
int instance_dim(int dh, bool int8) {
  if (dh < 1 || dh > kMaxHeadDim) return 0;
  int d = int8 ? 16 : 8;
  while (d < dh) d *= 2;
  return d;
}

// The kernels of one call: the split pass (over an int8 cache with kInt8),
// then the combine; with kLora the shrink kernel between them, the shrink
// and the combine each the programmatic dependent of the launch before.
// max_part (bsz, h, n_splits) f32 is the int8 mode's pre-pass scratch for
// q in f32.  Head dims past 256 take the wide path.  With lse (bsz, h) f32
// (not with kLora) the combine is fd_combine_lse_kernel, which writes the
// log-sum-exp there too, and out in f32.  Returns the launch error, or
// cudaErrorInvalidValue for a head dim outside [1, 1024] or a chunk that
// is not whole tiles.
template <typename T, typename W, bool kLora, bool kInt8 = false>
int launch_fd(const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* length,
              void* m_part, void* l_part, void* acc_part, void* out, int bsz,
              int s, int h, int kv, int dh, int n_splits, int chunk,
              const LoraArgs<T, W>& lora, cudaStream_t st,
              void* max_part = nullptr, void* lse = nullptr) {
  static_assert(!(kLora && kInt8), "the fused kernel reads a T cache");
  // cp.async copies 16-byte chunks of K and V (narrower pieces of a row
  // whose bytes are not a multiple of 16, aligned within the row)
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = dh > kMaxHeadDim;
  if (wide && dh > kWideMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const int di = wide ? dh : instance_dim(dh, kInt8);
  const bool pad = di != dh;
  // query heads a block: kMaxG256 on split_mma_d256 (mirrored by
  // flash_decode.py::mma256_pass and MMA256_GROUP)
  const int max_g = !kInt8 && kMmaD256<T, kMaxHeadDim> && di == kMaxHeadDim
                        ? kMaxG256 : kMaxG;
  const bool groups = h / kv > max_g;
  const dim3 grid(n_splits, kv * head_groups(h / kv, max_g), bsz);
  cudaError_t err;
#define REPRO_FD_SPLIT_P(D, G, P)                                            \
  launch_split<T, D, kLora, kInt8, G, P>(grid, st, q, k, v, k_scale,         \
                                         v_scale, length, m_part, l_part,    \
                                         acc_part, s, h, kv, n_splits,       \
                                         chunk, dh, max_part)
#define REPRO_FD_SPLIT_G(D, G) \
  (pad ? REPRO_FD_SPLIT_P(D, G, true) : REPRO_FD_SPLIT_P(D, G, false))
#define REPRO_FD_SPLIT(D) \
  (groups ? REPRO_FD_SPLIT_G(D, true) : REPRO_FD_SPLIT_G(D, false))
  if (wide)
    err = launch_split_wide<T, kInt8>(grid, st, q, k, v, k_scale, v_scale,
                                      length, m_part, l_part, acc_part, s, h,
                                      kv, n_splits, chunk, dh, max_part);
  else switch (di) {
    case 8:  // a bf16 row is one 16-byte chunk; the int8 mode starts at 16
      if constexpr (kInt8) return static_cast<int>(cudaErrorInvalidValue);
      else err = REPRO_FD_SPLIT(8);
      break;
    case 16: err = REPRO_FD_SPLIT(16); break;
    case 32: err = REPRO_FD_SPLIT(32); break;
    case 64: err = REPRO_FD_SPLIT(64); break;
    case 128: err = REPRO_FD_SPLIT(128); break;
    case 256: err = REPRO_FD_SPLIT(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FD_SPLIT
#undef REPRO_FD_SPLIT_G
#undef REPRO_FD_SPLIT_P
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kLora) {
    // the shrink: one cluster of C blocks a row, C <= 8 from dx (as BGMV
    // cuts d); then the combine
    LoraArgs<T, W> args = lora;
    auto cdiv = [](int a, int b) { return (a + b - 1) / b; };
    const int cluster = min(lr::kMaxCluster, max(1, cdiv(lora.dx, kShrinkRows)));
    args.d_tile = cdiv(cdiv(lora.dx, cluster), lr::kAlign) * lr::kAlign;
    // 16-byte loads of A need the base, a whole adapter and a slice start
    // (a multiple of kAlign rows) on 16 bytes
    args.vec_a = reinterpret_cast<uintptr_t>(lora.a) % 16 == 0 &&
                 (size_t)lora.dx * lora.r * sizeof(W) % 16 == 0;
    // those of B the base and every head's first column
    args.vec_b = reinterpret_cast<uintptr_t>(lora.b) % 16 == 0 &&
                 dh * sizeof(W) % 16 == 0;
    const int smem = args.d_tile * static_cast<int>(sizeof(float));
    auto kernel = fd_lora_shrink_kernel<T, W>;
    static repro::SmemLimit limit;
    err = limit.raise(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = lr::launch_clusters(kernel, dim3(cluster, bsz), lr::kThreads,
                              cluster, smem, st, true, args);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = lr::launch_clusters(
        wide ? fd_combine_wide_kernel<T, W> : fd_combine_kernel<T, W, true>,
        dim3(bsz * h), kCombineThreads, 0, 0, st, true,
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<T*>(out), n_splits,
        dh, args);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (lse) {
    fd_combine_lse_kernel<<<bsz * h, kCombineThreads, 0, st>>>(
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<float*>(out),
        static_cast<float*>(lse), n_splits, dh);
  } else {
    fd_combine_kernel<T, W, false><<<bsz * h, kCombineThreads, 0, st>>>(
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<T*>(out), n_splits,
        dh, lora);
  }
  return static_cast<int>(cudaPeekAtLastError());
}

bool bad_shape(int h, int kv, int n_splits, int chunk) {
  return kv < 1 || h % kv || n_splits < 1 || chunk < 1;
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  void* lse, int bsz, int s, int h, int kv,
                                  int dh, int n_splits, int chunk, int dtype,
                                  void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (bad_shape(h, kv, n_splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T,
      rc = launch_fd<T, T, false>(q, k, v, nullptr, nullptr, length, m_part,
                                  l_part, acc_part, out, bsz, s, h, kv, dh,
                                  n_splits, chunk, LoraArgs<T, T>{}, st,
                                  nullptr, lse));
  return rc;
}

extern "C" int repro_flash_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* length, void* m_part, void* l_part,
    void* acc_part, void* max_part, void* out, void* lse, int bsz, int s,
    int h, int kv, int dh, int n_splits, int chunk, int dtype, void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (bad_shape(h, kv, n_splits, chunk) || !k_scale || !v_scale ||
      (dtype == REPRO_F32 && !max_part))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T,
      rc = launch_fd<T, T, false, true>(q, k, v, k_scale, v_scale, length,
                                        m_part, l_part, acc_part, out, bsz,
                                        s, h, kv, dh, n_splits, chunk,
                                        LoraArgs<T, T>{}, st, max_part,
                                        lse));
  return rc;
}

extern "C" int repro_flash_decode_lora(
    const void* q, const void* k, const void* v, const void* length,
    const void* x, const void* a, const void* b, const void* idx,
    void* m_part, void* l_part, void* acc_part, void* h_part, void* out,
    int bsz, int s, int h, int kv, int dh, int n_splits, int chunk, int dx,
    int r, int n, float scale, int dtype, int w_dtype, void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (bad_shape(h, kv, n_splits, chunk) || r < 1 || r > lr::kMaxRank || n < 1 ||
      dx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T, REPRO_DISPATCH_DTYPE(w_dtype, W,
      rc = launch_fd<T, W, true>(
          q, k, v, nullptr, nullptr, length, m_part, l_part, acc_part, out,
          bsz, s, h, kv, dh, n_splits, chunk,
          LoraArgs<T, W>{static_cast<const T*>(x), static_cast<const W*>(a),
                         static_cast<const W*>(b),
                         static_cast<const int*>(idx),
                         static_cast<float*>(h_part), dx, r, n, h, scale, 0,
                         false, false},
          st)));
  return rc;
}
