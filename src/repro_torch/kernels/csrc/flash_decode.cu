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
// 16.8 MB: about 5 us at 3.35 TB/s).  The LoRA delta adds the bytes of x and
// of each used adapter's A and B (at dx=3072, r=8: 0.1 MB per adapter).
//
// Design: split-KV.  Blocks cannot carry state from one to the next, and one
// block per (row, kv-head) would leave most of the 132 SMs idle at decode
// batch sizes, so the sequence is cut into n_splits chunks and one block per
// (split, kv-head, row) covers the G query heads that share that KV head
// (query head h reads KV head h / G), so K and V are read once for all G.
// Each of its 4 warps takes every 4th position; a lane holds D/32 elements of
// q, K, V and acc, and the G dot products reduce across the warp.  Each warp
// keeps f32 (m, l, acc) per query head; the block merges its warps and writes
// one partial per (row, head, split).  A second kernel, one block per
// (row, head), merges the splits by log-sum-exp and writes q's dtype.  The
// tail is masked by the loop bound (no block-size halving); a length >= S
// means all of S; a length of 0 gives 0, as the Pallas kernel does.
//
// The fused kernel runs the same split kernel and the same combine kernel,
// instantiated with kLora: each (row, head) block shrinks h = x[row] @ A[id]
// in f32 into shared memory (kept f32, as the Pallas epilogue keeps it), then
// adds scale * h @ B[id][:, head*D:(head+1)*D] to the f32 attention before
// the one cast.  Every head of a row recomputes the rank-r shrink from L2
// (dx*r reads of A per block) rather than pay a third launch.  A row whose
// id is outside [0, N) skips the add, so an all-base batch is bitwise the
// plain kernel's output.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;
constexpr int kCombineThreads = 128;
constexpr int kMaxRank = 64;  // as bgmv.cu
constexpr int kBatch = 8;     // loads in flight a thread in the LoRA epilogue
constexpr float kNegInf = -1.0e30f;  // finite, as in Pallas: exp(m - m) stays 1

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ length,
                float* __restrict__ m_part, float* __restrict__ l_part,
                float* __restrict__ acc_part, int s, int h, int kv,
                int n_splits, int chunk) {
  constexpr int kE = (D + 31) / 32;  // elements per lane
  const int split = blockIdx.x, kvh = blockIdx.y, row = blockIdx.z;
  const int g_n = h / kv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale = rsqrtf(static_cast<float>(D));
  const int len = min(max(length[row], 0), s);
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);

  float qv[kMaxG][kE], acc[kMaxG][kE], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int dd = lane + 32 * e;
      acc[g][e] = 0.f;
      qv[g][e] = (g < g_n && dd < D)
                     ? repro::to_float(q[((size_t)row * h + kvh * g_n + g) * D + dd])
                     : 0.f;
    }
  }

  for (int p = s0 + warp; p < s1; p += kWarps) {
    const size_t base = (((size_t)row * s + p) * kv + kvh) * D;
    float kk[kE], vv[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int dd = lane + 32 * e;
      kk[e] = dd < D ? repro::to_float(k[base + dd]) : 0.f;
      vv[e] = dd < D ? repro::to_float(v[base + dd]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < g_n) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot += qv[g][e] * kk[e];
        const float sc = repro::warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float corr = expf(m[g] - m_new);
        const float pr = expf(sc - m_new);
        l[g] = l[g] * corr + pr;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = acc[g][e] * corr + pr * vv[e];
        m[g] = m_new;
      }
    }
  }

  // Merge the warps' states, then write this split's partial.
  __shared__ float sm[kWarps][kMaxG], sl[kWarps][kMaxG];
  __shared__ float sacc[kWarps][kMaxG][D];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (lane == 0) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int dd = lane + 32 * e;
      if (dd < D) sacc[warp][g][dd] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g_n * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w][g]);
    float ls = 0.f, as = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm[w][g] - mx);
      ls += sl[w][g] * c;
      as += sacc[w][g][dd] * c;
    }
    const size_t hp = ((size_t)row * h + kvh * g_n + g) * n_splits + split;
    acc_part[hp * D + dd] = as;
    if (dd == 0) {
      m_part[hp] = mx;
      l_part[hp] = ls;
    }
  }
}

// The LoRA epilogue's operands: x (bsz, dx) in the attention dtype, a
// (n, dx, r) and b (n, r, h*dh) in the bank's dtype W, idx (bsz,) int32.
template <typename T, typename W>
struct LoraArgs {
  const T* x;
  const W* a;
  const W* b;
  const int* idx;
  int dx, r, n, h;
  float scale;
};

// One block per (row, head): merge the splits by log-sum-exp; with kLora,
// add the row's LoRA delta for this head before the cast.  Plain
// flash-decode is the kLora = false instance of this code.
template <typename T, typename W, bool kLora>
__global__ void __launch_bounds__(kCombineThreads)
fd_combine_kernel(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ acc_part, T* __restrict__ out,
                  int n_splits, int dh, LoraArgs<T, W> lora) {
  const size_t hp = blockIdx.x;  // row * h + head
  const float* mp = m_part + hp * n_splits;
  const float* lp = l_part + hp * n_splits;
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, mp[i]);
  float ls = 0.f;
  for (int i = 0; i < n_splits; ++i) ls += lp[i] * expf(mp[i] - mx);
  const float inv = 1.f / fmaxf(ls, 1e-20f);

  // LoRA shrink: thread t owns lane t % r and walks the rows of A[id] (dx, r)
  // from t / r in steps of kCombineThreads / r, so neighbouring threads read
  // neighbouring elements; the lanes reduce through shared memory.  Loads
  // are issued kBatch at a time before their products are summed (in the
  // same order): with one load in flight a thread, each waiting for the
  // last, the shrink took ~70 us at dx 3072, r 8 on an H100 (PERF.md).
  __shared__ float part[kLora ? kCombineThreads : 1];
  __shared__ float hs[kLora ? kMaxRank : 1];
  bool live = false;
  const W* bt = nullptr;
  if constexpr (kLora) {
    const int row = static_cast<int>(hp / lora.h);
    const int head = static_cast<int>(hp % lora.h);
    const int id = lora.idx[row];
    live = id >= 0 && id < lora.n;  // the same for the whole block
    const int ida = min(max(id, 0), lora.n - 1);  // the address, clamped
    if (live) {
      const T* xr = lora.x + (size_t)row * lora.dx;
      const W* ar = lora.a + (size_t)ida * lora.dx * lora.r;
      const int step = kCombineThreads / lora.r;
      const int stride = lora.r * step;
      float acc = 0.f;
      if (threadIdx.x < stride) {
        const int lane = threadIdx.x % lora.r;
        int i = threadIdx.x / lora.r;
        for (; i + (kBatch - 1) * step < lora.dx; i += kBatch * step) {
          float xv[kBatch], av[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            xv[u] = repro::to_float(xr[i + u * step]);
            av[u] = repro::to_float(ar[(size_t)(i + u * step) * lora.r + lane]);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) acc += xv[u] * av[u];
        }
        for (; i < lora.dx; i += step)
          acc += repro::to_float(xr[i]) *
                 repro::to_float(ar[(size_t)i * lora.r + lane]);
      }
      part[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < lora.r) {
        float sum = 0.f;
        for (int k = threadIdx.x; k < stride; k += lora.r) sum += part[k];
        hs[threadIdx.x] = sum;
      }
      __syncthreads();
      bt = lora.b + (size_t)ida * lora.r * lora.h * dh + (size_t)head * dh;
    }
  }

  for (int dd = threadIdx.x; dd < dh; dd += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += acc_part[(hp * n_splits + i) * dh + dd] * expf(mp[i] - mx);
    float o = a * inv;
    if constexpr (kLora) {
      if (live) {
        const size_t ld = (size_t)lora.h * dh;  // B's row stride
        float delta = 0.f;
        int j = 0;
        for (; j + kBatch <= lora.r; j += kBatch) {
          float bv[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            bv[u] = repro::to_float(bt[(j + u) * ld + dd]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) delta += hs[j + u] * bv[u];
        }
        for (; j < lora.r; ++j) delta += hs[j] * repro::to_float(bt[j * ld + dd]);
        o += delta * lora.scale;
      }
    }
    out[hp * dh + dd] = repro::from_float<T>(o);
  }
}

template <typename T, int D>
void launch_split(const dim3& grid, cudaStream_t st, const void* q,
                  const void* k, const void* v, const void* length,
                  void* m_part, void* l_part, void* acc_part, int s, int h,
                  int kv, int n_splits, int chunk) {
  fd_split_kernel<T, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<float*>(m_part), static_cast<float*>(l_part),
      static_cast<float*>(acc_part), s, h, kv, n_splits, chunk);
}

// Both kernels of one call: the split pass, then the combine (kLora selects
// the epilogue).  Returns the launch error, or cudaErrorInvalidValue for a
// head dim that has no instance.
template <typename T, typename W, bool kLora>
int launch_fd(const void* q, const void* k, const void* v, const void* length,
              void* m_part, void* l_part, void* acc_part, void* out, int bsz,
              int s, int h, int kv, int dh, int n_splits, int chunk,
              const LoraArgs<T, W>& lora, cudaStream_t st) {
  const dim3 grid(n_splits, kv, bsz);
  switch (dh) {
    case 16: launch_split<T, 16>(grid, st, q, k, v, length, m_part, l_part, acc_part, s, h, kv, n_splits, chunk); break;
    case 32: launch_split<T, 32>(grid, st, q, k, v, length, m_part, l_part, acc_part, s, h, kv, n_splits, chunk); break;
    case 64: launch_split<T, 64>(grid, st, q, k, v, length, m_part, l_part, acc_part, s, h, kv, n_splits, chunk); break;
    case 128: launch_split<T, 128>(grid, st, q, k, v, length, m_part, l_part, acc_part, s, h, kv, n_splits, chunk); break;
    case 256: launch_split<T, 256>(grid, st, q, k, v, length, m_part, l_part, acc_part, s, h, kv, n_splits, chunk); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaPeekAtLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_combine_kernel<T, W, kLora><<<bsz * h, kCombineThreads, 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), n_splits, dh,
      lora);
  return static_cast<int>(cudaPeekAtLastError());
}

bool bad_shape(int h, int kv, int n_splits, int chunk) {
  return kv < 1 || h % kv || h / kv > kMaxG || n_splits < 1 || chunk < 1;
}

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  int bsz, int s, int h, int kv, int dh,
                                  int n_splits, int chunk, int dtype,
                                  void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (bad_shape(h, kv, n_splits, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T,
      rc = launch_fd<T, T, false>(q, k, v, length, m_part, l_part, acc_part,
                                  out, bsz, s, h, kv, dh, n_splits, chunk,
                                  LoraArgs<T, T>{}, st));
  return rc;
}

extern "C" int repro_flash_decode_lora(
    const void* q, const void* k, const void* v, const void* length,
    const void* x, const void* a, const void* b, const void* idx,
    void* m_part, void* l_part, void* acc_part, void* out, int bsz, int s,
    int h, int kv, int dh, int n_splits, int chunk, int dx, int r, int n,
    float scale, int dtype, int w_dtype, void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (bad_shape(h, kv, n_splits, chunk) || r < 1 || r > kMaxRank || n < 1 ||
      dx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  REPRO_DISPATCH_DTYPE(dtype, T, REPRO_DISPATCH_DTYPE(w_dtype, W,
      rc = launch_fd<T, W, true>(
          q, k, v, length, m_part, l_part, acc_part, out, bsz, s, h, kv, dh,
          n_splits, chunk,
          LoraArgs<T, W>{static_cast<const T*>(x), static_cast<const W*>(a),
                         static_cast<const W*>(b),
                         static_cast<const int*>(idx), dx, r, n, h, scale},
          st)));
  return rc;
}
