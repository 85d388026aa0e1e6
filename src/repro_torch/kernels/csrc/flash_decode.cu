// Flash-decode: single-query GQA attention over a contiguous KV cache.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::flash_decode
// (_fd_kernel, pallas_call at flash_decode.py:95).  Pallas walked the KV
// blocks of one batch row in order on one core, carrying the online-softmax
// state (m, l, acc) in VMEM scratch from grid step to grid step.
//
// What bounds it here: each query head reads its whole KV row once and does
// 4*D FLOPs per position against 2*D*bytes of K and V, so the kernel is bound
// by the bytes of K and V it streams (at B=8, S=512, KV=8, D=128 in bf16,
// 16.8 MB: about 5 us at 3.35 TB/s).
//
// Design: split-KV.  Blocks cannot carry state from one to the next, and one
// block per (row, kv-head) would leave most of the 132 SMs idle at decode
// batch sizes, so the sequence is cut into n_splits chunks and one block per
// (split, kv-head, row) covers the G query heads that share that KV head
// (query head h reads KV head h / G), so K and V are read once for all G.
// Each of its 4 warps takes every 4th position; a lane holds D/32 elements of
// q, K, V and acc, and the G dot products reduce across the warp.  Each warp
// keeps f32 (m, l, acc) per query head; the block merges its warps and writes
// one partial per (row, head, split).  A second kernel merges the splits by
// log-sum-exp and writes q's dtype.  The tail is masked by the loop bound
// (no block-size halving); a length >= S means all of S; a length of 0 gives
// 0, as the Pallas kernel does.
#include "common.cuh"
#include "kernels.h"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;
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

// One block per (row, head): merge the splits by log-sum-exp.
template <typename T>
__global__ void fd_combine_kernel(const float* __restrict__ m_part,
                                  const float* __restrict__ l_part,
                                  const float* __restrict__ acc_part,
                                  T* __restrict__ out, int n_splits, int dh) {
  const size_t hp = blockIdx.x;  // row * h + head
  const float* mp = m_part + hp * n_splits;
  const float* lp = l_part + hp * n_splits;
  float mx = kNegInf;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, mp[i]);
  float ls = 0.f;
  for (int i = 0; i < n_splits; ++i) ls += lp[i] * expf(mp[i] - mx);
  const float inv = 1.f / fmaxf(ls, 1e-20f);
  for (int dd = threadIdx.x; dd < dh; dd += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_splits; ++i)
      a += acc_part[(hp * n_splits + i) * dh + dd] * expf(mp[i] - mx);
    out[hp * dh + dd] = repro::from_float<T>(a * inv);
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

}  // namespace

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* length, void* m_part,
                                  void* l_part, void* acc_part, void* out,
                                  int bsz, int s, int h, int kv, int dh,
                                  int n_splits, int chunk, int dtype,
                                  void* stream) {
  if (bsz <= 0 || h <= 0) return 0;
  if (kv < 1 || h % kv || h / kv > kMaxG || n_splits < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_splits, kv, bsz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
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
    fd_combine_kernel<T><<<bsz * h, 128, 0, st>>>(
        static_cast<const float*>(m_part), static_cast<const float*>(l_part),
        static_cast<const float*>(acc_part), static_cast<T*>(out), n_splits, dh);
  });
  return static_cast<int>(cudaPeekAtLastError());
}
