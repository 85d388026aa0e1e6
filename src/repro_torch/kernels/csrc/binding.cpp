// Python binding of the kernels for torch.utils.cpp_extension.load.
//
// The only source that includes PyTorch's headers, so the .cu files compile
// fast.  Arguments arrive as plain integers (device pointers and the stream
// from the Python wrappers, which check and allocate every tensor); each
// function launches, then raises through C10_CUDA_KERNEL_LAUNCH_CHECK() if
// the launch was refused, or if the launcher rejected its arguments.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

inline const void* cptr(int64_t p) { return reinterpret_cast<const void*>(p); }
inline void* ptr(int64_t p) { return reinterpret_cast<void*>(p); }

// A refused launch raises (and clears the error) in the macro; arguments the
// launcher itself rejects come back as its non-zero return code.
inline void check(int rc, const char* name) {
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  TORCH_CHECK(rc == 0, name, ": launcher rejected its arguments (",
              cudaGetErrorString(static_cast<cudaError_t>(rc)), ")");
}

void bgmv(int64_t x, int64_t a, int64_t b, int64_t idx, int64_t y, int64_t t,
          int64_t d, int64_t r, int64_t o, int64_t n, double scale,
          int64_t x_dtype, int64_t w_dtype, int64_t stream) {
  check(repro_bgmv(cptr(x), cptr(a), cptr(b), cptr(idx), ptr(y), t, d, r, o, n,
             static_cast<float>(scale), x_dtype, w_dtype, ptr(stream)),
        "bgmv");
}

void sgmv_segments(int64_t idx, int64_t perm, int64_t seg, int64_t t,
                   int64_t n, int64_t stream) {
  check(repro_sgmv_segments(cptr(idx), ptr(perm), ptr(seg), t, n, ptr(stream)),
        "sgmv_segments");
}

void sgmv(int64_t x, int64_t a, int64_t b, int64_t idx, int64_t perm,
          int64_t seg, int64_t ranks, int64_t y, int64_t t, int64_t d,
          int64_t r, int64_t o, int64_t n, int64_t cap, double scale,
          int64_t x_dtype, int64_t w_dtype, int64_t stream) {
  check(repro_sgmv(cptr(x), cptr(a), cptr(b), cptr(idx), ptr(perm), ptr(seg),
             cptr(ranks), ptr(y), t, d, r, o, n, cap, static_cast<float>(scale),
             x_dtype, w_dtype, ptr(stream)),
        "sgmv");
}

void flash_decode(int64_t q, int64_t k, int64_t v, int64_t length,
                  int64_t m_part, int64_t l_part, int64_t acc_part,
                  int64_t out, int64_t lse, int64_t bsz, int64_t s,
                  int64_t h, int64_t kv, int64_t dh, int64_t n_splits,
                  int64_t chunk, int64_t dtype, int64_t stream) {
  check(repro_flash_decode(cptr(q), cptr(k), cptr(v), cptr(length), ptr(m_part),
                     ptr(l_part), ptr(acc_part), ptr(out), ptr(lse), bsz, s,
                     h, kv, dh, n_splits, chunk, dtype, ptr(stream)),
        "flash_decode");
}

void flash_decode_int8(int64_t q, int64_t k, int64_t v, int64_t k_scale,
                       int64_t v_scale, int64_t length, int64_t m_part,
                       int64_t l_part, int64_t acc_part, int64_t max_part,
                       int64_t out, int64_t lse, int64_t bsz, int64_t s,
                       int64_t h, int64_t kv, int64_t dh, int64_t n_splits,
                       int64_t chunk, int64_t dtype, int64_t stream) {
  check(repro_flash_decode_int8(cptr(q), cptr(k), cptr(v), cptr(k_scale),
                                cptr(v_scale), cptr(length), ptr(m_part),
                                ptr(l_part), ptr(acc_part), ptr(max_part),
                                ptr(out), ptr(lse), bsz, s, h, kv, dh,
                                n_splits, chunk, dtype, ptr(stream)),
        "flash_decode_int8");
}

void flash_decode_lora(int64_t q, int64_t k, int64_t v, int64_t length,
                       int64_t x, int64_t a, int64_t b, int64_t idx,
                       int64_t m_part, int64_t l_part, int64_t acc_part,
                       int64_t h_part, int64_t out, int64_t bsz, int64_t s,
                       int64_t h,
                       int64_t kv, int64_t dh, int64_t n_splits,
                       int64_t chunk, int64_t dx, int64_t r, int64_t n,
                       double scale, int64_t dtype, int64_t w_dtype,
                       int64_t stream) {
  check(repro_flash_decode_lora(
            cptr(q), cptr(k), cptr(v), cptr(length), cptr(x), cptr(a), cptr(b),
            cptr(idx), ptr(m_part), ptr(l_part), ptr(acc_part), ptr(h_part),
            ptr(out), bsz,
            s, h, kv, dh, n_splits, chunk, dx, r, n, static_cast<float>(scale),
            dtype, w_dtype, ptr(stream)),
        "flash_decode_lora");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bgmv", &bgmv, "BGMV LoRA (decode-sized batches)");
  m.def("sgmv_segments", &sgmv_segments,
        "stable sort of tokens by adapter (SGMV's segments)");
  m.def("sgmv", &sgmv, "SGMV LoRA (prefill-sized batches, dense or ragged)");
  m.def("flash_decode", &flash_decode, "split-KV flash-decode attention");
  m.def("flash_decode_int8", &flash_decode_int8,
        "split-KV flash-decode over an int8 cache with f16 scales");
  m.def("flash_decode_lora", &flash_decode_lora,
        "split-KV flash-decode with a fused multi-adapter LoRA delta");
}
