// Plain C interface of the port's CUDA kernels.
//
// Each launcher enqueues its kernel(s) on `stream` (a cudaStream_t passed as
// a pointer) and returns cudaPeekAtLastError() as an int, or an error code
// for arguments it does not take; binding.cpp raises on either.  Pointers
// are device pointers; every array is contiguous.  dtype codes:
// 0 = float32, 1 = bfloat16.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// y[t] = scale * x[t] @ a[idx[t]] @ b[idx[t]]; idx[t] outside [0, n) -> 0.
// x (t, d); a (n, d, r); b (n, r, o); idx (t,) int32; y (t, o) in x's dtype.
int repro_bgmv(const void* x, const void* a, const void* b, const void* idx,
               void* y, int t, int d, int r, int o, int n, float scale,
               int x_dtype, int w_dtype, void* stream);

// Stable sort of the tokens by adapter: perm (t,) int32 maps sorted
// position -> token; seg (n + 2,) int32 receives the segment starts in
// sorted order, segment n holding the tokens whose id is outside [0, n).
int repro_sgmv_segments(const void* idx, void* perm, void* seg, int t, int n,
                        void* stream);

// Segmented LoRA: repro_sgmv_segments into the scratch perm and seg, then
// y[t] = scale * x[t] @ a[idx[t]] @ b[idx[t]] over each adapter's segment;
// idx[t] outside [0, n) -> 0.  ranks (n,) int32 or NULL.  A token whose
// rank inside its segment is >= cap gets exactly 0.
int repro_sgmv(const void* x, const void* a, const void* b, const void* idx,
               void* perm, void* seg, const void* ranks, void* y, int t,
               int d, int r, int o, int n, int cap, float scale, int x_dtype,
               int w_dtype, void* stream);

// Split-KV single-query GQA attention.  q (bsz, h, dh), 1 <= dh <= 256;
// k, v (bsz, s, kv, dh), 16-byte aligned; length (bsz,) int32; `chunk`
// positions a split, a whole number of tiles
// (kernels/flash_decode.py::tile_positions).  Partials
// m, l (bsz, h, n_splits) and acc (bsz, h, n_splits, dh) are f32 scratch;
// out (bsz, h, dh) in q's dtype.  With lse (bsz, h) f32 (NULL for none)
// the combine also writes each (row, head)'s log-sum-exp of its scaled
// scores over its first length positions, m + log l (-inf at a length of
// 0), with which the slices of a sequence-sharded cache combine; out is
// then f32, whatever q's dtype: the output before its cast (rounded to
// q's dtype it is bitwise the output without lse).
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const void* length, void* m_part, void* l_part,
                       void* acc_part, void* out, void* lse, int bsz, int s,
                       int h, int kv, int dh, int n_splits, int chunk,
                       int dtype, void* stream);

// repro_flash_decode over an int8 cache: k, v (bsz, s, kv, dh) int8, 16-byte
// aligned, with f16 scales k_scale, v_scale (bsz, s, kv); the scores are
// scaled by k_scale and P, times v_scale, rounded to bf16 before it
// multiplies V.  q (bsz, h, dh) and out in `dtype` (f32 or bf16).  For q
// in f32, max_part (bsz, h, n_splits) f32 is the scratch of a pre-pass
// that finds the row's largest score, against which P is rounded (as the
// JAX package rounds it); NULL for bf16 q.  lse as repro_flash_decode's.
int repro_flash_decode_int8(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* length, void* m_part, void* l_part,
                            void* acc_part, void* max_part, void* out,
                            void* lse, int bsz, int s, int h, int kv, int dh,
                            int n_splits, int chunk, int dtype, void* stream);

// repro_flash_decode plus scale * x @ a[idx] @ b[idx] (reshaped (h, dh))
// added in f32 before the cast; idx[i] outside [0, n) adds nothing.
// x (bsz, dx) in q's dtype (`dtype`); a (n, dx, r), b (n, r, h * dh) in the
// bank's dtype (`w_dtype`); idx (bsz,) int32; 1 <= r <= 64; h_part
// (bsz, r) f32 scratch.
int repro_flash_decode_lora(const void* q, const void* k, const void* v,
                            const void* length, const void* x, const void* a,
                            const void* b, const void* idx, void* m_part,
                            void* l_part, void* acc_part, void* h_part,
                            void* out, int bsz,
                            int s, int h, int kv, int dh, int n_splits,
                            int chunk, int dx, int r, int n, float scale,
                            int dtype, int w_dtype, void* stream);

#ifdef __cplusplus
}
#endif
