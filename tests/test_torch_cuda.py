"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test skips (decided inside a
fixture, never at import).  On the GPU machine:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the kernels at the main path's shapes; these hold
them at edge shapes (rank 1 and odd ranks, expand widths off the tile,
every head dim the flash-decode kernels instantiate (8 among them) and
head dims without an instance (1, 7, 24, 72, 80, 96, 100, 192, 255; the
int8 mode also 8), which run padded, head dims past 256 (257, 320, 384,
512, 576, 1024), which run on the wide path, group sizes 1..24 (past 8 in
head groups),
lengths 0 and past S and at the split pass's tile edges, NaN past a row's
length, BGMV at ranks 1-64 with widths and views off the 16-byte vector,
SGMV at T around its 64-token tile, 32 skewed adapters, unaligned views,
its sort kernel bit for bit and sequence slices with their whole-prompt
arrival ranks bit for bit the whole prompt, the fused decode step at shrink clusters of 1 to 8 blocks
and adapter id -1, flash-decode's int8 mode at every head dim, at the
tile's edges, on one KV head's scales and with NaN scales past a row's
length, with q in f32 at f32's tolerance), and check
that the wrappers and the binding reject what the kernels do not take.
They also hold the serving executor's captured step (a CUDA graph) bitwise
equal to the eager step over 20 steps that cross the cache's end (and for
reduced gemma3 over 28 that cross its rolling buffers' wrap, reduced
olmoe's MoE layers over 20, reduced phi4-mini and gemma3 on an int8
KV cache, reduced recurrentgemma's rglru states over 28 and reduced
mamba2's ssd states over 20), count its launches under replay (none for
mamba2), and run an eager step under the sync debug mode (phi4-mini's,
olmoe's, phi4-mini's on an int8 cache, recurrentgemma's and mamba2's);
``quantize_kv`` on the card is its CPU result bit for bit, and the RG-LRU
and SSD mixers and reduced mamba2 in bf16 their CPU results.  The MoE
FFN is held on the card against its CPU result and its oracle, at the
decode shape, the largest dropless T and on the capacity path.  The
training step (reduced phi4-mini, olmoe, recurrentgemma and mamba2, f32,
two microbatches) on the card equals the same step on the CPU and launches
no kernel wrapper, and a captured decode step still replays bit for bit
the eager one after a train step has updated the weights in place.  The
products kept in f32 (``layers.matmul_f32``, ``bmm_f32``: cuBLAS's
``out_dtype`` overloads) equal the f32 product of the bf16 values within
1e-5, forward and backward; a checkpoint of card tensors (bf16, f32, int8,
f16, int32) round-trips bit for bit onto the card and the CPU; and reduced
phi4-mini's crash-and-resume run on the card ends bit for bit where its
uninterrupted run ends.  Flash-decode's log-sum-exp mode
(``flash_decode_lse``) is held against its plain versions in every mode
(q, K, V in f32 and bf16, the int8 mode), at head groups, padded and wide
head dims, length 0 (-inf) among the lengths, its output bit for bit the
call without it;
and reduced phi4-mini and gemma3 (bf16; phi4-mini also on an int8 cache)
decoding under the world-size-1 plan on the NCCL group hold to the step
without a plan; reduced phi4-mini, gemma3, olmoe and recurrentgemma
prefill under the world-size-1 prefill plan bit for bit as without a plan
(every request on one adapter, so SGMV's whole-prompt rule drops
tokens), and
decode from ``pad_cache``'s cache under the decode plan.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import bgmv, build, flash_decode, ops, ref, sgmv  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402
from repro_torch.serving.executor import TorchExecutor  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _normal(gen, *shape, dtype=torch.float32, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


def _bank(gen, n, d, r, o, dtype):
    return (_normal(gen, n, d, r, dtype=dtype, std=d ** -0.5),
            _normal(gen, n, r, o, dtype=dtype, std=r ** -0.5))


def _ids(gen, t, n):
    return torch.randint(-1, n, (t,), generator=gen, device="cuda",
                         dtype=torch.int32)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_rows(got, want, dtype):
    # attention outputs are weighted means of V and shrink with the row's
    # length, so besides _close each row is held to a share of its own
    # largest magnitude
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp(min=1e-30)
    assert (diff / scale).max().item() <= ROW_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,r,o,n", [
    (1, 64, 1, 32, 1), (8, 512, 64, 1000, 3), (16, 96, 7, 300, 4)])
def test_bgmv_kernel_edges(gen, t, d, r, o, n, dtype):
    x = _normal(gen, t, d, dtype=dtype)
    a, b = _bank(gen, n, d, r, o, dtype)
    ids = _ids(gen, t, n)
    _close(bgmv.bgmv(x, a, b, ids, 1.5), bgmv.bgmv_plain(x, a, b, ids, 1.5),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 7, 8, 16, 32, 64])
@pytest.mark.parametrize("t,d,o,n", [(8, 3072, 1024, 4), (5, 200, 1003, 3)])
def test_bgmv_kernel_ranks_and_ragged_widths(gen, t, d, r, o, n, dtype):
    # every rank of the vector path's lane mapping (r below, at and above a
    # 16-byte vector, and 7, which no vector width divides); o 1003 is no
    # multiple of 8, so B and y take the scalar path, and ids repeat and fall
    # outside [0, N) on both sides
    x = _normal(gen, t, d, dtype=dtype)
    a, b = _bank(gen, n, d, r, o, dtype)
    ids = torch.tensor([0, n, 1, 0, -3, n + 5, 1, 0][:t], dtype=torch.int32,
                       device="cuda")
    got = bgmv.bgmv(x, a, b, ids, 0.5)
    _close(got, bgmv.bgmv_plain(x, a, b, ids, 0.5), dtype)
    bad = (ids < 0) | (ids >= n)
    assert bool((got[bad] == 0).all())


@pytest.mark.parametrize("d,o", [
    (3072, 3072), (3072, 1024), (64, 32), (96, 300), (512, 1000), (1, 1),
    (200, 1003), (20, 8), (8192, 16), (4096, 16384), (100000, 7)])
def test_bgmv_plan_tiles_cover_d_and_o(gen, d, o):
    # the C launcher cuts d and o across a cluster of up to 8 blocks, in
    # tiles of multiples of 8 (the serving shapes: 8 x 384 of d, and 8 x 384
    # or 8 x 128 of o): every row of d must reach h and every column of o
    # be written once: a plan that left a gap would show as a wrong h or an
    # unwritten column of y (torch.empty's memory)
    t, r, n = 3, 8, 2
    x = _normal(gen, t, d, dtype=torch.bfloat16)
    a, b = _bank(gen, n, d, r, o, torch.bfloat16)
    ids = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    got = bgmv.bgmv(x, a, b, ids, 0.5)
    assert bool(torch.isfinite(got).all())
    _close(got, bgmv.bgmv_plain(x, a, b, ids, 0.5), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [7, 8])
def test_bgmv_kernel_unaligned_views(gen, r, dtype):
    # x, A and B as contiguous views one element past a 16-byte boundary:
    # the kernel reads them on its scalar path
    t, d, o, n = 6, 3072, 1024, 3

    def shifted(*shape, std):
        flat = _normal(gen, math.prod(shape) + 1, dtype=dtype, std=std)
        view = flat[1:].view(*shape)
        assert view.data_ptr() % 16
        return view
    x = shifted(t, d, std=1.0)
    a = shifted(n, d, r, std=d ** -0.5)
    b = shifted(n, r, o, std=r ** -0.5)
    ids = torch.tensor([2, 0, 2, -1, 1, 0], dtype=torch.int32, device="cuda")
    _close(bgmv.bgmv(x, a, b, ids), bgmv.bgmv_plain(x, a, b, ids), dtype)
    # aligned copies of the same values take the vector path: same function
    _close(bgmv.bgmv(x.clone(), a.clone(), b.clone(), ids),
           bgmv.bgmv_plain(x, a, b, ids), dtype)


def test_bgmv_kernel_mixed_dtypes(gen):
    # bf16 activations on an f32 bank; the output follows x
    x = _normal(gen, 8, 128, dtype=torch.bfloat16)
    a, b = _bank(gen, 2, 128, 8, 64, torch.float32)
    ids = _ids(gen, 8, 2)
    got = bgmv.bgmv(x, a, b, ids)
    assert got.dtype == torch.bfloat16
    _close(got, bgmv.bgmv_plain(x, a, b, ids), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,r,o,n,same", [
    (130, 32, 8, 48, 3, False), (700, 200, 5, 260, 6, False),
    (512, 64, 16, 100, 8, True),
    # T below, at and past one 64-token tile; ranks 1, 7, 16 and 64; d off
    # the 128-wide chunk, and off the 16-byte vector (36 in bf16), o off
    # it; rank 64 at d 3072, where the cluster shrinks to fit its partials
    (63, 64, 1, 40, 2, False), (64, 96, 7, 64, 3, False),
    (65, 200, 16, 72, 2, False), (1000, 256, 64, 264, 5, False),
    (97, 36, 9, 30, 2, False), (64, 3072, 8, 3072, 4, True),
    (300, 3072, 64, 3072, 3, False),
    # the measurement path's prefill shapes: T 512, 2048 and 4096 at its 32
    # adapters, rank 16, d = o = 3072
    (512, 3072, 16, 3072, 32, False), (2048, 3072, 16, 3072, 32, False),
    (4096, 3072, 16, 3072, 32, False)])
def test_sgmv_kernel_edges(gen, t, d, r, o, n, same, dtype):
    x = _normal(gen, t, d, dtype=dtype)
    a, b = _bank(gen, n, d, r, o, dtype)
    ids = torch.zeros(t, dtype=torch.int32, device="cuda") if same \
        else _ids(gen, t, n)
    got = sgmv.sgmv(x, a, b, ids)
    _close(got, ref.sgmv_ref(x, a, b, ids), dtype)
    ranks = torch.randint(1, r + 1, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    am, bm = ref.mask_ragged(a, b, ranks)
    ragged = sgmv.sgmv(x, a, b, ids, ranks=ranks)
    assert torch.equal(ragged, sgmv.sgmv(x, am, bm, ids))
    _close(ragged, ref.sgmv_ref(x, a, b, ids, ranks=ranks), dtype)


def _check_ragged_equals_dense(x, a, b, ids, ranks, dtype):
    am, bm = ref.mask_ragged(a, b, ranks)
    ragged = sgmv.sgmv(x, a, b, ids, ranks=ranks)
    assert torch.equal(ragged, sgmv.sgmv(x, am, bm, ids))
    _close(ragged, ref.sgmv_ref(x, a, b, ids, ranks=ranks), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,r,o", [(700, 512, 16, 320), (700, 3072, 8, 96)])
def test_sgmv_kernel_skewed_segments(gen, t, d, r, o, dtype):
    # the measurement path's 32 adapters with skew: adapter 5 past its
    # capacity, adapters 10-31 empty, ids -1 and >= N (no adapter: 0)
    n = 32
    cap = ref.sgmv_capacity(t, n)
    ids = torch.cat([torch.full((cap + 37,), 5),
                     torch.randint(0, 10, (t - cap - 37 - 30,), generator=gen,
                                   device="cuda").cpu(),
                     torch.tensor([-1, -7, n, n + 3, 1000] * 6)])
    ids = ids[torch.randperm(t, generator=gen, device="cuda").cpu()]
    ids = ids.to(device="cuda", dtype=torch.int32)
    x = _normal(gen, t, d, dtype=dtype)
    a, b = _bank(gen, n, d, r, o, dtype)
    got = sgmv.sgmv(x, a, b, ids, 0.5)
    _close(got, ref.sgmv_ref(x, a, b, ids, 0.5), dtype)
    fives = torch.nonzero(ids == 5).flatten()
    assert bool((got[fives[cap:]] == 0).all()) and bool(got[fives[:cap]].any())
    assert bool((got[(ids < 0) | (ids >= n)] == 0).all())
    ranks = torch.randint(1, r + 1, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    _check_ragged_equals_dense(x, a, b, ids, ranks, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [7, 8])
def test_sgmv_kernel_unaligned_views(gen, r, dtype):
    # x, A and B as contiguous views one element past a 16-byte boundary:
    # the kernel fills the same shared-memory layout element by element
    t, d, o, n = 300, 3072, 1024, 3

    def shifted(*shape, std):
        flat = _normal(gen, math.prod(shape) + 1, dtype=dtype, std=std)
        view = flat[1:].view(*shape)
        assert view.data_ptr() % 16
        return view
    x = shifted(t, d, std=1.0)
    a = shifted(n, d, r, std=d ** -0.5)
    b = shifted(n, r, o, std=r ** -0.5)
    ids = _ids(gen, t, n)
    got = sgmv.sgmv(x, a, b, ids)
    _close(got, ref.sgmv_ref(x, a, b, ids), dtype)
    # aligned copies of the same values take the vector path: same bits
    assert torch.equal(sgmv.sgmv(x.clone(), a.clone(), b.clone(), ids), got)
    ranks = torch.tensor([r, 1, 3], dtype=torch.int32, device="cuda")
    _check_ragged_equals_dense(x, a, b, ids, ranks, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,seq,n,slices,spread", [
    (8, 512, 4, 4, False), (8, 512, 4, 4, True), (3, 130, 2, 2, False),
    (5, 96, 3, 3, True)])
def test_sgmv_arrival_mode_over_sequence_slices(gen, bsz, seq, n, slices,
                                                spread, dtype):
    # a prompt of per-request ids (all on adapter 0, so tokens drop, or
    # spread) cut into sequence slices, each with its tokens' whole-prompt
    # arrival ranks and capacity: each slice against its rows of the plain
    # version of the whole prompt, and the slices together bit for bit the
    # whole prompt (a token's reduction order does not depend on the tile
    # it lands in); the whole prompt's own ranks change nothing
    d, r, o = 256, 8, 320
    t, s_loc = bsz * seq, seq // slices
    x = _normal(gen, t, d, dtype=dtype)
    a, b = _bank(gen, n, d, r, o, dtype)
    ids = (torch.arange(bsz, device="cuda") % n if spread
           else torch.zeros(bsz, device="cuda")).to(torch.int32)
    whole = sgmv.sgmv(x, a, b, ids.repeat_interleave(seq))
    own = ref._bucket_positions(ids.repeat_interleave(seq), n)
    assert torch.equal(sgmv.sgmv(x, a, b, ids.repeat_interleave(seq),
                                 arrival=own.to(torch.int32)), whole)
    cap = ref.sgmv_capacity(t, n)
    x3 = x.reshape(bsz, seq, d)
    plain = ref.sgmv_ref(x, a, b, ids.repeat_interleave(seq)).reshape(
        bsz, seq, o)
    parts = []
    for sl in range(slices):
        arrival = sgmv.arrival_ranks(ids, 0, bsz, seq, sl * s_loc, s_loc)
        xp = x3[:, sl * s_loc:(sl + 1) * s_loc].reshape(-1, d).contiguous()
        tp = ids.repeat_interleave(s_loc)
        got = sgmv.sgmv(xp, a, b, tp, arrival=arrival, cap=cap)
        _close(got, plain[:, sl * s_loc:(sl + 1) * s_loc].reshape(-1, o),
               dtype)
        parts.append(got.reshape(bsz, s_loc, o))
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(parts, 1).reshape(t, o), whole)


@pytest.mark.parametrize("t,n", [(1, 1), (31, 4), (1000, 4), (4096, 32),
                                 (5000, 300), (70, 2000)])
def test_sgmv_segments_kernel_matches_plain(gen, t, n):
    # the sort kernel against its plain version (torch.sort + searchsorted),
    # bit for bit; ids outside [0, N) on both sides
    ids = torch.randint(-3, n + 3, (t,), generator=gen, device="cuda",
                        dtype=torch.int32)
    perm, seg = sgmv.segments(ids, n)
    want_perm, want_seg = sgmv.segments_plain(ids, n)
    torch.cuda.synchronize()
    assert torch.equal(seg, want_seg)
    assert torch.equal(perm, want_perm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_decode.HEAD_DIMS)
@pytest.mark.parametrize("bsz,h,kv,s", [(3, 8, 8, 7), (2, 24, 8, 100),
                                        (2, 16, 2, 1000),
                                        # head groups: G 16 (two groups of
                                        # 8; one at D 256 in bf16), 12
                                        # (6 + 6), 9 (5 + 4)
                                        (3, 16, 1, 600), (2, 24, 2, 300),
                                        (2, 9, 1, 50)])
def test_flash_decode_kernel_edges(gen, bsz, h, kv, s, d, dtype):
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k = _normal(gen, bsz, s, kv, d, dtype=dtype)
    v = _normal(gen, bsz, s, kv, d, dtype=dtype)
    lengths = torch.randint(0, s + 40, (bsz,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0] = 0
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    _close(got, want, dtype)
    _close_rows(got, want, dtype)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_decode.HEAD_DIMS)
def test_flash_decode_kernel_tile_edges(gen, d, dtype):
    # lengths at a tile's edges (P - 1, P, P + 1) and inside the last
    # chunk, which is not a whole tile (S = 5P + 3), for each tile geometry
    p = flash_decode.tile_positions(d, torch.tensor([], dtype=dtype)
                                    .element_size())
    s = 5 * p + 3
    lengths = torch.tensor([p - 1, p, p + 1, 2 * p + 1, s - 1, s, s + 9, 1],
                           dtype=torch.int32, device="cuda")
    bsz, h, kv = lengths.numel(), 6, 2
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k = _normal(gen, bsz, s, kv, d, dtype=dtype)
    v = _normal(gen, bsz, s, kv, d, dtype=dtype)
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    _close(got, want, dtype)
    _close_rows(got, want, dtype)


def test_flash_decode_positions_past_length_are_never_read(gen):
    # NaN in the cache past each row's length (as in an unwritten cache)
    # must not reach the output: the split pass zero-fills those positions
    bsz, s, h, kv, d = 3, 300, 8, 2, 128
    q = _normal(gen, bsz, h, d, dtype=torch.bfloat16)
    k = _normal(gen, bsz, s, kv, d, dtype=torch.bfloat16)
    v = _normal(gen, bsz, s, kv, d, dtype=torch.bfloat16)
    lengths = torch.tensor([1, 65, 250], dtype=torch.int32, device="cuda")
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    for i, n in enumerate(lengths.tolist()):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    got = flash_decode.flash_decode(q, k, v, lengths)
    assert bool(torch.isfinite(got).all())
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype,wdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("d", flash_decode.HEAD_DIMS)
@pytest.mark.parametrize("bsz,h,kv,s,dx,r,n", [
    (3, 8, 8, 7, 40, 1, 1), (4, 24, 8, 100, 96, 7, 3),
    (3, 16, 2, 1000, 64, 16, 2),
    # h 1, 3, 7, 32; dx 3072 and 40, ranks 64, 5, 33 and 32, batch 1 and
    # 32; the shrink's clusters of 1, 2, 6 and 8 blocks (dx 40/96, 1000,
    # 3072, 4096)
    (1, 1, 1, 50, 3072, 64, 4), (2, 3, 1, 60, 40, 5, 2),
    (32, 7, 7, 33, 96, 33, 5), (2, 32, 8, 70, 3072, 32, 3),
    (3, 4, 2, 90, 1000, 9, 2), (2, 8, 8, 70, 4096, 16, 3),
    # the serving shape; 11 heads over many splits
    (8, 24, 8, 512, 3072, 8, 4), (1, 11, 11, 4096, 96, 8, 2),
    # head groups: recurrentgemma-9b's 16 heads on 1 KV head (d 4096), a
    # group of 10 (5 + 5)
    (8, 16, 1, 512, 4096, 8, 4), (3, 20, 2, 300, 64, 4, 2)])
def test_flash_decode_lora_kernel_edges(gen, bsz, h, kv, s, dx, r, n, d,
                                        dtype, wdtype):
    # group sizes 1, 3, 4 and 8; some rows run past S; with more than one
    # row, row 0 has length 0 and row 1 is a base request (id -1)
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k = _normal(gen, bsz, s, kv, d, dtype=dtype)
    v = _normal(gen, bsz, s, kv, d, dtype=dtype)
    x = _normal(gen, bsz, dx, dtype=dtype)
    a, b = _bank(gen, n, dx, r, h * d, wdtype)
    ids = torch.randint(0, n, (bsz,), generator=gen, device="cuda",
                        dtype=torch.int32)
    lengths = torch.randint(1, s + 40, (bsz,), generator=gen, device="cuda",
                            dtype=torch.int32)
    if bsz > 1:
        ids[1] = -1
        lengths[0] = 0
    got = flash_decode.flash_decode_lora(q, k, v, lengths, x, a, b, ids, 1.5)
    want = flash_decode.flash_decode_lora_plain(q, k, v, lengths, x, a, b,
                                                ids, 1.5)
    _close(got, want, dtype)
    _close_rows(got, want, dtype)
    attn = flash_decode.flash_decode(q, k, v, lengths)
    if bsz > 1:
        assert torch.equal(got[1], attn[1])      # no add for id -1
    base = torch.full_like(ids, -1)
    assert torch.equal(flash_decode.flash_decode_lora(
        q, k, v, lengths, x, a, b, base, 1.5), attn)


def _int8_cache(gen, bsz, s, kv, d):
    return quantize_kv(_normal(gen, bsz, s, kv, d, dtype=torch.bfloat16))


def _close_int8(q, k, v, lengths, ks, vs, per_row=True):
    """The int8 mode against flash_decode_int8_plain at the tolerance of
    q's dtype; returns the kernel's output.

    q in bf16 (the serving path) is held at bf16's tolerance: the kernel
    rounds P times v_scale to bf16 against each split's running max, the
    plain version (the JAX arithmetic) against the row's global max.  q in
    f32 is held at f32's 2e-5 against the plain version with
    ``exact_dot``: the kernel's pre-pass gives it the row's max and both
    take q . k's exact f32 value, so both round each P times v_scale to
    the same bf16 value.  Against the plain version as the JAX package
    sums q . k (f32, in the einsum's order) a term within that order's
    rounding of a bf16 rounding boundary rounds the other way; there the
    kernel is held at 2e-5 plus the plain version's own departure between
    the two sums, which is those terms' flips."""
    got = flash_decode.flash_decode(q, k, v, lengths, ks, vs)
    want = flash_decode.flash_decode_int8_plain(q, k, v, lengths, ks, vs)
    if q.dtype == torch.bfloat16:
        _close(got, want, q.dtype)
        if per_row:
            _close_rows(got, want, q.dtype)
        return got
    exact = flash_decode.flash_decode_int8_plain(q, k, v, lengths, ks, vs,
                                                 exact_dot=True)
    _close(got, exact, q.dtype)
    if per_row:
        _close_rows(got, exact, q.dtype)
    flips = (exact - want).abs()
    tol = TOL[torch.float32]
    assert bool(((got - want).abs() <= tol + tol * want.abs() + flips).all())
    return got


# head dims without an instance, each run on the next larger one, padded:
# the public 80, 96 and 192, dims whose rows are not whole 16-byte copies
# (1, 7, 100, 255: pieces of 2, 8 and 2 bytes in bf16), 24 and 72
ANY_HEAD_DIMS = (1, 7, 24, 72, 80, 96, 100, 192, 255)
# head dims past 256, on the wide path: rows of 514 bytes in bf16 (257),
# whole and partial 128-element thread strides, and its largest, 1024
WIDE_HEAD_DIMS = (257, 320, 384, 512, 576, 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS + WIDE_HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 4, 16])
def test_flash_decode_kernel_any_head_dim(gen, g, d, dtype):
    # plain flash-decode and the fused kernel at G query heads a KV head
    # (16: two head groups; one at 192 and 255 in bf16), ragged lengths
    # with 0 among them, ids with -1; the fused kernel bitwise flash-decode
    # on an all-base batch
    bsz, kv, s, dx, r, n = 3, 2, 300, 96, 8, 3
    h = g * kv
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k = _normal(gen, bsz, s, kv, d, dtype=dtype)
    v = _normal(gen, bsz, s, kv, d, dtype=dtype)
    lengths = torch.tensor([0, 77, s], dtype=torch.int32, device="cuda")
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    _close(got, want, dtype)
    _close_rows(got, want, dtype)
    assert bool((got[0] == 0).all())
    x = _normal(gen, bsz, dx, dtype=dtype)
    a, b = _bank(gen, n, dx, r, h * d, dtype)
    ids = torch.tensor([0, -1, 2], dtype=torch.int32, device="cuda")
    fused = flash_decode.flash_decode_lora(q, k, v, lengths, x, a, b, ids,
                                           1.5)
    want = flash_decode.flash_decode_lora_plain(q, k, v, lengths, x, a, b,
                                                ids, 1.5)
    _close(fused, want, dtype)
    _close_rows(fused, want, dtype)
    assert torch.equal(fused[1], got[1])
    assert torch.equal(flash_decode.flash_decode_lora(
        q, k, v, lengths, x, a, b, torch.full_like(ids, -1), 1.5), got)


@pytest.mark.parametrize("d", [256, 200, 129])
@pytest.mark.parametrize("g", [1, 4, 16, 24])
def test_flash_decode_d256_tensor_core_pass(gen, g, d):
    # the bf16 tensor-core pass at D 256 and the dims padded onto it: G up
    # to 16 in one block a KV head (24: two groups of 12); lengths 0, 1, a
    # tile's edges, S and past it; plain, fused (ids with -1, bitwise
    # flash-decode on an all-base batch) and the log-sum-exp mode (its
    # output rounded bitwise the plain call's); NaN past each row's length
    # never read (bitwise the clean cache's output)
    bsz, kv, s, dx, r, n = 8, 2, 300, 96, 8, 3
    h = g * kv
    assert flash_decode.mma256_pass(d, torch.bfloat16, 2)
    assert flash_decode.head_groups(g, flash_decode.MMA256_GROUP) == \
        (1 if g <= 16 else 2)
    p = flash_decode.tile_positions(d, 2)
    lengths = torch.tensor([0, 1, p - 1, p + 1, s // 2 + 3, s - 1, s,
                            s + 40], dtype=torch.int32, device="cuda")
    dt = torch.bfloat16
    q = _normal(gen, bsz, h, d, dtype=dt)
    k = _normal(gen, bsz, s, kv, d, dtype=dt)
    v = _normal(gen, bsz, s, kv, d, dtype=dt)
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    _close(got, want, dt)
    _close_rows(got, want, dt)
    assert bool((got[0] == 0).all())
    x = _normal(gen, bsz, dx, dtype=dt)
    a, b = _bank(gen, n, dx, r, h * d, dt)
    ids = torch.tensor([0, -1, 2, 1, -1, 0, 2, 1], dtype=torch.int32,
                       device="cuda")
    fused = flash_decode.flash_decode_lora(q, k, v, lengths, x, a, b, ids,
                                           1.5)
    want_f = flash_decode.flash_decode_lora_plain(q, k, v, lengths, x, a, b,
                                                  ids, 1.5)
    _close(fused, want_f, dt)
    _close_rows(fused, want_f, dt)
    assert torch.equal(flash_decode.flash_decode_lora(
        q, k, v, lengths, x, a, b, torch.full_like(ids, -1), 1.5), got)
    out, lse = flash_decode.flash_decode_lse(q, k, v, lengths)
    assert torch.equal(out.to(dt), got)
    want_out, want_lse = flash_decode.flash_decode_plain(q, k, v, lengths,
                                                         return_lse=True)
    _close(out, want_out, dt)
    empty = torch.isneginf(want_lse)
    assert bool(empty[0].all()) and torch.equal(torch.isneginf(lse), empty)
    _close(lse[~empty], want_lse[~empty], dt)
    for i, m in enumerate(lengths.tolist()):
        k[i, min(m, s):] = float("nan")
        v[i, min(m, s):] = float("nan")
    assert torch.equal(flash_decode.flash_decode(q, k, v, lengths), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", (8,) + ANY_HEAD_DIMS + WIDE_HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 4, 16])
def test_flash_decode_int8_any_head_dim(gen, g, d, dtype):
    # the int8 mode off its instances (8 and below on the 16 instance),
    # lengths 0, at a tile's edge and the whole cache
    bsz, kv, s = 3, 2, 300
    q = _normal(gen, bsz, g * kv, d, dtype=dtype)
    k, ks = _int8_cache(gen, bsz, s, kv, d)
    v, vs = _int8_cache(gen, bsz, s, kv, d)
    lengths = torch.tensor([0, flash_decode.tile_positions(d, 1) + 1, s],
                           dtype=torch.int32, device="cuda")
    # a row of fewer than 8 values (D 1 and 7) can have as its largest a
    # sum that cancels, against which bf16 q's rounding (each split's
    # max) is not small: those rows are held elementwise only
    got = _close_int8(q, k, v, lengths, ks, vs,
                      per_row=d >= 8 or dtype == torch.float32)
    assert not got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [257, 512, 1024])
def test_flash_decode_wide_tile_edges(gen, d, dtype):
    # the wide path's 32-position tiles: lengths at a tile's edges and
    # inside the last chunk, in every mode; NaN past each row's length
    # (never read: the output is bit for bit the clean cache's)
    p = flash_decode.WIDE_TILE
    s = 5 * p + 3
    lengths = torch.tensor([p - 1, p, p + 1, 2 * p + 1, s - 1, s, s + 9, 1],
                           dtype=torch.int32, device="cuda")
    bsz, h, kv = lengths.numel(), 6, 2
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k = _normal(gen, bsz, s, kv, d, dtype=dtype)
    v = _normal(gen, bsz, s, kv, d, dtype=dtype)
    got = flash_decode.flash_decode(q, k, v, lengths)
    want = flash_decode.flash_decode_plain(q, k, v, lengths)
    _close(got, want, dtype)
    _close_rows(got, want, dtype)
    k8, ks = _int8_cache(gen, bsz, s, kv, d)
    v8, vs = _int8_cache(gen, bsz, s, kv, d)
    got8 = _close_int8(q, k8, v8, lengths, ks, vs)
    for i, n in enumerate(lengths.tolist()):
        k[i, n:], v[i, n:] = float("nan"), float("nan")
        ks[i, n:], vs[i, n:] = float("nan"), float("nan")
    assert torch.equal(flash_decode.flash_decode(q, k, v, lengths), got)
    assert torch.equal(flash_decode.flash_decode(q, k8, v8, lengths, ks, vs),
                       got8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_decode.INT8_HEAD_DIMS)
def test_flash_decode_int8_tile_edges(gen, d, dtype):
    # lengths at an int8 tile's edges (P - 1, P, P + 1) and inside the last
    # chunk (S = 5P + 3), every head dim, D 16's rows one 16-byte chunk
    p = flash_decode.tile_positions(d, 1)
    s = 5 * p + 3
    lengths = torch.tensor([p - 1, p, p + 1, 2 * p + 1, s - 1, s, s + 9, 1],
                           dtype=torch.int32, device="cuda")
    bsz, h, kv = lengths.numel(), 6, 2
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k, ks = _int8_cache(gen, bsz, s, kv, d)
    v, vs = _int8_cache(gen, bsz, s, kv, d)
    got = _close_int8(q, k, v, lengths, ks, vs)
    assert got.dtype == dtype
    assert not flash_decode.flash_decode(q, k, v, 0, ks, vs).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(4, 256), (8, 128), (1, 64), (16, 256),
                                 (16, 128), (12, 32)])
def test_flash_decode_int8_one_kv_head(gen, h, d, dtype):
    # one KV head (gemma3's global layers: 4 heads of 256): each
    # position's scales are 2 bytes apart; 12 and 16 heads on it run in
    # two head groups
    bsz, s = 3, 700
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k, ks = _int8_cache(gen, bsz, s, 1, d)
    v, vs = _int8_cache(gen, bsz, s, 1, d)
    lengths = torch.tensor([s, 1, 333], dtype=torch.int32, device="cuda")
    _close_int8(q, k, v, lengths, ks, vs)


def test_flash_decode_int8_positions_past_length_are_never_read(gen):
    # int8 values and NaN scales past each row's length: the split pass
    # neither copies those positions nor loads their scales, so the output
    # is bit for bit the clean cache's
    bsz, s, h, kv, d = 3, 300, 8, 2, 128
    q = _normal(gen, bsz, h, d, dtype=torch.bfloat16)
    k, ks = _int8_cache(gen, bsz, s, kv, d)
    v, vs = _int8_cache(gen, bsz, s, kv, d)
    lengths = torch.tensor([1, 129, 250], dtype=torch.int32, device="cuda")
    want = flash_decode.flash_decode(q, k, v, lengths, ks, vs)
    for i, n in enumerate(lengths.tolist()):
        k[i, n:], v[i, n:] = 127, -128
        ks[i, n:] = float("nan")
        vs[i, n:] = float("nan")
    got = flash_decode.flash_decode(q, k, v, lengths, ks, vs)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_flash_decode_int8_wrapper_rejects_what_the_kernel_does_not_take(gen):
    bsz, s, h, kv, d = 2, 64, 4, 2, 32
    q = _normal(gen, bsz, h, d, dtype=torch.bfloat16)
    k, ks = _int8_cache(gen, bsz, s, kv, d)
    v, vs = _int8_cache(gen, bsz, s, kv, d)
    fd = flash_decode.flash_decode
    with pytest.raises(TypeError, match="int8 mode"):
        fd(q, k, v.bfloat16(), s, ks, vs)             # mixed K/V dtypes
    with pytest.raises(TypeError, match="int8 mode"):
        fd(q, k, v, s, ks.float(), vs)                # f32 scales
    with pytest.raises(TypeError, match="int8 mode"):
        fd(q.half(), k, v, s, ks, vs)                 # f16 q
    with pytest.raises(TypeError, match="share one dtype"):
        fd(q, k.bfloat16(), v, s)                     # int8 V, no scales
    with pytest.raises(ValueError, match="want \\(B, S, KV\\)"):
        fd(q, k, v, s, ks[:, :-1].contiguous(), vs)   # scales of S - 1
    with pytest.raises(ValueError, match="want \\(B, S, KV\\)"):
        fd(q, k, v, s, ks[..., None], vs)
    with pytest.raises(ValueError, match="both scales"):
        fd(q, k, v, s, ks, None)
    with pytest.raises(ValueError, match="contiguous"):
        fd(q, k, v, s, ks.transpose(0, 1).contiguous().transpose(0, 1), vs)
    shifted = torch.zeros(k.numel() + 1, dtype=torch.int8,
                          device="cuda")[1:].view(k.shape)
    assert shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd(q, shifted, v, s, ks, vs)
    # head dims 48 and 8, which have no instance, run padded (on 64 and on
    # 16: an int8 row of 8 bytes is half a 16-byte copy), 257 on the wide
    # path; past the largest, 1024, the wrapper raises
    for d in (48, 8, 257):
        qd = _normal(gen, bsz, h, d, dtype=torch.bfloat16)
        (kd, ksd), (vd, vsd) = (_int8_cache(gen, bsz, s, kv, d)
                                for _ in range(2))
        _close_int8(qd, kd, vd, s, ksd, vsd)
    d = flash_decode.MAX_HEAD_DIM + 1
    qd = _normal(gen, bsz, h, d, dtype=torch.bfloat16)
    kd, ksd = _int8_cache(gen, bsz, s, kv, d)
    with pytest.raises(ValueError, match=f"D={d} unsupported .*1..1024"):
        fd(qd, kd, kd, s, ksd, ksd)


def test_binding_raises_on_a_rejected_int8_launch(gen):
    # head dim 1025 is past the wide path's largest: the launcher refuses
    # it and the binding raises rather than return an unwritten output; so
    # it does for q in f32 without the pre-pass's scratch
    x = _normal(gen, 4, 8)
    for dh, dtype in ((flash_decode.MAX_HEAD_DIM + 1, 1), (64, 0)):
        with pytest.raises(RuntimeError, match="flash_decode_int8: launcher "
                                               "rejected"):
            build.kernels().flash_decode_int8(
                0, 0, 0, 16, 16, 0, 0, 0, 0, 0, 0, 0, 2, 64, 4, 2, dh, 1,
                64, dtype, build.stream_handle(x.device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_on_the_card_matches_cpu(gen, dtype):
    x = _normal(gen, 4, 300, 8, 128, dtype=dtype, std=3.0)
    x[0, 0, 0] = 0
    q, s = quantize_kv(x)
    want_q, want_s = quantize_kv(x.cpu())
    assert torch.equal(q.cpu(), want_q)
    assert torch.equal(s.cpu().view(torch.int16), want_s.view(torch.int16))


def test_wrappers_reject_what_kernels_do_not_take(gen):
    x = _normal(gen, 4, 32)
    a, b = _bank(gen, 2, 32, 65, 16, torch.float32)
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="rank 65"):
        bgmv.bgmv(x, a, b, ids)
    a, b = _bank(gen, 2, 32, 8, 16, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        sgmv.sgmv(x, a, b, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        bgmv.bgmv(x, a.transpose(1, 2).contiguous().transpose(1, 2), b, ids)
    # head dim 48 runs padded on the 64 instance, 257 on the wide path;
    # past 1024 the wrapper raises
    for d in (48, 257):
        q = _normal(gen, 2, 4, d)
        kv = _normal(gen, 2, 16, 2, d)
        _close(flash_decode.flash_decode(q, kv, kv, 16),
               flash_decode.flash_decode_plain(q, kv, kv, 16), torch.float32)
    d = flash_decode.MAX_HEAD_DIM + 1
    q = _normal(gen, 2, 4, d)
    kv = _normal(gen, 2, 16, 2, d)
    with pytest.raises(ValueError, match=f"D={d} unsupported .*1..1024"):
        flash_decode.flash_decode(q, kv, kv, 16)
    q = _normal(gen, 2, 4, 16)
    shifted = _normal(gen, 2 * 16 * 2 * 16 + 1)[1:].view(2, 16, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_decode.flash_decode(q, shifted, shifted, 16)
    q, kv = _normal(gen, 2, 4, 16), _normal(gen, 2, 16, 2, 16)
    x = _normal(gen, 2, 32)
    ids = torch.zeros(2, dtype=torch.int32, device="cuda")
    a, b = _bank(gen, 2, 32, 4, 4 * 16 + 8, torch.float32)
    with pytest.raises(ValueError, match="expand dim"):
        flash_decode.flash_decode_lora(q, kv, kv, 16, x, a, b, ids)
    a, b = _bank(gen, 2, 32, 65, 4 * 16, torch.float32)
    with pytest.raises(ValueError, match="rank 65"):
        flash_decode.flash_decode_lora(q, kv, kv, 16, x, a, b, ids)
    a, b = _bank(gen, 2, 32, 4, 4 * 16, torch.float32)
    with pytest.raises(TypeError, match="int32"):
        flash_decode.flash_decode_lora(q, kv, kv, 16, x, a, b, ids.long())
    with pytest.raises(TypeError, match="q's dtype"):
        flash_decode.flash_decode_lora(q, kv, kv, 16, x.bfloat16(), a, b,
                                       ids)


def test_binding_raises_on_rejected_arguments(gen):
    # a launcher that refuses its arguments (rank 100 > 64) launches nothing,
    # and the binding raises rather than return an unwritten output
    x = _normal(gen, 4, 8)
    with pytest.raises(RuntimeError, match="bgmv: launcher rejected"):
        build.kernels().bgmv(0, 0, 0, 0, 0, 4, 8, 100, 8, 2, 1.0, 0, 0,
                             build.stream_handle(x.device))


# --------------------------------------------------------------------------- #
# the serving step captured as a CUDA graph (``TorchExecutor``)
# --------------------------------------------------------------------------- #

def _served(dtype, cache_len=16, arch="phi4-mini-3.8b", kv_quant=False):
    """A reduced model on the card and its executor (8 rows); with
    ``kv_quant`` its global layers' caches in int8."""
    cfg = dataclasses.replace(get_reduced(arch),
                              dtype=str(dtype).split(".")[1])
    model = Model(cfg, device="cuda", seed=3, kv_quant=kv_quant)
    lora = model.init_lora(4, 4, seed=3)
    return model, lora, TorchExecutor(model, lora, max_batch=8,
                                      cache_len=cache_len, device="cuda")


def _clone_cache(cache):
    return {"pos": cache["pos"].clone(),
            "layers": [{k: v.clone() for k, v in c.items()}
                       for c in cache["layers"]]}


def _replays_equal_eager(model, lora, ex, steps):
    """``steps`` replays against eager steps on a clone of the cache, ids
    mixed with base rows (-1): logits, and at the end every cache tensor,
    bit for bit."""
    assert ex.graph is not None and int(ex.cache["pos"]) == 0
    eager = _clone_cache(ex.cache)
    rng = np.random.default_rng(0)
    for step in range(steps):
        idx = rng.integers(-1, 4, 8).astype(np.int32)
        got = ex.decode(idx)
        want, _ = model.decode_step(lora, eager, ex.tokens,
                                    torch.from_numpy(idx).cuda())
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"step {step}"
    assert int(ex.cache["pos"]) == int(eager["pos"]) == steps
    for c, e in zip(ex.cache["layers"], eager["layers"]):
        assert c.keys() == e.keys()
        assert all(torch.equal(c[k], e[k]) for k in c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_replay_equals_eager_step(gen, dtype):
    # 20 steps at cache_len 16: the last 4 past the end (write skipped, all
    # of S attended)
    _replays_equal_eager(*_served(dtype), steps=20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_replay_equals_eager_step_rolling(gen, dtype):
    # reduced gemma3 (window 16) at cache_len 20: 28 steps, the local
    # layers' 16-row buffers written at pos % 16 (wrapping at step 16), the
    # global caches skipping their write from step 20
    _replays_equal_eager(*_served(dtype, 20, "gemma3-1b"), steps=28)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_replay_equals_eager_step_moe(gen, dtype):
    # reduced olmoe (8 experts, top-2): the MoE FFN's routing, dispatch
    # into the (E, C, d) buffer and combine replay bit for bit
    _replays_equal_eager(*_served(dtype, 16, "olmoe-1b-7b"), steps=20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_replay_equals_eager_step_rglru(gen, dtype):
    # reduced recurrentgemma (window 16) at cache_len 20: 28 steps, the
    # rglru layers' conv and lru states written in place every step, the
    # local layer's 16-row buffer wrapping at step 16; its 2 heads on 1 KV
    # head
    _replays_equal_eager(*_served(dtype, 20, "recurrentgemma-9b"), steps=28)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_rglru_on_the_card(gen, decode, dtype):
    # the RG-LRU mixer (plain PyTorch) on the card against its CPU result
    # on the same inputs: prefill (the log-depth scan) and decode (the
    # states written in place)
    from repro_torch.models import rglru
    cfg = dataclasses.replace(get_reduced("recurrentgemma-9b"),
                              dtype=str(dtype).split(".")[1])
    p = rglru.init_rglru(torch.Generator().manual_seed(0), cfg, dtype, "cpu")
    cpu_gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1 if decode else 37, cfg.d_model),
                    generator=cpu_gen).to(dtype)
    conv = torch.randn((3, 3, cfg.lru_width), generator=cpu_gen).to(dtype)
    lru = torch.randn((3, cfg.lru_width), generator=cpu_gen)
    states = dict(conv_state=conv, lru_state=lru) if decode else {}
    card = {k: v.cuda() for k, v in states.items()}
    want, (wconv, wlru) = rglru.apply_rglru(p, x, **states)
    got, (conv_c, lru_c) = rglru.apply_rglru(
        {k: v.cuda() for k, v in p.items()}, x.cuda(), **card)
    if decode:
        assert conv_c is card["conv_state"] and lru_c is card["lru_state"]
    _close(got.cpu(), want, dtype)
    _close(conv_c.cpu(), wconv, dtype)
    _close(lru_c.cpu(), wlru, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_replay_equals_eager_step_ssd(gen, dtype):
    # reduced mamba2 at cache_len 16: 20 steps, the ssd layers' conv_x,
    # conv_bc and ssm states written in place every step; no layer has
    # attention or LoRA
    _replays_equal_eager(*_served(dtype, 16, "mamba2-2.7b"), steps=20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decode", [False, True])
def test_apply_ssd_on_the_card(gen, decode, dtype):
    # the SSD mixer (plain PyTorch) on the card against its CPU result on
    # the same inputs: prefill (the chunked scan over 37 positions, chunks
    # of 1 by reduced mamba2's chunk 8) and decode (the states written in
    # place)
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"),
                              dtype=str(dtype).split(".")[1])
    d_inner, h, hd, n = ssm.ssd_dims(cfg)
    p = ssm.init_ssd(torch.Generator().manual_seed(0), cfg, dtype, "cpu")
    cpu_gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1 if decode else 37, cfg.d_model),
                    generator=cpu_gen).to(dtype)
    states = {}
    if decode:
        states = dict(conv_state=tuple(
            torch.randn((3, 3, w), generator=cpu_gen).to(dtype)
            for w in (d_inner, 2 * n)),
            ssm_state=torch.randn((3, h, hd, n), generator=cpu_gen))
    card = {k: tuple(t.cuda() for t in v) if isinstance(v, tuple)
            else v.cuda() for k, v in states.items()}
    want, wstates = ssm.apply_ssd(p, x, cfg, **states)
    got, cstates = ssm.apply_ssd({k: v.cuda() for k, v in p.items()},
                                 x.cuda(), cfg, **card)
    if decode:
        given = (*card["conv_state"], card["ssm_state"])
        assert all(c is g for c, g in zip(cstates, given))
    _close(got.cpu(), want, dtype)
    for c, w in zip(cstates, wstates):
        _close(c.cpu(), w, dtype)


def test_reduced_mamba2_on_the_card_matches_cpu(gen):
    # reduced mamba2 in bf16: the same weights on the card and on the CPU,
    # prefill of 13 tokens (chunks of 1) and 6 decode steps
    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"), dtype="bfloat16")
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (4, 19),
                           generator=torch.Generator().manual_seed(2))
    want, wcache = cpu.prefill(None, tokens[:, :13])
    got, cache = card.prefill(None, tokens[:, :13].cuda())
    _close(got.cpu(), want, torch.bfloat16)
    for i in range(13, 19):
        want, wcache = cpu.decode_step(None, wcache, tokens[:, i:i + 1])
        got, cache = card.decode_step(None, cache, tokens[:, i:i + 1].cuda())
        _close(got.cpu(), want, torch.bfloat16)
    for c, w in zip(cache["layers"], wcache["layers"]):
        for k in c:
            _close(c[k].cpu(), w[k], torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,cache_len,steps", [
    ("phi4-mini-3.8b", 16, 20),
    # gemma3's int8 global caches end at step 20, its local layers' f32 or
    # bf16 buffers wrap at step 16
    ("gemma3-1b", 20, 28)])
def test_executor_replay_equals_eager_step_int8(gen, arch, cache_len, steps,
                                                dtype):
    # the quantized write (quantize_kv, the scales' index_copy_) and the
    # int8 mode replay bit for bit
    _replays_equal_eager(*_served(dtype, cache_len, arch, kv_quant=True),
                         steps=steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,router_add", [(8, 0.0), (2047, 0.0),
                                          (2049, 0.3)])
def test_apply_moe_on_the_card(gen, t, router_add, dtype):
    # the decode shape, the largest dropless T (T*k 4094) and the capacity
    # path with expert 0 past its capacity: against the port's CPU result
    # on the same inputs, and (dropless) against the oracle on the card
    from repro_torch.models import moe
    e, d, f, k = 8, 64, 32, 2
    p = moe.init_moe(torch.Generator().manual_seed(0), d, f, e, dtype, "cpu")
    p["router"][:, 0] += router_add
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(1)).to(
        dtype)
    want = moe.apply_moe(p, x, top_k=k, n_experts=e, capacity_factor=1.25)
    card = {n: w.cuda() for n, w in p.items()}
    got = moe.apply_moe(card, x.cuda(), top_k=k, n_experts=e,
                        capacity_factor=1.25)
    _close(got[0].cpu(), want[0], dtype)
    assert abs(float(got[1]) - float(want[1])) < 1e-5
    if t * k <= 4096:
        _close(got[0], moe.apply_moe_ref(card, x.cuda(), top_k=k,
                                         n_experts=e), dtype)


def test_executor_replays_count_their_launches(gen):
    _replays_count_their_launches("phi4-mini-3.8b")


def test_executor_replays_count_their_launches_rglru(gen):
    # recurrentgemma's rglru layers launch neither BGMV nor flash-decode
    _replays_count_their_launches("recurrentgemma-9b")


def test_executor_replays_count_their_launches_ssd(gen):
    # mamba2 has no attention layer: a replay launches no kernel wrapper
    _replays_count_their_launches("mamba2-2.7b")


def _replays_count_their_launches(arch):
    # one BGMV per LoRA target and one flash-decode per attention layer
    model, lora, ex = _served(torch.bfloat16, arch=arch)
    ops.reset_launches()
    model.decode_step(lora, _clone_cache(ex.cache), ex.tokens, ex.ids)
    per_step = {k: n for k, n in ops.launch_counts().items() if n}
    n_attn = sum(k in ("global", "local") for k in model.cfg.layer_kinds)
    want = {"bgmv": 2 * n_attn, "flash_decode": n_attn}
    assert per_step == {k: n for k, n in want.items() if n}
    assert ex.graph_launches == per_step
    ops.reset_launches()
    for _ in range(5):
        ex.decode(np.zeros(8, np.int32))
    assert ex.replays == 5
    assert {k: n for k, n in ops.launch_counts().items() if n} == \
        {k: 5 * n for k, n in per_step.items()}


def test_eager_decode_step_does_not_synchronise(gen):
    _decode_step_does_not_synchronise("phi4-mini-3.8b")


def test_eager_moe_decode_step_does_not_synchronise(gen):
    # nothing in the MoE FFN waits for the host: no .item(), nonzero or
    # data-dependent shape, so the step can be captured
    _decode_step_does_not_synchronise("olmoe-1b-7b")


def test_eager_int8_decode_step_does_not_synchronise(gen):
    # the quantized write stays on the device: the step can be captured
    _decode_step_does_not_synchronise("phi4-mini-3.8b", kv_quant=True)


def test_eager_rglru_decode_step_does_not_synchronise(gen):
    # the RG-LRU decode (the conv window, the gates, the in-place state
    # writes) stays on the device: the step can be captured
    _decode_step_does_not_synchronise("recurrentgemma-9b")


def test_eager_ssd_decode_step_does_not_synchronise(gen):
    # the SSD decode (the conv windows, the O(1) update, the in-place
    # state writes) stays on the device: the step can be captured
    _decode_step_does_not_synchronise("mamba2-2.7b")


def _decode_step_does_not_synchronise(arch, kv_quant=False):
    model, lora, ex = _served(torch.bfloat16, arch=arch, kv_quant=kv_quant)
    ids = torch.tensor([0, 1, -1, 3, 2, 2, -1, 0], dtype=torch.int32,
                       device="cuda")
    cache = _clone_cache(ex.cache)
    model.decode_step(lora, cache, ex.tokens, ids)   # cuBLAS handle, kernels
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.decode_step(lora, cache, ex.tokens, ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all())


# --------------------------------------------------------------------------- #
# the training step on the card
# --------------------------------------------------------------------------- #

def _train_batch(cfg, rows=4, tokens=32):
    from repro_torch.data import DataConfig, TokenPipeline
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=tokens,
                                    global_batch=rows)).batch_at(0)


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "olmoe-1b-7b",
                                  "recurrentgemma-9b", "mamba2-2.7b"])
def test_train_step_on_the_card_matches_cpu(gen, arch):
    # reduced, f32 (TF32 off), the same weights: one step of 2 microbatches
    # on the card against the CPU's, loss, gradient norm and each f32
    # gradient leaf within 2e-4 (test_consistency.py:39), no kernel wrapper
    # launched (training runs none of the port's kernels)
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device="cuda", seed=3)
    card.load_state_dict(cpu.state_dict())
    batch = _train_batch(cfg)
    tcfg = TrainConfig(microbatches=2)
    cpu_step = make_train_step(cpu, tcfg)
    _, want = cpu_step(init_train_state(cpu, tcfg), batch)
    ops.reset_launches()
    card_step = make_train_step(card, tcfg)
    _, got = card_step(init_train_state(card, tcfg), batch)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    for key in ("loss", "grad_norm", "lr"):
        assert _rel(got[key], want[key]) <= 2e-4, key
    assert card_step.grads.keys() == cpu_step.grads.keys()
    for name, g in cpu_step.grads.items():
        assert card_step.grads[name].dtype == torch.float32
        assert _rel(card_step.grads[name], g) <= 2e-4, name


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "olmoe-1b-7b"])
def test_executor_replay_equals_eager_step_after_train_step(gen, arch):
    # the decode step captured first, then a train step updates the weights
    # in place: the replays read the new weights and equal the eager step
    # bit for bit
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    model, lora, ex = _served(torch.bfloat16, 16, arch)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-2, warmup_steps=0))
    make_train_step(model, tcfg)(init_train_state(model, tcfg),
                                 _train_batch(model.cfg))
    assert any(not torch.equal(before[n], p)
               for n, p in model.named_parameters())
    _replays_equal_eager(model, lora, ex, steps=20)


# --------------------------------------------------------------------------- #
# products kept in f32; checkpoints and the fault-tolerant loop on the card
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("op,x_shape,w_shape", [
    ("mm", (8, 3072), (3072, 8192)),          # phi4-mini's MLP, T 8
    ("mm", (8, 3072), (3072, 200192)),        # its untied logits
    ("mm", (3, 7, 65), (65, 129)),            # odd widths, 3-D x
    ("bmm", (4, 1, 2048), (4, 2048, 1024)),   # the MoE oracle's rows
    ("bmm", (64, 8, 2048), (64, 2048, 1024)),  # olmoe's dense dispatch
], ids=["mlp", "logits", "odd", "bmm_rows", "bmm_experts"])
def test_products_in_f32(gen, op, x_shape, w_shape):
    # layers.matmul_f32 and bmm_f32: bf16 operands, f32 results within 1e-5
    # of the f32 product of the bf16 values (TF32 off), forward and
    # backward; the backward's cotangent in bf16, as autograd of
    # (x @ w).float() takes it
    from repro_torch.models import layers
    fn = layers.matmul_f32 if op == "mm" else layers.bmm_f32
    x = _normal(gen, *x_shape, dtype=torch.bfloat16).requires_grad_(True)
    w = _normal(gen, *w_shape, dtype=torch.bfloat16,
                std=w_shape[-2] ** -0.5).requires_grad_(True)
    got = fn(x, w)
    want = x.detach().float() @ w.detach().float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    g = _normal(gen, *got.shape)
    gx, gw = torch.autograd.grad(got, (x, w), g)
    wx, ww = torch.autograd.grad((x @ w).float(), (x, w), g)
    assert gx.dtype == gw.dtype == torch.bfloat16
    _close(gx, wx, torch.bfloat16)
    _close(gw, ww, torch.bfloat16)


def test_tied_logits_in_f32_on_the_card(gen):
    # the tied unembedding reads embed.T, a transposed view
    from repro_torch.models import layers
    x = _normal(gen, 8, 1, 256, dtype=torch.bfloat16)
    embed = _normal(gen, 4096, 256, dtype=torch.bfloat16, std=0.02)
    got = layers.unembed({"embed": embed}, x, 30.0)
    want = torch.tanh((x.float() @ embed.float().T) / 30.0) * 30.0
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5


def test_checkpoint_of_card_tensors_round_trips(gen, tmp_path):
    # bf16, f32, int8 and f16 leaves on the card, saved async, restored
    # onto the card and onto the CPU bit for bit
    from repro_torch.checkpoint import CheckpointManager
    tree = {"w": _normal(gen, 64, 33, dtype=torch.bfloat16),
            "m": [_normal(gen, 64, 33), _normal(gen, 5)],
            "q": (torch.randint(-127, 128, (64, 33), generator=gen,
                                device="cuda", dtype=torch.int8),
                  _normal(gen, 1, 33).to(torch.float16)),
            "step": torch.tensor(7, dtype=torch.int32, device="cuda")}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, tree, {"card": torch.cuda.get_device_name(0)})
    for dev in ("cuda", "cpu"):
        got = mgr.restore(tree, device=dev)
        pairs = [(got["w"], tree["w"]), (got["m"][0], tree["m"][0]),
                 (got["m"][1], tree["m"][1]), (got["q"][0], tree["q"][0]),
                 (got["q"][1], tree["q"][1]), (got["step"], tree["step"])]
        for a, b in pairs:
            assert a.device.type == dev and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())


def test_ft_loop_crash_and_resume_on_the_card(gen, tmp_path):
    # reduced phi4-mini, bf16, on the card: 12 steps with a crash at step 8
    # and checkpoints every 5 end bit for bit where 12 steps without one end
    from repro_torch.checkpoint import copy_into
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.fault_tolerance import FaultTolerantLoop, FTConfig
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_train_step)
    from repro_torch.training.train_lib import trainable
    cfg = dataclasses.replace(get_reduced("phi4-mini-3.8b"), dtype="bfloat16")
    model = Model(cfg, device="cuda", seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8))
    state = {"params": trainable(model), "opt": init_train_state(model, tcfg)}
    start = {"params": {k: v.detach().clone()
                        for k, v in state["params"].items()},
             "opt": {"step": state["opt"]["step"].clone(),
                     "m": {k: v.clone() for k, v in state["opt"]["m"].items()},
                     "v": {k: v.clone() for k, v in state["opt"]["v"].items()}}}
    step_fn = make_train_step(model, tcfg)

    def init_fn():
        copy_into(state, start)
        return state

    def one(s, batch):
        return {"params": s["params"], "opt": step_fn(s["opt"], batch)[0]}

    finals = []
    for name, failure_at in (("crash", 8), ("plain", None)):
        copy_into(state, start)
        loop = FaultTolerantLoop(FTConfig(str(tmp_path / name),
                                          checkpoint_every=5), state)
        out = loop.run_with_restarts(init_fn, one, pipe.batch_at, 12,
                                     failure_at=failure_at)
        assert loop.report.restarts == (failure_at is not None)
        assert loop.report.resumed_from == (5 if failure_at else None)
        assert int(out["opt"]["step"]) == 12
        finals.append({"params": {k: v.detach().clone()
                                  for k, v in out["params"].items()},
                       "m": {k: v.clone() for k, v in out["opt"]["m"].items()},
                       "v": {k: v.clone() for k, v in out["opt"]["v"].items()}})
    for part in ("params", "m", "v"):
        for k, v in finals[0][part].items():
            assert torch.equal(v, finals[1][part][k]), (part, k)


# flash-decode's log-sum-exp mode (B, H, KV, D): phi4-mini's heads, head
# groups past 8 (16 on 1 KV head of 256), padded head dims (96; 8 on the
# int8 mode's 16) and the wide path (512)
LSE_SHAPES = [(8, 24, 8, 128), (8, 16, 1, 256), (4, 8, 2, 96), (4, 8, 2, 512),
              (2, 4, 4, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True], ids=["kv", "int8"])
@pytest.mark.parametrize("bsz,h,kv,d", LSE_SHAPES)
def test_flash_decode_lse_matches_plain(gen, bsz, h, kv, d, int8, dtype):
    # the output in f32, rounded to q's dtype bit for bit the call without
    # the log-sum-exp; output and log-sum-exp at q's tolerance against the
    # plain version's (the int8 mode with q in f32 against exact q . k),
    # -inf at a length of 0
    s = 300
    q = _normal(gen, bsz, h, d, dtype=dtype)
    k, v = (_normal(gen, bsz, s, kv, d, dtype=dtype) for _ in range(2))
    lengths = torch.randint(0, s + 8, (bsz,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[:2] = torch.tensor([0, 1], device="cuda")
    scales = ()
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    out, lse = flash_decode.flash_decode_lse(q, k, v, lengths, *scales)
    assert lse.shape == (bsz, h) and lse.dtype == out.dtype == torch.float32
    assert torch.equal(out.to(dtype), flash_decode.flash_decode(
        q, k, v, lengths, *scales))
    if int8:
        want_out, want = flash_decode.flash_decode_int8_plain(
            q, k, v, lengths, *scales, exact_dot=dtype == torch.float32,
            return_lse=True)
    else:
        want_out, want = flash_decode.flash_decode_plain(q, k, v, lengths,
                                                         return_lse=True)
    _close(out, want_out, dtype)
    empty = torch.isneginf(want)
    assert bool(empty[0].all()) and torch.equal(torch.isneginf(lse), empty)
    _close(lse[~empty], want[~empty], dtype)


@pytest.mark.parametrize("arch,kv_quant", [("phi4-mini-3.8b", False),
                                           ("gemma3-1b", False),
                                           ("phi4-mini-3.8b", True)])
def test_plan_step_at_world_size_one_equals_the_step_without(gen, arch,
                                                             kv_quant):
    # the NCCL world-size-1 group: every collective of the plan's step runs
    # over groups of one, its global layers through flash-decode's
    # log-sum-exp mode and the combine
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models.sharding import (COLLECTIVES, make_plan,
                                             reset_collectives, shard_cache)
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    init_cuda_group()
    try:
        plan = make_plan(cfg, make_single_device_mesh(), "decode",
                         global_batch=4, kv_quant=kv_quant)
        ref = Model(cfg, device="cuda", seed=3, kv_quant=kv_quant)
        model = Model(cfg, device="cuda", seed=3, plan=plan)
        assert model.layers[-1].kv_quant == ref.layers[-1].kv_quant
        lora = ref.init_lora(4, 4, seed=3)
        tokens = torch.randint(0, cfg.vocab_size, (4, 24), generator=gen,
                               device="cuda")
        idx = torch.tensor([0, 1, -1, 3], dtype=torch.int32, device="cuda")
        _, cache = ref.prefill(lora, tokens[:, :20], idx)
        cache = ref.pad_cache(cache, 4)
        planned = shard_cache(cache, plan)
        ops.reset_launches()
        reset_collectives()
        for i in range(20, 24):
            got, _ = model.decode_step(lora, planned, tokens[:, i:i + 1], idx)
            want, _ = ref.decode_step(lora, cache, tokens[:, i:i + 1], idx)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            rel = ((got - want).abs().max() / want.abs().max()).item()
            assert rel < 2e-4, (i, rel)
        assert ops.launch_counts()["flash_decode_lse"] > 0
        assert COLLECTIVES["all_reduce"] > 0 and COLLECTIVES["all_gather"] > 0
    finally:
        dist.destroy_process_group()
        ops.reset_launches()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "gemma3-1b",
                                  "olmoe-1b-7b", "recurrentgemma-9b"])
def test_prefill_plan_at_world_size_one_equals_the_prefill_without(gen,
                                                                   arch):
    # the NCCL world-size-1 group: the prefill plan's weight gathers, ring
    # and SGMV's whole-prompt rule over groups of one give the prefill without a
    # plan bit for bit (every request on adapter 0: 512 tokens, capacity
    # 384, so tokens drop); pad_cache lays the cache out for the decode
    # plan, whose steps hold to the steps without a plan
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_cuda_group, make_single_device_mesh
    from repro_torch.models.sharding import (COLLECTIVES, make_plan,
                                             reset_collectives)
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    init_cuda_group()
    try:
        mesh = make_single_device_mesh()
        ref = Model(cfg, device="cuda", seed=3)
        pre = Model(cfg, device="cuda", seed=3,
                    plan=make_plan(cfg, mesh, "prefill", global_batch=4))
        dec = Model(cfg, device="cuda", seed=3,
                    plan=make_plan(cfg, mesh, "decode", global_batch=4))
        lora = ref.init_lora(4, 4, seed=3)
        tokens = torch.randint(0, cfg.vocab_size, (4, 132), generator=gen,
                               device="cuda")
        idx = torch.zeros(4, dtype=torch.int32, device="cuda")
        ops.reset_launches()
        reset_collectives()
        got, planned = pre.prefill(lora, tokens[:, :128], idx)
        launches = ops.launch_counts()["sgmv"]
        want, cache = ref.prefill(lora, tokens[:, :128], idx)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert launches == ops.launch_counts()["sgmv"] // 2 > 0
        planned, cache = pre.pad_cache(planned, 4), ref.pad_cache(cache, 4)
        for a, b in zip(planned["layers"], cache["layers"]):
            assert all(torch.equal(a[n], b[n]) for n in b)
        for i in range(128, 132):
            got, _ = dec.decode_step(lora, planned, tokens[:, i:i + 1], idx)
            want, _ = ref.decode_step(lora, cache, tokens[:, i:i + 1], idx)
            torch.cuda.synchronize()
            rel = ((got - want).abs().max() / want.abs().max()).item()
            assert rel < 2e-4, (i, rel)
        assert COLLECTIVES["all_gather"] > 0
    finally:
        dist.destroy_process_group()
        ops.reset_launches()
