"""The port's kernels (their plain versions, as they run on a CPU tensor)
against the JAX package's Pallas kernels run with interpret=True, and
the fused decode step also against the JAX composed oracle
``fused_decode_ref``.

Inputs are drawn with numpy from a fixed seed and handed to both sides
(bf16 through the bridge, bit for bit).  Tolerances are the JAX suite's:
f32 2e-5, bf16 3e-2 (the port keeps h = x @ A in f32, as the Pallas
kernels do).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.bgmv import bgmv as jax_bgmv  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_decode import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.flash_decode import flash_decode_lora as jax_fd_lora  # noqa: E402
from repro.kernels.sgmv import sgmv as jax_sgmv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import bgmv, flash_decode, ops, ref, sgmv  # noqa: E402

DTYPES = {"float32": (jnp.float32, 2e-5), "bfloat16": (jnp.bfloat16, 3e-2)}


def _both(arr, dtype):
    """One array as (jax array, torch tensor) with identical bits."""
    j = jnp.asarray(arr).astype(dtype)
    return j, bridge.tensor(np.asarray(j))


def _lora(seed, t, d, r, o, n, dtype, ids=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), np.float32)
    a = rng.standard_normal((n, d, r), np.float32) * 0.1
    b = rng.standard_normal((n, r, o), np.float32) * 0.1
    if ids is None:
        ids = rng.integers(-1, n, t)
    ids = np.asarray(ids, np.int32)
    jx, tx = _both(x, dtype)
    ja, ta = _both(a, dtype)
    jb, tb = _both(b, dtype)
    return (jx, ja, jb, jnp.asarray(ids)), (tx, ta, tb, torch.from_numpy(ids))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,o,n", [
    (4, 64, 8, 64, 2), (8, 128, 16, 256, 4), (1, 512, 4, 512, 3),
    (8, 32, 1, 32, 4),
])
def test_bgmv_matches_pallas(t, d, r, o, n, dtype):
    jdt, tol = DTYPES[dtype]
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(0, t, d, r, o, n, jdt)
    got = bgmv.bgmv(tx, ta, tb, ti, 1.5)
    assert got.dtype == tx.dtype and got.shape == (t, o)
    _close(got, jax_bgmv(jx, ja, jb, ji, 1.5, interpret=True), tol)


def _skewed_ids(seed, t, n):
    """The measurement path's adapter count with skew: adapter 0 takes more
    tokens than the capacity ``ref.sgmv_capacity(t, n)``, adapters 1-9
    share most of the rest, the others stay empty, and some tokens have
    no adapter (-1); shuffled.  (An id >= N has no meaning in the JAX
    package, whose bucketing clamps it to adapter N-1: only the card tests
    use one.)"""
    rng = np.random.default_rng(seed)
    over = ref.sgmv_capacity(t, n) + 44
    ids = np.concatenate([np.zeros(over, np.int64),
                          rng.integers(1, 10, t - over - 20),
                          np.full(20, -1)])
    assert ids.size == t and over < t
    return rng.permutation(ids)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,r,o,n,skewed", [
    pytest.param(256, 64, 8, 64, 2, False, id="256-64-8-64-2"),
    pytest.param(300, 128, 16, 128, 3, False, id="300-128-16-128-3"),
    pytest.param(130, 32, 8, 48, 3, False, id="130-32-8-48-3"),
    pytest.param(600, 32, 8, 48, 32, True, id="600-32-8-48-32-skewed"),
])
def test_sgmv_dense_matches_pallas(t, d, r, o, n, skewed, dtype):
    jdt, tol = DTYPES[dtype]
    ids = _skewed_ids(11, t, n) if skewed else None
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(1, t, d, r, o, n, jdt, ids)
    got = sgmv.sgmv(tx, ta, tb, ti)
    _close(got, jax_sgmv(jx, ja, jb, ji, interpret=True), tol)
    if skewed:  # adapter 0's tokens past its capacity get exactly 0
        first = np.flatnonzero(ti.numpy() == 0)
        cap = ref.sgmv_capacity(t, n)
        assert bool((got[first[cap:]] == 0).all())
        assert bool(got[first[:cap]].any())


@pytest.mark.parametrize("dtype,t,n,ranks", [
    pytest.param("float32", 192, 4, (1, 16, 7, 4), id="float32"),
    pytest.param("bfloat16", 192, 4, (1, 16, 7, 4), id="bfloat16"),
    pytest.param("float32", 600, 32, tuple(range(1, 17)) * 2,
                 id="float32-600-32-skewed"),
    pytest.param("bfloat16", 600, 32, tuple(range(1, 17)) * 2,
                 id="bfloat16-600-32-skewed"),
])
def test_sgmv_ragged_matches_pallas(dtype, t, n, ranks):
    jdt, tol = DTYPES[dtype]
    ids = _skewed_ids(12, t, n) if n == 32 else None
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(2, t, 32, 16, 48, n, jdt, ids)
    ranks = np.array(ranks, np.int32)
    got = sgmv.sgmv(tx, ta, tb, ti, ranks=torch.from_numpy(ranks))
    want = jax_sgmv(jx, ja, jb, ji, ranks=jnp.asarray(ranks), interpret=True)
    _close(got, want, tol)
    # ragged == dense on the masked bank, bitwise (test_kernels_edge.py:166)
    am, bm = ref.mask_ragged(ta, tb, torch.from_numpy(ranks))
    assert torch.equal(got, sgmv.sgmv(tx, am, bm, ti))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgmv_capacity_overflow_matches_pallas(dtype):
    # test_kernels_edge.py:138-150: 512 tokens all on adapter 0 of 8;
    # capacity 256, tokens past it get exactly 0
    jdt, tol = DTYPES[dtype]
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(
        3, 512, 32, 8, 32, 8, jdt, ids=np.zeros(512))
    assert ref.sgmv_capacity(512, 8) == 256
    got = sgmv.sgmv(tx, ta, tb, ti)
    _close(got, jax_sgmv(jx, ja, jb, ji, interpret=True), tol)
    assert bool((got[256:] == 0).all()) and bool(got[:256].any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgmv_capacity_over_sequence_slices_is_the_whole_prompts(dtype):
    # a prompt of 4 requests x 128 tokens, every request on adapter 0 of 4:
    # the whole prompt's capacity is 384 of its 512 tokens.  Cut into 4
    # sequence slices (the ranks of a prefill plan) with the tokens'
    # whole-prompt arrival ranks and capacity, the slices give the whole
    # prompt's result bit for bit, which is the JAX kernel's in interpret
    # mode; each slice with its own rule (32 tokens a request, its own
    # capacity 128) would keep all 512
    jdt, tol = DTYPES[dtype]
    bsz, seq, n, slices, d = 4, 128, 4, 4, 32
    t, s_loc = bsz * seq, seq // slices
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(
        9, t, d, 8, 32, n, jdt, ids=np.zeros(t))
    cap = ref.sgmv_capacity(t, n)
    assert cap == 384
    whole = sgmv.sgmv(tx, ta, tb, ti)
    _close(whole, jax_sgmv(jx, ja, jb, ji, interpret=True), tol)
    assert bool((whole[cap:] == 0).all()) and bool(whole[:cap].any())
    ids = torch.zeros(bsz, dtype=torch.int32)
    x3 = tx.reshape(bsz, seq, d)
    pieces, own, routed = [], [], []
    for r in range(slices):
        lo = r * s_loc
        arrival = sgmv.arrival_ranks(ids, 0, bsz, seq, lo, s_loc)
        xp = x3[:, lo:lo + s_loc].reshape(-1, d)
        tp = ti[:xp.shape[0]]
        pieces.append(sgmv.sgmv(xp, ta, tb, tp, arrival=arrival, cap=cap))
        own.append(sgmv.sgmv(xp, ta, tb, tp))
        # ops.lora_apply with per-token ids takes SGMV and the same rule
        routed.append(ops.lora_apply(xp, ta, tb, tp, arrival=arrival,
                                     tokens=t))

    def whole_order(parts):
        return torch.stack([p.reshape(bsz, s_loc, -1) for p in parts],
                           1).reshape(t, -1)
    assert torch.equal(whole_order(pieces), whole)
    assert torch.equal(whole_order(routed), whole)
    assert bool(whole_order(own).all(-1).all())   # nothing dropped


@pytest.mark.parametrize("bsz,seq,n_batch,n_seq", [(6, 12, 2, 3),
                                                   (4, 8, 1, 4),
                                                   (5, 6, 5, 1)])
def test_arrival_ranks_are_the_whole_prompts(bsz, seq, n_batch, n_seq):
    # each (batch piece, sequence slice) of a prompt of per-request ids,
    # some repeated and some < 0: its tokens' arrival ranks are those of
    # the whole prompt flattened row-major (ref._bucket_positions)
    ids = torch.from_numpy(np.random.default_rng(bsz * seq).integers(
        -1, 3, bsz).astype(np.int32))
    whole = ref._bucket_positions(ids.repeat_interleave(seq).long(), 3)
    whole = torch.where(ids.repeat_interleave(seq) >= 0, whole,
                        0).reshape(bsz, seq)
    rows, s_loc = bsz // n_batch, seq // n_seq
    for bi in range(n_batch):
        for si in range(n_seq):
            got = sgmv.arrival_ranks(ids, bi * rows, rows, seq, si * s_loc,
                                     s_loc).reshape(rows, s_loc)
            live = ids[bi * rows:(bi + 1) * rows] >= 0
            want = whole[bi * rows:(bi + 1) * rows, si * s_loc:
                         (si + 1) * s_loc]
            assert got.dtype == torch.int32
            assert torch.equal(got[live].long(), want[live])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,d,s,block_s", [
    (2, 8, 2, 64, 512, 512), (2, 4, 1, 64, 300, 512), (2, 4, 2, 16, 33, 16),
    (3, 6, 2, 32, 100, 512),
    # more than 8 query heads per KV head (the kernel's head groups):
    # recurrentgemma-9b's 16 on 1, a group of 12; and head dim 8
    (2, 16, 1, 64, 300, 512), (3, 24, 2, 32, 100, 512), (2, 8, 2, 8, 50, 16),
])
def test_flash_decode_matches_pallas(b, h, kv, d, s, block_s, dtype):
    # S not divisible by the block; ragged per-row lengths
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    jq, tq = _both(rng.standard_normal((b, h, d)), jdt)
    jk, tk = _both(rng.standard_normal((b, s, kv, d)), jdt)
    jv, tv = _both(rng.standard_normal((b, s, kv, d)), jdt)
    length = rng.integers(1, s + 1, b).astype(np.int32)
    got = flash_decode.flash_decode(tq, tk, tv, torch.from_numpy(length))
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(length),
                            block_s=block_s, interpret=True)
    _close(got, want, tol)


# head dims the Pallas kernel takes and the card runs on a padded instance
# (csrc/flash_decode.cu: the next larger of 8, 16, ..., 256), and past 256,
# which the card runs on the wide path
ANY_HEAD_DIMS = (24, 80, 96, 100, 192)
WIDE_HEAD_DIMS = (320, 512)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ANY_HEAD_DIMS + WIDE_HEAD_DIMS)
def test_flash_decode_any_head_dim_matches_pallas(d, dtype):
    # 16 query heads on 2 KV heads, ragged lengths, S not a whole block
    jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(d)
    b, h, kv, s = 3, 16, 2, 70
    jq, tq = _both(rng.standard_normal((b, h, d)), jdt)
    jk, tk = _both(rng.standard_normal((b, s, kv, d)), jdt)
    jv, tv = _both(rng.standard_normal((b, s, kv, d)), jdt)
    length = np.array([1, 33, s], np.int32)
    got = flash_decode.flash_decode(tq, tk, tv, torch.from_numpy(length))
    _close(got, jax_flash_decode(jq, jk, jv, jnp.asarray(length), block_s=32,
                                 interpret=True), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", ANY_HEAD_DIMS + WIDE_HEAD_DIMS)
def test_fused_decode_any_head_dim_matches_pallas(d, dtype):
    jdt, tol = DTYPES[dtype]
    j, t = _decode(17 + d, 3, 8, 2, d, 50, 48, 8, 3, jdt)
    got = flash_decode.flash_decode_lora(*t, 0.5)
    assert got.shape == (3, 8, d)
    _close(got, jax_fd_lora(*j, 0.5, interpret=True), tol)
    _close(got, jref.fused_decode_ref(*j, 0.5), tol)


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_int8_wide_head_dim_matches_jax_quantized_decode(d):
    # the int8 mode's plain version past 256 against the JAX quantized
    # decode (plain jnp, any D) after its own write at pos, over its pos
    # + 1 positions, to 2e-5 in f32
    from test_torch_kv_int8 import _decode_inputs, _jax_branch, _rel
    q, kq, vq, ks, vs, nk, nv = _decode_inputs(d, h=8, kv=2, d=d)
    pos = 29
    out, *caches = _jax_branch(d)(q, kq, vq, nk, nv, jnp.int32(pos), ks, vs)
    k, v, k_scale, v_scale = (torch.from_numpy(np.array(c)) for c in caches)
    got = flash_decode.flash_decode_int8_plain(torch.from_numpy(q), k, v,
                                               pos + 1, k_scale, v_scale)
    assert got.shape == q.shape
    assert _rel(got.numpy(), out) < 2e-5


def test_flash_decode_length_zero_gives_zero_like_pallas():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    got = flash_decode.flash_decode(*map(torch.from_numpy, (q, k, v)), 0)
    want = jax_flash_decode(q, k, v, 0, interpret=True)
    assert bool((got == 0).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_decode_ref_matches_jax_ref():
    from repro.kernels import ref as jref
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 4, 16), (3, 40, 2, 16), (3, 40, 2, 16)))
    length = np.array([1, 17, 40], np.int32)
    got = ref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, length)))
    _close(got, jref.flash_decode_ref(q, k, v, length), 2e-5)


@pytest.mark.parametrize("t", [4, 12, 96])
def test_lora_apply_routes_like_pallas(t, monkeypatch):
    # T <= 4N -> BGMV, larger T -> SGMV (ops.py:77-89), ragged bank included
    n = 3
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(7, t, 16, 8, 24, n,
                                               jnp.float32)
    ranks = np.array([2, 8, 5], np.int32)
    calls = []
    for mod, name in ((bgmv, "bgmv"), (sgmv, "sgmv")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    got = ops.lora_apply(tx, ta, tb, ti, 1.0, ranks=torch.from_numpy(ranks))
    want = jops.lora_apply(jx, ja, jb, ji, 1.0, ranks=jnp.asarray(ranks),
                           force="interpret")
    assert calls == (["bgmv"] if t <= 4 * n else ["sgmv"])
    _close(got, want, 2e-5)


def test_lora_apply_per_request_layout_matches_jax_ref():
    # (B, S, d) with per-request ids (B,): the JAX plain path (ops.py:48-62)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    a = rng.standard_normal((4, 16, 4)).astype(np.float32)
    b = rng.standard_normal((4, 4, 24)).astype(np.float32)
    ids = np.array([0, -1, 3], np.int32)
    got = ops.lora_apply(*map(torch.from_numpy, (x, a, b, ids)), 0.5)
    want = jops.lora_apply(x, a, b, jnp.asarray(ids), 0.5, force="ref")
    assert got.shape == (3, 5, 24)
    _close(got, want, 2e-5)
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("t", [8, 64])
def test_negative_id_gives_exact_zero(t):
    _, (tx, ta, tb, _) = _lora(9, t, 32, 4, 16, 2, jnp.float32)
    ids = torch.full((t,), -1, dtype=torch.int32)
    ids[0] = 1
    out = ops.lora_apply(tx, ta, tb, ids)
    assert bool((out[1:] == 0).all()) and bool(out[0].any())


def test_kernel_wrappers_count_only_launches():
    # a CPU tensor runs the plain version: no launch is counted
    ops.reset_launches()
    _, (tx, ta, tb, ti) = _lora(10, 8, 32, 4, 16, 2, jnp.float32)
    ops.lora_apply(tx, ta, tb, ti)
    ops.lora_apply(tx.repeat(8, 1), ta, tb, ti.repeat(8))
    _, args = _decode(12, 2, 4, 2, 16, 32, 24, 4, 2, np.float32)
    ops.flash_decode(*args[:4])
    ops.flash_decode_lse(*args[:4])
    ops.fused_decode(*args)
    assert ops.launch_counts() == {"bgmv": 0, "sgmv": 0, "flash_decode": 0,
                                   "flash_decode_lse": 0,
                                   "flash_decode_lora": 0}


def _decode(seed, b, h, kv, d, s, dx, r, n, dtype, wdtype=None, ids=None,
            length=None):
    """Seeded inputs of the fused decode step as (jax args, torch args),
    each (q, k, v, length, x, a, b, idx); x follows the attention dtype,
    the bank ``wdtype`` (default: the same)."""
    rng = np.random.default_rng(seed)
    wdtype = wdtype or dtype
    q, k, v = (_both(rng.standard_normal(sh), dtype)
               for sh in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))
    x = _both(rng.standard_normal((b, dx)), dtype)
    a = _both(rng.standard_normal((n, dx, r)) * 0.1, wdtype)
    bw = _both(rng.standard_normal((n, r, h * d)) * 0.1, wdtype)
    ids = np.asarray(rng.integers(-1, n, b) if ids is None else ids,
                     np.int32)
    length = np.asarray(rng.integers(1, s + 1, b) if length is None
                        else length, np.int32)
    j = (q[0], k[0], v[0], jnp.asarray(length), x[0], a[0], bw[0],
         jnp.asarray(ids))
    t = (q[1], k[1], v[1], torch.from_numpy(length), x[1], a[1], bw[1],
         torch.from_numpy(ids))
    return j, t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,d,s,dx,r,n", [
    (2, 8, 2, 64, 512, 128, 8, 3), (3, 4, 1, 16, 100, 32, 4, 2),
    (4, 6, 2, 32, 33, 48, 16, 4),
    # 16 query heads on 1 KV head; head dim 8
    (2, 16, 1, 32, 70, 64, 8, 2), (3, 4, 2, 8, 40, 32, 4, 2),
])
def test_fused_decode_matches_pallas_and_oracle(b, h, kv, d, s, dx, r, n,
                                                dtype):
    # ragged lengths, S not a multiple of the block, ids with -1
    jdt, tol = DTYPES[dtype]
    j, t = _decode(13, b, h, kv, d, s, dx, r, n, jdt)
    got = ops.fused_decode(*t, 0.5)
    assert got.dtype == t[0].dtype and got.shape == (b, h, d)
    _close(got, jax_fd_lora(*j, 0.5, interpret=True), tol)
    _close(got, jref.fused_decode_ref(*j, 0.5), tol)


def test_fused_decode_ref_matches_jax_oracle():
    j, t = _decode(14, 3, 4, 2, 16, 40, 32, 8, 3, jnp.float32)
    _close(ref.fused_decode_ref(*t, 0.5), jref.fused_decode_ref(*j, 0.5),
           2e-5)


def test_fused_decode_mixed_dtypes_like_pallas():
    # test_kernels_edge.py:116-131: bf16 q/K/V and x on an f32 bank
    j, t = _decode(15, 2, 4, 2, 16, 64, 32, 8, 3, jnp.bfloat16,
                  wdtype=jnp.float32, ids=[1, -1], length=[40, 64])
    got = flash_decode.flash_decode_lora(*t, 1.0)
    assert got.dtype == torch.bfloat16 and t[5].dtype == torch.float32
    _close(got, jax_fd_lora(*j, 1.0, interpret=True), 3e-2)
    _close(got, jref.fused_decode_ref(*j, 1.0), 3e-2)


def test_fused_decode_batch_one_rank_one_like_pallas():
    # test_kernels_edge.py:196-208: batch 1, one KV head, rank 1, scale 3
    j, t = _decode(16, 1, 2, 1, 16, 48, 16, 1, 1, jnp.float32, ids=[0],
                  length=[20])
    got = flash_decode.flash_decode_lora(*t, 3.0)
    _close(got, jax_fd_lora(*j, 3.0, interpret=True), 2e-5)
    _close(got, jref.fused_decode_ref(*j, 3.0), 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_all_base_is_flash_decode_bitwise(dtype):
    # test_kernels_edge.py:211-226: every id -1 gives plain flash-decode
    # bit for bit (the add is skipped, not a zero added)
    jdt, tol = DTYPES[dtype]
    j, t = _decode(17, 3, 4, 2, 16, 64, 32, 8, 2, jdt,
                  ids=[-1, -1, -1], length=[10, 64, 33])
    fused = flash_decode.flash_decode_lora(*t, 1.0)
    assert torch.equal(fused, flash_decode.flash_decode_plain(*t[:4]))
    _close(fused, jax_fd_lora(*j, 1.0, interpret=True), tol)


def test_fused_decode_expand_dim_mismatch_raises():
    # test_kernels_edge.py:229-236: B's expand dim must be H*D
    q = torch.zeros(1, 4, 16)
    k = torch.zeros(1, 32, 2, 16)
    x, a, b = torch.zeros(1, 16), torch.zeros(1, 16, 4), torch.zeros(1, 4, 72)
    idx = torch.zeros(1, dtype=torch.int32)
    for fn in (flash_decode.flash_decode_lora, ops.fused_decode):
        with pytest.raises(ValueError, match="expand dim"):
            fn(q, k, k, 8, x, a, b, idx)


def test_fused_decode_ragged_dispatch_like_pallas():
    # test_kernels_edge.py:239-260: ops.fused_decode masks a ragged bank
    j, t = _decode(18, 2, 4, 2, 16, 64, 32, 8, 3, jnp.float32,
                  ids=[2, 0], length=[64, 17])
    ranks = np.array([8, 3, 1], np.int32)
    got = ops.fused_decode(*t, 1.0, ranks=torch.from_numpy(ranks))
    am, bm = jref.mask_ragged(j[5], j[6], jnp.asarray(ranks))
    want = jref.fused_decode_ref(*j[:5], am, bm, j[7], 1.0)
    _close(got, want, 2e-5)
    _close(got, jops.fused_decode(*j, 1.0, ranks=jnp.asarray(ranks),
                                  force="interpret"), 2e-5)


@pytest.mark.parametrize("name", ["lora_ref", "lora_ref_ragged",
                                  "lora_ref_bucketed", "lora_shrink_ref",
                                  "mask_ragged"])
def test_oracles_match_jax_oracles(name):
    # the port's copies of repro.kernels.ref, same inputs, f32
    from repro.kernels import ref as jref
    (jx, ja, jb, ji), (tx, ta, tb, ti) = _lora(11, 40, 24, 8, 16, 3,
                                               jnp.float32)
    ranks = np.array([3, 8, 1], np.int32)
    jr, tr = jnp.asarray(ranks), torch.from_numpy(ranks)
    args = {"lora_ref": ((jx, ja, jb, ji, 0.5), (tx, ta, tb, ti, 0.5)),
            "lora_ref_ragged": ((jx, ja, jb, ji, jr), (tx, ta, tb, ti, tr)),
            "lora_ref_bucketed": ((jx, ja, jb, ji), (tx, ta, tb, ti)),
            "lora_shrink_ref": ((jx, ja, jnp.maximum(ji, 0)),
                                (tx, ta, ti.clamp(min=0).long())),
            "mask_ragged": ((ja, jb, jr), (ta, tb, tr))}[name]
    want, got = getattr(jref, name)(*args[0]), getattr(ref, name)(*args[1])
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        _close(g, w, 2e-5)


@pytest.mark.parametrize("t,n", [
    (600, 32), (130, 3), (1, 1),
    # the measurement path's prefill token counts at its 32 adapters, one
    # adapter, and more adapters than a warp's 32 lanes
    (512, 32), (2048, 32), (4096, 32), (4096, 1), (4096, 300)])
def test_sgmv_segments_plain_is_a_stable_sort(t, n):
    # the plain version of SGMV's sort kernel: numpy's stable argsort of the
    # adapter ids, ids outside [0, N) last; seg holds the N+2 starts, and a
    # token's position minus its segment's start is its rank among its
    # adapter's tokens, the rank the capacity rule reads
    ids = _skewed_ids(13, t, n) if n == 32 else \
        np.random.default_rng(14).integers(-2, n + 2, t)
    keys = np.where((ids >= 0) & (ids < n), ids, n)
    perm, seg = sgmv.segments(torch.from_numpy(ids.astype(np.int32)), n)
    assert perm.dtype == seg.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(
        seg.numpy(), np.searchsorted(np.sort(keys), np.arange(n + 2)))
    rank = np.empty(t, np.int64)
    rank[perm.numpy()] = np.arange(t) - seg.numpy()[np.sort(keys)]
    onehot = keys[:, None] == np.arange(n + 1)[None, :]
    want = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(1)
    np.testing.assert_array_equal(rank, want)
