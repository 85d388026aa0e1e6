"""The Python that chooses the flash-decode kernels' launch, on the CPU.

``flash_decode.split_plan`` (``split_plan_d256`` on the bf16 tensor-core
pass at D 256) cuts each row's S positions into chunks of whole tiles for
the split pass.  The kernel rejects a plan that breaks this rule
(``csrc/flash_decode.cu::launch_split``), so these tests hold the plan to it
over the shapes the port runs: the serving step, the measurement grid
(``repro_torch.bench.kernels_bench``: batch 1/8/32 x seq 256/1024/4096)
and edge widths, at every head dim 1..1024 (a dim up to 256 without an
instance runs the next larger one, padded; past 256 the wide path's
32-position tiles).  (BGMV's launch plan lives in its C
launcher and is held by the card tests of ``tests/test_torch_cuda.py``.)
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode  # noqa: E402

H100_SMS = 132
BATCHES = (1, 3, 8, 32)
KV_HEADS = (1, 2, 8)
SEQS = (1, 7, 15, 16, 17, 63, 64, 65, 100, 256, 512, 1000, 1024, 4096)
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_decode.HEAD_DIMS)
def test_tile_fits_the_split_pass(d, dtype):
    # a tile is TILE_BYTES of K (within TILE_MIN..TILE_MAX positions), a
    # power of two that the split pass's 128 threads divide, and its ring
    # of three K+V stages fits the 227 KB a block may use
    p = flash_decode.tile_positions(d, ITEMSIZE[dtype])
    assert flash_decode.TILE_MIN <= p <= flash_decode.TILE_MAX
    assert p & (p - 1) == 0 and 128 % p == 0
    row = d * ITEMSIZE[dtype]
    assert p * row <= flash_decode.TILE_BYTES or p == flash_decode.TILE_MIN
    assert 3 * 2 * p * row <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", flash_decode.HEAD_DIMS)
def test_split_plan_whole_tiles_cover_s(d, dtype):
    tile = flash_decode.tile_positions(d, ITEMSIZE[dtype])
    for bsz in BATCHES:
        for kv in KV_HEADS:
            for s in SEQS:
                n_splits, chunk = flash_decode.split_plan(bsz, kv, s,
                                                          H100_SMS, tile)
                assert chunk % tile == 0 and chunk > 0
                spans = [(i * chunk, min((i + 1) * chunk, s))
                         for i in range(n_splits)]
                # consecutive, non-empty, from 0 to exactly s
                assert spans[0][0] == 0 and spans[-1][1] == s
                assert all(a < b for a, b in spans)
                assert all(spans[i][1] == spans[i + 1][0]
                           for i in range(n_splits - 1))
                # never more splits than tiles, and blocks for about two an
                # SM where the tiles allow (at least half of that)
                n_tiles = -(-s // tile)
                assert n_splits <= n_tiles
                assert 2 * bsz * kv * n_splits >= min(2 * H100_SMS,
                                                      bsz * kv * n_tiles)


def test_split_plan_at_the_serving_shape():
    # phi4-mini serving: 8 rows, 8 KV heads, cache 512, D 128 in bf16
    tile = flash_decode.tile_positions(128, 2)
    assert tile == 64
    assert flash_decode.split_plan(8, 8, 512, H100_SMS, tile) == (4, 128)



def test_split_plan_at_recurrentgemma_shape():
    # recurrentgemma-9b serving: 16 query heads on 1 KV head, D 256 in bf16
    # (32-position tiles), 8 rows; 512 rows of a rolling buffer and the
    # full 2048-row window.  The bf16 tensor-core pass at D 256 takes the
    # 16 heads in one block (one group), so each split reads K and V once;
    # every other pass cuts them into two groups of 8
    assert flash_decode.mma256_pass(256, torch.bfloat16, 2)
    limit = flash_decode.MMA256_GROUP
    assert limit == 16
    assert [flash_decode.head_groups(g, limit) for g in (1, 8, 9, 16, 24,
                                                         33)] == \
        [1, 1, 1, 1, 2, 3]
    assert [flash_decode.head_groups(g) for g in (1, 8, 9, 16, 24)] == \
        [1, 1, 2, 2, 3]
    tile = flash_decode.tile_positions(256, 2)
    assert tile == 32
    groups = 1 * flash_decode.head_groups(16, limit)
    assert groups == 1
    assert flash_decode.split_plan_d256(8, groups, 512, H100_SMS, tile) == \
        (8, 64)
    assert flash_decode.split_plan_d256(8, groups, 2048, H100_SMS, tile) == \
        (16, 128)
    # the passes at D <= 128, in f32, and in the int8 mode keep groups of 8
    # and their plans
    for d, dtype, itemsize in ((128, torch.bfloat16, 2),
                               (96, torch.bfloat16, 2),
                               (256, torch.float32, 4),
                               (256, torch.bfloat16, 1),
                               (512, torch.bfloat16, 2)):
        assert not flash_decode.mma256_pass(d, dtype, itemsize)
    assert flash_decode.MAX_GROUP == 8
    assert [flash_decode.mma256_pass(d, torch.bfloat16, 2)
            for d in (128, 129, 200, 255, 256, 257)] == \
        [False, True, True, True, True, False]
    assert flash_decode.split_plan(8, 1 * flash_decode.head_groups(16), 512,
                                   H100_SMS, 32) == (16, 32)
    assert flash_decode.split_plan(8, 1 * flash_decode.head_groups(16), 2048,
                                   H100_SMS, 32) == (16, 128)
    assert flash_decode.split_plan(8, 8 * flash_decode.head_groups(3), 512,
                                   H100_SMS,
                                   flash_decode.tile_positions(128, 2)) == \
        (4, 128)


# the six head-dim-256 shapes where SDPA outran bf16 flash-decode before
# the tensor-core pass at D 256 (recurrentgemma-9b's decode cells at B 128
# and 1 and its 2048-row window at B 8; gemma3-1b's global and local layers
# at decode_32k and its long_500k cache), by S: (name, S), each at B 1, 8
# and 128 and G 1, 4, 16 and 24
D256_SHAPES = (("rgemma_b128", 2048), ("gemma3_global_b128", 32768),
               ("gemma3_local_b128", 512), ("rgemma_window_b8", 2048),
               ("gemma3_long_b1", 524288), ("rgemma_b1", 2048))


@pytest.mark.parametrize("g", [1, 4, 16, 24])
@pytest.mark.parametrize("bsz", [1, 8, 128])
@pytest.mark.parametrize("name,s", D256_SHAPES)
def test_split_plan_covers_s_on_the_d256_pass(name, s, bsz, g):
    # one KV head whose G heads the bf16 pass at D 256 takes in
    # ceil(G / 16) groups, on its plan (split_plan_d256): chunks of whole
    # 32-position tiles, consecutive, non-empty, from 0 to exactly S; no
    # more splits than tiles nor than ceil(2 sqrt(tiles)); blocks in at
    # most one wave of two an SM where a split's blocks are more than half
    # the SMs, else of one an SM (one split a row where the rows alone
    # fill it), and at least half the splits the plan wants
    groups = flash_decode.head_groups(g, flash_decode.MMA256_GROUP)
    assert groups == -(-g // 16)
    tile = flash_decode.tile_positions(256, 2)
    n_splits, chunk = flash_decode.split_plan_d256(bsz, groups, s, H100_SMS,
                                                   tile)
    assert chunk % tile == 0 and chunk > 0
    spans = [(i * chunk, min((i + 1) * chunk, s)) for i in range(n_splits)]
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(n_splits - 1))
    n_tiles = -(-s // tile)
    cap = math.ceil(2 * math.sqrt(n_tiles))
    assert n_splits <= min(n_tiles, cap)
    rows = bsz * groups
    per_sm = 2 if 2 * rows > H100_SMS else 1
    assert rows * n_splits <= max(per_sm * H100_SMS, rows)
    want = min(n_tiles, cap, max(1, per_sm * H100_SMS // rows))
    assert 2 * n_splits > want


def test_split_plan_d256_at_the_cells():
    # the plans the D 256 pass takes at the six shapes above (one KV head)
    # and the two served caches: two splits at B 128 (256 blocks, one
    # wave), one block an SM at B 1 over 524288 rows, 2 sqrt(tiles) splits
    # where that is fewer
    plan = flash_decode.split_plan_d256
    assert [plan(b, g, s, H100_SMS, 32) for b, g, s in (
        (128, 1, 2048), (128, 1, 32768), (128, 1, 512), (8, 1, 2048),
        (1, 1, 524288), (1, 1, 2048), (8, 1, 512))] == \
        [(2, 1024), (2, 16384), (2, 256), (16, 128), (132, 4000),
         (16, 128), (8, 64)]


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_every_head_dim_has_an_instance_and_a_plan(itemsize):
    # every head dim 1..256 runs on an instantiated one (itself where
    # there is one; int8 from 16), whose tile fits; 257..1024 on the wide
    # path (itself, unpadded, in tiles of WIDE_TILE positions); each
    # split plan covers S in whole tiles; 0 and 1025 have none
    dims = flash_decode.INT8_HEAD_DIMS if itemsize == 1 \
        else flash_decode.HEAD_DIMS
    assert flash_decode.MAX_INSTANCE_DIM == dims[-1] == 256
    assert flash_decode.MAX_HEAD_DIM == 1024
    for d in range(1, flash_decode.MAX_HEAD_DIM + 1):
        di = flash_decode.instance_dim(d, itemsize)
        p = flash_decode.tile_positions(d, itemsize)
        if d <= flash_decode.MAX_INSTANCE_DIM:
            assert not flash_decode.is_wide(d)
            assert di in dims and di >= d
            assert di == d or di == dims[0] or di // 2 < d
            assert p == flash_decode.tile_positions(di, itemsize)
            assert flash_decode.TILE_MIN <= p <= flash_decode.TILE_MAX
            assert 3 * 2 * p * di * itemsize <= 227 * 1024
        else:
            assert flash_decode.is_wide(d) and di == d
            assert p == flash_decode.WIDE_TILE
        assert p & (p - 1) == 0 and 128 % p == 0
        for bsz, kv, s in ((1, 1, 1), (8, 8, 512), (3, 2, 1000),
                           (32, 8, 4096)):
            n_splits, chunk = flash_decode.split_plan(bsz, kv, s, H100_SMS,
                                                      p)
            assert chunk % p == 0
            assert (n_splits - 1) * chunk < s <= n_splits * chunk
    for d in (0, flash_decode.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError, match="head dim"):
            flash_decode.instance_dim(d, itemsize)
        with pytest.raises(ValueError, match="head dim"):
            flash_decode.tile_positions(d, itemsize)


def test_padded_head_dims_at_public_widths():
    # 80, 96 and 192 (common public head dims) run on the 128 and 256
    # instances: 64- and 32-position bf16 tiles, 128 and 64 in int8
    assert [flash_decode.instance_dim(d, 2) for d in (80, 96, 192)] == \
        [128, 128, 256]
    assert [flash_decode.tile_positions(d, 2) for d in (80, 96, 192)] == \
        [64, 64, 32]
    assert [flash_decode.tile_positions(d, 1) for d in (8, 96, 192)] == \
        [128, 128, 64]
    assert flash_decode.split_plan(8, 32, 512, H100_SMS,
                                   flash_decode.tile_positions(96, 2)) == \
        (2, 256)
