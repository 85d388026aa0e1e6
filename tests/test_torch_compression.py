"""The port's gradient compression (``repro_torch.training.compression``)
against the JAX package's (ROADMAP.md item 11f), on the CPU.

Inputs are drawn from numpy generators (seeds below); the same f32 bits,
and for bf16 gradients the same bf16 values, go to both packages.  Every
comparison is bit for bit:

* ``_quantize`` (q and scale) against the JAX one, run eagerly, on the
  inputs of ``test_quantize_error_bound`` (tests/test_training_and_ft.py:
  131-139) with its hypothesis settings and its half-step error bound;
  the zero tensor;
* ``quantized_psum`` of one shard is x, with no collective; on 8 gloo
  ranks (``tests/torch_dist_ranks.py``) each rank's sum against the JAX
  ``quantized_psum`` under ``shard_map`` over 8 host devices
  (``tests/sharded_body_jax.py``, run eagerly as ``case_compression``,
  tests/sharded_cases.py:118-135, runs it), within 8 scales of the exact
  sum, with 14 shifts;
* ``compressed_grad_sync`` over 3 calls, the residual carried: of one
  shard against the JAX one in-process, and on 4 gloo ranks against the
  JAX one under ``shard_map`` over 4 devices, each call's synced
  gradients and residual on each rank;
* an ``n_shards`` other than the group's size raises ``ValueError``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis", reason="hypothesis not installed (pip install -e .[dev])")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.training import compression as jcomp  # noqa: E402
from repro_torch.models.sharding import (COLLECTIVES,  # noqa: E402
                                         reset_collectives)
from repro_torch.training import (_quantize, compressed_grad_sync,  # noqa: E402
                                  quantized_psum)
from tests import torch_dist_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 240.0   # seconds a spawn's ranks may take
BODY = Path(__file__).resolve().parent / "sharded_body_jax.py"
# three gradients of a data-parallel step: bf16 and f32 leaves
LEAVES = {"w": ((16, 24), "bfloat16"), "b": ((24,), "float32"),
          "embed": ((40, 8), "bfloat16")}
CALLS = 3


def _bits(a):
    """The bit patterns of an f32 (or int8) array or tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    assert np.array_equal(_bits(got), _bits(want))


def _jax_body(inp, tmp_path):
    """The JAX body of ``inp`` (tests/sharded_body_jax.py), through a
    pickle."""
    src, dst = tmp_path / "body_in.pkl", tmp_path / "body_out.pkl"
    src.write_bytes(pickle.dumps(inp))
    proc = subprocess.run(
        [sys.executable, str(BODY), str(src), str(dst)], capture_output=True,
        text=True, timeout=SPAWN_TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return pickle.loads(dst.read_bytes())


def _grads(seed, n):
    """{name: (CALLS, n, ...) f32}, each bf16 leaf's values bf16's."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in LEAVES.items():
        g = rng.normal(0, 0.05, (CALLS, n, *shape)).astype(np.float32)
        out[name] = np.asarray(jnp.asarray(g, dtype), np.float32)
    return out


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16))
def test_quantize_matches_jax_and_error_bound(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (64,)).astype(np.float32)
    q, s = _quantize(torch.from_numpy(x))
    jq, js = jcomp._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    _same(q, jq)
    _same(s, js)
    err = np.max(np.abs(q.numpy().astype(np.float32) * s.item() - x))
    assert err <= s.item() / 2 + 1e-6            # half-ulp of the grid


def test_quantize_zero_tensor():
    q, s = _quantize(torch.zeros(16))
    jq, js = jcomp._quantize(jnp.zeros(16, jnp.float32))
    _same(q, jq)
    _same(s, js)
    assert s.item() == np.float32(1e-12) and not q.any()


def test_quantized_psum_single_shard_identity():
    x = torch.tensor([1.0, -2.5, 3.25])
    reset_collectives()
    got = quantized_psum(x, None, 1)
    assert not any(COLLECTIVES.values())
    _same(got, jcomp.quantized_psum(jnp.asarray(x.numpy()), "pod", 1))


def test_shard_count_other_than_the_groups_raises():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="n_shards 2"):
        quantized_psum(x, None, 2)
    with pytest.raises(ValueError, match="n_shards 4"):
        compressed_grad_sync({"x": x}, None, 4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_compressed_grad_sync_single_shard_matches_jax(dtype):
    """One shard: the ring is the identity, so each call's synced gradient
    is (g + r) in g's dtype; the residuals carry over 3 calls."""
    grads = _grads(7, 1)
    got_r = want_r = None
    for c in range(CALLS):
        g = {k: v[c, 0] for k, v in grads.items()}
        tg = {k: torch.tensor(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
        reset_collectives()
        got, new_r = compressed_grad_sync(tg, None, 1, got_r)
        want, want_r = jcomp.compressed_grad_sync(jg, "pod", 1, want_r)
        assert not any(COLLECTIVES.values())
        for k in g:
            assert got[k].dtype == tg[k].dtype
            plus = tg[k].float() + (0 if got_r is None else got_r[k])
            assert torch.equal(got[k], plus.to(tg[k].dtype))
            _same(got[k].float(), np.asarray(want[k], np.float32))
            _same(new_r[k], want_r[k])
            assert new_r[k].abs().any()
        got_r = new_r


def test_quantized_psum_ring_matches_jax_shard_map(tmp_path):
    """8 ranks, x (8, 128) f32: each rank holds its own row exactly and the
    other 7 rows through the int8 wire format, added in ring order."""
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
    outs = ranks.spawn("compression", 8, {"mode": "psum", "x": x},
                       tmp_path, SPAWN_TIMEOUT)
    want = _jax_body({"kind": "compression", "mode": "psum", "mesh": (8, 1),
                      "x": x}, tmp_path)["out"]
    scale = np.abs(x).max() / 127.0
    total = x.sum(0)
    for o in outs:
        i = o["index"]
        _same(o["out"], want[i])
        assert np.max(np.abs(o["out"] - total)) < 8 * scale
        assert o["collectives"] == {**dict.fromkeys(COLLECTIVES, 0),
                                    "shift": 14}


def test_compressed_grad_sync_matches_jax_shard_map(tmp_path):
    grads = _grads(5, 4)
    inp = {"mode": "sync", "grads": grads,
           "dtypes": {k: d for k, (_, d) in LEAVES.items()}}
    outs = ranks.spawn("compression", 4, inp, tmp_path, SPAWN_TIMEOUT)
    want = _jax_body({"kind": "compression", "mesh": (4, 1), **inp},
                     tmp_path)["calls"]
    for o in outs:
        i = o["index"]
        assert o["refused"]
        assert len(o["calls"]) == len(want) == CALLS
        for got, w in zip(o["calls"], want):
            assert got["collectives"]["shift"] == 2 * (4 - 1) * len(LEAVES)
            for k, (_, dtype) in LEAVES.items():
                assert got["dtypes"][k] == f"torch.{dtype}"
                assert w["dtypes"][k] == dtype
                _same(got["synced"][k], w["synced"][k][i])
                _same(got["residual"][k], w["residual"][k][i])
