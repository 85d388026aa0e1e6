"""The checkpoint of a planned train state against the JAX package's
elastic restore, on gloo ranks (ROADMAP.md item 11g).

Reduced phi4-mini (FSDP over ``data`` and ``model``, the sequence over
``model``) and reduced mamba2 (width-TP over ``model``, FSDP over
``data``) in f32 on ``PRNGKey(2)`` weights through ``bridge.py``, three
token batches (4, 33), AdamW lr 1e-3 with warmup 2, under
``make_plan(cfg, mesh, "train", global_batch=4)``.  The JAX side is one
subprocess on 8 host devices (``tests/sharded_body_jax.py``, kind
``checkpoint``), the port's one spawn of 8 ranks
(``tests/torch_dist_ranks.py::case_checkpoint``); both run once a
session, shared by the xdist workers through a file lock.

(a) Saved at step 2 on the (2, 4) mesh (async; each leaf gathered whole
once, rank 0 writing every file and no other rank any), restored onto the
same mesh and stepped: the third step's parameters, m and v bit for bit.
(b) Restored onto (1, 8), (4, 2) and without a plan: every rank's pieces
before the step ``shard_tensor`` of the saved whole bit for bit, and after
it within rel 2e-4 of the same pieces of the uninterrupted step, the
gradient norm within rel 1e-5 (the limits of
``test_planned_step_updates_pieces_as_the_unplanned_step``).  (c) The
planned save's files and manifest byte for byte an unplanned save of the
gathered state.  (d) The JAX package's planned checkpoint of one step,
restored through ``shardings=`` onto the (1, 8) plan and stepped, against
the port's restore of the same directory onto its (1, 8) plan and the
same step: the parameters gathered whole within ``test_planned_grads_
match_jax``'s limits (worst leaf max |d| / max |g| 5e-3, ||d||_2 / ||g||_2
2e-4); the JAX manager restores the port's planned checkpoint bit for
bit.  (e) ``FaultTolerantLoop.run_with_restarts`` on (2, 4): 6 steps, a
checkpoint every 3, a crash at step 4; every rank resumes from step 3 and
ends bit for bit where 6 steps without a crash end.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro_torch import bridge  # noqa: E402
from tests import torch_dist_ranks as ranks  # noqa: E402
from tests.test_torch_train_plan import _max_rel, _rel, _shared  # noqa: E402

SPAWN_TIMEOUT = 240.0   # seconds a spawn's ranks may take
BODY = Path(__file__).resolve().parent / "sharded_body_jax.py"
ARCHS = ("phi4_mini_3p8b", "mamba2_2p7b")


def _jax_checkpoint(workdir):
    inp = {"kind": "checkpoint", "mesh": (2, 4), "archs": list(ARCHS),
           "dir": str(workdir)}
    src, dst = workdir / "checkpoint_in.pkl", workdir / "checkpoint_out.pkl"
    src.write_bytes(pickle.dumps(inp))
    proc = subprocess.run(
        [sys.executable, str(BODY), str(src), str(dst)], capture_output=True,
        text=True, timeout=SPAWN_TIMEOUT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return pickle.loads(dst.read_bytes())


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    return _shared(tmp_path_factory, "checkpoint_plan_jax", _jax_checkpoint)


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory, jax_ckpt):
    def make(workdir):
        inp = {"archs": list(ARCHS), "dir": str(workdir),
               "jax": {a: {"params": jax_ckpt[a]["params"],
                           "tokens": jax_ckpt[a]["tokens"],
                           "jax_dir": jax_ckpt[a]["dir"],
                           "jax_state": jax_ckpt[a]["state"]}
                       for a in ARCHS}}
        return ranks.spawn("checkpoint", 8, inp, workdir, SPAWN_TIMEOUT)
    return _shared(tmp_path_factory, "checkpoint_plan_port", make)


def _rank0(outs):
    return next(o for o in outs if o["rank"] == 0)


def _nested(flat):
    """{"a/b": x} -> {"a": {"b": x}}."""
    out = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_save_gathers_each_leaf_and_rank_0_writes(port_ckpt, arch):
    outs = port_ckpt
    n_leaves = len(_rank0(outs)[arch]["saved"])
    for r in outs:
        o = r[arch]["save"]
        c = o["collectives"]
        assert c["all_reduce"] == c["all_gather"] == c["reduce_scatter"] \
            == c["shift"] == 0
        if r["rank"] == 0:
            # one gather a leaf that the plan cuts
            assert c["weight_gather"] == o["cut"] > 0
            assert o["writes"] == n_leaves
            assert ["write_s" in t for t in o["timings"]] == [True]
        else:
            assert o["writes"] == 0
            assert ["write_s" in t for t in o["timings"]] == [False]
    # only rank 0's group of the cut axes gathers; a leaf cut over every
    # axis is gathered by all 8 ranks
    assert max(r[arch]["save"]["collectives"]["weight_gather"]
               for r in outs if r["rank"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_files_are_an_unplanned_save_of_the_whole(port_ckpt, arch):
    planned, unplanned = map(Path, _rank0(port_ckpt)[arch]["dirs"])
    names = sorted(os.listdir(planned))
    assert names == sorted(os.listdir(unplanned))
    assert "manifest.json" in names and "_COMMITTED" in names
    assert len(names) == len(_rank0(port_ckpt)[arch]["saved"]) + 2
    for name in names:
        assert (planned / name).read_bytes() == \
            (unplanned / name).read_bytes(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_manager_restores_the_planned_checkpoint(port_ckpt, arch):
    saved = _rank0(port_ckpt)[arch]["saved"]
    planned = Path(_rank0(port_ckpt)[arch]["dirs"][0])
    got = JaxManager(str(planned.parent)).restore(_nested(saved), 2)
    got = {"/".join(k): v for k, v in _flat_items(got)}
    assert set(got) == set(saved)
    for k, want in saved.items():
        g = np.asarray(got[k])
        assert g.dtype == want.dtype and g.shape == want.shape, k
        assert g.tobytes() == want.tobytes(), k


def _flat_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_items(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_the_saving_mesh_steps_bitwise(port_ckpt, arch):
    for r in port_ckpt:
        assert r[arch]["same_mesh"] == {"before": [], "after": []}


@pytest.mark.parametrize("mesh", ["1x8", "4x2", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_restore_onto_another_mesh_steps_as_the_saving_one(port_ckpt, arch,
                                                           mesh):
    outs = [r for r in port_ckpt if mesh in r[arch]]
    assert len(outs) == (1 if mesh == "none" else 8)
    for r in outs:
        o = r[arch][mesh]
        assert o["before"] == []
        assert o["step"] == 3
        assert abs(o["grad_norm"] - o["want_grad_norm"]) <= \
            1e-5 * o["want_grad_norm"]
        assert o["params"] <= 2e-4 and o["moments"] <= 2e-4, o


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_resumes_on_the_port_plan(jax_ckpt, port_ckpt, arch):
    want = jax_ckpt[arch]
    for r in port_ckpt:
        o = r[arch]["from_jax"]
        for key in ("loss", "grad_norm"):
            assert abs(o[key] - want[key]) <= 1e-5 * abs(want[key]), key
    second = bridge.named_leaves(want["second"])
    got = _rank0(port_ckpt)[arch]["from_jax"]["params"]
    assert set(got) == set(second)
    worst = max((_max_rel(g, second[n]), n) for n, g in got.items())
    assert worst[0] <= 5e-3, worst
    worst = max((_rel(g, second[n]), n) for n, g in got.items())
    assert worst[0] <= 2e-4, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_planned_loop_resumes_every_rank_bitwise(port_ckpt, arch):
    for r in port_ckpt:
        o = r[arch]["loop"]
        assert (o["resumed_from"], o["restarts"], o["step"]) == (3, 1, 6)
        assert o["differ"] == []
    assert _rank0(port_ckpt)[arch]["loop"]["committed"] == [3, 6]
