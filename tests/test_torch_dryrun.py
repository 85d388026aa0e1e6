"""The port's dry-run (``repro_torch.launch.dryrun``, ``roofline``,
``hillclimb``) on the CPU, held to the JAX package's where the two share
arithmetic.

* Ports of tests/test_dryrun_units.py: ``probe_depths`` for every
  architecture, equal to the JAX function's; ``CellCost.extrapolate``;
  ``RooflineTerms`` at the H100's rates (the JAX test's inputs rescaled
  to them); ``model_flops_for`` positive and ordered; and, in place of the
  compile of a reduced cell on a (2, 2) placeholder mesh, a reduced cell
  of each step kind through ``run_cell`` as rank 0 of a (2, 2) mesh on
  ``meta``.  The HLO collective parser has no counterpart: the port
  counts the bytes of the collectives it issues itself
  (``sharding.COLLECTIVE_BYTES``), so there is no text to parse.
* Each block family (dense global attention, local+global, MoE, SSM,
  hybrid) at reduced widths and 3 pattern repeats: the probes'
  extrapolation equals the direct full-depth count exactly, FLOPs, bytes
  and every collective kind, for each step kind.
* Each kernel wrapper on ``meta``: outputs of its plain version's shapes
  and dtypes, its call counted at its formula, no launch counted.
* A reduced FSDP train cell's all-gather operand bytes against the figure
  the plan's specs give, with and without ``remat``.
* ``kv_int8`` lowers a decode cell's cache bytes a device to what
  ``cell_bytes`` gives; a rank's planned bundle holds the bytes a device
  ``cell_bytes`` gives its cell.
* The launchers' command lines at full size (a decode cell, ~5 s each).

The fake process group lives inside ``meta_mesh``, so none outlives a
test.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.roofline import CellCost as JaxCellCost  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.kernels import (bgmv, cost, flash_decode, ops,  # noqa: E402
                                 sgmv)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshShape, meta_mesh  # noqa: E402
from repro_torch.launch.roofline import (HBM_BW, LINK_BW,  # noqa: E402
                                         PEAK_FLOPS, CellCost, RooflineTerms,
                                         model_flops_for)
from repro_torch.launch.steps import (arg_bytes, build_step,  # noqa: E402
                                      cell_bytes)
from repro_torch.models import SHAPES, Model, ShapeConfig  # noqa: E402
from repro_torch.models.sharding import local_shape, make_plan  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESH = MeshShape((2, 2), ("data", "model"))
SMALL = {"train": ShapeConfig("train_t", 64, 4, "train"),
         "prefill": ShapeConfig("prefill_t", 64, 4, "prefill"),
         "decode": ShapeConfig("decode_t", 64, 4, "decode")}
FAMILIES = {"global": "phi4_mini_3p8b", "local+global": "gemma3_1b",
            "moe": "olmoe_1b_7b", "ssd": "mamba2_2p7b",
            "rglru+local": "recurrentgemma_9b"}


def _jax_probe_depths():
    """``repro.launch.dryrun.probe_depths``; importing the module sets
    XLA_FLAGS to 512 host devices, undone here."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import probe_depths
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return probe_depths


@pytest.fixture
def cells(monkeypatch):
    """``use(cfgs)`` makes ``run_cell`` read ``cfgs[arch]`` and the small
    shapes of ``SMALL`` (by their names) in place of the published ones."""
    shapes = {s.name: s for s in SMALL.values()}

    def use(cfgs):
        monkeypatch.setattr(dryrun, "get_config", cfgs.__getitem__)
        monkeypatch.setattr(dryrun, "SHAPES", shapes)
        monkeypatch.setattr(dryrun, "applicable_shapes",
                            lambda cfg: list(shapes.values()))
    return use


def _deep(arch, repeats=3):
    """The reduced config (bf16) at ``repeats`` block-pattern repeats plus
    its remainder (or 1 layer of remainder past a longer pattern)."""
    cfg = get_reduced(arch)
    plen = len(cfg.block_pattern)
    rem = cfg.n_layers % plen or (1 if plen > 1 else 0)
    return dataclasses.replace(cfg, n_layers=repeats * plen + rem)


# --------------------------------------------------------------------------- #
# ports of tests/test_dryrun_units.py
# --------------------------------------------------------------------------- #

def test_probe_depths_exact_for_all_archs():
    jax_probe_depths = _jax_probe_depths()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        pd = dryrun.probe_depths(cfg)
        assert pd == jax_probe_depths(jax_config(arch))
        plen = len(cfg.block_pattern)
        # probe2 - probe1 == exactly one pattern repeat
        assert pd["probe2"] - pd["probe1"] == plen
        # extrapolation reconstructs the full depth
        assert pd["probe1"] + pd["extra_repeats"] * plen == cfg.n_layers


def test_cell_cost_extrapolation_linear():
    args = ((10.0, 100.0, {"all-gather": 4, "total": 4}),
            (16.0, 130.0, {"all-gather": 6, "total": 6}))
    c1, c2 = (CellCost(*a) for a in args)
    full = c1.extrapolate(c2, extra_repeats=10)
    assert full.flops == 10 + 10 * 6
    assert full.bytes_accessed == 100 + 10 * 30
    assert full.coll["all-gather"] == 4 + 10 * 2
    j1, j2 = (JaxCellCost(*a) for a in args)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        j1.extrapolate(j2, extra_repeats=10))


def test_roofline_terms_and_bottleneck():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)
    cost = CellCost(flops=PEAK_FLOPS, bytes_accessed=HBM_BW * 2,
                    coll={"total": LINK_BW * 3})
    t = RooflineTerms.from_cost(cost, n_chips=4, model_flops=4 * PEAK_FLOPS)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 2.0) < 1e-9
    assert abs(t.collective_s - 3.0) < 1e-9
    assert t.bottleneck == "collective"
    assert 0 < t.roofline_fraction <= 1.0


def test_model_flops_positive_and_ordered():
    cfg = get_config("internlm2_20b")
    f_train = model_flops_for(cfg, SHAPES["train_4k"])
    f_dec = model_flops_for(cfg, SHAPES["decode_32k"])
    assert f_train > f_dec > 0


@pytest.mark.parametrize("kind", list(SMALL))
def test_reduced_cell_counts_on_small_mesh(cells, kind):
    cells({"gemma3_1b": get_reduced("gemma3_1b")})
    rec = dryrun.run_cell("gemma3_1b", SMALL[kind].name, False, mesh=MESH)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == {"data": 2, "model": 2}
    mem, cost_ = rec["memory"], rec["cost"]
    assert mem["total_bytes_per_device"] > mem["argument_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] > 0
    assert cost_["flops_per_chip"] > 0 and cost_["bytes_per_chip"] > 0
    assert cost_["collectives"]["total"] == sum(
        v for k, v in cost_["collectives"].items() if k != "total") > 0
    r = rec["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"]) > 0
    assert r["hlo_flops_global"] == 4 * cost_["flops_per_chip"]
    # the kernels each step kind runs: SGMV in the prefill, BGMV and
    # flash-decode's log-sum-exp mode on the sequence-sharded cache in
    # decode, none in training
    want = {"train": set(), "prefill": {"sgmv"},
            "decode": {"bgmv", "flash_decode_lse", "flash_decode"}}[kind]
    assert set(rec["kernel_calls"]) == want


# --------------------------------------------------------------------------- #
# the probes against the direct count
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_probe_extrapolation_equals_full_count(cells, family, kind):
    arch = FAMILIES[family]
    cfg = _deep(arch)
    pd = dryrun.probe_depths(cfg)
    assert pd["extra_repeats"] == 2
    cells({arch: cfg})
    rec = dryrun.run_cell(arch, SMALL[kind].name, False, mesh=MESH)
    assert rec["ok"], rec.get("traceback")
    # run_cell fails a cell where they differ; held here key by key
    assert rec["cost"]["flops_per_chip"] == rec["cost_full"]["flops_per_chip"]
    assert rec["cost"]["bytes_per_chip"] == rec["cost_full"]["bytes_per_chip"]
    assert rec["cost"]["collectives"] == rec["cost_full"]["collectives"]
    assert set(rec["cost"]["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute", "total"}


def test_run_cell_fails_where_the_probes_disagree(cells, monkeypatch):
    arch = "phi4_mini_3p8b"
    cells({arch: _deep(arch)})
    real = dryrun.probe_depths
    monkeypatch.setattr(dryrun, "probe_depths", lambda cfg: {
        **real(cfg), "extra_repeats": real(cfg)["extra_repeats"] + 1})
    rec = dryrun.run_cell(arch, "decode_t", False, mesh=MESH)
    assert not rec["ok"] and "differs from the full-depth count" in \
        rec["error"]


# --------------------------------------------------------------------------- #
# the kernels on meta
# --------------------------------------------------------------------------- #

def _meta(*tensors):
    return [t.to("meta") for t in tensors]


def _kernel_cases():
    g = torch.Generator().manual_seed(5)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)
    t, d, r, o, n = 8, 32, 8, 48, 4
    x, a, b = normal(t, d), normal(n, d, r), normal(n, r, o)
    idx = torch.tensor([0, 1, -1, 3, 2, 0, 1, 3], dtype=torch.int32)
    ts = 40                      # an SGMV-sized token count (> 4 N)
    xs = normal(ts, d)
    ids = torch.randint(-1, n, (ts,), generator=g, dtype=torch.int32)
    bsz, s, h, kv, hd = 2, 32, 4, 2, 16
    q, k, v = normal(bsz, h, hd), normal(bsz, s, kv, hd), \
        normal(bsz, s, kv, hd)
    k8 = torch.randint(-127, 128, (bsz, s, kv, hd), generator=g,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (bsz, s, kv, hd), generator=g,
                       dtype=torch.int8)
    ks, vs = (torch.rand((bsz, s, kv), generator=g).half() for _ in "kv")
    length = torch.tensor([s, 5], dtype=torch.int32)
    xf, af, bf = normal(bsz, d), normal(n, d, r), normal(n, r, h * hd)
    fid = torch.tensor([1, -1], dtype=torch.int32)
    es = 2
    fd_flops = 4 * (h // kv) * bsz * s * kv * hd
    fd_bytes = 2 * bsz * h * hd * es + 2 * bsz * s * kv * hd * es + 4 * bsz
    lora = (2 * t * r * (d + o),
            t * (d + o) * es + min(t, n) * r * (d + o) * es + 4 * t)
    return {
        "bgmv": (bgmv.bgmv, (x, a, b, idx), lora),
        "sgmv": (sgmv.sgmv, (xs, a, b, ids),
                 (2 * ts * r * (d + o), ts * (d + o) * es
                  + n * r * (d + o) * es + 4 * ts)),
        "flash_decode": (flash_decode.flash_decode, (q, k, v, length),
                         (fd_flops, fd_bytes)),
        "flash_decode_int8": (
            flash_decode.flash_decode, (q, k8, v8, length, ks, vs),
            (fd_flops, 2 * bsz * h * hd * es + 2 * bsz * s * kv * (hd + 2)
             + 4 * bsz)),
        "flash_decode_lse": (
            flash_decode.flash_decode_lse, (q, k, v, length),
            (fd_flops, bsz * h * hd * (es + 4) + 2 * bsz * s * kv * hd * es
             + 4 * bsz + 4 * bsz * h)),
        "flash_decode_lora": (
            flash_decode.flash_decode_lora, (q, k, v, length, xf, af, bf,
                                             fid),
            (fd_flops + 2 * bsz * r * (d + h * hd),
             fd_bytes + bsz * d * es + min(bsz, n) * r * (d + h * hd) * es
             + 4 * bsz)),
    }


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_kernel_on_meta_shapes_and_cost(name):
    fn, args, (flops, nbytes) = _kernel_cases()[name]
    want = fn(*args)                       # the plain version, on the CPU
    ops.reset_launches()
    with cost.counting() as c:
        got = fn(*_meta(*args))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(w.shape, w.dtype) for w in want] == \
        [(t.shape, t.dtype) for t in got]
    assert all(t.is_meta for t in got)
    wrapper = name.removesuffix("_int8")
    assert c.calls == {wrapper: 1}
    assert (c.flops, c.bytes) == (flops, nbytes)


@pytest.mark.parametrize("tokens,kernel", [(8, "bgmv"), (40, "sgmv")])
def test_lora_apply_on_meta_picks_the_kernel(tokens, kernel):
    x = torch.empty(tokens, 32, dtype=torch.bfloat16, device="meta")
    a = torch.empty(4, 32, 8, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 8, 16, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(tokens, dtype=torch.int32, device="meta")
    with cost.counting() as c:
        y = ops.lora_apply(x, a, b, idx)
    assert (y.shape, y.dtype, y.is_meta) == ((tokens, 16), x.dtype, True)
    assert c.calls == {kernel: 1}


def test_kernel_on_meta_still_checks_its_inputs():
    x, a, b = (torch.empty(s, device="meta", dtype=torch.bfloat16)
               for s in ((8, 32), (4, 32, 8), (4, 8, 16)))
    idx = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(TypeError, match="int32"):
        bgmv.bgmv(x, a, b, idx)
    with pytest.raises(ValueError, match="one CUDA device"):
        bgmv.bgmv(x, a, b, torch.zeros(8, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# collectives, memory and the planned bundle
# --------------------------------------------------------------------------- #

def _gather_operands(shape, spec, plan, itemsize):
    """The operand bytes of ``gather_whole`` of a piece of ``shape`` under
    ``spec``: each cut dimension gathered in turn, the operand of each the
    tensor as gathered so far."""
    piece = list(local_shape(shape, spec, plan))
    total = 0
    for dim, entry in enumerate(spec):
        if entry is not None:
            total += math.prod(piece) * itemsize
            piece[dim] = shape[dim]
    return total


@pytest.mark.parametrize("remat", [False, True])
def test_fsdp_all_gather_bytes_from_the_specs(cells, remat):
    arch = "phi4_mini_3p8b"
    cfg = _deep(arch, repeats=2)
    cells({arch: cfg})
    rec = dryrun.run_cell(arch, "train_t", False, mesh=MESH, probes=False,
                          plan_overrides={"remat": remat})
    assert rec["ok"], rec.get("traceback")
    # worked out from the plan's specs: every weight cut FSDP-style is
    # gathered whole at its use, a layer's once in the forward and again
    # in the recompute with remat, the embedding in the trunk and the
    # unembedding in the loss (one chunk of logits here) once
    plan = make_plan(cfg, MESH, "train", global_batch=4, remat=remat)
    whole = dict(Model(cfg, device="meta").named_parameters())
    want = 0
    for name, spec in plan.param_specs(whole).items():
        t = whole[name]
        uses = (2 if remat else 1) if name.startswith("layers.") else 1
        want += uses * _gather_operands(t.shape, spec, plan,
                                        t.element_size())
    assert not cfg.tie_embeddings
    assert rec["cost_full"]["collectives"]["all-gather"] == want


def test_kv_int8_lowers_decode_cache_bytes(cells):
    arch = "phi4_mini_3p8b"
    cfg = get_reduced(arch)
    cells({arch: cfg})
    shape = SMALL["decode"]
    cache = {}
    for variant, over in (("baseline", None), ("kv_int8",
                                               {"kv_quant": True})):
        rec = dryrun.run_cell(arch, shape.name, False, mesh=MESH,
                              probes=False, plan_overrides=over)
        assert rec["ok"], rec.get("traceback")
        want = cell_bytes(build_step(cfg, shape, MESH, plan_overrides=over))
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == want["total"]
        # the cache is the donated argument, updated in place
        assert mem["alias_size_in_bytes"] == want["cache"]
        cache[variant] = want["cache"]
    # (B, S, KV, D) bf16 K and V against int8 with (B, S, KV) f16 scales,
    # beside the int32 position
    hd = cfg.resolved_head_dim
    kv = {k: n - 4 for k, n in cache.items()}
    assert kv["kv_int8"] * 2 * hd == kv["baseline"] * (hd + 2)


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("arch", ["gemma3_1b", "mamba2_2p7b"])
def test_planned_bundle_holds_a_device_s_bytes(arch, kind):
    cfg = get_reduced(arch)
    want = cell_bytes(build_step(cfg, SMALL[kind], MESH))
    with meta_mesh(MESH) as mesh:
        b = build_step(cfg, SMALL[kind], mesh, planned=True)
        assert cell_bytes(b) == want
        assert sum(arg_bytes(b)) == want["total"]
        assert b.model.plan is not None
        assert all(p.is_meta for p in b.model.parameters())


def test_no_mesh_cell_counts_the_whole_step(cells):
    cells({"gemma3_1b": get_reduced("gemma3_1b")})
    rec = dryrun.run_cell("gemma3_1b", "decode_t", False,
                          mesh=dryrun.NO_MESH)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == {}
    assert rec["cost"]["collectives"]["total"] == 0
    want = cell_bytes(build_step(get_reduced("gemma3_1b"), SMALL["decode"],
                                 None))
    assert rec["memory"]["argument_size_in_bytes"] == want["total"]
    assert rec["roofline"]["hlo_flops_global"] == \
        rec["cost"]["flops_per_chip"]


def test_no_probes_roofline_is_the_full_count(cells):
    cells({"gemma3_1b": get_reduced("gemma3_1b")})
    both = dryrun.run_cell("gemma3_1b", "prefill_t", False, mesh=MESH)
    rec = dryrun.run_cell("gemma3_1b", "prefill_t", False, mesh=MESH,
                          probes=False)
    assert both["ok"] and rec["ok"], rec.get("traceback")
    assert rec["cost"] == rec["cost_full"] == both["cost"]
    assert rec["roofline"] == both["roofline"]
    only = dryrun.run_cell("gemma3_1b", "prefill_t", False, mesh=MESH,
                           full=False)
    assert only["ok"] and "memory" not in only and "cost_full" not in only
    assert only["cost"] == both["cost"]


def test_meta_mesh_destroys_its_group_on_error():
    import torch.distributed as dist
    with pytest.raises(KeyError):
        with meta_mesh(MESH) as mesh:
            assert dist.get_world_size() == 4 and mesh.size() == 4
            raise KeyError("inside")
    assert not dist.is_initialized()


def test_attn_batch_train_cell_fails_naming_item_11e(cells):
    cells({"phi4_mini_3p8b": get_reduced("phi4_mini_3p8b")})
    rec = dryrun.run_cell("phi4_mini_3p8b", "train_t", False, mesh=MESH,
                          plan_overrides={"attn_batch_shard": True})
    assert not rec["ok"] and "item 11e" in rec["error"]


# --------------------------------------------------------------------------- #
# the launchers' command lines
# --------------------------------------------------------------------------- #

def _run(module, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_dryrun_cli_one_cell(tmp_path):
    out = tmp_path / "dry.jsonl"
    proc = _run("repro_torch.launch.dryrun", "--arch", "gemma3-1b",
                "--shape", "decode_32k", "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "mesh: {'data': 16, 'model': 16} (256 chips)"
    assert lines[1].startswith("OK  gemma3_1b:decode_32k:pod1 mem/dev=")
    assert lines[-1] == "1/1 cells OK"
    rec = json.loads(out.read_text())
    assert rec["cost"] == rec["cost_full"]


def test_hillclimb_cli_kv_int8(tmp_path):
    out = tmp_path / "hc.jsonl"
    proc = _run("repro_torch.launch.hillclimb", "--cell",
                "phi4_mini_3p8b:decode_32k", "--variant", "kv_int8",
                "--out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK  phi4_mini_3p8b:decode_32k [kv_int8]")
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["variant"] == "kv_int8"
    assert {"memory", "cost", "roofline"} <= set(rec)
    assert np.isfinite(rec["roofline"]["step_time_s"])
