"""Multi-pod dry-run of the port (counterpart of ``repro.launch.dryrun``):
count every (architecture x input-shape x mesh) cell as one chip of the
production mesh runs it, and its roofline terms at the H100's rates.

Per cell, on the ``meta`` device (nothing allocated), as rank 0 of the
mesh (``launch.mesh.meta_mesh``: a process group that moves nothing):
  1. FULL: the step at full depth, built under the cell's plan and run
     once under ``roofline.cost_of_step``: the memory report (the keys of
     XLA's ``memory_analysis``) and the direct full-depth count.
  2. Two PROBES at reduced depth (one and two block-pattern repeats plus
     the remainder), counted the same way and extrapolated linearly to full
     depth (``CellCost.extrapolate``), as the JAX dry-run does.  Eager
     counting sees every layer, so the extrapolation must equal the direct
     count: a cell where it does not fails.  Without the probes
     (``--no-probes``) the roofline is that of the direct count.

Usage:
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --multi-pod --out dry.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from typing import Any, Dict

from ..configs import ARCH_IDS, canonical, get_config
from ..models import SHAPES, applicable_shapes
from .mesh import MeshShape, meta_mesh, production_shape
from .roofline import RooflineTerms, cost_of_step, model_flops_for
from .steps import arg_bytes, build_step, cell_bytes, cell_id

#: ``run_cell(mesh=NO_MESH)``: the cell whole on one device, without a plan
NO_MESH = MeshShape((), ())


def probe_depths(cfg) -> Dict[str, int]:
    plen = len(cfg.block_pattern)
    rem = cfg.n_layers % plen
    full_repeats = cfg.n_layers // plen
    return {"probe1": plen + rem, "probe2": 2 * plen + rem,
            "extra_repeats": full_repeats - 1}


def memory_report(bundle, live) -> Dict[str, float]:
    """The keys of the JAX ``_memory_report`` (dryrun.py:50-68) for a
    counted step (``live``, ``cost_of_step``'s ``memory``): the arguments'
    bytes a device (``cell_bytes``), its outputs' bytes, its temporaries
    (the peak of the bytes it held beyond its arguments, less the new
    outputs, which that peak also holds), the donated arguments' bytes
    (updated in place, returned as outputs), and the JAX total."""
    sizes = arg_bytes(bundle)
    out = {"argument_size_in_bytes": float(cell_bytes(bundle)["total"]),
           "output_size_in_bytes": float(live["output_bytes"]),
           "temp_size_in_bytes": float(live["peak_bytes"]
                                       - live["output_new_bytes"]),
           "alias_size_in_bytes": float(sum(sizes[i]
                                            for i in bundle.donate))}
    out["total_bytes_per_device"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


def _cost_record(cost) -> Dict[str, Any]:
    return {"flops_per_chip": cost.flops, "bytes_per_chip":
            cost.bytes_accessed, "collectives": cost.coll}


@contextlib.contextmanager
def _cell_mesh(mesh, multi_pod: bool):
    """The mesh a cell is counted on: rank 0 of a ``MeshShape`` (the
    production mesh's by default) under ``meta_mesh``, or None for
    ``NO_MESH``."""
    if mesh is None:
        mesh = production_shape(multi_pod)
    if not mesh.shape:
        yield None
    else:
        with meta_mesh(mesh) as m:
            yield m


def _count(cfg, shape, mesh, plan_overrides, layers=None, memory=None):
    b = build_step(cfg, shape, mesh, unroll=layers is not None,
                   layers_override=layers, plan_overrides=plan_overrides,
                   planned=mesh is not None)
    cost = cost_of_step(b.fn, *b.args, memory=memory)
    return b, cost


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             probes: bool = True, full: bool = True,
             mesh=None, plan_overrides=None) -> Dict[str, Any]:
    """One cell's record: ``cell``, ``ok``, and ``skipped`` (a long cell
    of a full-attention model), or ``memory`` and ``cost_full`` (the
    direct full-depth count; with ``full``), ``cost`` (the probes
    extrapolated, or without ``probes`` the full-depth count) and
    ``roofline`` (of ``cost``, at the H100's rates), or ``error`` and
    ``traceback``.  With both, the extrapolation must equal the direct
    count.

    ``mesh``: None for the production mesh of ``multi_pod``, a
    ``MeshShape`` (counted as rank 0 of it), or ``NO_MESH``: the cell
    whole on one device, without a plan (one chip)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {"cell": cell_id(arch, shape_name, multi_pod),
                           "arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod, "ok": False}
    if shape not in applicable_shapes(cfg):
        rec["skipped"] = ("long_500k needs sub-quadratic attention; "
                          f"{cfg.name} is full-attention (see DESIGN.md)")
        rec["ok"] = True
        return rec
    t0 = time.time()
    try:
        with _cell_mesh(mesh, multi_pod) as m:
            n_chips = 1 if m is None else m.size()
            rec["mesh"] = ({} if m is None else
                           dict(zip(m.mesh_dim_names, m.shape)))
            if full:
                live: Dict[str, Any] = {}
                b, full_cost = _count(cfg, shape, m, plan_overrides,
                                      memory=live)
                rec["memory"] = memory_report(b, live)
                rec["kernel_calls"] = live["kernel_calls"]
                rec["cost_full"] = _cost_record(full_cost)
                rec["full_count_s"] = round(time.time() - t0, 1)
                del b
            cost = full_cost if full else None
            if probes:
                pd = probe_depths(cfg)
                costs = [_count(cfg, shape, m, plan_overrides, layers=d)[1]
                         for d in (pd["probe1"], pd["probe2"])]
                cost = costs[0].extrapolate(costs[1], pd["extra_repeats"])
                if full and _cost_record(cost) != rec["cost_full"]:
                    raise AssertionError(
                        f"the probes' extrapolation {_cost_record(cost)} "
                        f"differs from the full-depth count "
                        f"{rec['cost_full']}")
            if cost is not None:
                rec["cost"] = _cost_record(cost)
                mf = model_flops_for(cfg, shape)
                terms = RooflineTerms.from_cost(cost, n_chips, mf)
                rec["roofline"] = {
                    "compute_s": terms.compute_s,
                    "memory_s": terms.memory_s,
                    "collective_s": terms.collective_s,
                    "bottleneck": terms.bottleneck,
                    "model_flops": mf,
                    "hlo_flops_global": terms.hlo_flops_global,
                    "useful_ratio": terms.useful_ratio,
                    "step_time_s": terms.step_time_s,
                    "roofline_fraction": terms.roofline_fraction,
                }
        rec["ok"] = True
        rec["elapsed_s"] = round(time.time() - t0, 1)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else [canonical(args.arch)]
    mesh = production_shape(args.multi_pod)
    print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"({math.prod(mesh.shape)} chips)")
    records = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in applicable_shapes(cfg)]
                  if args.shape == "all" else [args.shape])
        for shape_name in shapes:
            rec = run_cell(arch, shape_name, args.multi_pod,
                           probes=not args.no_probes,
                           full=not args.no_full, mesh=mesh)
            records.append(rec)
            status = "OK " if rec["ok"] else "FAIL"
            extra = ""
            if "memory" in rec:
                extra += (f" mem/dev={rec['memory'].get('total_bytes_per_device', 0) / 2 ** 30:.2f}GiB")
            if "roofline" in rec:
                r = rec["roofline"]
                extra += (f" terms(c/m/t)={r['compute_s']:.3e}/"
                          f"{r['memory_s']:.3e}/{r['collective_s']:.3e}"
                          f" bottleneck={r['bottleneck']}")
            if "skipped" in rec:
                extra = " SKIP: " + rec["skipped"][:60]
            if "error" in rec:
                extra = " ERR: " + rec["error"][:160]
            print(f"{status} {rec['cell']}{extra}", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["ok"] for r in records)
    print(f"{n_ok}/{len(records)} cells OK")
    if n_ok < len(records):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
