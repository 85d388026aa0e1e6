"""Flash-decode on the card, for holding one checkout's kernels against
another's in one call: the shapes of its earlier rows (``PERF.md`` §6)
and, with ``--groups``, shapes past 8 query heads per KV head and head
dim 8, which only a checkout with head groups runs.

Run the file from the root of each checkout in turns (A, B, B, A): it
imports the ``repro_torch`` of the directory it runs in, and builds that
checkout's kernels.

    cd <checkout> && python3 <this file> <label> [--groups]

With ``--d256`` it also times the head-dim-256 shapes of the dry-run's
decode cells and the served caches (``D256_ROWS``: gemma3-1b's 4 heads
and recurrentgemma-9b's 16 on 1 KV head, B 1 to 128, S 512 to 524288),
the int8 mode at gemma3-1b ``decode_32k``'s global shape, and prints a
third line, ``D256 <label> {...}``: each of those rows' bound (µs,
``kernels.cost.flash_decode_cost`` over 3.35 TB/s) and SDPA's µs on
head-major bf16 copies of the same input sets (for the int8 row: over
the bf16 cache it was quantized from).  SDPA is a yardstick only; the
port never calls it.

With ``--sweep`` it times instead each of ``D256_ROWS`` over split plans
of n_splits from 1 to as many as the shape has tiles (``SWEEP_SPLITS``,
chunks of whole 32-position tiles, the plan forced in place of
``split_plan_d256``) and prints one line a shape, ``SWEEP <label> <name>
{plan: [µs a call, split µs, combine µs]}``, the kernels' µs from the
profiler under replay: what ``split_plan_d256`` was chosen from.

Prints two lines.  ``AB <label> {...}``: µs a call, CUDA-graph replay of
32 or more calls cycling over input copies that outgrow the 50 MB L2,
timed with CUDA events; bf16, B 8, every position attended; ``*_int8``
the int8 mode on ``quantize_kv`` of the same K/V, ``*_fused`` the fused
kernel with a rank-8 delta from 4 adapters.  ``PROF <label> {...}``: at
phi4-mini's and olmoe-1b-7b's shapes, the µs a call of the replayed
graph (CUDA events) and each kernel's mean device time under replay
(``torch.profiler``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

# (name, B, S, H, KV, D): phi4-mini's serving shape, gemma3-1b's,
# olmoe-1b-7b's, and 8 heads of 256 on 1 KV head at 512 and 2048 rows
ROWS = (("serving", 8, 512, 24, 8, 128), ("gemma3", 8, 512, 4, 1, 256),
        ("olmoe", 8, 512, 16, 16, 128), ("g8_d256_s512", 8, 512, 8, 1, 256),
        ("g8_d256_s2048", 8, 2048, 8, 1, 256))
# past 8 heads a KV head (recurrentgemma-9b's 16 on 1 at 512 and 2048
# rows, a group of 12) and head dim 8
GROUP_ROWS = (("g16_d256_s512", 8, 512, 16, 1, 256),
              ("g16_d256_s2048", 8, 2048, 16, 1, 256),
              ("g24_kv2_d128_s512", 8, 512, 24, 2, 128),
              ("d8_h8_kv2_s512", 8, 512, 8, 2, 8))
# head dim 256 (the bf16 tensor-core pass at D 256): the dry-run's
# decode cells (recurrentgemma-9b 16 heads over 2048 rows at B 128 and 1;
# gemma3-1b's local and global layers at B 128, its 524288 rows at B 1),
# recurrentgemma-9b's 2048-row window at B 8 and the two served caches
D256_ROWS = (("rg_b128_s2048", 128, 2048, 16, 1, 256),
             ("rg_b1_s2048", 1, 2048, 16, 1, 256),
             ("rg_b8_s2048", 8, 2048, 16, 1, 256),
             ("g3_b128_s512", 128, 512, 4, 1, 256),
             ("g3_b128_s32768", 128, 32768, 4, 1, 256),
             ("g3_b1_s524288", 1, 524288, 4, 1, 256),
             ("g3_b8_s512", 8, 512, 4, 1, 256),
             ("rg_b8_s512", 8, 512, 16, 1, 256))
D256_INT8 = ("g3_b128_s32768",)   # the int8 mode's row (phase 14b's path)
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 132, 198, 264,
                396, 528)
HBM_BYTES_PER_S = 3.35e12
INT8 = ("serving", "gemma3")
FUSED = ("serving", "g16_d256_s512", "g16_d256_s2048")
PROFILED = ("serving", "olmoe")


def graph_us(fn, sets, calls=32, reps=5):
    """µs a call: ``calls`` (at least one per set) captured in a CUDA graph,
    replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    n = max(calls, len(sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n) * 1e3, graph, n


def kernel_us(graph, n, reps=5):
    """Each flash-decode kernel's mean device µs over ``reps`` replays of
    ``graph`` (``n`` calls), from the profiler."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in ("split", "combine", "shrink") if k in e.name),
                   "other")
        out.setdefault(key, []).append(e.time_range.end - e.time_range.start)
    return {k: sum(v) / len(v) for k, v in out.items()}


D256_NAMES = {r[0] for r in D256_ROWS}


def d256_row(name, b, s, h, kv, d, normal, yard):
    """One of ``D256_ROWS``: the port's µs (and the int8 mode's, for
    ``D256_INT8``), as ``times`` keys; its bound and SDPA's µs into
    ``yard``.  Large caches get one input set, copies of the rest fill
    about 100 MB."""
    import torch.nn.functional as F
    from repro_torch.kernels import cost
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import quantize_kv
    out = {}
    copies = max(1, min(64, math.ceil(1e8 / (2 * b * s * kv * d * 2))))
    sets = [(normal(b, h, d), normal(b, s, kv, d), normal(b, s, kv, d), s)
            for _ in range(copies)]
    big = 2 * b * s * kv * d * 2 > 2e8   # fewer calls a graph
    calls = 4 if big else 32
    out[name] = graph_us(fd.flash_decode, sets, calls=calls)[0]
    yard[name + "_bound"] = cost.flash_decode_cost(b, s, h, kv, d)[1] \
        / HBM_BYTES_PER_S * 1e6
    lib = [(q[:, :, None], k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous()) for q, k, v, _ in sets]
    yard[name + "_sdpa"] = graph_us(
        lambda qq, kk, vv: F.scaled_dot_product_attention(
            qq, kk, vv, enable_gqa=True), lib, calls=calls)[0]
    del lib
    torch.cuda.empty_cache()
    if name in D256_INT8:
        int8 = []
        for q, k, v, length in sets:
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            int8.append((q, k8, v8, length, ks, vs))
        del sets
        torch.cuda.empty_cache()
        out[name + "_int8"] = graph_us(fd.flash_decode, int8, calls=calls)[0]
        yard[name + "_int8_bound"] = cost.flash_decode_cost(
            b, s, h, kv, d, kv_bytes=1, scale_bytes=2)[1] \
            / HBM_BYTES_PER_S * 1e6
        del int8
    torch.cuda.empty_cache()
    return out


def sweep(label, normal) -> None:
    """``--sweep``: each of ``D256_ROWS`` over the plans of
    ``SWEEP_SPLITS`` (and the wrapper's own), one ``SWEEP`` line a
    shape."""
    from repro_torch.kernels import flash_decode as fd
    tile = fd.tile_positions(256, 2)
    chosen = fd.split_plan_d256
    for name, b, s, h, kv, d in D256_ROWS:
        copies = max(1, min(64, math.ceil(1e8 / (2 * b * s * kv * d * 2))))
        sets = [(normal(b, h, d), normal(b, s, kv, d), normal(b, s, kv, d),
                 s) for _ in range(copies)]
        calls = 4 if 2 * b * s * kv * d * 2 > 2e8 else 32
        n_tiles = -(-s // tile)
        own = chosen(b, kv * fd.head_groups(h // kv, fd.MMA256_GROUP), s,
                     torch.cuda.get_device_properties(0).multi_processor_count,
                     tile)
        res = {"plan": "%dx%d" % own}
        for n in sorted({n for n in SWEEP_SPLITS if n <= n_tiles} |
                        {own[0]}):
            chunk = -(-n_tiles // n) * tile
            plan = (-(-s // chunk), chunk)
            fd.split_plan_d256 = lambda *a, _p=plan, **k: _p
            try:
                t, graph, nc = graph_us(fd.flash_decode, sets, calls=calls)
                kt = kernel_us(graph, nc)
            finally:
                fd.split_plan_d256 = chosen
            res["%dx%d" % plan] = [round(t, 2), round(kt.get("split", 0), 2),
                                   round(kt.get("combine", 0), 2)]
            del graph
        print("SWEEP", label, name, json.dumps(res), flush=True)
        del sets
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label")
    ap.add_argument("--groups", action="store_true",
                    help="also the shapes that need head groups")
    ap.add_argument("--d256", action="store_true",
                    help="also the head-dim-256 shapes, their bounds and "
                         "SDPA's times")
    ap.add_argument("--sweep", action="store_true",
                    help="only the head-dim-256 shapes over split plans")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import quantize_kv
    build.kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    if args.sweep:
        sweep(args.label, normal)
        return
    times, prof, d256 = {}, {}, {}
    for name, b, s, h, kv, d in ROWS + (GROUP_ROWS if args.groups else ()) \
            + (D256_ROWS if args.d256 else ()):
        if name in D256_NAMES:
            times.update(d256_row(name, b, s, h, kv, d, normal, d256))
            continue
        copies = max(1, min(64, math.ceil(1e8 / (2 * b * s * kv * d * 2))))
        sets = [(normal(b, h, d), normal(b, s, kv, d), normal(b, s, kv, d),
                 s) for _ in range(copies)]
        times[name], graph, n = graph_us(fd.flash_decode, sets)
        if name in PROFILED:
            prof[name] = {"call": times[name], **kernel_us(graph, n)}
        del graph
        if name in INT8:
            int8 = []
            for q, k, v, length in sets:
                (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
                int8.append((q, k8, v8, length, ks, vs))
            times[name + "_int8"] = graph_us(fd.flash_decode, int8)[0]
            del int8
        if name in FUSED:
            n_ad, dx = 4, 3072 if name == "serving" else 4096
            ids = (torch.arange(b, device="cuda") % n_ad).to(torch.int32)
            fused = [(q, k, v, length, normal(b, dx),
                      normal(n_ad, dx, 8) * dx ** -0.5,
                      normal(n_ad, 8, h * d) * 0.3, ids)
                     for q, k, v, length in sets]
            times[name + "_fused"] = graph_us(fd.flash_decode_lora, fused)[0]
            del fused
        del sets
        torch.cuda.empty_cache()
    print("AB", args.label, json.dumps({k: round(v, 3)
                                        for k, v in times.items()}))
    print("PROF", args.label, json.dumps(
        {k: {n: round(t, 3) for n, t in v.items()} for k, v in prof.items()}),
        flush=True)
    if args.d256:
        print("D256", args.label, json.dumps(
            {k: round(v, 3) for k, v in d256.items()}), flush=True)


if __name__ == "__main__":
    main()
