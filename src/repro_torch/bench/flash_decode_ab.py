"""Flash-decode on the card, for holding one checkout's kernels against
another's in one call: the shapes of its earlier rows (``PERF.md`` §6)
and, with ``--groups``, shapes past 8 query heads per KV head and head
dim 8, which only a checkout with head groups runs.

Run the file from the root of each checkout in turns (A, B, B, A): it
imports the ``repro_torch`` of the directory it runs in, and builds that
checkout's kernels.

    cd <checkout> && python3 <this file> <label> [--groups]

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("label")
    ap.add_argument("--groups", action="store_true",
                    help="also the shapes that need head groups")
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
    times, prof = {}, {}
    for name, b, s, h, kv, d in ROWS + (GROUP_ROWS if args.groups else ()):
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


if __name__ == "__main__":
    main()
