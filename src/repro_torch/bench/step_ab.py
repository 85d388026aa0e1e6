"""Served decode steps and the training step on the card, for holding one
checkout against another in one session: ``chip_smoke.py``'s phases 5
and 6 on phi4-mini-3.8b, 5f and 6f on mamba2-2.7b (with the SSD split),
5c and 6c on olmoe-1b-7b and 8b, and, where the checkout has them, the
products kept in f32 (``layers.matmul_f32``) replayed beside the bf16
product.

Run the file from the root of each checkout in turns (A, B, B, A): it
imports the ``chip_smoke.py`` and ``repro_torch`` of the directory it
runs in, and builds that checkout's kernels.

    cd <checkout> && python3 <this file> <label>

Prints ``AB {...}``: the label, the card (name and power limit), each
served step's numbers as ``phase_step`` and ``step_split`` give them,
and 8b's losses, gradient norms, step walls, update and busy ms (or the
assertion 8b raised, as ``train_failed``); and ``PRODUCT {...}`` lines:
µs a call of ``matmul_f32``, of the bf16 product cast after and of the
bf16 product, at phi4-mini's T 8 by d 3072 against 8192 and 200192
columns (``graph_ms``: CUDA-graph replay over weight copies that
outgrow the 50 MB L2).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

TRAIN_KEYS = ("losses", "grad_norms", "step_ms", "update_ms_median",
              "busy_ms", "profiled_wall_ms", "split_ms", "step_walls_ms")


def products(cs, label) -> None:
    from repro_torch.models import layers
    if not hasattr(layers, "matmul_f32"):
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 3072, generator=gen, device="cuda").to(torch.bfloat16)
    fns = (("matmul_f32", layers.matmul_f32),
           ("bf16_then_float", lambda a, b: (a @ b).float()),
           ("bf16", lambda a, b: a @ b))
    for width, n_copies in ((8192, 2), (200192, 1)):
        sets = [(x, (torch.randn(3072, width, generator=gen, device="cuda")
                     * 3072 ** -0.5).to(torch.bfloat16))
                for _ in range(n_copies)]
        row = {name: cs.graph_ms(fn, sets, calls=16) for name, fn in fns}
        print("PRODUCT " + json.dumps({"label": label, "width": width,
                                       **row}), flush=True)


def main() -> None:
    label = sys.argv[1]
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import chip_smoke as cs
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    executor, _ = cs.phase_serve("phi4-mini-3.8b", ops)
    _, phi4 = cs.phase_step(executor, ops)
    del executor
    torch.cuda.empty_cache()
    executor, _, mamba2 = cs.serve_variant(cs.SSM_ARCH, "f", ops)
    mamba2.update(cs.step_split(executor, "ssd"))
    del executor
    torch.cuda.empty_cache()
    executor, _, olmoe = cs.serve_variant(cs.MOE_ARCH, "c", ops)
    del executor
    torch.cuda.empty_cache()
    out = {"label": label, "card": card, "phi4": phi4, "mamba2": mamba2,
           "olmoe": olmoe}
    try:
        stats, _ = cs.phase_train(ops, card)
        out["train"] = {k: stats[k] for k in TRAIN_KEYS}
    except AssertionError as e:     # 8b's own checks: reported, not hidden
        out["train_failed"] = str(e)[:500]
    print("AB " + json.dumps(out), flush=True)
    products(cs, label)


if __name__ == "__main__":
    main()
