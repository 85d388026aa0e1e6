"""§Perf hill-climb launcher of the port (counterpart of
``repro.launch.hillclimb``): re-count one cell under a named plan variant
on the production mesh (``launch.dryrun.run_cell``) and append the record
(with the variant tag) to a JSONL log.

    python -m repro_torch.launch.hillclimb --cell phi4_mini_3p8b:decode_32k \\
        --variant kv_int8 --out hillclimb.jsonl

The ``attn_batch`` variants of a prefill or train cell fail in the
record: the port does not run batch-parallel attention over the
sequence axis yet (ROADMAP.md item 11e), and the model raises naming it.
"""
import argparse
import json

VARIANTS = {
    "baseline": {},
    "kv_int8": {"kv_quant": True},
    "attn_batch": {"attn_batch_shard": True},
    "attn_batch+kv_int8": {"attn_batch_shard": True, "kv_quant": True},
    "no_remat": {"remat": False},
    "attn_batch+no_remat": {"attn_batch_shard": True, "remat": False},
    "kv_int8+w8_experts": {"kv_quant": True, "expert_quant": True},
}


def main() -> None:
    from .dryrun import run_cell
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)   # arch:shape
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--out", default="hillclimb.jsonl")
    args = ap.parse_args()
    arch, shape = args.cell.split(":")
    rec = run_cell(arch, shape, False, probes=True, full=not args.no_full,
                   plan_overrides=VARIANTS[args.variant] or None)
    rec["variant"] = args.variant
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    r = rec.get("roofline", {})
    m = rec.get("memory", {}).get("total_bytes_per_device", 0) / 2 ** 30
    status = "OK " if rec.get("ok") else "FAIL " + rec.get("error", "")[:200]
    print(f"{status} {args.cell} [{args.variant}] mem/dev={m:.2f}GiB "
          f"c/m/t={r.get('compute_s', 0):.3e}/{r.get('memory_s', 0):.3e}/"
          f"{r.get('collective_s', 0):.3e}")


if __name__ == "__main__":
    main()
