"""Serving launcher of the port: run the multi-adapter engine on a model
with the torch executor, under a Poisson multi-adapter workload.

    python -m repro_torch.launch.serve --arch phi4-mini-3.8b --adapters 8 \
        --slots 4 --rate 0.5 --horizon 30

The same flags and printed line as ``python -m repro.launch.serve``; like
it, ``main()`` serves the reduced configuration.  ``serve()`` takes any
``ModelConfig`` (``chip_smoke.py`` passes the published one) and, as a
keyword only, ``kv_quant`` for an int8 KV cache (the JAX launcher has no
such flag, so neither has this one).  Runs on the GPU.
"""
from __future__ import annotations

import argparse
from typing import Tuple

from ..configs import get_reduced
from ..core.workload import WorkloadSpec, generate_requests, make_adapter_pool
from ..models import Model, ModelConfig
from ..serving.engine import EngineConfig, ServingEngine
from ..serving.executor import TorchExecutor
from ..serving.metrics import ServingMetrics
from ..serving.policy import SCHED_POLICIES


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface (the flag set of ``repro.launch.serve``)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--adapters", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--rate", type=float, default=0.5)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--horizon", type=float, default=30.0)
    ap.add_argument("--dataset", default="small")
    ap.add_argument("--kv-tokens", type=int, default=4096)
    ap.add_argument("--sched-policy", default="fcfs",
                    choices=sorted(SCHED_POLICIES),
                    help="admission/preemption scheduling policy")
    return ap


def serve(cfg: ModelConfig, args: argparse.Namespace, device=None, *,
          kv_quant: bool = False) -> Tuple[ServingMetrics, TorchExecutor]:
    """Build the model (weights from seed 0; with ``kv_quant`` its global
    layers' KV caches in int8) and the executor, serve the workload
    ``args`` describes; return the engine's metrics and the executor (its
    model, cache and last logits)."""
    model = Model(cfg, device=device, seed=0, kv_quant=kv_quant)
    lora = model.init_lora(max(args.slots, 1), args.rank, seed=0)
    executor = TorchExecutor(model, lora, max_batch=8, cache_len=512,
                             device=device)

    pool = make_adapter_pool(args.adapters, [args.rank], [args.rate])
    spec = WorkloadSpec(adapters=pool, dataset=args.dataset,
                        horizon=args.horizon)
    reqs = generate_requests(spec)
    engine = ServingEngine(EngineConfig(
        kv_capacity_tokens=args.kv_tokens, adapter_slots=args.slots,
        sched_policy=args.sched_policy),
        executor)
    return engine.run(reqs, horizon=args.horizon), executor


def report(m: ServingMetrics) -> str:
    """The launcher's printed summary (the JAX launcher's line)."""
    lines = [
        f"served {m.n_finished} requests | throughput={m.throughput:.1f} "
        f"tok/s (ideal {m.ideal_throughput:.1f}) | itl={m.itl * 1e3:.1f}ms "
        f"| ttft={m.ttft * 1e3:.1f}ms "
        f"(p50 {m.ttft_p50 * 1e3:.1f} / p99 {m.ttft_p99 * 1e3:.1f}) "
        f"| preemptions={m.n_preemptions} "
        f"| loads={m.n_loads} | starved={m.starved} "
        f"| starved_reqs={m.n_starved_requests}"]
    if m.starved_per_adapter:
        worst = sorted(m.starved_per_adapter.items(),
                       key=lambda kv: -kv[1])[:5]
        lines.append("  starved requests by adapter: "
                     + ", ".join(f"{a}:{c}" for a, c in worst))
    return "\n".join(lines)


def main() -> None:
    args = build_parser().parse_args()
    print(report(serve(get_reduced(args.arch), args)[0]))


if __name__ == "__main__":
    main()
