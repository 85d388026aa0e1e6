"""Training launcher of the port (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --reduced --steps 50 --batch 8 --seq 128

The JAX launcher's flags, defaults and printed lines: the model's weights
from seed 0, AdamW (``--lr``, 10 warmup steps) through the port's
``make_train_step`` on the seeded ``TokenPipeline``, a checkpoint every
``--checkpoint-every`` steps and at the end under ``--checkpoint-dir``
(by default ``repro_ckpt`` in the temporary directory), and a run that
finds a committed step there resumes from it (``resumed from step N``).
The step is eager and updates the model in place.  ``train()`` runs on
the GPU unless the caller names another device; ``main()`` runs on the
GPU and raises without one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict

from ..configs import get_config, get_reduced
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..models import Model, ModelConfig
from ..training import (AdamWConfig, TrainConfig, init_train_state,
                        make_train_step)
from ..training.train_lib import trainable
from .fault_tolerance import FTConfig, FaultTolerantLoop


def build_parser() -> argparse.ArgumentParser:
    """The CLI surface (the flag set of ``repro.launch.train``)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (smoke/demo)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    return ap


def train(cfg: ModelConfig, args: argparse.Namespace,
          device=None) -> Dict[str, Any]:
    """Train ``cfg`` as ``args`` say, from the latest checkpoint in
    ``args.checkpoint_dir`` if there is one; return the final state
    ({"params", "opt"})."""
    model = Model(cfg, device=resolve_device(device), seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=args.lr, warmup_steps=10))
    step_fn = make_train_step(model, tcfg)
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, n_image_tokens=cfg.n_image_tokens,
        d_model=cfg.d_model))

    opt = init_train_state(model, tcfg)
    state = {"params": trainable(model), "opt": opt}
    ft = FaultTolerantLoop(
        FTConfig(args.checkpoint_dir,
                 checkpoint_every=args.checkpoint_every), state)
    state = ft.resume_or_init(lambda: state)
    start = ft.mgr.latest_step() or 0
    if start:
        print(f"resumed from step {start}")

    def one(state, batch):
        # TrainStep casts img_embeds to the model's dtype
        opt, info = step_fn(state["opt"], batch)
        one.last_info = info
        return {"params": state["params"], "opt": opt}

    t0 = time.time()
    for step in range(start, args.steps):
        state = one(state, pipe.batch_at(step))
        if step % 10 == 0 or step == args.steps - 1:
            info = one.last_info
            print(f"step {step:5d} loss={float(info['loss']):.4f} "
                  f"gnorm={float(info['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if (step + 1) % args.checkpoint_every == 0:
            ft.mgr.save(step + 1, state)
    ft.mgr.save(args.steps, state)
    ft.mgr.wait()
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s; "
          f"checkpoints at {args.checkpoint_dir}")
    return state


def main() -> None:
    args = build_parser().parse_args()
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    train(cfg, args)


if __name__ == "__main__":
    main()
