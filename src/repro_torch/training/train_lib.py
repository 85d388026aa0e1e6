"""Train-step factory: loss + grad + AdamW, with microbatch accumulation
(counterpart of ``repro.training.train_lib``).

The model holds its parameters: ``init_train_state`` turns on
``requires_grad`` for the floating-point ones and returns the AdamW state
over them, and the step updates them in place.  The gradients come from
autograd through ``Model.train_loss``, whose attention blocks and loss
chunks are recomputed in backward, as the JAX package's ``jax.checkpoint``s
are, and whose layers are where the model's plan sets ``remat``.  Under a train plan (``Model(cfg, plan=make_plan(cfg, mesh,
"train", global_batch=B))``) the model holds the rank's pieces, and so do
the AdamW state and the step's updates.  The compressed cross-pod
gradient sync, which the step does not call, is ``compression``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1        # gradient accumulation
    # never read, as in the JAX package: train_loss hard-codes 0.01
    aux_weight: float = 0.01


def trainable(model) -> Dict[str, torch.nn.Parameter]:
    """The model's floating-point parameters by name (int8 experts are
    left out)."""
    return {n: p for n, p in model.named_parameters()
            if p.is_floating_point()}


def train_state_specs(model, state):
    """The specs of a train state ``{"params": trainable(model), "opt":
    its AdamW state}`` under the model's plan, in the state's structure:
    each parameter's (``Model.param_specs``), each moment's and master
    copy's its parameter's, the step replicated (``()``); None without a
    plan.  What ``CheckpointManager`` and ``FaultTolerantLoop`` take as
    ``specs``, the JAX package's tree of shardings."""
    if model.plan is None:
        return None
    ps = model.param_specs
    opt = {k: {n: ps[n] for n in v} for k, v in state["opt"].items()
           if k != "step"}
    return {"params": {n: ps[n] for n in state["params"]},
            "opt": {"step": (), **opt}}


def init_train_state(model, tcfg: TrainConfig = TrainConfig()):
    """Turn on ``requires_grad`` for the model's floating-point parameters
    and return ``adamw_init`` of them (train_lib.py:58-61, whose
    parameters the port's model already holds)."""
    params = trainable(model)
    for p in params.values():
        p.requires_grad_(True)
    return adamw_init(params, tcfg.optimizer)


class TrainStep:
    """``train_step(opt_state, batch) -> (opt_state, info)``: one step of
    ``model`` on ``batch`` (numpy arrays or tensors), its parameters
    updated in place; ``info`` holds "loss", "grad_norm" and "lr" as 0-d
    tensors.  ``grads`` keeps the gradients the last step gave AdamW (with
    microbatches, their f32 mean) until the next step begins.

    Under a train plan ``batch`` is the whole batch, the same on every
    rank: with ``microbatches`` n it is cut into n microbatches of B / n
    rows first and each is then cut to the rank's rows over the batch
    axes (``Model.batch_rows``), as the JAX step reshapes the global batch
    under ``jit`` (train_lib.py:39-44); the gradients are finished by
    ``Model.sync_grads`` and the clip's norm is the whole gradients'."""

    def __init__(self, model, tcfg: TrainConfig):
        self.model, self.tcfg = model, tcfg
        self.grads = None

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The batch on the model's device, ``img_embeds`` in the model's
        dtype (launch/train.py:59-60)."""
        model = self.model
        out = {"tokens": torch.as_tensor(batch["tokens"], device=model.device)}
        if batch.get("img_embeds") is not None:
            out["img_embeds"] = torch.as_tensor(
                batch["img_embeds"], device=model.device).to(
                    model.cfg.torch_dtype)
        return out

    def __call__(self, opt_state, batch):
        model, n = self.model, self.tcfg.microbatches
        params = {k: p for k, p in trainable(model).items()
                  if k in opt_state["m"]}
        self.grads = None
        for p in params.values():
            p.grad = None
        batch = self._to_device(batch)
        rows = model.batch_rows

        def grad_of(p):
            return p.grad if p.grad is not None else torch.zeros_like(p)

        if n > 1:
            # split axis 0 into n microbatches; sum the gradients in f32
            # (the JAX ``zero`` tree), then divide the sum and the loss by n
            mbs = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                   for k, v in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(n):
                mb_loss = model.train_loss(rows({k: v[i]
                                                 for k, v in mbs.items()}))
                mb_loss.backward()
                with torch.no_grad():
                    for k, p in params.items():
                        grads[k].add_(grad_of(p))
                        p.grad = None
                loss = loss + mb_loss.detach()
            for g in grads.values():
                g.div_(n)
            loss = loss / n
        else:
            loss = model.train_loss(rows(batch))
            loss.backward()
            loss = loss.detach()
            grads = {k: grad_of(p) for k, p in params.items()}
        norm = {}
        if model.plan is not None:
            model.sync_grads(grads)
            norm = {"replicas": {k: model.plan.replicas(
                model.param_specs[k]) for k in params},
                "group": model.tp.world}
        _, opt_state, info = adamw_update(params, grads, opt_state,
                                          self.tcfg.optimizer, **norm)
        info["loss"] = loss
        self.grads = grads
        return opt_state, info


def make_train_step(model, tcfg: TrainConfig = TrainConfig()) -> TrainStep:
    """The step of ``model`` under ``tcfg`` (train_lib.py:26-55)."""
    return TrainStep(model, tcfg)
