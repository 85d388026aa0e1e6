"""AdamW on named tensors (counterpart of ``repro.training.optimizer``).

The JAX package's arithmetic, not ``torch.optim.AdamW``'s (whose bf16
parameters keep bf16 moments and are not clipped): the moments m and v are
f32; the gradients are clipped by their global norm, taken over f32
squares; the update runs in f32 and is cast back to each parameter's dtype
(the bf16 master-less recipe; ``master_weights=True`` carries f32 masters
and updates those).  Parameters, gradients and moments are dicts keyed by
parameter name.  ``adamw_update`` writes the parameters and the moments in
place, one tensor at a time under ``no_grad``, so its f32 temporaries stay
a few tensors large; the step count, the learning rate and the clip factor
stay 0-d tensors on the parameters' device (nothing waits for the host).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    master_weights: bool = False


def adamw_init(params: Tensors, cfg: AdamWConfig) -> Dict[str, object]:
    """{"step": 0-d int32 0, "m": f32 zeros, "v": f32 zeros, and with
    ``master_weights`` "master": f32 copies}, each keyed as ``params``
    (optimizer.py:29-40)."""
    dev = next(iter(params.values())).device if params else None

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": zeros(), "v": zeros()}
    if cfg.master_weights:
        state["master"] = {k: p.detach().to(torch.float32, copy=True)
                           for k, p in params.items()}
    return state


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """lr * min(step / max(warmup, 1), 1), in f32 (optimizer.py:43-45)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(grads: Iterable[torch.Tensor], replicas=None,
                group=None) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's sum of f32 squares
    (optimizer.py:48-51).

    Under a train plan ``grads`` are a rank's pieces and the norm is the
    whole gradients' (the clip is then JAX's): ``replicas`` gives, tensor
    by tensor, the ranks that hold the same piece
    (``ShardingPlan.replicas``), whose squares count once over them, and
    the sum is all-reduced over ``group``, every rank of the mesh."""
    total = None
    for i, g in enumerate(grads):
        sq = torch.sum(torch.square(g.float()))
        if replicas is not None and replicas[i] > 1:
            sq = sq / replicas[i]
        total = sq if total is None else total + sq
    if group is not None:
        from ..models.sharding import all_reduce
        total = all_reduce(total, "sum", group)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state, cfg: AdamWConfig,
                 replicas=None, group=None
                 ) -> Tuple[Tensors, Dict[str, object], Tensors]:
    """One AdamW step (optimizer.py:54-94): returns (params, state,
    {"grad_norm", "lr"}).  ``params`` (and ``state``'s m, v and master)
    are updated in place and returned; ``state["step"]`` is a new tensor.
    Under a train plan ``params``, ``grads`` and the state are the rank's
    pieces, updated where they lie; ``replicas`` ({name: ranks holding the
    same piece}) and ``group`` make the clip's norm the whole gradients'
    (``global_norm``).

    Per tensor, in f32: g = grad * clip, clip = min(1, grad_clip / (gnorm +
    1e-9)) (1 when ``grad_clip`` is 0); m = b1 m + (1 - b1) g; v = b2 v +
    (1 - b2) g^2; p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p), bc
    the bias corrections, then cast to the parameter's dtype.
    """
    step = state["step"] + 1
    gnorm = global_norm((grads[k] for k in params),
                        None if replicas is None
                        else [replicas[k] for k in params], group)
    clip = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            if cfg.grad_clip else 1.0)
    lr = _schedule(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf

    src = state.get("master", params)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * clip                 # a new f32 tensor
        t = torch.square(g).mul_(1 - cfg.b2)
        v.mul_(cfg.b2).add_(t)
        m.mul_(cfg.b1).add_(g.mul_(1 - cfg.b1))
        torch.div(m, bc1, out=t)                       # mh
        torch.div(v, bc2, out=g)                       # vh
        t.div_(g.sqrt_().add_(cfg.eps))
        pf = src[name].float()
        t.add_(torch.mul(pf, cfg.weight_decay, out=g))
        pf = torch.sub(pf, t.mul_(lr), out=t)
        if cfg.master_weights:
            src[name].copy_(pf)
        p.copy_(pf)                                    # cast to p's dtype
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if cfg.master_weights:
        new_state["master"] = state["master"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
