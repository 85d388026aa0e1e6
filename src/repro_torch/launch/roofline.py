"""Analytical useful FLOPs of a dry-run cell (counterpart of
``model_flops_for`` in ``repro.launch.roofline``).

Only ``model_flops_for`` is ported here: it reads the model configuration
and the cell's shape, and no property of a device.  The rest of the JAX
module (the HLO collective parser, ``CellCost`` and ``RooflineTerms``,
whose times divide by one accelerator's peak rates) comes with the
dry-run's records, ROADMAP.md item 12b, with the rates of the card the
port runs on.
"""
from __future__ import annotations


def model_flops_for(cfg, shape) -> float:
    """Analytical useful FLOPs for the cell (6ND train, 2ND inference;
    MoE counts active experts only; + attention quadratic term)."""
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention score/value FLOPs
    hd, nq = cfg.resolved_head_dim, cfg.n_heads
    kinds = cfg.layer_kinds
    for k in kinds:
        if k == "global":
            if shape.kind == "decode":
                flops += mult / 2 * 2 * 2 * shape.global_batch * nq * hd \
                    * shape.seq_len
            else:
                flops += mult / 2 * 2 * 2 * tokens * nq * hd \
                    * shape.seq_len / 2
        elif k == "local":
            w = min(cfg.local_window, shape.seq_len)
            if shape.kind == "decode":
                flops += mult / 2 * 2 * 2 * shape.global_batch * nq * hd * w
            else:
                flops += mult / 2 * 2 * 2 * tokens * nq * hd * w
    return flops
