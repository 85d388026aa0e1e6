"""What one call of each hand-written kernel costs, and the counter a step
on the ``meta`` device adds it to.

One function a kernel gives a call's operations and HBM bytes: each input
read once and each output written once, the least any implementation of
the call moves.  ``chip_smoke.py`` divides them by the card's rates for
each kernel's bound; on ``meta`` each wrapper adds them to the counter
open then (``counting``), where ``launch.roofline.cost_of_step`` reads
them, since a ``meta`` call runs no aten op that a count of the step
could see.  On ``meta`` the ids and lengths have no values, so a call
counts every token as adapted, min(T, N) adapters read, and every cache
position read: what the call can need at most.

``x_bytes``, ``w_bytes`` and the like are element sizes.
"""
from __future__ import annotations

from typing import List

#: the counters open, the innermost last (``counting``)
_OPEN: List["KernelCount"] = []


class KernelCount:
    """The kernel calls counted while it is open: operations and bytes
    summed, and the calls by wrapper name."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.calls = {}

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.calls[name] = self.calls.get(name, 0) + 1


class counting:
    """``with counting() as c:`` opens ``c``, a ``KernelCount``, for the
    calls made on ``meta`` inside the block."""

    def __enter__(self) -> KernelCount:
        _OPEN.append(KernelCount())
        return _OPEN[-1]

    def __exit__(self, *exc) -> None:
        _OPEN.pop()


def add(name: str, cost) -> None:
    """Add a call's (flops, bytes) to the innermost open counter, if
    any."""
    if _OPEN:
        _OPEN[-1].add(name, *cost)


def lora_cost(t: int, d: int, r: int, o: int, used: int, rows=None,
              x_bytes: int = 2, w_bytes: int = 2, id_bytes: int = 4):
    """BGMV's or SGMV's call, y (T, o) = s * x (T, d) @ A[id] @ B[id]:
    2 r (d + o) operations a token with an adapter (``rows`` of them, T
    by default); x, y and ``used`` adapters' A and B moved once, and
    ``id_bytes`` a token (the ids; 8 with SGMV's arrival ranks)."""
    rows = t if rows is None else rows
    return (2 * rows * r * (d + o),
            t * (d + o) * x_bytes + used * r * (d + o) * w_bytes
            + id_bytes * t)


def flash_decode_cost(bsz: int, s: int, h: int, kv: int, d: int,
                      q_bytes: int = 2, kv_bytes: int = 2,
                      out_bytes=None, scale_bytes: int = 0,
                      lse: bool = False):
    """Flash-decode's call over ``s`` positions a row: 4 G D operations a
    (position, KV head), G = H / KV; q read and the output written (in
    ``out_bytes``, q's by default), K and V and their scales (the int8
    mode's, ``scale_bytes`` a position and KV head) read once, the
    lengths, and with ``lse`` the (B, H) f32 log-sum-exp written."""
    out_bytes = q_bytes if out_bytes is None else out_bytes
    return (4 * (h // kv) * bsz * s * kv * d,
            bsz * h * d * (q_bytes + out_bytes)
            + 2 * bsz * s * kv * (d * kv_bytes + scale_bytes)
            + 4 * bsz + (4 * bsz * h if lse else 0))


def flash_decode_lora_cost(bsz: int, s: int, h: int, kv: int, d: int,
                           dx: int, r: int, used: int, q_bytes: int = 2,
                           w_bytes: int = 2):
    """The fused call: flash-decode's, plus the LoRA delta's operations
    (2 r (dx + H D) a row) and its x, ``used`` adapters' A and B and the
    ids read (its output is the attention's)."""
    f, nb = flash_decode_cost(bsz, s, h, kv, d, q_bytes)
    return (f + 2 * bsz * r * (dx + h * d),
            nb + bsz * dx * q_bytes + used * r * (dx + h * d) * w_bytes
            + 4 * bsz)
