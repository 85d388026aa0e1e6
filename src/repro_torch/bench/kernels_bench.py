"""Kernel microbenchmarks and the twin's kernel measurement mode, on the
port's kernels.

The port of ``benchmarks/kernels_bench.py``:

1. **Microbenchmarks** (``main``): BGMV, SGMV (dense and ragged),
   flash-decode, and one fused ``ops.fused_decode`` launch against the
   base-then-adapter sequence (``ops.flash_decode`` + ``ops.lora_apply``
   + add) at the same shape.

2. **Stable timing** (``_time``): warm up once, then the min of k round
   means of per-launch wall time, each launch waited for (on the card
   with ``torch.cuda.synchronize``); a round set whose coefficient of
   variation is above the gate loses its slowest round and measures a
   fresh one.

3. **Measurement mode** (``collect_kernel_rows``,
   ``measured_step_times``): the fused decode kernel over a (batch, seq,
   rank) grid, plus SGMV prefill and unique-adapter arms, fitted into
   the ``MeasuredStepTimes`` surface that the twin's
   ``measured_step_times=`` hook takes.

Runs on the card unless ``device="cpu"`` is given; there it times the
kernels' plain versions, which is no device measurement.  Inputs come
from a seeded ``torch.Generator``.

    python -m repro_torch.bench.kernels_bench
    REPRO_BENCH_SMOKE=1 python -m repro_torch.bench.kernels_bench --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from ..core import MeasuredStepTimes, fit_measured_step_times
from ..device import resolve_device
from ..kernels import ops
from .common import CsvOut, is_smoke


@dataclasses.dataclass
class Timing:
    us: float            # min-of-k per-launch wall time (microseconds)
    cv: float            # coefficient of variation across kept rounds
    rejected: int        # rounds discarded by the CV gate

    @property
    def derived(self) -> str:
        return f"cv={self.cv:.3f};rejected_rounds={self.rejected}"


def _wait(out) -> None:
    """Block until ``out`` is computed (the JAX bench's
    ``block_until_ready``): a CUDA tensor synchronises its device."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def _time(fn, *args, reps: int = 5, rounds: int = 3, cv_gate: float = 0.30,
          max_rounds: int = 8) -> Timing:
    """Per-launch wall time, robust to thermally-polluted samples.

    Warms up exactly once and waits for the real output.  Then takes
    ``rounds`` rounds of ``reps`` launches each, every launch waited for;
    if the coefficient of variation of the round means exceeds
    ``cv_gate``, the slowest round (pollution is one-sided) is dropped and
    a fresh round is measured, up to ``max_rounds`` total.  Returns the
    **min** of the kept round means (the least-disturbed estimate, the
    right statistic for fitting step-time coefficients) plus the final CV
    and the number of rejected rounds.
    """
    _wait(fn(*args))

    def one_round() -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            _wait(fn(*args))
        return (time.perf_counter() - t0) / reps * 1e6

    means = [one_round() for _ in range(rounds)]
    rejected = 0
    budget = max_rounds - rounds

    def cv(xs) -> float:
        m = statistics.fmean(xs)
        return (statistics.pstdev(xs) / m) if m > 0 else 0.0

    while len(means) >= 2 and cv(means) > cv_gate and budget > 0:
        means.remove(max(means))
        means.append(one_round())
        rejected += 1
        budget -= 1
    return Timing(us=min(means), cv=cv(means), rejected=rejected)


# --------------------------------------------------------------------- #
# measurement mode: kernel launches -> MeasuredStepTimes rows
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class Widths:
    """Model widths of the measurement grid: decode attention (``h``
    query heads, ``kv`` KV heads, head dim ``d``), the fused delta's input
    width ``dx`` (B's expand dim is h*d), and the prefill LoRA's
    d = o.  The defaults are the JAX bench's."""
    h: int = 8
    kv: int = 2
    d: int = 64
    dx: int = 128
    prefill: int = 128

    @classmethod
    def of(cls, cfg) -> "Widths":
        """A model's published widths (a ``ModelConfig``)."""
        return cls(h=cfg.n_heads, kv=cfg.n_kv_heads, d=cfg.head_dim,
                   dx=cfg.d_model, prefill=cfg.d_model)


def _normal(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


def _ids(gen, t, n):
    return torch.randint(0, n, (t,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def _fused(length):
    """The fused decode step at a fixed full ``length``, as a function of
    the other inputs."""
    return lambda q, k, v, x, a, b, i: ops.fused_decode(q, k, v, length, x,
                                                        a, b, i)


def _decode_data(gen, bsz, s, rank, n, h=8, kv=2, d=64, dx=128):
    """bf16 inputs of one fused decode step, drawn from ``gen``."""
    return (_normal(gen, bsz, h, d), _normal(gen, bsz, s, kv, d),
            _normal(gen, bsz, s, kv, d), _normal(gen, bsz, dx),
            _normal(gen, n, dx, rank), _normal(gen, n, rank, h * d),
            _ids(gen, bsz, n))


def collect_kernel_rows(device=None, smoke: bool | None = None,
                        seed: int = 0, widths: Widths = Widths()) -> list:
    """Run the kernels over a per-(rank, batch, seq) grid; return fit rows.

    On the card this times the kernels; with ``device="cpu"`` their plain
    versions (same math, no device measurement).  Rows feed
    ``fit_measured_step_times``.
    """
    dev = resolve_device(device)
    if smoke is None:
        smoke = is_smoke()
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = dict(h=widths.h, kv=widths.kv, d=widths.d, dx=widths.dx)
    if smoke:
        b_grid, s_grid, r_grid = (1, 4), (128, 256), (8, 16)
        pf_grid, a_grid = (256, 512), (1, 2, 4)
        reps, rounds = 2, 2
    else:
        b_grid, s_grid, r_grid = (1, 8, 32), (256, 1024, 4096), (8, 16, 32)
        pf_grid, a_grid = (512, 2048, 4096), (1, 2, 8, 32)
        reps, rounds = 5, 3
    rows = []

    # decode surface: one fused launch per (batch, seq, rank) point
    for bsz in b_grid:
        for s in s_grid:
            for rank in r_grid:
                q, k, v, x, a, b, idx = _decode_data(gen, bsz, s, rank,
                                                     n=max(a_grid), **w)
                t = _time(_fused(s), q, k, v, x, a, b, idx, reps=reps,
                          rounds=rounds)
                rows.append(dict(kind="decode", batch=bsz, seq=s,
                                 rank=rank, t=t.us * 1e-6, cv=t.cv))

    # prefill: SGMV launch cost per token count
    for tokens in pf_grid:
        d, rank, o, n = widths.prefill, 16, widths.prefill, max(a_grid)
        t = _time(ops.lora_apply, _normal(gen, tokens, d),
                  _normal(gen, n, d, rank), _normal(gen, n, rank, o),
                  _ids(gen, tokens, n), reps=reps, rounds=rounds)
        rows.append(dict(kind="prefill", tokens=tokens, t=t.us * 1e-6,
                         cv=t.cv))

    # unique-adapter multiplier: same shape, growing distinct adapters
    bsz, s, rank = max(b_grid), max(s_grid), 16
    base_t = None
    for a_unique in a_grid:
        q, k, v, x, a, b, _ = _decode_data(gen, bsz, s, rank,
                                           n=max(a_grid), **w)
        idx = torch.arange(bsz, dtype=torch.int32, device=dev) % a_unique
        t = _time(_fused(s), q, k, v, x, a, b, idx, reps=reps,
                  rounds=rounds)
        if base_t is None:
            base_t = t.us
        rows.append(dict(kind="adapters", a_unique=a_unique,
                         mult=t.us / base_t, cv=t.cv))
    return rows


def fit_rows(rows: list) -> MeasuredStepTimes:
    """The surface of ``collect_kernel_rows``'s rows, centred on the mean
    decode context and rank of the grid."""
    seqs = [r["seq"] for r in rows if r["kind"] == "decode"]
    ranks = [r["rank"] for r in rows if r["kind"] == "decode"]
    return fit_measured_step_times(
        rows, mean_seq=statistics.fmean(seqs),
        mean_rank=statistics.fmean(ranks))


def measured_step_times(device=None, smoke: bool | None = None,
                        seed: int = 0,
                        widths: Widths = Widths()) -> MeasuredStepTimes:
    """One-call measurement mode: kernel launches -> fitted surface for
    the twin's ``measured_step_times=`` hook."""
    return fit_rows(collect_kernel_rows(device=device, smoke=smoke,
                                        seed=seed, widths=widths))


# --------------------------------------------------------------------- #
# the benchmark
# --------------------------------------------------------------------- #

def main(out: CsvOut, device=None) -> None:
    dev = resolve_device(device)
    smoke = is_smoke()
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return _normal(gen, *shape)

    def ids(t, n):
        return _ids(gen, t, n)

    # BGMV decode shapes (T tokens, one adapter each)
    bgmv_shapes = [(8, 256, 16, 256, 8)] if smoke else \
        [(32, 2048, 16, 2048, 32), (128, 3072, 16, 3072, 32)]
    for (t, d, r, o, n) in bgmv_shapes:
        tm = _time(ops.lora_apply, normal(t, d), normal(n, d, r),
                   normal(n, r, o), ids(t, n))
        out.row(f"bgmv_t{t}_d{d}", tm.us, tm.derived)

    # SGMV prefill shapes: dense and ragged-rank arms
    sgmv_shapes = [(512, 256, 16, 256, 8)] if smoke else \
        [(4096, 2048, 16, 2048, 32)]
    for (t, d, r, o, n) in sgmv_shapes:
        x, a, b, idx = normal(t, d), normal(n, d, r), normal(n, r, o), \
            ids(t, n)
        ranks = (torch.arange(n, dtype=torch.int32, device=dev) % 3 + 1) \
            * (r // 4)
        tm = _time(ops.lora_apply, x, a, b, idx)
        out.row(f"sgmv_t{t}_d{d}", tm.us, tm.derived)
        tr = _time(lambda x, a, b, i, rk: ops.lora_apply(x, a, b, i,
                                                         ranks=rk),
                   x, a, b, idx, ranks)
        out.row(f"sgmv_ragged_t{t}_d{d}", tr.us,
                f"ranks<=r_max={r};{tr.derived}")

    # flash decode + the fused-vs-unfused arms
    fd_shapes = [(4, 8, 2, 64, 512, 128, 16, 8)] if smoke else \
        [(8, 32, 8, 128, 4096, 4096, 16, 32),
         (32, 32, 8, 128, 2048, 4096, 16, 32)]
    for (b, h, kv, d, s, dx, r, n) in fd_shapes:
        q, k, v = normal(b, h, d), normal(b, s, kv, d), normal(b, s, kv, d)
        x, aw, bw, idx = normal(b, dx), normal(n, dx, r), \
            normal(n, r, h * d), ids(b, n)

        t_attn = _time(lambda q, k, v, _s=s: ops.flash_decode(q, k, v, _s),
                       q, k, v)
        out.row(f"flashdec_b{b}_s{s}", t_attn.us, t_attn.derived)

        # unfused: base attention, separate LoRA launch, add-back
        def unfused(q, k, v, x, aw, bw, i, _s=s):
            attn = ops.flash_decode(q, k, v, _s)
            delta = ops.lora_apply(x, aw, bw, i)
            return attn + delta.reshape(attn.shape).to(attn.dtype)
        t_unf = _time(unfused, q, k, v, x, aw, bw, idx)
        out.row(f"decode_unfused_b{b}_s{s}", t_unf.us, t_unf.derived)

        t_fus = _time(_fused(s), q, k, v, x, aw, bw, idx)
        out.row(f"decode_fused_b{b}_s{s}", t_fus.us,
                f"vs_unfused={t_unf.us / max(t_fus.us, 1e-9):.2f}x;"
                f"{t_fus.derived}")

    # measurement mode: fit the MeasuredStepTimes surface from real
    # launches and print the coefficients (the twin hook's input)
    mst = measured_step_times(device=dev, smoke=smoke)
    c = mst.decode
    out.row("measured_fit_decode", c[0] * 1e6,
            f"cB_us={c[1] * 1e6:.3f};cBS_ns={c[2] * 1e9:.4f};"
            f"cBr_us={c[3] * 1e6:.4f};"
            f"prefill_us_per_tok={mst.prefill_per_token * 1e6:.4f};"
            f"adapter_mult_slope={mst.adapters[1]:.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench."
                                 "kernels_bench")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    csv = CsvOut("kernels")
    main(csv, device=ap.parse_args().device)
    csv.done()
