"""The port's kernel measurement mode (``repro_torch.bench.kernels_bench``)
on the CPU, where it runs the kernels' plain versions: its rows have the
JAX bench's kinds, keys and grid; ``_time``'s CV gate drops a polluted
round; the rows fit into a ``MeasuredStepTimes`` as the JAX package fits
them; and without a card the entry points raise instead of falling back.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro_torch.bench import kernels_bench as kb  # noqa: E402
from repro_torch.bench.common import CsvOut  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GRID_KEYS = {"decode": ("batch", "seq", "rank"), "prefill": ("tokens",),
             "adapters": ("a_unique",)}


@pytest.fixture(scope="module")
def rows():
    return kb.collect_kernel_rows(device="cpu", smoke=True, seed=0)


def test_rows_have_the_jax_kinds_keys_and_grid(rows):
    from benchmarks.kernels_bench import collect_kernel_rows
    want = collect_kernel_rows(mode="ref", smoke=True, seed=0)
    assert [r["kind"] for r in rows] == [r["kind"] for r in want]
    for got, ref in zip(rows, want):
        assert sorted(got) == sorted(ref)
        assert [got[k] for k in GRID_KEYS[got["kind"]]] == \
            [ref[k] for k in GRID_KEYS[ref["kind"]]]


def test_rows_are_positive_times(rows):
    for r in rows:
        value = r["t"] if "t" in r else r["mult"]
        assert math.isfinite(value) and value > 0 and r["cv"] >= 0
    assert [r["mult"] for r in rows if r["kind"] == "adapters"][0] == 1.0


def test_rows_fit_as_the_jax_package_fits_them(rows):
    fit = kb.fit_rows(rows)
    dec = [r for r in rows if r["kind"] == "decode"]
    want = jcore.fit_measured_step_times(
        rows, mean_seq=np.mean([r["seq"] for r in dec]),
        mean_rank=np.mean([r["rank"] for r in dec]))
    np.testing.assert_allclose(fit.decode, want.decode, rtol=1e-12)
    np.testing.assert_allclose(fit.adapters, want.adapters, rtol=1e-12)
    assert fit.prefill_per_token == pytest.approx(want.prefill_per_token,
                                                  rel=1e-12)
    assert (fit.mean_seq, fit.mean_rank) == (192.0, 12.0)
    assert np.isfinite(fit.lat_model(8, 64))


def test_measured_step_times_fits_in_one_call():
    mst = kb.measured_step_times(device="cpu", smoke=True, seed=1)
    assert mst.decode.shape == (4,) and np.all(np.isfinite(mst.decode))
    assert mst.adapters.shape == (2,) and mst.source == "kernels_bench"


@pytest.fixture
def clock(monkeypatch):
    """A fake ``perf_counter`` that only the timed function advances."""
    now = [0.0]
    monkeypatch.setattr(kb.time, "perf_counter", lambda: now[0])
    return now


def test_time_cv_gate_drops_the_slowest_round(clock):
    # the second round is polluted (one 60 ms stall in 3 launches): the
    # gate drops it and measures a fresh round
    calls = []

    def fn():
        calls.append(1)
        clock[0] += 0.06 if len(calls) == 5 else 0.002
    t = kb._time(fn, reps=3, rounds=3)
    assert t.rejected == 1 and len(calls) == 1 + 4 * 3
    assert t.us == pytest.approx(2000.0) and t.cv == pytest.approx(0.0)
    assert t.derived == "cv=0.000;rejected_rounds=1"


def test_time_gives_up_after_max_rounds(clock):
    # every round after the first is slow: the gate keeps rejecting until
    # the round budget is spent, and the min of the kept rounds is reported
    calls = []

    def fn():
        calls.append(1)
        clock[0] += 0.002 if len(calls) in (2, 3) else 0.02
    t = kb._time(fn, reps=2, rounds=2, max_rounds=5)
    assert t.rejected == 3 and len(calls) == 1 + 5 * 2
    assert t.us == pytest.approx(2000.0) and t.cv > 0.30


def test_widths_of_phi4_mini_are_its_published_widths():
    w = kb.Widths.of(get_config("phi4-mini-3.8b"))
    assert w == kb.Widths(h=24, kv=8, d=128, dx=3072, prefill=3072)
    assert kb.Widths() == kb.Widths(h=8, kv=2, d=64, dx=128, prefill=128)


def test_decode_data_shapes():
    gen = torch.Generator().manual_seed(0)
    q, k, v, x, a, b, idx = kb._decode_data(gen, 2, 16, 4, 3, h=6, kv=2,
                                            d=8, dx=12)
    assert (q.shape, k.shape, v.shape, x.shape, a.shape, b.shape) == (
        (2, 6, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 12), (3, 12, 4),
        (3, 4, 48))
    assert idx.dtype == torch.int32 and bool(((idx >= 0) & (idx < 3)).all())


def test_main_prints_every_row(capsys, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    ops.reset_launches()
    kb.main(CsvOut("kernels"), device="cpu")
    labels = [line.split(",")[0] for line in
              capsys.readouterr().out.splitlines()]
    assert labels == ["kernels/bgmv_t8_d256", "kernels/sgmv_t512_d256",
                      "kernels/sgmv_ragged_t512_d256",
                      "kernels/flashdec_b4_s512",
                      "kernels/decode_unfused_b4_s512",
                      "kernels/decode_fused_b4_s512",
                      "kernels/measured_fit_decode"]
    assert set(ops.launch_counts().values()) == {0}   # plain versions


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kb.collect_kernel_rows(smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kb.measured_step_times(smoke=True)
