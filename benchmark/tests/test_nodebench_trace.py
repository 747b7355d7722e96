"""The trace arithmetic on a small recorded event list: busy time is the
union of the device intervals (never their sum), idle gaps are named by
the host op running at their start, and device time goes to the program
range open when its launching op started."""
import pytest

from benchmark.harness import trace


def _recorded():
    # window 0..100 us; kernels overlap on 10..30 and 25..40, then 60..70
    return trace.Recorded(
        window=(0.0, 100.0),
        device=[("k1", 10.0, 30.0), ("k2", 25.0, 40.0), ("k3", 60.0, 70.0),
                ("k4", 95.0, 120.0)],
        ranges=[("nodems.attack", 0.0, 50.0), ("nodems.update", 50.0, 90.0)],
        launches=[(5.0, 20.0), (20.0, 15.0), (55.0, 10.0), (92.0, 25.0)],
        host=[("aten::step", 0.0, 100.0), ("cudaStreamSynchronize", 40.0,
                                            60.0)])


def test_busy_is_the_union_clipped_to_the_window():
    rec = _recorded()
    # 10..40 (30) + 60..70 (10) + 95..100 (5): overlap counted once
    assert trace.busy_us(rec) == pytest.approx(45.0)
    assert sum(e - s for _, s, e in rec.device) == 70.0


def test_idle_gaps_longest_first_named_by_the_host():
    gaps = trace.idle_gaps(_recorded(), top=3)
    assert [g[0] for g in gaps] == ["aten::step", "cudaStreamSynchronize",
                                    "aten::step"]
    assert [g[1] for g in gaps] == pytest.approx([25e-6, 20e-6, 10e-6])


def test_device_time_goes_to_the_range_open_at_launch():
    assert trace.by_range(_recorded()) == {
        "nodems.attack": 35.0, "nodems.update": 10.0, "outside": 25.0}


def test_names_and_counts_inside_the_window():
    rec = _recorded()
    assert trace.by_name(rec) == {"k1": 20.0, "k2": 15.0, "k3": 10.0,
                                  "k4": 5.0}
    assert trace.count_in_window(rec) == 4


@pytest.mark.parametrize("lo,hi,busy", [(0.0, 10.0, 0.0), (12.0, 28.0, 16.0),
                                        (35.0, 65.0, 10.0)])
def test_window_clipping(lo, hi, busy):
    rec = _recorded()
    rec.window = (lo, hi)
    assert trace.busy_us(rec) == pytest.approx(busy)


def test_mfu_and_idle_take_the_untraced_units_wall_time():
    from types import SimpleNamespace

    from benchmark.harness import layers

    ctx = SimpleNamespace(units=4, wall_s=2.0, plain_wall_s=1.0, busy_s=0.8,
                          flops_per_unit=5e12, peak_flops=1e14)
    assert layers.mfu(ctx) == pytest.approx(20.0)
    assert layers.idle(ctx) == pytest.approx(20.0)
    assert layers.idle(SimpleNamespace(plain_wall_s=1.0, busy_s=0.0)) is None


@pytest.mark.parametrize("name", ["premetanode10.serve.b256",
                                  "mnist_metanode64.fleet27.clean"])
def test_a_traced_run_reads_every_per_layer_metric_of_its_cell(tiny_cell,
                                                                name):
    """The traced path end to end on the CPU at a test's size: three
    passes of ``trace_units`` units, and each metric read or left out (the
    CPU records no device time, so only the whole unit's share of the peak
    is read)."""
    import os
    import sys

    import torch

    from conftest import ROOT

    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import run

    cell = tiny_cell(name)
    out = run.run_cell(cell, 2147483931, 0.2, True, torch.device("cpu"))
    assert out["correct"] and out["attempted"] == 3 * 2
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names
    assert any(n.startswith("mfu.") for n in out["metrics"])
    assert out["device"]["window_s"] > 0
    for m in out["metrics"].values():
        assert m["value"] == m["value"]
