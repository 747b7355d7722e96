"""The span arithmetic (``harness/spans.py``) on hand-made spans and a
hand-made device trace: a gap no host op covers is named by the innermost
span open at its start, the idle time split by span adds up to the whole,
launch calls are counted inside units, host ms a unit by span name; and
the device time by ``nodems.*`` range is what it was, spans or not."""
import os
import sys
from types import SimpleNamespace

import pytest

from benchmark.harness import spans, trace


def _recorded():
    # window 0..100 us: kernels 10..30, 60..70, 90..100; the runtime's
    # calls: a launch at 5, a copy 30..40, launches at 55 and 85, and one
    # launch at 98, after the last unit ended
    return trace.Recorded(
        window=(0.0, 100.0),
        device=[("k1", 10.0, 30.0), ("k2", 60.0, 70.0), ("k3", 90.0, 100.0)],
        host=[("cudaLaunchKernel", 5.0, 6.0), ("cudaMemcpyAsync", 30.0, 40.0),
              ("cudaLaunchKernel", 55.0, 56.0),
              ("cudaLaunchKernelExC", 85.0, 86.0),
              ("cudaLaunchKernel", 98.0, 99.0)])


# (name, start, end, id, parent, unit): two steps; step 1 holds an attack
# phase that holds a solve; nothing is open from 80 to 82
PLACED = [("train.step", 0.0, 80.0, 1, None, 1),
          ("nodems.attack", 2.0, 50.0, 2, 1, 1),
          ("ode.solve", 3.0, 45.0, 3, 2, 1),
          ("train.draws", 50.0, 58.0, 4, 1, 1),
          ("train.step", 82.0, 97.0, 5, None, 5)]


def test_a_gap_no_host_op_covers_is_named_by_the_innermost_span():
    # gaps: 0..10 (10), 30..60 (30), 70..90 (20)
    assert spans.gaps(_recorded()) == [(0.0, 10.0), (30.0, 60.0),
                                       (70.0, 90.0)]
    named = spans.named_gaps(_recorded(), PLACED, top=3)
    # 30..60 starts inside the runtime's copy: the host op names it;
    # 70..90 starts in step 1 alone; 0..10 inside the step only; each in
    # the first unit, 30, 70 and 0 us after it opened
    assert named == [("cudaMemcpyAsync", pytest.approx(30e-6), (0, 30.0)),
                     ("train.step", pytest.approx(20e-6), (0, 70.0)),
                     ("train.step", pytest.approx(10e-6), (0, 0.0))]
    late = [("train.step", 0.0, 65.0, 1, None, 1)]
    assert spans.named_gaps(_recorded(), late, top=3)[1][::2] == ("idle",
                                                                  None)
    assert spans.unit_at(PLACED, 90.0) == (1, 8.0)
    assert trace.idle_gaps(_recorded(), 3)[1][0] == "idle"


def test_idle_by_span_adds_up_to_the_idle_time():
    rec = _recorded()
    by = spans.idle_by_span(rec, PLACED)
    assert by == {"train.step": 10.0 + 20.0, "ode.solve": 30.0}
    idle = rec.window[1] - rec.window[0] - trace.busy_us(rec)
    assert sum(by.values()) == pytest.approx(idle)
    by = spans.idle_by_span(rec, PLACED[1:2])
    assert by == {"nodems.attack": 30.0, "outside": 10.0 + 20.0}
    assert sum(by.values()) == pytest.approx(idle)
    # over each gap: 0..2 the step, 2..3 the attack, 3..10 the solve;
    # 30..45 the solve, 45..50 the attack, 50..58 the draws, 58..60 the
    # step; 70..80 step 1, 80..82 between the steps, 82..90 step 2
    by = spans.idle_by_span(rec, PLACED, over_gap=True)
    assert by == {"train.step": 2.0 + 2.0 + 10.0 + 8.0,
                  "nodems.attack": 1.0 + 5.0, "ode.solve": 7.0 + 15.0,
                  "train.draws": 8.0, "outside": 2.0}
    assert sum(by.values()) == pytest.approx(idle)


def test_unnamed_gaps_say_where_they_fall():
    late = [("train.step", 12.0, 50.0, 1, None, 1),
            ("train.step", 75.0, 80.0, 2, None, 2)]
    got = spans.unnamed_gaps(_recorded(), late)
    assert got == {"before the units": [10.0], "between units": [20.0]}
    got = spans.unnamed_gaps(_recorded(), late[:1])
    assert got == {"before the units": [10.0], "after the units": [20.0]}


def test_launch_calls_are_counted_inside_the_units():
    assert spans.launches_in_units(_recorded(), PLACED) == (4, 0.75)
    assert spans.launches_in_units(_recorded(), []) == (4, 0.0)
    empty = trace.Recorded(window=(0.0, 1.0))
    assert spans.launches_in_units(empty, PLACED) == (0, None)


def test_host_ms_a_unit_by_span_name():
    s = lambda name, t0, t1, i, parent: SimpleNamespace(  # noqa: E731
        name=name, start_ns=t0, end_ns=t1, id=i, parent=parent)
    ms = 1_000_000
    rec = [s("ode.solve", 0, 2 * ms, 1, 3),
           s("ode.solve", 3 * ms, 4 * ms, 2, 3),
           s("train.step", 0, 9 * ms, 3, None),
           s("ode.solve", 0, 3 * ms, 4, 5),
           s("train.step", 0, 11 * ms, 5, None)]
    got = spans.host_ms(rec, 2)
    # step 1 holds 3 ms of solves, step 2 holds 3: self (9 - 3 + 11 - 3) / 2
    assert got["train.step"] == {"ms": pytest.approx(10.0),
                                 "self_ms": pytest.approx(7.0), "count": 1.0}
    assert got["ode.solve"] == {"ms": pytest.approx(3.0),
                                "self_ms": pytest.approx(3.0),
                                "count": pytest.approx(1.5)}


def test_by_range_reads_the_same_ranges_with_spans_recorded():
    """A step's profile holds the three ``nodems.*`` ranges and no other,
    whether spans are recorded or not, so the device time by range reads
    what it read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from neural_ode_metasolver_tpu_torch import backend
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, create_train_state, make_optimizer, make_train_step)

    model = build_model("mnist", device="cpu", dim=8)
    opt = make_optimizer("sgd", 0.05)
    step = make_train_step(model, opt, [create_solver("rk2", "u", n_steps=2,
                                                       u0=0.5)],
                           SolverOptions(), AttackConfig(mode="fgsm"))
    ts = create_train_state(model, opt)
    x, y = torch.rand(2, 28, 28, 1), torch.tensor([1, 2])
    got = []
    for record in (False, True):
        with backend.record_spans() if record else backend._NOOP:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with record_function("nodebench.window"):
                    step(ts, x, y, torch.Generator().manual_seed(0))
        rec = trace.from_profiler(prof, "nodebench.window")
        got.append(sorted(r[0] for r in rec.ranges))
        assert not any(h[0].startswith(("train.", "ode."))
                       for h in rec.host)
    assert got[0] == got[1] == ["nodems.attack", "nodems.train_pass",
                                "nodems.update"]


@pytest.mark.parametrize("name", ["premetanode10.serve.b256",
                                  "mnist_metanode64.fleet27.clean"])
def test_the_span_windows_run_on_the_cpu(tiny_cell, name):
    """``benchmark/spans.py``'s windows end to end at a test's size: the
    CPU trace has no device time, so its window is one idle gap, split by
    span without loss, and every unit is one unit span."""
    import torch

    from benchmark.harness.cell import ROOT

    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import spans as cli

    cell = tiny_cell(name)
    driver = cell.driver()
    run = driver.setup(cell, 2147483931, torch.device("cpu"))
    out = cli.measure(cell, driver, run, torch.device("cpu"), pairs=2)
    t = out["traced"]
    assert t["idle_by_span_sum_ms"] == pytest.approx(t["idle_ms"])
    unit = "serve.request" if "serve" in name else "train.step"
    host = out["untraced"]["host_ms"]
    assert host[unit]["count"] == 1.0 and host[unit]["ms"] > 0
    # B2's two blocks a request; the clean fleet's one training forward
    assert host["ode.solve"]["count"] == (2.0 if "serve" in name else 1.0)
    win = out["untraced"]
    assert len(win["spans_wall_s"]) == len(win["plain_gc_s"]) == 2
    assert all(0 <= g <= w for g, w in zip(win["spans_gc_s"],
                                           win["spans_wall_s"]))
    assert out["span_ns"]["on"] > out["span_ns"]["off"] > 0
