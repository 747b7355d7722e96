"""The port's program spans (``backend.span``) on the CPU: off by default at
the cost of a flag check, recorded with their parents, threads and units
inside ``record_spans()``, placed where the work happens (a train step, a
fleet step, a served request, the data wait, a checkpoint save), mapped
onto ``torch.profiler``'s timeline, and written into ``profiling.trace``'s
``trace.json``."""
import json
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from neural_ode_metasolver_tpu_torch import backend
from neural_ode_metasolver_tpu_torch.data import (batch_iterator,
                                                  synthetic_dataset)
from neural_ode_metasolver_tpu_torch.data.prefetch import prefetch_to_device
from neural_ode_metasolver_tpu_torch.models import build_model
from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                 create_solver,
                                                 meta_integrate)
from neural_ode_metasolver_tpu_torch.serving import ServedModel
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig, NoiseConfig, create_fleet_state, create_train_state,
    fleet_generators, make_fleet_train_step, make_optimizer,
    make_train_step, profiling, save_checkpoint)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

SOLVERS = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
ATTACK = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255)
NOISE = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
PHASES = ("nodems.attack", "nodems.train_pass", "nodems.update")


def _mnist_batch(n=4, seed=0):
    ds = synthetic_dataset(n, (28, 28, 1), seed=seed)
    x, y = next(iter(batch_iterator(ds, n, seed=seed)))
    return torch.from_numpy(x), torch.from_numpy(y).long()


def _by_id(rec):
    return {s.id: s for s in rec}


def _inside(rec, child, parent_name):
    """Whether ``child``'s chain of parents holds a span named
    ``parent_name``, whose interval contains the child's."""
    ids = _by_id(rec)
    p = ids.get(child.parent)
    while p is not None:
        if p.name == parent_name:
            return p.start_ns <= child.start_ns <= child.end_ns <= p.end_ns
        p = ids.get(p.parent)
    return False


def _train_step(seed=0):
    model = build_model("mnist", device="cpu", dim=8,
                        generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
    step = make_train_step(model, opt, SOLVERS, SolverOptions(), ATTACK,
                           NOISE)
    return step, create_train_state(model, opt)


def test_spans_are_off_outside_a_recording():
    """Outside ``record_spans`` a span is the one shared no-op and nothing
    is kept; a recording opened later sees none of it."""
    off = backend.span("ode.solve", path="rk", steps=8)
    assert off is backend.span("train.step", unit=True)
    with off:
        with backend.span("inner"):
            pass
    with backend.record_spans() as rec:
        pass
    assert rec == [] and not backend._RECORDINGS
    step, ts = _train_step()
    x, y = _mnist_batch()
    step(ts, x, y, torch.Generator().manual_seed(1))
    with backend.record_spans() as rec:
        assert backend.span("x") is not off
    assert rec == []


def test_a_span_keeps_its_parent_thread_unit_and_attributes():
    with backend.record_spans() as outer:
        with backend.span("serve.request", unit=True, batch=4):
            with backend.span("serve.copy_in", bytes=48):
                pass
            seen = []
            t = threading.Thread(target=lambda: seen.append(
                _one_span("elsewhere")))
            t.start()
            t.join()
        with backend.record_spans() as inner:
            with backend.span("serve.request", unit=True):
                pass
    req, copy = (next(s for s in outer if s.name == n)
                 for n in ("serve.request", "serve.copy_in"))
    assert copy.parent == req.id and req.parent is None
    assert copy.unit == req.unit == req.id
    assert req.attrs == {"batch": 4} and copy.attrs == {"bytes": 48}
    assert copy.thread == req.thread == threading.get_native_id()
    other = next(s for s in outer if s.name == "elsewhere")
    # no parent on its own thread; the open unit is the process's
    assert other.parent is None and other.unit == req.unit
    assert other.thread == seen[0] != req.thread
    assert [s.name for s in inner] == ["serve.request"]
    assert inner[0].unit != req.unit and len(outer) == 4
    assert outer.wall(req.start_ns) - outer.wall_ns == \
        req.start_ns - outer.perf_ns


def _one_span(name):
    with backend.span(name):
        pass
    return threading.get_native_id()


def test_a_train_step_records_its_phases_solves_and_backwards():
    step, ts = _train_step()
    x, y = _mnist_batch()
    with backend.record_spans() as rec:
        step(ts, x, y, torch.Generator().manual_seed(1))
    names = [s.name for s in rec]
    (top,) = [s for s in rec if s.name == "train.step"]
    assert top.parent is None and {s.unit for s in rec} == {top.id}
    for name in ("train.draws",) + PHASES:
        (s,) = [s for s in rec if s.name == name]
        assert s.parent == top.id, name
    # MNIST's one ODE block: the attack's forward and the training pass's
    solves = [s for s in rec if s.name == "ode.solve"]
    assert len(solves) == 2
    assert all(s.attrs == {"path": "rk", "steps": 2} for s in solves)
    assert _inside(rec, solves[0], "nodems.attack")
    assert _inside(rec, solves[1], "nodems.train_pass")
    backs = [s for s in rec if s.name == "train.backward"]
    assert len(backs) == 2 and _inside(rec, backs[0], "nodems.attack") \
        and _inside(rec, backs[1], "nodems.train_pass")
    assert all(_inside(rec, s, "train.step") for s in rec if s is not top)
    assert names.count("train.step") == 1


def test_the_fleet_step_records_one_unit_a_step():
    model = build_model("mnist", device="cpu", dim=8)
    opt = make_optimizer("rmsprop", 1e-3)
    fstep = make_fleet_train_step(model, opt, SOLVERS, SolverOptions(),
                                  ATTACK, NOISE)
    fts = create_fleet_state(model, opt, [1, 2])
    xs, ys = zip(*(_mnist_batch(seed=i) for i in range(2)))
    x, y = torch.stack(xs), torch.stack(ys)
    gens = fleet_generators([11, 12])
    with backend.record_spans() as rec:
        fts, _ = fstep(fts, x, y, gens)
        fstep(fts, x, y, gens)
    tops = [s for s in rec if s.name == "train.step"]
    assert len(tops) == 2 and tops[0].unit != tops[1].unit
    for top in tops:
        mine = [s.name for s in rec if s.unit == top.unit]
        assert sorted(mine) == sorted(
            ["train.step", "train.draws", *PHASES, "ode.solve", "ode.solve",
             "train.backward", "train.backward"])


def test_a_served_request_records_its_copy_in_and_b2_solves():
    """premetanode10's ODE blocks go to B2's ``ode_block_rk2_forward``
    (its plain version on the CPU) under the exact GELU: two solves."""
    model = build_model("premetanode10", device="cpu", in_planes=8,
                        acts=("GeLU",) * 3)
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    served = ServedModel(model, solvers, SolverOptions())
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    with backend.record_spans() as rec:
        served(x)
    (req,) = [s for s in rec if s.name == "serve.request"]
    (copy,) = [s for s in rec if s.name == "serve.copy_in"]
    solves = [s for s in rec if s.name == "ode.solve"]
    assert req.attrs == {"batch": 3} and copy.attrs == {"bytes": x.nbytes}
    assert copy.parent == req.id and req.unit == req.id
    assert len(solves) == 2 and all(
        s.attrs == {"path": "b2", "steps": 2} and s.unit == req.id
        and _inside(rec, s, "serve.request") for s in solves)
    assert copy.end_ns <= solves[0].start_ns


def test_a_span_contains_its_range_on_the_profilers_timeline():
    """The clock pair of ``record_spans`` maps a span onto the profiler's
    timeline (``trace_start_ns``): it holds the ``record_function`` range
    it encloses, every time, and its edges lie within 50 us of the range's
    (the median of nine; the rest is the host's own pace)."""
    n = 9
    with backend.record_spans() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):
                torch.ones(256).mul(2).sum()
            for i in range(n):
                with backend.span(f"s{i}"):
                    with record_function(f"r{i}"):
                        torch.ones(256).mul(2).sum()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    placed = {s.name: (a, b) for s, a, b in
              profiling.on_profiler(rec, start_ns)}
    ranges = {e.name: (e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CPU
              and e.name[0] == "r" and e.name[1:].isdigit()}
    assert len(ranges) == n
    gaps = []
    for i in range(n):
        (a, b), (ra, rb) = placed[f"s{i}"], ranges[f"r{i}"]
        assert a <= ra and rb <= b, (i, a, ra, rb, b)
        gaps += [ra - a, b - rb]
    assert float(np.median(gaps)) < 50, gaps


def test_profiling_trace_writes_the_windows_spans(tmp_path):
    step, ts = _train_step()
    x, y = _mnist_batch()
    with backend.record_spans() as before:
        step(ts, x, y, torch.Generator().manual_seed(1))  # not traced
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("nodems.test", what=1):
            step(ts, x, y, torch.Generator().manual_seed(2))
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    names = [e["name"] for e in spans]
    assert sorted(names) == sorted([s.name for s in before] + ["nodems.test"])
    ann = next(e for e in spans if e["name"] == "nodems.test")
    top = next(e for e in spans if e["name"] == "train.step")
    assert top["args"]["parent"] == ann["args"]["id"]
    assert ann["args"]["what"] == 1 and ann["tid"] >= profiling.SPAN_ROW
    # the step's phase ranges sit inside its span on the file's timeline
    for name in PHASES:
        rng = next(e for e in events if e.get("name") == name
                   and e.get("cat") != "span")
        assert top["ts"] <= rng["ts"] + 50
        assert rng["ts"] + rng["dur"] <= top["ts"] + top["dur"] + 50
    assert any(e.get("ph") == "M" and e.get("tid") == ann["tid"]
               for e in events)


@pytest.mark.parametrize("record", [False, True])
def test_only_the_three_phases_are_nodems_ranges(record):
    """The benchmark reads device time by the ``nodems.*`` range open at
    each launch: a step's profile holds the three phases as ranges whether
    spans are recorded or not, and no other span becomes such a range."""
    step, ts = _train_step()
    x, y = _mnist_batch()
    with backend.record_spans() if record else backend._NOOP:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(ts, x, y, torch.Generator().manual_seed(1))
    ranges = [e.name for e in prof.events() if e.name.startswith("nodems.")]
    assert sorted(ranges) == sorted(PHASES)
    assert not any(e.name.startswith(("train.", "ode.", "serve."))
                   for e in prof.events())


def test_the_data_wait_and_checkpoint_save_record_their_spans(tmp_path):
    ds = synthetic_dataset(12, (28, 28, 1), seed=3)
    with backend.record_spans() as rec:
        got = list(prefetch_to_device(batch_iterator(ds, 4, seed=1), size=2,
                                      device="cpu", thread=True))
    waits = [s for s in rec if s.name == "data.wait"]
    # one wait per batch and one for the end of the stream
    assert len(got) == 3 and len(waits) == 4
    assert {s.thread for s in waits} == {threading.get_native_id()}
    _, ts = _train_step()
    with backend.record_spans() as rec:
        save_checkpoint(str(tmp_path / "ckpt"), ts)
    assert [s.name for s in rec] == ["checkpoint.save"]


def test_a_switch_solve_records_its_regime_draw():
    solvers = [create_solver("rk2", "u", n_steps=2, u0=u)
               for u in (0.5, 1.0)]
    opts = SolverOptions(solver_mode="switch")
    y0 = torch.ones(2, 3)
    with backend.record_spans() as rec:
        meta_integrate(solvers, lambda t, y: -y, y0, opts,
                       torch.Generator().manual_seed(0))
    solve, draw = (next(s for s in rec if s.name == n)
                   for n in ("ode.solve", "regime.draw"))
    assert draw.parent == solve.id and solve.attrs["path"] == "rk"
