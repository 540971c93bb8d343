"""The split of the card's idle time by program span (bench_port/spans.py) on a hand-worked
event list, reduce_events unmoved by host-only program spans, and the two readers of the
program's solve counters (host_reads_per_step, useful_iter_frac) on a record and on a
program without the counters."""
import pytest
import torch

import tube_mpc_tpu_torch.ops.cuda as ops_cuda
from bench_port.metrics import host_reads_per_step, useful_iter_frac
from bench_port.spans import NONE, idle_by_span, self_by_span
from bench_port.trace import EPISODE_SPAN, SOLVE_SPAN, reduce_events
from tube_mpc_tpu_torch.ops.cuda import lane_solver


class Ev:
    """A profiler event: name, host or card, [start, end) in ns."""

    def __init__(self, name, start, end, cuda=False):
        self._name, self._start, self._end, self._cuda = name, start, end, cuda

    def name(self):
        return self._name

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end


# The episode [0, 100]; the card busy [10, 20] and [50, 60], idle [0, 10], [20, 50],
# [60, 100]. On the host: tube.step [0, 90] holds tube.nominal_solve [5, 45], which holds
# kernel.ric [15, 30] and lane.epilogue [30, 40]; the harness's bench.solve [4, 46] and
# an aten operation [32, 35] own nothing; nothing is open after 90.
DEVICE = [Ev("lane::ric_kernel<float, 0, 5>", 10, 20, cuda=True),
          Ev("lane::fwd_kernel<float, 0, 5>", 50, 60, cuda=True),
          Ev(SOLVE_SPAN, 4, 46, cuda=True)]
HARNESS = [Ev(EPISODE_SPAN, 0, 100), Ev(SOLVE_SPAN, 4, 46), Ev("aten::mul", 32, 35)]
PROGRAM = [Ev("tube.step", 0, 90), Ev("tube.nominal_solve", 5, 45), Ev("kernel.ric", 15, 30),
           Ev("lane.epilogue", 30, 40)]
EVENTS = DEVICE + HARNESS + PROGRAM


def test_idle_is_split_by_overlap_and_the_innermost_span_owns_it():
    idle = idle_by_span(EVENTS)
    # [0, 10]: tube.step 5, nominal 5; [20, 50]: ric 10, epilogue 10, nominal 5 (40-45),
    # tube.step 5 (45-50); [60, 100]: tube.step 30, nothing open 10
    want = {"tube.step": 40, "tube.nominal_solve": 10, "kernel.ric": 10, "lane.epilogue": 10,
            NONE: 10}
    assert idle == pytest.approx({k: v * 1e-9 for k, v in want.items()})
    assert sum(idle.values()) == pytest.approx(80e-9)


def test_self_time_is_the_time_each_span_owns():
    own = self_by_span(EVENTS)
    want = {"tube.step": 50, "tube.nominal_solve": 15, "kernel.ric": 15, "lane.epilogue": 10,
            NONE: 10}
    assert own == pytest.approx({k: v * 1e-9 for k, v in want.items()})


def test_a_program_without_spans_leaves_every_gap_unowned():
    assert idle_by_span(DEVICE + HARNESS) == pytest.approx({NONE: 80e-9})
    assert idle_by_span(DEVICE + PROGRAM) == {}   # no episode span: nothing to split


def test_reduce_events_is_unmoved_by_host_only_program_spans():
    with_spans, without = reduce_events(EVENTS), reduce_events(DEVICE + HARNESS)
    for key in ("busy_s", "device_ops", "traced_window_s"):
        assert with_spans[key] == pytest.approx(without[key])
    assert with_spans["busy_s"] == pytest.approx(20e-9)


@pytest.fixture
def counters(monkeypatch):
    """The program's counters as a window left them: 3 K1 launches at 100 lanes and 2 at
    50, 60 host reads, 240 lanes that entered an iteration unconverged."""
    monkeypatch.setattr(lane_solver.lane_ilqr_solve, "counts",
                        {"host_reads": 60, "live_lane_iters": 240})
    monkeypatch.setattr(lane_solver.ric, "by_width", {100: 3, 50: 2})
    return dict(B=100, steps=20, traced_steps=10, launches={"ric": 5})


def test_counter_readers_on_a_record(counters):
    assert host_reads_per_step.read(counters) == pytest.approx(3.0)
    assert useful_iter_frac.read(counters) == pytest.approx(60.0)   # 240 of 400 lanes


def test_counter_readers_silent_without_a_traced_record_or_the_counters(counters, monkeypatch):
    untraced = {k: v for k, v in counters.items() if k != "launches"}
    assert host_reads_per_step.read(untraced) is None and useful_iter_frac.read(untraced) is None
    monkeypatch.delattr(ops_cuda, "solve_counts")
    assert host_reads_per_step.read(counters) is None and useful_iter_frac.read(counters) is None


def test_useful_iter_frac_silent_without_k1_launches(counters, monkeypatch):
    monkeypatch.setattr(lane_solver.ric, "by_width", {})
    assert useful_iter_frac.read(counters) is None
