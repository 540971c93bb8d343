"""The port's spans and solve counters (utils/profiling.py::annotate,
ops/cuda/__init__.py::solve_counts), on the CPU: one paper step of configs/dubins.yaml cut
to N=6, B=160 lanes from scattered starts, both solves with the caps (1, 3), so that the
loop runs a compacted stage and a full-width one, run once under torch.profiler and once
without it.

- Every span of the step appears, in the span it belongs to: the step's phases in
  ``tube.step``, the solver's spans and the kernel wrappers' in the solves or the
  sensitivity; no operation runs in ``tube.step`` outside its phases.
- No program span is a user annotation (which would get a device row under CUPTI).
- The step's outputs are bitwise the same with the profiler on and off.
- ``host_reads`` equals the ``aten::_local_scalar_dense`` events in the solves (each
  ``int``/``bool`` of a tensor dispatches one), and ``live_lane_iters`` the sum of both
  solves' ``with_lane_iters`` counts; ``reset_launch_counts`` zeroes both.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tube_mpc_tpu_torch.ops.cuda import lane_solver, reset_launch_counts, solve_counts
from tube_mpc_tpu_torch.presets import config_setup
from tube_mpc_tpu_torch.tube.lane_closed_loop import make_paper_lane_step, paper_lane_init_state
from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem
from tube_mpc_tpu_torch.utils.config import load_config

B, N, CAPS = 160, 6, (1, 3)
SOLVES = ("tube.nominal_solve", "tube.ancillary_solve")
# each span's name, and the names of the spans it may sit in directly
PARENTS = {
    "tube.step": (None,),
    "tube.nominal_solve": ("tube.step",),
    "tube.ancillary_solve": ("tube.step",),
    "tube.sensitivity": ("tube.step",),
    "tube.update": ("tube.step",),
    "tube.propagate": ("tube.step",),
    "lane.solve_setup": SOLVES,
    "lane.host_read": SOLVES,
    "lane.epilogue": SOLVES,
    "lane.compact": SOLVES,
    "lane.scatter": SOLVES,
    "kernel.ric": SOLVES,
    "kernel.fwd": SOLVES + ("lane.solve_setup",),
    "kernel.sbwd": ("tube.sensitivity",),
    "kernel.sfwd": ("tube.sensitivity",),
}


def is_span(name: str) -> bool:
    return name.split(".")[0] in ("tube", "lane", "kernel")


def owners(events, spans=is_span):
    """For each of ``events`` (host events of one thread), the innermost other event
    whose name ``spans`` accepts that holds it, or None: one sweep in start order, with
    the spans that are open on a stack (ranges of one thread nest)."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i].start_ns(), -events[i].end_ns()))
    owner, stack = [None] * len(events), []
    for i in order:
        e = events[i]
        while stack and stack[-1].end_ns() < e.end_ns():
            stack.pop()
        owner[i] = stack[-1] if stack else None
        if spans(e.name()):
            stack.append(e)
    return owner


@pytest.fixture(scope="module")
def run():
    """The step's outputs, counts and stages without the profiler and with it, and the
    profiled step's host events."""
    s = config_setup(load_config("configs/dubins.yaml"), N=N, H=3, device="cpu",
                     dtype=torch.float32)
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                target=s.target, B=B, dtype=torch.float32, device="cpu",
                                iter_telemetry=True, nom_compact_caps=CAPS,
                                aux_compact_caps=CAPS)
    g = torch.Generator().manual_seed(0)
    x0 = s.x0 + 0.3 * torch.randn((B, s.system.nx), generator=g)
    state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp, x0=x0,
                                  B=B, dtype=torch.float32)
    w_t = 0.01 * torch.randn((B, s.system.nx), generator=g)

    out = {}
    reset_launch_counts()
    out["off"] = step(state, w_t)
    out["off_counts"], out["off_stages"] = solve_counts(), dict(lane_solver.lane_ilqr_solve.stages)
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out["on"] = step(state, w_t)
    out["on_counts"], out["on_stages"] = solve_counts(), dict(lane_solver.lane_ilqr_solve.stages)
    out["events"] = [e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CPU]
    out["owner"] = owners(out["events"])
    out["solve"] = owners(out["events"], lambda name: name in SOLVES)
    return out


def test_the_step_runs_a_compacted_and_a_full_width_stage(run):
    assert run["off_stages"] == run["on_stages"]
    assert run["on_stages"]["compacted"] >= 1 and run["on_stages"]["full"] >= 1


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_span_sits_in_its_layer(run, name):
    parents = [p for e, p in zip(run["events"], run["owner"]) if e.name() == name]
    assert parents, f"no {name} span"
    for p in parents:
        assert (p.name() if p is not None else None) in PARENTS[name]


def test_every_span_is_named_and_every_operation_is_under_a_phase(run):
    assert {e.name() for e in run["events"] if is_span(e.name())} == set(PARENTS)
    ops = [(e, p) for e, p in zip(run["events"], run["owner"])
           if e.name().startswith("aten::") and p is not None]
    assert ops
    for e, p in ops:
        assert p.name() != "tube.step", e.name()


def test_no_program_span_is_a_user_annotation(run):
    spans = [e for e in run["events"] if is_span(e.name())]
    assert spans and not any(e.is_user_annotation() for e in spans)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def test_the_step_is_bitwise_with_the_profiler_on_and_off(run):
    (s_off, log_off), (s_on, log_on) = run["off"], run["on"]
    leaves = lambda state, log: [*state[:6], *state.adapt, *state.vel, *log]
    for a, b in zip(leaves(s_off, log_off), leaves(s_on, log_on), strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert run["off_counts"] == run["on_counts"]


def test_host_reads_are_the_scalar_reads_in_the_solves(run):
    reads = Counter(p is not None for e, p in zip(run["events"], run["solve"])
                    if e.name() == "aten::_local_scalar_dense")
    assert reads[True] == run["on_counts"]["host_reads"] > 0
    # one a loop test of each call of _improve, one a stage after the first cap: at least
    # one a solve's iteration
    assert run["on_counts"]["host_reads"] > max(run["on"][1][-2].max(), 0)


def test_live_lane_iters_sum_the_lane_iteration_counts(run):
    nom_iters, aux_iters = run["on"][1][-2], run["on"][1][-1]
    assert run["on_counts"]["live_lane_iters"] == int(nom_iters.sum() + aux_iters.sum()) > 0


def test_reset_launch_counts_zeroes_the_solve_counts(run):
    lane_solver.lane_ilqr_solve.counts["host_reads"] += 5
    reset_launch_counts()
    assert solve_counts() == {"host_reads": 0, "live_lane_iters": 0}
