"""Faults planted in the timed path underneath a run, each a way in which the program
could answer wrongly that the check (modes/<mode>.py) has to catch: the step's carry
returned unchanged; half of the lanes not advanced; the applied control altered where the
step produces it; the solves returning their warm start on half of the lanes; a compacted
stage of the straggler compaction whose result is not scattered back. The check's tests
plant them on the CPU (tests/test_bench_port_check.py), and control.py reads them on the
card at a cell's own size.

    with planted("warm_half"):
        ... episodes of the entry ...
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("unchanged", "half", "altered", "warm_half", "no_scatter")


def _even_lanes(n: int, device, ndim: int) -> torch.Tensor:
    return (torch.arange(n, device=device) % 2 == 0).view((-1,) + (1,) * (ndim - 1))


def _step_fault(fault: str):
    def wrap(make):
        def make_broken(*a, **k):
            step = make(*a, **k)

            def bad(state, w):
                new, log = step(state, w)
                if fault == "unchanged":
                    return state, log
                if fault == "half":
                    pick = lambda n, o: torch.where(_even_lanes(w.shape[0], w.device, n.ndim), n, o)
                    return type(new)(*(type(n)(*map(pick, n, o)) if isinstance(n, tuple)
                                       else pick(n, o) for n, o in zip(new, state))), log
                return new, (log[0], log[1] + 0.05) + log[2:]

            return bad

        return make_broken

    return wrap


def _warm_half(solve):
    """Each solve answers the clamped warm start and its rollout on the even lanes."""

    def warm(pb, cfg, **k):
        out = solve(pb, cfg, **k)
        idle = solve(pb, dataclasses.replace(cfg, max_iter=0), **k)
        even = lambda a: _even_lanes(a.shape[0], a.device, a.ndim)
        return tuple(torch.where(even(a), b, a) for a, b in zip(out[:2], idle[:2])) + out[2:]

    return warm


def _no_scatter(improve):
    """A compacted stage runs, and the lanes it iterated keep the values they had before
    it: its results are never written back. Each solve's first stage runs at full width
    from iteration 0; a later stage on fewer lanes is a compacted one."""
    full = [0]

    def stage(pb, x_hat0, X_ref, U_ref, C, s, cap, **k):
        out = improve(pb, x_hat0, X_ref, U_ref, C, s, cap, **k)
        if s.it == 0:
            full[0] = s.U.shape[-1]
        elif s.U.shape[-1] < full[0]:
            stage.compacted += 1
            return s._replace(it=out.it)
        return out

    stage.compacted = 0
    return stage


@contextlib.contextmanager
def planted(fault: str):
    """Plant ``fault`` in the program's modules for the block; yields the planted wrapper."""
    from tube_mpc_tpu_torch.ops.cuda import lane_solver
    from tube_mpc_tpu_torch.tube import lane_closed_loop as loop

    if fault == "warm_half":
        owner, attr, wrap = loop, "tube_ilqr_solve_lanes", _warm_half
    elif fault == "no_scatter":
        owner, attr, wrap = lane_solver, "_improve", _no_scatter
    elif fault in FAULTS:
        owner, attr, wrap = loop, "make_paper_lane_step", _step_fault(fault)
    else:
        raise ValueError(f"no fault {fault!r}; the faults are {', '.join(FAULTS)}")
    original = getattr(owner, attr)
    wrapper = wrap(original)
    setattr(owner, attr, wrapper)
    try:
        yield wrapper
    finally:
        setattr(owner, attr, original)
