"""The traced run: torch.profiler over one episode of the window, the harness's own spans
around the two solves, and the program's kernel launch counts, reduced to one record
that the per-layer metrics read (bench_port/metrics/)."""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SOLVE_SPAN = "bench.solve"
EPISODE_SPAN = "bench.episode"


def _short(name: str) -> str:
    """A kernel's or operation's name without its argument list and return type."""
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:120]


class Tracer:
    """Context over one episode of ``mode``: profiles the host and the card, times each
    call of the entry's solve (the mode's ``solve_owner.solve_attr``, wrapped for the
    episode only) from the host, and counts the program's kernel launches."""

    def __init__(self, mode):
        self.mode = mode
        self.record: Dict = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        from tube_mpc_tpu_torch.ops.cuda import reset_launch_counts

        owner, attr = self.mode.solve_owner, self.mode.solve_attr
        self.solve = getattr(owner, attr)
        self.solve_s = 0.0
        solve = self.solve

        def timed(*a, **k):
            with torch.profiler.record_function(SOLVE_SPAN):
                t0 = time.perf_counter()
                out = solve(*a, **k)
                self.solve_s += time.perf_counter() - t0
            return out

        setattr(owner, attr, timed)
        reset_launch_counts()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = torch.profiler.record_function(EPISODE_SPAN)
        self.span.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from tube_mpc_tpu_torch.ops.cuda import launch_counts

        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        setattr(self.mode.solve_owner, self.mode.solve_attr, self.solve)
        if exc[0] is not None:
            return False
        t_reduce = time.perf_counter()
        self.record = dict(traced_s=wall, solve_s=self.solve_s, launches=launch_counts(),
                           launches_by_width=launch_counts(by_width=True),
                           **reduce_events(self.prof.profiler.kineto_results.events()))
        self.record["reduce_s"] = time.perf_counter() - t_reduce
        return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


SPANS = {EPISODE_SPAN, SOLVE_SPAN}


def reduce_events(events) -> Dict:
    """From the profiler's raw events: the episode span's window, the card's busy time (the
    union of its kernel, copy and set intervals inside the window; the spans' own device
    rows, which carry the harness's span names, are not work), the device time of each
    kernel or operation by name, and the card's idle time by the host operation that was
    running at each gap's middle (the innermost one; the harness's solve span when nothing
    inside it was)."""
    dev, cpu = [], []
    window = None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in SPANS:
                dev.append((e.start_ns(), e.end_ns(), name))
        elif name == EPISODE_SPAN:
            window = (e.start_ns(), e.end_ns())
        else:
            cpu.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return {}
    w0, w1 = window
    by_name: Dict[str, float] = defaultdict(float)
    inside = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            inside.append((s, e))
            by_name[_short(name)] += (e - s) * 1e-9
    busy = _union(inside)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    cpu = sorted(c for c in cpu if c[1] >= w0 and c[0] <= w1)
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name = "(no host operation)"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - 200), -1):
            if cpu[j][1] >= mid:
                name = _short(cpu[j][2])
                break
        idle[name] += (e - s) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(traced_window_s=(w1 - w0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                device_ops=dict(by_name), breakdown=dict(device_ops=top(by_name),
                                                         idle_gaps=top(idle)))
