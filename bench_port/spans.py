"""The card's idle time in a traced episode split by the program span that the host was in,
and each program span's self time on the host, from the profiler's events; and a command
that prints both for one traced episode of a cell, with the untraced episodes after it:

    python3 bench_port/spans.py --workload <cell> --seed <n> [--untraced <k>]

Program spans are the host ranges that the program records at its layer boundaries
(``tube_mpc_tpu_torch/utils/profiling.py::annotate``), named ``tube.*``, ``lane.*`` and
``kernel.*``; they share the clock of the card's rows. At each instant the innermost
open program span owns the host; the harness's spans and the aten operations own nothing,
and an instant under no program span belongs to ``(none)``. A span's self time is the time
it owns; a gap in the card's work (the busy union of ``trace.reduce_events``) is divided
among the owners by overlap. A program without spans puts everything under ``(none)``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port.trace import EPISODE_SPAN, SPANS, _union  # noqa: E402

PREFIXES = ("tube.", "lane.", "kernel.")
NONE = "(none)"


def is_program_span(name: str) -> bool:
    return name.startswith(PREFIXES)


def _owned(spans: List[Tuple[int, int, str]], w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """[w0, w1] cut into pieces (start, end, owner): the innermost open span of ``spans``
    (start, end, name), the one opened last of those still open, or NONE."""
    spans = [sp for sp in spans if sp[1] > sp[0]]
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    out, open_, t = [], [], w0
    for at, starts, i in marks:   # at one instant ends come before starts
        at = min(max(at, w0), w1)
        if at > t:
            out.append((t, at, spans[open_[-1]][2] if open_ else NONE))
            t = at
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if w1 > t:
        out.append((t, w1, NONE))
    return out


def _timeline(events):
    """The episode's window, the card's idle gaps in it (the complement of the union of
    its kernel, copy and set rows, as trace.reduce_events takes it) and the host's owned
    pieces, in ns."""
    dev, spans, window = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in SPANS:
                dev.append((e.start_ns(), e.end_ns()))
        elif name == EPISODE_SPAN:
            window = (e.start_ns(), e.end_ns())
        elif is_program_span(name):
            spans.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return None
    w0, w1 = window
    gaps, prev = [], w0
    for s, e in _union([(max(s, w0), min(e, w1)) for s, e in dev if min(e, w1) > max(s, w0)]):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps, _owned(spans, w0, w1)


def idle_by_span(events) -> Dict[str, float]:
    """{owner: seconds of the traced episode in which the card ran nothing and the host was
    in that program span}; empty without the harness's episode span."""
    tl = _timeline(events)
    if tl is None:
        return {}
    gaps, pieces = tl
    idle: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps:   # both lists are in time order and do not overlap themselves
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            idle[name] += (min(e, g1) - max(s, g0)) * 1e-9
            k += 1
    return dict(idle)


def self_by_span(events) -> Dict[str, float]:
    """{owner: seconds of the traced episode in which the host was in that program span and
    in none inside it}: each span's self time, summed by name."""
    tl = _timeline(events)
    if tl is None:
        return {}
    own: Dict[str, float] = defaultdict(float)
    for s, e, name in tl[1]:
        own[name] += (e - s) * 1e-9
    return dict(own)


def program_counts() -> Dict[str, int]:
    """The program's solve counts (ops/cuda/__init__.py::solve_counts), or {} for a
    program without them."""
    try:
        from tube_mpc_tpu_torch.ops.cuda import solve_counts
    except ImportError:
        return {}
    return solve_counts()


def main(argv=None) -> int:
    """One traced episode of a cell (as the benchmark's ``--trace 1`` run traces its
    window's first), then ``--untraced`` episodes timed by the host's clock; one JSON
    line."""
    from bench_port import run as bench
    from bench_port.trace import Tracer

    ap = argparse.ArgumentParser(prog="python3 bench_port/spans.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--untraced", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    mode = bench.prepare(cell, "cuda")
    gc.collect()
    gc.freeze()
    tracer = Tracer(mode)
    bench.episode(mode, args.seed, 0, mode.H, tracer)
    counts = program_counts()
    events = tracer.prof.profiler.kineto_results.events()
    rec = tracer.record
    cuda = [e.device_type() == torch.autograd.DeviceType.CUDA for e in events]
    span_rows = sum(1 for e, c in zip(events, cuda) if c and is_program_span(e.name()))
    spans = sum(1 for e, c in zip(events, cuda) if not c and is_program_span(e.name()))
    untraced = []
    for e in range(1, args.untraced + 1):
        t0 = time.perf_counter()
        bench.episode(mode, args.seed, e, mode.H)
        untraced.append(time.perf_counter() - t0)
    ric_lanes = sum(b * n for (k, b), n in rec["launches_by_width"].items() if k == "ric")
    top = lambda d: {k: round(v, 6) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    print(json.dumps(dict(
        workload=args.workload, seed=args.seed, device=torch.cuda.get_device_name(0),
        traced_s=rec["traced_s"], busy_s=rec["busy_s"], window_s=rec["traced_window_s"],
        device_idle_frac=100.0 * (1.0 - rec["busy_s"] / rec["traced_window_s"]),
        cuda_rows_named_as_program_spans=span_rows, program_spans_per_step=spans / mode.H,
        steps=mode.H, solve_counts=counts,
        host_reads_per_step=counts["host_reads"] / mode.H if counts else None,
        useful_iter_frac=(100.0 * counts["live_lane_iters"] / ric_lanes
                          if counts and ric_lanes else None),
        launches=rec["launches"], idle_by_span=top(idle_by_span(events)),
        self_by_span=top(self_by_span(events)), untraced_episode_s=untraced)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
