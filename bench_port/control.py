"""The check's readings for one cell, on the cell's card at its own size: the program's
numbers on a dozen seeds or more (the lower readings), the control's, the plain reference
in bfloat16 put in the program's place, on three seeds or more (the upper readings), and
the program's with a fault planted in its timed path (bench_port/faults.py); limits are
set between them (bench_port/limits/<cell>.json, PERF.md).

    python3 bench_port/control.py --workload <cell> --seeds 1,2,...,12 --control-seeds 1,2,3 \\
        --faults warm_half,no_scatter --fault-seeds 21,22,23 [--lanes]

One set-up, then for each seed one episode as a run's window holds it (the same pool,
draw order, kept steps and check sample as a run of that seed), its numbers printed as one
JSON line; ``--lanes`` adds each kept (step, lane) pair's numbers before reduction.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_port import run as bench  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser(prog="python3 bench_port/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--lanes", action="store_true")
    args = ap.parse_args()
    import torch

    from bench_port.faults import planted
    from bench_port.modes.paper import Control, reduce

    cell = bench.load_cell(args.workload)
    mode = bench.prepare(cell, "cuda")
    samples = int(mode.traffic["check"]["samples"])
    control_seeds = set(seeds(args.control_seeds))
    runs = [(s, None) for s in seeds(args.seeds)]
    runs += [(s, f) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]

    def reading(win, seed, candidate=None):
        start, lanes = mode.judged(win["kept"], bench.check_seed(seed), samples, candidate)
        out = dict(start_gap=start, **reduce(lanes))
        if args.lanes:
            out["lanes"] = {k: [float(f"{x:.3g}") for x in v.double().tolist()]
                            for k, v in lanes.items()}
        return out

    for seed, fault in runs:
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        if fault is None:
            win = bench.window(mode, seed, 0.0)
            line = dict(seed=seed)
        else:
            with planted(fault) as wrapper:
                win = bench.window(mode, seed, 0.0)
            line = dict(seed=seed, fault=fault,
                        compacted_stages=getattr(wrapper, "compacted", None))
        t1 = time.perf_counter()
        torch.set_num_threads(8)
        line.update(episode_s=t1 - t0, failed=win["failed"], program=reading(win, seed))
        t2 = time.perf_counter()
        line["check_s"] = t2 - t1
        if fault is None and seed in control_seeds:
            line["control"] = reading(win, seed, Control(cell["config"], torch.bfloat16, "cuda"))
            line["control_s"] = time.perf_counter() - t2
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
