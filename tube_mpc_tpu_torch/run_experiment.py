"""Closed-loop adaptive tube-MPC experiment CLI of the port:

    python -m tube_mpc_tpu_torch.run_experiment --config configs/dubins.yaml [--batch B]
        [--engine lanes|xla] [--device cuda|cpu] [--compact-caps C1,C2[;N1]]
        [--checkpoint-every K] [--run-dir DIR] [--profile TRACE_DIR] [--plot]

The counterpart of the root run_experiment.py, with its flags: the same config, run
directory, artifacts and printed summary. --engine lanes (this CLI's default) runs the
lane kernels in f32, with the root CLI's default straggler compaction caps; --engine xla
(the root CLI's default) runs the feature-major solvers as batched PyTorch operations in
the config's dtype (use_float64 honoured). --device is the counterpart of --platform: the
card (cuda) by default, the CPU when asked. --checkpoint-every K runs the loop in
resumable K-step segments under <run_dir>/ckpt; the same command with --run-dir <run_dir>
resumes it. --profile writes a torch.profiler trace of the run into TRACE_DIR; --plot (or
plot: true in the config) writes the five figures into the run directory (matplotlib).
``main(argv)`` takes an argument list, so that it can be called in-process.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (sys.argv[1:] if None); returns the runner's results and
    the run directory."""
    ap = argparse.ArgumentParser(prog="python -m tube_mpc_tpu_torch.run_experiment")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--batch", type=int, default=None,
                    help="run B disturbance scenarios at once (default: 1)")
    ap.add_argument("--run-dir", type=str, default=None,
                    help="write into this run directory instead of a new one under out_dir "
                         "(required to resume a checkpointed run)")
    ap.add_argument("--engine", choices=("xla", "lanes"), default="lanes",
                    help="'lanes' (default): the lane kernels, f32; 'xla': the feature-major "
                         "solvers in the config's dtype (the root CLI's default)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): on the card; cpu: on the CPU (the lane kernels' plain "
                         "versions)")
    ap.add_argument("--plot", action="store_true", help="write the five figures into the run "
                    "directory (needs matplotlib)")
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="K",
                    help="run in resumable K-step segments, persisting the carry to "
                         "<run_dir>/ckpt; relaunch with --run-dir to resume (the XLA engine: "
                         "paper mode, one trajectory)")
    ap.add_argument("--profile", type=str, default=None, metavar="TRACE_DIR",
                    help="write a torch.profiler trace of the run into TRACE_DIR")
    ap.add_argument("--compact-caps", type=str, default=None, metavar="C1,C2[;N1]",
                    help="lanes engine: straggler-compaction iteration caps of the ancillary "
                         "(and after ';' the nominal) solves, bitwise-identical results; "
                         "default '1,4,8' when the config clips gradients, else '2,5,8' (the "
                         "root CLI's); '' disables")
    args = ap.parse_args(argv)
    if args.batch is not None and args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.checkpoint_every is not None and args.checkpoint_every < 1:
        ap.error("--checkpoint-every must be >= 1")
    if args.engine == "xla" and args.compact_caps:
        ap.error("--compact-caps: compact_caps is a lanes-engine feature (--engine lanes)")

    import torch

    from .runners import run_experiment
    from .utils.config import load_config, read_yaml
    from .utils.io import make_run_dir, save_json
    from .utils.profiling import trace

    cfg = load_config(args.config)
    if args.compact_caps is None and args.engine == "lanes":
        # the root CLI's defaults: clipped adaptation converges in fewer iterations, so
        # its shorter straggler tail takes earlier compaction
        args.compact_caps = "1,4,8" if cfg.adaptation.grad_clip_norm else "2,5,8"
    if cfg.use_float64 and args.engine == "lanes":
        print("note: --engine lanes is float32-only; ignoring use_float64")
    if args.engine == "xla":
        torch.set_float32_matmul_precision("highest")

    run_dir = args.run_dir or make_run_dir(cfg.out_dir, cfg.run_name)
    profiled = (trace(args.profile, device=args.device) if args.profile
                else contextlib.nullcontext())
    # debug_numerics: the anomaly mode too (utils/debug.debug_nans), for this run only
    with profiled, torch.autograd.set_detect_anomaly(cfg.debug_numerics, check_nan=True):
        results = run_experiment(cfg, run_dir, batch=args.batch, engine=args.engine,
                                 device=args.device, checkpoint_every=args.checkpoint_every,
                                 compact_caps=args.compact_caps)
    save_json(run_dir, "config_used.json", read_yaml(args.config))

    print(f"Saved run to: {run_dir}")
    print(json.dumps(results["summary"], indent=2, ensure_ascii=False))

    if cfg.plot or args.plot:
        from .plotting import plot_run

        plot_run(run_dir, obstacles=[dict(o) for o in cfg.environment.obstacles], show=False)
        print("Plots saved.")
    return dict(results, run_dir=run_dir)


if __name__ == "__main__":
    main()
