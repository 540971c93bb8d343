"""Closed-loop adaptive tube-MPC experiment CLI of the port:

    python -m tube_mpc_tpu_torch.run_experiment --config configs/dubins.yaml [--batch B]
        [--engine lanes|xla] [--device cuda|cpu]

The counterpart of the root run_experiment.py: the same config, run directory,
artifacts and printed summary. --engine lanes (this CLI's default) runs the lane
kernels in f32; --engine xla (the root CLI's default) runs the feature-major solvers as
batched PyTorch operations in the config's dtype (use_float64 honoured). --device is the
counterpart of --platform: the card (cuda) by default, the CPU when asked. Flags whose
feature is not ported yet are refused with the ROADMAP.md item that would bring it; none
is ignored. ``main(argv)`` takes an argument list, so that it can be called in-process.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

NOT_PORTED = {
    "--compact-caps": "straggler compaction is not ported yet (ROADMAP.md, queue A item 3); "
                      "the port runs uncompacted, which gives a bitwise-identical result",
    "--checkpoint-every": "checkpoint and resume are not ported yet (ROADMAP.md, queue A item 5)",
    "--profile": "the profiling helpers are not ported yet (ROADMAP.md, queue A item 8)",
    "--plot": "plotting is not ported yet (ROADMAP.md, queue A item 4); plot_results.py "
              "reads the run directory's artifacts",
}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the CLI on ``argv`` (sys.argv[1:] if None); returns the runner's results and
    the run directory."""
    ap = argparse.ArgumentParser(prog="python -m tube_mpc_tpu_torch.run_experiment")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--batch", type=int, default=None,
                    help="run B disturbance scenarios at once (default: 1)")
    ap.add_argument("--run-dir", type=str, default=None,
                    help="write into this run directory instead of a new one under out_dir")
    ap.add_argument("--engine", choices=("xla", "lanes"), default="lanes",
                    help="'lanes' (default): the lane kernels, f32; 'xla': the feature-major "
                         "solvers in the config's dtype (the root CLI's default)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): on the card; cpu: on the CPU (the lane kernels' plain "
                         "versions)")
    ap.add_argument("--plot", action="store_true", help=NOT_PORTED["--plot"])
    ap.add_argument("--checkpoint-every", type=int, default=None, metavar="K",
                    help=NOT_PORTED["--checkpoint-every"])
    ap.add_argument("--profile", type=str, default=None, metavar="TRACE_DIR",
                    help=NOT_PORTED["--profile"])
    ap.add_argument("--compact-caps", type=str, default=None, metavar="C1,C2[;N1]",
                    help=NOT_PORTED["--compact-caps"] + "; '' is taken")
    args = ap.parse_args(argv)
    if args.batch is not None and args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.engine == "xla" and args.compact_caps:
        ap.error("--compact-caps: compact_caps is a lanes-engine feature (--engine lanes)")
    asked = {"--compact-caps": bool(args.compact_caps),
             "--checkpoint-every": args.checkpoint_every is not None,
             "--profile": args.profile is not None, "--plot": args.plot}
    for flag, given in asked.items():
        if given:
            ap.error(f"{flag}: {NOT_PORTED[flag]}")

    import torch

    from .runners import run_experiment
    from .utils.config import load_config, read_yaml
    from .utils.io import make_run_dir, save_json

    cfg = load_config(args.config)
    if cfg.plot:
        ap.error(f"plot: true in {args.config}: {NOT_PORTED['--plot']}")
    if cfg.use_float64 and args.engine == "lanes":
        print("note: --engine lanes is float32-only; ignoring use_float64")
    if args.engine == "xla":
        torch.set_float32_matmul_precision("highest")

    run_dir = args.run_dir or make_run_dir(cfg.out_dir, cfg.run_name)
    # debug_numerics: the anomaly mode too (utils/debug.debug_nans), for this run only
    with torch.autograd.set_detect_anomaly(cfg.debug_numerics, check_nan=True):
        results = run_experiment(cfg, run_dir, batch=args.batch, engine=args.engine,
                                 device=args.device)
    save_json(run_dir, "config_used.json", read_yaml(args.config))

    print(f"Saved run to: {run_dir}")
    print(json.dumps(results["summary"], indent=2, ensure_ascii=False))
    return dict(results, run_dir=run_dir)


if __name__ == "__main__":
    main()
