"""Nominal-only receding-horizon MPC CLI of the port (the validation harness):

    python -m tube_mpc_tpu_torch.run_nominal --config configs/dubins.yaml
        [--mode receding|once] [--feasible-filter] [--device cuda|cpu]

The counterpart of the root run_nominal.py, on the feature-major solvers: the solver and
barrier stack without adaptation or disturbances, with success/collision checks, in the
config's dtype. The same flags, with --device in place of --platform (the card by
default); --plot (or plot: true) writes the figures into the run directory (matplotlib).
``main(argv)`` runs it in-process.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m tube_mpc_tpu_torch.run_nominal")
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--plot", action="store_true", help="write the figures into the run "
                    "directory (needs matplotlib)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--mode", choices=("receding", "once"), default="receding",
                    help="the receding horizon, or a single solve from x0")
    ap.add_argument("--feasible-filter", action="store_true",
                    help="once-mode: strict-feasibility line-search filter")
    args = ap.parse_args(argv)

    import torch

    from .runners import run_nominal, run_nominal_single
    from .utils.config import load_config, read_yaml
    from .utils.io import make_run_dir, save_json

    cfg = load_config(args.config)
    torch.set_float32_matmul_precision("highest")
    run_dir = make_run_dir(cfg.out_dir, cfg.run_name + "_nominal")
    if args.mode == "once":
        results = run_nominal_single(cfg, run_dir, feasible_filter=args.feasible_filter,
                                     device=args.device)
    else:
        results = run_nominal(cfg, run_dir, device=args.device)
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
