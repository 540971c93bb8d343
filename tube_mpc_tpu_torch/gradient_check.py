"""End-to-end finite-difference gradient check CLI of the port:

    python -m tube_mpc_tpu_torch.gradient_check [--config configs/dubins.yaml] [--eps 1e-3]
        [--iters 3] [--tol T] [--json-out PATH] [--device cuda|cpu]

The counterpart of the root gradient_check.py: it shrinks the problem (N <= 8, H <= 2,
f64, the iLQR caps set to --iters), runs the closed loop on the feature-major engine at
the config, at Q_nominal[0] + eps and - eps under one disturbance draw, and prints the
central difference beside the analytic dL/dQ_nominal[0] of the same final loss, by
torch.autograd.grad through the differentiable closed loop
(tube/closed_loop.make_paper_closed_loop_diff; paper mode only). The same flags and
JSON, with --device in place of --platform. The disturbances are the root CLI's draw,
bitwise: [H, nx] from PRNGKey(seed) of the config's seed (utils/prng.py).
"""
from __future__ import annotations

import argparse
import copy
import json
import tempfile
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(prog="python -m tube_mpc_tpu_torch.gradient_check")
    ap.add_argument("--config", type=str, default="configs/dubins.yaml")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--iters", type=int, default=3,
                    help="iLQR iteration cap of the shrunk problem (the analytic column "
                         "assumes converged solves: raise it to tighten the agreement)")
    ap.add_argument("--tol", type=float, default=None,
                    help="override the solver's convergence tol (~1e-12 with --iters 50 "
                         "for a tight comparison)")
    ap.add_argument("--json-out", type=str, default=None,
                    help="also write the result dict to this path")
    args = ap.parse_args(argv)

    import torch

    from .ops.costs import CostWeights
    from .runners import run_experiment
    from .tube.closed_loop import make_paper_closed_loop_diff
    from .utils.config import build_experiment, parse_config, read_yaml
    from .utils.prng import PRNGKey

    torch.set_float32_matmul_precision("highest")
    raw = copy.deepcopy(read_yaml(args.config))
    raw["use_float64"] = True
    sysc = raw["system"]
    sysc["horizon_N"] = min(8, int(sysc["horizon_N"]))
    sysc["task_horizon_H"] = min(2, int(sysc["task_horizon_H"]))
    sysc["nominal_max_iter"] = int(args.iters)
    sysc["aux_max_iter"] = int(args.iters)
    if args.tol is not None:
        sysc["ilqr_tol"] = float(args.tol)
    H = sysc["task_horizon_H"]
    cfg = parse_config(raw)

    # one disturbance draw for all three runs
    built = build_experiment(cfg, device=args.device)
    w_seq = built.system.sample_disturbance(PRNGKey(cfg.seed, built.device), (H,),
                                            dtype=cfg.dtype)

    def loss_for(raw_cfg) -> float:
        with tempfile.TemporaryDirectory() as d:
            out = run_experiment(parse_config(raw_cfg), d, w_seq=w_seq.cpu().numpy(),
                                 engine="xla", device=args.device)
        return float(out["summary"]["final_loss"])

    base = loss_for(raw)
    eps = float(args.eps)
    raw_p, raw_m = copy.deepcopy(raw), copy.deepcopy(raw)
    raw_p["cost_nominal"]["Q"] = list(raw["cost_nominal"]["Q"])
    raw_m["cost_nominal"]["Q"] = list(raw["cost_nominal"]["Q"])
    raw_p["cost_nominal"]["Q"][0] = float(raw["cost_nominal"]["Q"][0]) + eps
    raw_m["cost_nominal"]["Q"][0] = float(raw["cost_nominal"]["Q"][0]) - eps
    loss_p = loss_for(raw_p)
    loss_m = loss_for(raw_m)
    fd = (loss_p - loss_m) / (2.0 * eps)

    analytic = None
    if cfg.paper_dubins_mode and not cfg.adaptation.adapt_nominal:
        # the FD runs perturb Q[0]; a config without Qf ties Qf to Q, so Qf[0] moves too
        qf_tied = raw["cost_nominal"].get("Qf") is None
        loop = make_paper_closed_loop_diff(built.system, built.aug, built.tube_cfg,
                                           bp=built.bp, target=built.target)
        q0 = torch.tensor(float(raw["cost_nominal"]["Q"][0]), dtype=cfg.dtype,
                          device=built.device, requires_grad=True)
        wn = built.w_nominal
        w_nom = CostWeights(Q=torch.cat([q0[None], wn.Q[1:]]), R=wn.R,
                            Qf=torch.cat([q0[None], wn.Qf[1:]]) if qf_tied else wn.Qf,
                            qb=wn.qb)
        loss = loop(w_nom, built.aux_init, built.x0, w_seq).loss[0, -1]
        analytic = float(torch.autograd.grad(loss, q0)[0])

    result = {
        "baseline_loss": base,
        "loss_plus": loss_p,
        "loss_minus": loss_m,
        "fd_dL_dQ0": fd,
        "analytic_dL_dQ0": analytic,
        "rel_err": (abs(fd - analytic) / max(abs(fd), abs(analytic), 1e-30)
                    if analytic is not None else None),
    }
    print("Finite-difference vs analytic check (whole closed loop):")
    print(json.dumps(result, indent=2))
    print()
    print("Note: FD perturbs the configured nominal weight through the full closed loop")
    print("(solver, adaptation, warm starts); the analytic column is torch.autograd.grad")
    print("through the differentiable closed loop (paper mode only). The analytic gradient")
    print("is exact under the IFT assumption that each solve converged: raise --iters if")
    print("the columns disagree at loose iteration caps.")
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
