"""The reference against the program's CPU path (its kernels' plain versions) at a small
size in float64: the same closed loop, step by step, from the configuration alone."""
import json
from pathlib import Path

import pytest
import torch

from bench_port.reference.tube import PaperTube

BENCH = Path(__file__).resolve().parents[1]


def small(name, N=8, H=3):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf["values"]["system"].update(horizon_N=N, task_horizon_H=H)
    return conf


@pytest.mark.parametrize("name", ["dubins", "quadrotor2d"])
def test_reference_follows_the_program(name):
    from tube_mpc_tpu_torch.presets import config_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import make_paper_lane_step, paper_lane_init_state
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem
    from tube_mpc_tpu_torch.utils.config import parse_config

    conf, B, H = small(name), 3, 3
    cfg = parse_config(conf["values"])
    s = config_setup(cfg, N=cfg.system.horizon_N, H=H, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                target=s.target, B=B, dtype=torch.float64, device="cpu")
    state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                  x0=s.x0, B=B, dtype=torch.float64)
    tube = PaperTube(conf, torch.float64)
    # the program runs here in float64, so its 2x2 inverse's guard takes float64's ulp
    tube.guard_eps = float(torch.finfo(torch.float64).eps)
    ref = tube.init_state(B)
    lo, hi = (torch.tensor(conf["values"]["system"]["disturbance"][k], dtype=torch.float64)
              for k in ("w_low", "w_high"))
    w = lo + (hi - lo) * torch.rand((H, B, lo.numel()), generator=torch.Generator().manual_seed(3),
                                    dtype=torch.float64)
    # not bitwise: the two sum in other orders, and a lane whose last iLQR step improves
    # its cost by about the tolerance may freeze one iteration earlier on one side, which
    # moves its plan by that last step (6.6e-9 in a control here)
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    for t in range(H):
        state, log = step(state, w[t])
        out = tube.step(ref, w[t])
        close(log[1], out["U_aux"][:, 0])
        close(log[3], out["U_nom"][:, 0])
        close(log[5], out["loss"])
        for got, want in zip(log[6:9], out["theta"]):
            close(got, want)
        x, b, xb, bb = out["next"]
        close(state.x, x)
        close(state.b, b)
        close(state.x_bar, xb)
        ref = ref._replace(x=x, b=b, x_bar=xb, b_bar=bb, U_nom_ws=state.U_nom_ws.clone(),
                           U_aux_ws=state.U_aux_ws.clone(), Q=out["theta"][0], R=out["theta"][1],
                           qb=out["theta"][2], vQ=out["vel"][0], vR=out["vel"][1], vqb=out["vel"][2])
