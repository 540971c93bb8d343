"""2-D double integrator, batched (port of tube_mpc_tpu/systems/double_integrator.py,
the parts the lane closed loop uses: the step, h, the bounds, the target and the
disturbance bounds).

State [px, py, vx, vy], control [ax, ay]; position leads, so the circle obstacles'
smooth-min h (systems/obstacles.py) applies unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import Tensor

from .base import System
from .obstacles import CircleField, make_h


@dataclasses.dataclass(frozen=True)
class DoubleIntegratorConfig:
    dt: float = 0.05
    a_max: float = 5.0
    w_low: Tuple[float, ...] = (-0.02, -0.02, -0.02, -0.02)
    w_high: Tuple[float, ...] = (0.02, 0.02, 0.02, 0.02)
    x_target: Tuple[float, ...] = (10.0, 10.0, 0.0, 0.0)


def di_step(x: Tensor, u: Tensor, *, dt: float) -> Tensor:
    p = x[..., :2] + dt * x[..., 2:4]
    v = x[..., 2:4] + dt * u
    return torch.cat([p, v], dim=-1)


def make_double_integrator(
    cfg: DoubleIntegratorConfig = DoubleIntegratorConfig(),
    *,
    obstacles: Optional[CircleField] = None,
    aggregation: str = "smoothmin",
    beta: float = 20.0,
    device,
    dtype=torch.float32,
) -> System:
    dt = float(cfg.dt)
    h = make_h(obstacles, aggregation=aggregation, beta=beta) if obstacles is not None else None
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="double_integrator",
        nx=4,
        nu=2,
        f=lambda x, u: di_step(x, u, dt=dt),
        h=h,
        u_min=t([-cfg.a_max, -cfg.a_max]),
        u_max=t([cfg.a_max, cfg.a_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
