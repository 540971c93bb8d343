"""Dubins (unicycle) vehicle, batched (port of tube_mpc_tpu/systems/dubins.py:20-95)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from .base import System
from .obstacles import CircleField, make_h


@dataclasses.dataclass(frozen=True)
class DubinsConfig:
    dt: float = 0.01
    v_min: float = -10.0
    v_max: float = 10.0
    omega_max: float = math.pi
    w_low: Tuple[float, float, float] = (-0.05, -0.05, -0.05)
    w_high: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    x_target: Tuple[float, float, float] = (10.0, 10.0, math.pi / 4)


def dubins_step(x: Tensor, u: Tensor, *, dt: float) -> Tensor:
    """x = [px, py, theta], u = [v, omega]; Euler step over leading dims."""
    px, py, th = x[..., 0], x[..., 1], x[..., 2]
    v, om = u[..., 0], u[..., 1]
    return torch.stack(
        [px + dt * v * torch.cos(th), py + dt * v * torch.sin(th), th + dt * om], dim=-1
    )


def make_dubins(
    cfg: DubinsConfig = DubinsConfig(),
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
        name="dubins",
        angle_dims=(2,),
        nx=3,
        nu=2,
        f=lambda x, u: dubins_step(x, u, dt=dt),
        h=h,
        u_min=t([cfg.v_min, -cfg.omega_max]),
        u_max=t([cfg.v_max, cfg.omega_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
