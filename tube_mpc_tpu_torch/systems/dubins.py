"""Dubins (unicycle) vehicle, batched, with analytic Jacobians (port of
tube_mpc_tpu/systems/dubins.py:20-95)."""
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


def dubins_jac(x: Tensor, u: Tensor, *, dt: float) -> Tuple[Tensor, Tensor]:
    """A = df/dx [..., 3, 3], B = df/du [..., 3, 2]."""
    th = x[..., 2]
    v = u[..., 0]
    c, s = torch.cos(th), torch.sin(th)
    o = torch.ones_like(th)
    z = torch.zeros_like(th)
    A = torch.stack([torch.stack([o, z, -dt * v * s], dim=-1),
                     torch.stack([z, o, dt * v * c], dim=-1),
                     torch.stack([z, z, o], dim=-1)], dim=-2)
    B = torch.stack([torch.stack([dt * c, z], dim=-1),
                     torch.stack([dt * s, z], dim=-1),
                     torch.stack([z, dt * o], dim=-1)], dim=-2)
    return A, B


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
    h = h_grad = None
    if obstacles is not None:
        h, h_grad = make_h(obstacles, aggregation=aggregation, beta=beta)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="dubins",
        angle_dims=(2,),
        nx=3,
        nu=2,
        f=lambda x, u: dubins_step(x, u, dt=dt),
        f_jac=lambda x, u: dubins_jac(x, u, dt=dt),
        h=h,
        h_grad=h_grad,
        u_min=t([cfg.v_min, -cfg.omega_max]),
        u_max=t([cfg.v_max, cfg.omega_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
