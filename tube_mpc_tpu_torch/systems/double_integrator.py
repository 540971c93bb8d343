"""2-D double integrator, batched (port of tube_mpc_tpu/systems/double_integrator.py,
with its constant analytic Jacobians).

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


def di_jac(x: Tensor, u: Tensor, *, dt: float) -> Tuple[Tensor, Tensor]:
    """The constant A [..., 4, 4] and B [..., 4, 2]."""
    batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    A = torch.eye(4, dtype=x.dtype, device=x.device)
    A[0, 2] = dt
    A[1, 3] = dt
    B = torch.zeros((4, 2), dtype=x.dtype, device=x.device)
    B[2, 0] = dt
    B[3, 1] = dt
    return A.expand(batch + (4, 4)), B.expand(batch + (4, 2))


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
    h = h_grad = None
    if obstacles is not None:
        h, h_grad = make_h(obstacles, aggregation=aggregation, beta=beta)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="double_integrator",
        nx=4,
        nu=2,
        f=lambda x, u: di_step(x, u, dt=dt),
        f_jac=lambda x, u: di_jac(x, u, dt=dt),
        h=h,
        h_grad=h_grad,
        u_min=t([-cfg.a_max, -cfg.a_max]),
        u_max=t([cfg.a_max, cfg.a_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
