"""Planar quadrotor, batched (port of tube_mpc_tpu/systems/quadrotor2d.py, the parts
the lane closed loop uses: the step, h, the bounds, the target and the disturbance
bounds).

State [px, pz, th, vx, vz, om], control [T1, T2] (rotor thrusts); Euler step of

    ax = -(T1+T2) sin(th) / m,  az = (T1+T2) cos(th) / m - g,  al = (T2-T1) L / I.

Position leads, so the circle obstacles' smooth-min h applies unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import Tensor

from .base import System
from .obstacles import CircleField, make_h


@dataclasses.dataclass(frozen=True)
class Quadrotor2DConfig:
    dt: float = 0.02
    mass: float = 0.8
    inertia: float = 0.02
    arm: float = 0.2
    gravity: float = 9.81
    t_min: float = 0.0
    t_max: float = 8.0
    w_low: Tuple[float, ...] = (-0.02,) * 6
    w_high: Tuple[float, ...] = (0.02,) * 6
    x_target: Tuple[float, ...] = (8.0, 8.0, 0.0, 0.0, 0.0, 0.0)


def quad2d_step(x: Tensor, u: Tensor, *, cfg: Quadrotor2DConfig) -> Tensor:
    """The JAX form's operations in its order; a division by a constant is a true
    division (a multiplication by its rounded reciprocal on the card would round
    otherwise)."""
    px, pz, th, vx, vz, om = (x[..., i] for i in range(6))
    t1, t2 = u[..., 0], u[..., 1]
    m, inertia, arm, g, dt = cfg.mass, cfg.inertia, cfg.arm, cfg.gravity, cfg.dt
    thrust = t1 + t2
    s, c = torch.sin(th), torch.cos(th)
    ax = -thrust * s / torch.full_like(s, m)
    az = thrust * c / torch.full_like(c, m) - g
    al = (t2 - t1) * arm / torch.full_like(t1, inertia)
    return torch.stack(
        [px + dt * vx, pz + dt * vz, th + dt * om, vx + dt * ax, vz + dt * az, om + dt * al],
        dim=-1,
    )


def make_quadrotor2d(
    cfg: Quadrotor2DConfig = Quadrotor2DConfig(),
    *,
    obstacles: Optional[CircleField] = None,
    aggregation: str = "smoothmin",
    beta: float = 20.0,
    device,
    dtype=torch.float32,
) -> System:
    h = make_h(obstacles, aggregation=aggregation, beta=beta) if obstacles is not None else None
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="quadrotor2d",
        angle_dims=(2,),
        nx=6,
        nu=2,
        f=lambda x, u: quad2d_step(x, u, cfg=cfg),
        h=h,
        u_min=t([cfg.t_min, cfg.t_min]),
        u_max=t([cfg.t_max, cfg.t_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
