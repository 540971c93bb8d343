"""Planar quadrotor, batched, with analytic Jacobians (port of
tube_mpc_tpu/systems/quadrotor2d.py).

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


def quad2d_jac(x: Tensor, u: Tensor, *, cfg: Quadrotor2DConfig) -> Tuple[Tensor, Tensor]:
    """A = df/dx [..., 6, 6], B = df/du [..., 6, 2], in the JAX form's operation order."""
    th = x[..., 2]
    t1, t2 = u[..., 0], u[..., 1]
    m, inertia, arm, dt = cfg.mass, cfg.inertia, cfg.arm, cfg.dt
    s, c = torch.sin(th), torch.cos(th)
    thrust = t1 + t2
    o = torch.ones_like(th)
    z = torch.zeros_like(th)
    A = torch.stack([
        torch.stack([o, z, z, dt * o, z, z], dim=-1),
        torch.stack([z, o, z, z, dt * o, z], dim=-1),
        torch.stack([z, z, o, z, z, dt * o], dim=-1),
        torch.stack([z, z, -dt * thrust * c / m, o, z, z], dim=-1),
        torch.stack([z, z, -dt * thrust * s / m, z, o, z], dim=-1),
        torch.stack([z, z, z, z, z, o], dim=-1),
    ], dim=-2)
    B = torch.stack([
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([z, z], dim=-1),
        torch.stack([-dt * s / m, -dt * s / m], dim=-1),
        torch.stack([dt * c / m, dt * c / m], dim=-1),
        torch.stack([-dt * arm / inertia * o, dt * arm / inertia * o], dim=-1),
    ], dim=-2)
    return A, B


def make_quadrotor2d(
    cfg: Quadrotor2DConfig = Quadrotor2DConfig(),
    *,
    obstacles: Optional[CircleField] = None,
    aggregation: str = "smoothmin",
    beta: float = 20.0,
    device,
    dtype=torch.float32,
) -> System:
    h = h_grad = None
    if obstacles is not None:
        h, h_grad = make_h(obstacles, aggregation=aggregation, beta=beta)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="quadrotor2d",
        angle_dims=(2,),
        nx=6,
        nu=2,
        f=lambda x, u: quad2d_step(x, u, cfg=cfg),
        f_jac=lambda x, u: quad2d_jac(x, u, cfg=cfg),
        h=h,
        h_grad=h_grad,
        u_min=t([cfg.t_min, cfg.t_min]),
        u_max=t([cfg.t_max, cfg.t_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
