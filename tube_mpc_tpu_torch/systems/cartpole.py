"""Cart-pole, batched (port of tube_mpc_tpu/systems/cartpole.py). Its Jacobians come from
autodiff (System.jacobians: torch.func.jacfwd), as the JAX package takes them.

State [x, xdot, th, thdot] (th = 0 upright), control [F]; Euler step of the
underactuated cart-pole. Safety: the cart stays on the track, h(x) = x_lim² - x².
This feature-last form keeps the JAX step's own ``om**2`` and ``c**2`` (the component
form in ops/lanes.py multiplies them out, as its JAX counterpart does).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor

from .base import System


@dataclasses.dataclass(frozen=True)
class CartPoleConfig:
    dt: float = 0.02
    m_cart: float = 1.0
    m_pole: float = 0.1
    length: float = 0.5     # half pole length
    gravity: float = 9.81
    f_max: float = 20.0
    x_lim: float = 2.4
    w_low: Tuple[float, ...] = (-0.01, -0.01, -0.01, -0.01)
    w_high: Tuple[float, ...] = (0.01, 0.01, 0.01, 0.01)
    x_target: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)


def cartpole_step(x: Tensor, u: Tensor, *, cfg: CartPoleConfig) -> Tensor:
    """The JAX form's operations in its order; a division by a constant is a true
    division (a multiplication by its rounded reciprocal on the card would round
    otherwise)."""
    pos, vel, th, om = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0]
    mc, mp, l, g = cfg.m_cart, cfg.m_pole, cfg.length, cfg.gravity
    s, c = torch.sin(th), torch.cos(th)
    total_m = torch.full_like(s, mc + mp)
    temp = (force + mp * l * om**2 * s) / total_m
    th_acc = (g * s - c * temp) / (l * (4.0 / 3.0 - mp * c**2 / total_m))
    x_acc = temp - mp * l * th_acc * c / total_m
    dt = cfg.dt
    return torch.stack(
        [pos + dt * vel, vel + dt * x_acc, th + dt * om, om + dt * th_acc], dim=-1
    )


def make_cartpole(cfg: CartPoleConfig = CartPoleConfig(), *, device,
                  dtype=torch.float32) -> System:
    x_lim = float(cfg.x_lim)

    def h(x: Tensor) -> Tensor:
        return x_lim**2 - x[..., 0] ** 2

    def h_grad(x: Tensor) -> Tensor:
        return torch.cat([(-2.0 * x[..., 0])[..., None], torch.zeros_like(x[..., 1:])], dim=-1)

    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return System(
        name="cartpole",
        angle_dims=(2,),
        nx=4,
        nu=1,
        f=lambda x, u: cartpole_step(x, u, cfg=cfg),
        h=h,
        h_grad=h_grad,
        u_min=t([-cfg.f_max]),
        u_max=t([cfg.f_max]),
        x_target=t(cfg.x_target),
        w_low=t(cfg.w_low),
        w_high=t(cfg.w_high),
    )
