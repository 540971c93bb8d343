"""DBaS augmentation of a feature-last System (port of tube_mpc_tpu/ops/dbas.py:31-128,
the value parts the closed loop uses):

    x̂ = [x, b],   x̂⁺ = [ f(x,u),  B(h(f(x,u)) - s) - γ (B(h(x) - s) - b) ]
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor

from ..systems.base import System
from .barrier import barrier_value


class BarrierParams(NamedTuple):
    """Runtime DBaS parameters: relaxation alpha, feedback gamma, tightening s."""

    alpha: Tensor
    gamma: Tensor
    tight: Tensor

    @staticmethod
    def create(alpha=0.0, gamma=0.0, tight=0.0, *, device, dtype=torch.float32) -> "BarrierParams":
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return BarrierParams(alpha=t(alpha), gamma=t(gamma), tight=t(tight))


class AugmentedDynamics(NamedTuple):
    f_hat: Callable     # (x_hat [..., nx+1], u [..., nu], bp) -> [..., nx+1]
    h_eff: Callable     # (x [..., nx], bp) -> [...]
    init_b0: Callable   # (x0 [..., nx], bp) -> [...]
    nx_hat: int
    nu: int


def make_augmented(system: System, *, barrier_type: str = "inverse", eps: float = 1e-6) -> AugmentedDynamics:
    if system.h is None:
        raise ValueError(f"System {system.name} needs a safety function h for DBaS")
    f, h, nx = system.f, system.h, system.nx

    def h_eff(x: Tensor, bp: BarrierParams) -> Tensor:
        return h(x) - bp.tight

    def f_hat(x_hat: Tensor, u: Tensor, bp: BarrierParams) -> Tensor:
        x, b = x_hat[..., :nx], x_hat[..., nx]
        x_next = f(x, u)
        b_next_barrier = barrier_value(h_eff(x_next, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        b_curr_barrier = barrier_value(h_eff(x, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        b_next = b_next_barrier - bp.gamma * (b_curr_barrier - b)
        return torch.cat([x_next, b_next[..., None]], dim=-1)

    def init_b0(x0: Tensor, bp: BarrierParams) -> Tensor:
        return barrier_value(h_eff(x0, bp), bp.alpha, barrier_type=barrier_type, eps=eps)

    return AugmentedDynamics(f_hat=f_hat, h_eff=h_eff, init_b0=init_b0, nx_hat=nx + 1, nu=system.nu)
