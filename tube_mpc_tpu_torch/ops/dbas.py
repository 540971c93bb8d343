"""DBaS augmentation of a feature-last System and its analytic Jacobian (port of
tube_mpc_tpu/ops/dbas.py:31-128):

    x̂ = [x, b],   x̂⁺ = [ f(x,u),  B(h(f(x,u)) - s) - γ (B(h(x) - s) - b) ]

    ∂b⁺/∂x = B'(h⁺) ∇h(x⁺)ᵀ A - γ B'(h) ∇h(x)ᵀ,   ∂b⁺/∂u = B'(h⁺) ∇h(x⁺)ᵀ B,   ∂b⁺/∂b = γ

(A, B the system's Jacobians). The barrier parameters broadcast against the states'
leading dims: scalars, or [...] per sample.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch import Tensor

from ..systems.base import System
from .barrier import barrier_deriv, barrier_value


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
    f_hat_jac: Callable  # (x_hat, u, bp) -> (A [..., nx+1, nx+1], B [..., nx+1, nu])
    h_eff: Callable     # (x [..., nx], bp) -> [...]
    init_b0: Callable   # (x0 [..., nx], bp) -> [...]
    nx_hat: int
    nu: int


def make_augmented(system: System, *, barrier_type: str = "inverse", eps: float = 1e-6) -> AugmentedDynamics:
    if system.h is None:
        raise ValueError(f"System {system.name} needs a safety function h for DBaS")
    f, h, nx = system.f, system.h, system.nx
    f_jac = system.jacobians()
    h_grad = system.safety_grad()

    def h_eff(x: Tensor, bp: BarrierParams) -> Tensor:
        return h(x) - bp.tight

    def f_hat(x_hat: Tensor, u: Tensor, bp: BarrierParams) -> Tensor:
        x, b = x_hat[..., :nx], x_hat[..., nx]
        x_next = f(x, u)
        b_next_barrier = barrier_value(h_eff(x_next, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        b_curr_barrier = barrier_value(h_eff(x, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        b_next = b_next_barrier - bp.gamma * (b_curr_barrier - b)
        return torch.cat([x_next, b_next[..., None]], dim=-1)

    def f_hat_jac(x_hat: Tensor, u: Tensor, bp: BarrierParams) -> Tuple[Tensor, Tensor]:
        x = x_hat[..., :nx]
        A3, B3 = f_jac(x, u)
        x_next = f(x, u)
        dB_curr = barrier_deriv(h_eff(x, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        dB_next = barrier_deriv(h_eff(x_next, bp), bp.alpha, barrier_type=barrier_type, eps=eps)
        dh_curr = h_grad(x)
        dh_next = h_grad(x_next)
        dhnA = torch.einsum("...i,...ij->...j", dh_next, A3)
        dhnB = torch.einsum("...i,...ij->...j", dh_next, B3)
        gamma = torch.as_tensor(bp.gamma, dtype=x.dtype, device=x.device)
        row_x = dB_next[..., None] * dhnA - gamma[..., None] * dB_curr[..., None] * dh_curr
        row_u = dB_next[..., None] * dhnB

        batch = row_x.shape[:-1]
        gamma_col = torch.broadcast_to(gamma, batch)[..., None]
        zeros_col = torch.zeros(batch + (nx, 1), dtype=row_x.dtype, device=row_x.device)
        A_top = torch.cat([A3.expand(batch + A3.shape[-2:]), zeros_col], dim=-1)
        A_bot = torch.cat([row_x, gamma_col], dim=-1)[..., None, :]
        A = torch.cat([A_top, A_bot], dim=-2)
        B = torch.cat([B3.expand(batch + B3.shape[-2:]), row_u[..., None, :]], dim=-2)
        return A, B

    def init_b0(x0: Tensor, bp: BarrierParams) -> Tensor:
        return barrier_value(h_eff(x0, bp), bp.alpha, barrier_type=barrier_type, eps=eps)

    return AugmentedDynamics(f_hat=f_hat, f_hat_jac=f_hat_jac, h_eff=h_eff, init_b0=init_b0,
                             nx_hat=nx + 1, nu=system.nu)
