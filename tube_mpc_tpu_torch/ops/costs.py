"""Diagonal-quadratic costs of the two MPC layers and their exact derivatives (port of
tube_mpc_tpu/ops/costs.py:25-88)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from .linalg import _diag_embed


class CostWeights(NamedTuple):
    """Weights of one MPC layer: stage Q [nx], R [nu], terminal Qf [nx], barrier qb [].

    Vector weights may also be per lane ([B, nx], [B, nu]) and qb [B]."""

    Q: Tensor
    R: Tensor
    Qf: Tensor
    qb: Tensor

    @staticmethod
    def create(Q, R, Qf, qb, *, device, dtype=torch.float32) -> "CostWeights":
        t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return CostWeights(Q=t(Q), R=t(R), Qf=t(Qf), qb=t(qb))


# ---------------------------------------------------------------------------
# Costs and their exact derivatives (port of tube_mpc_tpu/ops/costs.py:43-88). The
# weights broadcast against the states from the right: Q [nx] or any [..., nx] that
# broadcasts with x_hat[..., :nx], qb [] or [...] with x_hat[..., -1].
# ---------------------------------------------------------------------------

def stage_cost(x_hat: Tensor, u: Tensor, w: CostWeights, x_ref: Tensor, u_ref: Tensor) -> Tensor:
    """(Q ⊙ (x - x_ref))·(x - x_ref) + (R ⊙ (u - u_ref))·(u - u_ref) + q_b b²; x_hat = [x, b]."""
    x, b = x_hat[..., :-1], x_hat[..., -1]
    dx = x - x_ref
    du = u - u_ref
    return (torch.sum(w.Q * dx * dx, dim=-1) + torch.sum(w.R * du * du, dim=-1)
            + w.qb * b * b)


def terminal_cost(x_hat_N: Tensor, w: CostWeights, x_ref_N: Tensor) -> Tensor:
    """(Qf ⊙ (x_N - ref))·(x_N - ref) + q_b b_N²."""
    x, b = x_hat_N[..., :-1], x_hat_N[..., -1]
    dx = x - x_ref_N
    return torch.sum(w.Qf * dx * dx, dim=-1) + w.qb * b * b


def stage_derivs(x_hat: Tensor, u: Tensor, w: CostWeights, x_ref: Tensor, u_ref: Tensor):
    """(l_x, l_u, l_xx, l_uu, l_ux) of stage_cost, exactly."""
    x, b = x_hat[..., :-1], x_hat[..., -1]
    dx = x - x_ref
    du = u - u_ref
    l_x = torch.cat([2.0 * w.Q * dx, (2.0 * w.qb * b)[..., None]], dim=-1)
    l_u = 2.0 * w.R * du
    qb_col = torch.broadcast_to(2.0 * w.qb, b.shape)[..., None]
    l_xx = _diag_embed(torch.cat([torch.broadcast_to(2.0 * w.Q, dx.shape), qb_col], dim=-1))
    l_uu = _diag_embed(torch.broadcast_to(2.0 * w.R, du.shape))
    l_ux = torch.zeros(du.shape[:-1] + (u.shape[-1], x_hat.shape[-1]), dtype=x_hat.dtype,
                       device=x_hat.device)
    return l_x, l_u, l_xx, l_uu, l_ux


def terminal_derivs(x_hat_N: Tensor, w: CostWeights, x_ref_N: Tensor):
    """(phi_x, phi_xx) of terminal_cost, the barrier's terminal terms included."""
    x, b = x_hat_N[..., :-1], x_hat_N[..., -1]
    dx = x - x_ref_N
    phi_x = torch.cat([2.0 * w.Qf * dx, (2.0 * w.qb * b)[..., None]], dim=-1)
    qb_col = torch.broadcast_to(2.0 * w.qb, b.shape)[..., None]
    phi_xx = _diag_embed(torch.cat([torch.broadcast_to(2.0 * w.Qf, dx.shape), qb_col], dim=-1))
    return phi_x, phi_xx


def wrap_angle(err: Tensor) -> Tensor:
    """An angle error mapped to (-pi, pi]."""
    return torch.atan2(torch.sin(err), torch.cos(err))
