"""Closed-form Algorithm-2 weight gradients from the sensitivity directions (port of
tube_mpc_tpu/solvers/weight_grads.py:25-65): for the diagonal tracking weights,

    ∇_Q L  = Σ_{k=0..N} 2 (x_k − x̄_k) ⊙ δx_k        (the terminal row too; Qf tied to Q)
    ∇_R L  = Σ_{k<N}    2 (u_k − ū_k) ⊙ δu_k
    ∇_qb L = Σ_{k=0..N} 2 b_k δb_k

Every function broadcasts over leading batch dims.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from ..tube.params import AuxAdapt
from .sensitivity import SensitivityResult


def grads_aux_from_deltas(X_aux: Tensor, U_aux: Tensor, X_ref: Tensor, U_ref: Tensor,
                          sens: SensitivityResult):
    """AuxAdapt(gQ, gR, gqb) of the ancillary weights: X_aux [..., N+1, nx+1],
    U_aux [..., N, nu], the nominal references X_ref [..., N+1, nx], U_ref [..., N, nu]."""
    nx = X_ref.shape[-1]
    dx = X_aux[..., :nx] - X_ref
    du = U_aux - U_ref
    b = X_aux[..., nx]
    gQ = torch.sum(2.0 * dx * sens.delta_X[..., :nx], dim=-2)
    gR = torch.sum(2.0 * du * sens.delta_U, dim=-2)
    gqb = torch.sum(2.0 * b * sens.delta_X[..., nx], dim=-1)
    return AuxAdapt(Q=gQ, R=gR, qb=gqb)


def grads_nominal_from_deltas(X_nom: Tensor, U_nom: Tensor, target: Tensor,
                              sens: SensitivityResult) -> Tuple[Tensor, Tensor, Tensor]:
    """(gQ, gR, gqb) of goal-tracking nominal weights: X_nom [..., N+1, nx+1],
    U_nom [..., N, nu], target [..., nx]."""
    nx = target.shape[-1]
    dx = X_nom[..., :nx] - target[..., None, :]
    b = X_nom[..., nx]
    gQ = torch.sum(2.0 * dx * sens.delta_X[..., :nx], dim=-2)
    gR = torch.sum(2.0 * U_nom * sens.delta_U, dim=-2)
    gqb = torch.sum(2.0 * b * sens.delta_X[..., nx], dim=-1)
    return gQ, gR, gqb


def apply_sgd(params, grads, lr: float):
    """p - lr·g over matching named tuples (the projected momentum step is
    tube/params.momentum_update)."""
    return type(params)(*(p - lr * g for p, g in zip(params, grads)))
