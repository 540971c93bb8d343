"""Diagonal-quadratic cost weights (port of tube_mpc_tpu/ops/costs.py:25-41)."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


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
