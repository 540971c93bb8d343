"""Closed-loop configuration and log types (port of
tube_mpc_tpu/tube/closed_loop.py:48-93, the parts the lane closed loops use)."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

from torch import Tensor

from ..solvers.ilqr import ILQRConfig
from .params import AdaptConfig


@dataclasses.dataclass(frozen=True)
class TubeMPCConfig:
    N: int
    H: int
    nominal_max_iter: int = 10
    aux_max_iter: int = 20
    tol: float = 1e-3
    reg: float = 1e-6
    alphas: Tuple[float, ...] = (1.0,)
    adapt: AdaptConfig = AdaptConfig(lr=5e-2, momentum=0.9)
    adapt_nominal: bool = False
    adapt_ancillary: bool = True
    # "reference": L treats the nominal plan as constant, and dL/dθ̄ reaches the
    # nominal parameters only through the ancillary problem's reference. "full":
    # the exact bilevel gradient, with the explicit ∂L/∂x̄ term as well.
    coupling: str = "reference"

    def nominal_ilqr(self) -> ILQRConfig:
        return ILQRConfig(max_iter=self.nominal_max_iter, tol=self.tol, reg=self.reg, alphas=self.alphas)

    def aux_ilqr(self) -> ILQRConfig:
        return ILQRConfig(max_iter=self.aux_max_iter, tol=self.tol, reg=self.reg, alphas=self.alphas)


class ClosedLoopLog(NamedTuple):
    """Per-step trajectories, [B, H, ...] from run_paper_closed_loop_lanes."""

    x_real: Tensor   # state at the start of each step
    u_real: Tensor   # applied ancillary control
    x_bar: Tensor    # nominal state
    u_bar: Tensor    # applied nominal control
    b_real: Tensor   # barrier state
    loss: Tensor     # upper loss L per step
    Q_hist: Tensor   # adapted ancillary Q (post-update)
    R_hist: Tensor
    qb_hist: Tensor
