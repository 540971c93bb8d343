"""iLQR hyperparameters (port of ILQRConfig, tube_mpc_tpu/solvers/ilqr.py:45)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    max_iter: int = 30
    tol: float = 1e-6
    reg: float = 1e-6
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
