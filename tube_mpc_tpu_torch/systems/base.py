"""Controlled system with box control bounds and a safety function (port of
tube_mpc_tpu/systems/base.py:23-95, the parts the lane closed loop uses).

Callables broadcast over leading batch dims: x [..., nx], u [..., nu].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor


@dataclasses.dataclass(frozen=True)
class System:
    """Discrete-time system x_{k+1} = f(x, u) with safety h(x) > 0.

    u_min, u_max, x_target, w_low, w_high are tensors of the system's device and
    dtype; w_low/w_high bound the additive uniform disturbance of the true step."""

    name: str
    nx: int
    nu: int
    f: Callable[[Tensor, Tensor], Tensor]
    u_min: Tensor
    u_max: Tensor
    h: Optional[Callable[[Tensor], Tensor]] = None
    x_target: Optional[Tensor] = None
    w_low: Optional[Tensor] = None
    w_high: Optional[Tensor] = None
    angle_dims: Tuple[int, ...] = ()

    def clamp(self, u: Tensor) -> Tensor:
        """Hard box projection, as jnp.clip: max(u_min, u) then min(u_max, .)."""
        return torch.minimum(self.u_max, torch.maximum(self.u_min, u))

    def sample_disturbance(self, generator: torch.Generator, shape=(), dtype=None) -> Tensor:
        """Uniform w ~ U[w_low, w_high] of shape [*shape, nx], drawn from ``generator``
        on the generator's device."""
        if self.w_low is None or self.w_high is None:
            raise ValueError(f"System {self.name} has no disturbance bounds")
        dtype = dtype or self.w_low.dtype
        low = self.w_low.to(dtype)
        high = self.w_high.to(dtype)
        u01 = torch.rand(tuple(shape) + (self.nx,), generator=generator, dtype=dtype,
                         device=generator.device)
        return low.to(u01.device) + (high - low).to(u01.device) * u01
