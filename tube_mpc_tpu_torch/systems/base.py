"""Controlled system with box control bounds, a safety function and their derivatives
(port of tube_mpc_tpu/systems/base.py:23-95).

Callables broadcast over leading batch dims: x [..., nx], u [..., nu].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from ..utils import prng


@dataclasses.dataclass(frozen=True)
class System:
    """Discrete-time system x_{k+1} = f(x, u) with safety h(x) > 0.

    u_min, u_max, x_target, w_low, w_high are tensors of the system's device and
    dtype; w_low/w_high bound the additive uniform disturbance of the true step.
    f_jac (x, u) -> (A [..., nx, nx], B [..., nx, nu]) and h_grad x -> [..., nx] are the
    analytic derivatives; None takes them by autodiff (``jacobians``, ``safety_grad``)."""

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
    f_jac: Optional[Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]] = None
    h_grad: Optional[Callable[[Tensor], Tensor]] = None

    def jacobians(self) -> Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]:
        """f_jac, or else forward-mode autodiff of f, one sample at a time under
        torch.func.vmap over the flattened leading dims."""
        if self.f_jac is not None:
            return self.f_jac
        jac = torch.func.vmap(torch.func.jacfwd(self.f, argnums=(0, 1)))

        def f_jac(x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
            lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
            xs = x.expand(lead + x.shape[-1:]).reshape(-1, self.nx)
            us = u.expand(lead + u.shape[-1:]).reshape(-1, self.nu)
            A, B = jac(xs, us)
            # torch.func's forward mode under vmap carries a product with a Python float
            # in float64: the Jacobian comes back in the states' dtype
            return (A.to(x.dtype).reshape(lead + (self.nx, self.nx)),
                    B.to(x.dtype).reshape(lead + (self.nx, self.nu)))

        return f_jac

    def safety_grad(self) -> Callable[[Tensor], Tensor]:
        """h_grad, or else the gradient of h by autodiff (each sample's h depends on its own
        state only, so the gradient of the sum is each sample's gradient)."""
        if self.h is None:
            raise ValueError(f"System {self.name} has no safety function h")
        if self.h_grad is not None:
            return self.h_grad
        return torch.func.grad(lambda x: torch.sum(self.h(x)))

    def clamp(self, u: Tensor) -> Tensor:
        """Hard box projection, as jnp.clip: max(u_min, u) then min(u_max, .)."""
        return torch.minimum(self.u_max, torch.maximum(self.u_min, u))

    def active_mask(self, u: Tensor, tol: float = 1e-8) -> Tensor:
        """The control dims at (within tol of) their bounds."""
        return (u <= self.u_min + tol) | (u >= self.u_max - tol)

    def sample_disturbance(self, key: Tensor, shape=(), dtype=None) -> Tensor:
        """Uniform w ~ U[w_low, w_high] of shape [*key.shape[:-1], *shape, nx], drawn from
        the threefry key ``key`` (utils/prng.py; a batch of keys draws as jax.vmap over
        them) on the key's device: bitwise the JAX package's draw from the same key."""
        if self.w_low is None or self.w_high is None:
            raise ValueError(f"System {self.name} has no disturbance bounds")
        dtype = dtype or self.w_low.dtype
        u01 = prng.uniform(key, tuple(shape) + (self.nx,), dtype=dtype)
        low = self.w_low.to(dtype=dtype, device=u01.device)
        high = self.w_high.to(dtype=dtype, device=u01.device)
        return low + (high - low) * u01
