"""Relaxed inverse and log barriers, their derivatives and the barrier-state step (port of
tube_mpc_tpu/ops/barrier.py:23-117).

Every function broadcasts over leading dims. ``alpha`` is a runtime tensor (or
number); ``eps`` and ``barrier_type`` are Python constants. The arithmetic keeps
the reference's operation order so that f64 results agree to rounding.

``barrier_lin`` and ``barrier_dalpha`` add what the JAX package gets from
``jax.jvp``: the tangent in zeta and the derivative in alpha, written out by
JAX's differentiation rules (max, div, integer_pow, where), used by the
hand-written tangent maps of the augmented step (ops/lanes.py).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import Tensor


def _as(alpha, like: Tensor) -> Tensor:
    return torch.as_tensor(alpha, dtype=like.dtype, device=like.device)


def relaxed_inverse_barrier(zeta: Tensor, alpha, *, eps: float = 1e-12) -> Tensor:
    """B(zeta) = 1/zeta for zeta >= a, else 1/a - (zeta-a)/a^2 + (zeta-a)^2/a^3,
    with a = max(alpha, eps)."""
    alpha_eff = torch.clamp(_as(alpha, zeta), min=eps)
    safe = zeta >= alpha_eff
    b_safe = 1.0 / torch.clamp(zeta, min=eps)
    diff = zeta - alpha_eff
    aa = alpha_eff * alpha_eff
    b_unsafe = 1.0 / alpha_eff - diff / aa + (diff * diff) / (aa * alpha_eff)
    return torch.where(safe, b_safe, b_unsafe)


def d_relaxed_inverse_barrier(zeta: Tensor, alpha, *, eps: float = 1e-12) -> Tensor:
    """Analytic dB/dzeta of the relaxed inverse barrier."""
    alpha_eff = torch.clamp(_as(alpha, zeta), min=eps)
    safe = zeta >= alpha_eff
    zc = torch.clamp(zeta, min=eps)
    d_safe = -1.0 / (zc * zc)
    diff = zeta - alpha_eff
    aa = alpha_eff * alpha_eff
    d_unsafe = -1.0 / aa + (2.0 * diff) / (aa * alpha_eff)
    return torch.where(safe, d_safe, d_unsafe)


def log_barrier(zeta: Tensor, *, eps: float = 1e-12) -> Tensor:
    return -torch.log(torch.clamp(zeta, min=eps))


def d_log_barrier(zeta: Tensor, *, eps: float = 1e-12) -> Tensor:
    return -1.0 / torch.clamp(zeta, min=eps)


def barrier_value(zeta: Tensor, alpha, *, barrier_type: str = "inverse", eps: float = 1e-12) -> Tensor:
    if barrier_type == "inverse":
        return relaxed_inverse_barrier(zeta, alpha, eps=eps)
    if barrier_type == "log":
        return log_barrier(zeta, eps=eps)
    raise ValueError(f"Unknown barrier_type: {barrier_type}")


def barrier_deriv(zeta: Tensor, alpha, *, barrier_type: str = "inverse", eps: float = 1e-12) -> Tensor:
    if barrier_type == "inverse":
        return d_relaxed_inverse_barrier(zeta, alpha, eps=eps)
    if barrier_type == "log":
        return d_log_barrier(zeta, eps=eps)
    raise ValueError(f"Unknown barrier_type: {barrier_type}")


def balanced_weight(x: Tensor, ans: Tensor, other) -> Tensor:
    """JAX's balanced-equality factor in the tangent of lax.max/min(x, other) = ans:
    1 where x won alone, 1/2 on a tie, 0 where it lost."""
    one = torch.ones_like(ans)
    return torch.where(x == ans, one, 0.0 * one) / torch.where(ans == other, 2.0 * one, one)


def barrier_lin(
    zeta: Tensor, alpha, *, barrier_type: str = "inverse", eps: float = 1e-12
) -> Tuple[Tensor, Callable[[Tensor], Tensor]]:
    """(B(zeta), dzeta -> dB) with the tangent by JAX's differentiation rules."""
    value = barrier_value(zeta, alpha, barrier_type=barrier_type, eps=eps)
    m = torch.clamp(zeta, min=eps)
    w = balanced_weight(zeta, m, eps)
    if barrier_type == "log":
        return value, lambda dz: -((dz * w) / m)
    alpha_eff = torch.clamp(_as(alpha, zeta), min=eps)
    safe = zeta >= alpha_eff
    diff = zeta - alpha_eff
    aa = alpha_eff * alpha_eff
    inv_mm = 1.0 / (m * m)

    def tangent(dz: Tensor) -> Tensor:
        d_safe = (-(dz * w)) * inv_mm
        d_unsafe = -(dz / aa) + (dz * (2.0 * diff)) / (aa * alpha_eff)
        return torch.where(safe, d_safe, d_unsafe)

    return value, tangent


def barrier_dalpha(zeta: Tensor, alpha, *, barrier_type: str = "inverse",
                   eps: float = 1e-12) -> Tensor:
    """∂B/∂α at zeta, as jax.jvp in alpha (tangent 1) computes it.

    With a = max(α, ε): da = the balanced-equality weight of max (1/2 on the tie
    α == ε); the quotient rule for 1/a, diff/a² and diff²/a³, with
    d(a²) = da·(2a), d(a³) = da·(3a²), d(diff) = -da, d(diff²) = d(diff)·(2 diff);
    0 on the branch B = 1/max(zeta, ε), which does not depend on α. The log
    barrier does not depend on α."""
    if barrier_type == "log":
        return torch.zeros_like(zeta)
    alpha = _as(alpha, zeta)
    a = torch.clamp(alpha, min=eps)
    da = balanced_weight(alpha, a, eps)
    diff = zeta - a
    aa = a * a
    a3 = a * aa
    d_diff = -da
    d_inv = (-da) * (1.0 / aa)
    d_lin = d_diff / aa + ((-(da * (2.0 * a))) * diff) * (1.0 / (aa * aa))
    d_quad = (d_diff * (2.0 * diff)) / a3 + ((-(da * (3.0 * aa))) * (diff * diff)) * (1.0 / (a3 * a3))
    d_unsafe = (d_inv - d_lin) + d_quad
    return torch.where(zeta >= a, torch.zeros_like(d_unsafe), d_unsafe)


def dbas_step(x: Tensor, u: Tensor, b: Tensor, *, f: Callable[[Tensor, Tensor], Tensor],
              h: Callable[[Tensor], Tensor], alpha, gamma, barrier_type: str = "inverse",
              eps: float = 1e-12) -> Tuple[Tensor, Tensor]:
    """One DBaS-augmented step: x⁺ = f(x, u), b⁺ = B(h(x⁺)) - γ (B(h(x)) - b); x [..., nx],
    u [..., nu], b [...] -> (x⁺, b⁺)."""
    x_next = f(x, u)
    b_next_barrier = barrier_value(h(x_next), alpha, barrier_type=barrier_type, eps=eps)
    b_curr_barrier = barrier_value(h(x), alpha, barrier_type=barrier_type, eps=eps)
    gamma = _as(gamma, b_next_barrier)
    b_next = b_next_barrier - gamma * (b_curr_barrier - b)
    return x_next, b_next


def dbas_init_b0(x0: Tensor, *, h: Callable[[Tensor], Tensor], alpha,
                 barrier_type: str = "inverse", eps: float = 1e-12) -> Tensor:
    """b_0 = B(h(x_0))."""
    return barrier_value(h(x0), alpha, barrier_type=barrier_type, eps=eps)
