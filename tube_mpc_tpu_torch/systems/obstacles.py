"""Circular-obstacle safety value h(x) > 0 and its gradient in feature-last form (port of
tube_mpc_tpu/systems/obstacles.py:23-132): the smooth-min, the exact min and the
single-obstacle aggregations.

This is the ``logsumexp`` form that the closed loop's propagation uses
(``aug.f_hat`` and ``aug.init_b0``). The lane kernels use the min-shifted
component form of ops/lanes.py instead; the two agree only to rounding and are
kept apart on purpose. The kernels take the smooth-min and the min; 'single' runs on
the feature-major (XLA) engine only, and utils/config.validate_for_engine refuses it
for the lane engine before any kernel is built. The gradients are the feature-major
solvers' Jacobian rows of f̂ (ops/dbas.py::f_hat_jac).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch
from torch import Tensor


class CircleField(NamedTuple):
    centers: Tensor  # [M, 2]
    radii: Tensor    # [M]


def h_circles_each(x: Tensor, field: CircleField) -> Tensor:
    """h_i(x) = ||p - c_i||^2 - r_i^2; x [..., nx] (position first) -> [..., M]."""
    d = x[..., None, :2] - field.centers
    return torch.sum(d * d, dim=-1) - field.radii * field.radii


def _logsumexp(a: Tensor) -> Tensor:
    """jax.scipy.special.logsumexp over the last axis, in its operation order."""
    amax = torch.amax(a, dim=-1)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = torch.sum(torch.exp(a - amax[..., None]), dim=-1)
    return torch.log(torch.abs(sumexp)) + amax


def h_smoothmin(x: Tensor, field: CircleField, *, beta: float = 20.0) -> Tensor:
    """-(1/beta) logsumexp(-beta h_i)."""
    return -(1.0 / beta) * _logsumexp(-beta * h_circles_each(x, field))


def h_min(x: Tensor, field: CircleField) -> Tensor:
    """min_i h_i(x)."""
    return torch.amin(h_circles_each(x, field), dim=-1)


def grad_h_circles_each(x: Tensor, field: CircleField) -> Tensor:
    """dh_i/dx, zero beyond the position dims: x [..., nx] -> [..., M, nx]."""
    nx = x.shape[-1]
    d = 2.0 * (x[..., None, :2] - field.centers)
    pad = torch.zeros(d.shape[:-1] + (nx - 2,), dtype=d.dtype, device=d.device)
    return torch.cat([d, pad], dim=-1)


def grad_h_min(x: Tensor, field: CircleField) -> Tensor:
    """The argmin subgradient of h_min: the first minimal obstacle's gradient."""
    hs = h_circles_each(x, field)
    grads = grad_h_circles_each(x, field)
    idx = torch.argmin(hs, dim=-1)
    onehot = (idx[..., None] == torch.arange(hs.shape[-1], device=hs.device)).to(grads.dtype)
    return torch.sum(onehot[..., None] * grads, dim=-2)


def grad_h_smoothmin(x: Tensor, field: CircleField, *, beta: float = 20.0) -> Tensor:
    """The softmax-weighted gradient of the smooth-min."""
    hs = h_circles_each(x, field)
    grads = grad_h_circles_each(x, field)
    z = -beta * hs
    z = z - torch.amax(z, dim=-1, keepdim=True)
    w = torch.exp(z)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(w[..., None] * grads, dim=-2)


def make_h(field: CircleField, *, aggregation: str = "smoothmin",
           beta: float = 20.0) -> Tuple[Callable[[Tensor], Tensor], Callable[[Tensor], Tensor]]:
    """(h, grad_h) of the aggregation; an empty field is everywhere safe (h = 1)."""
    if field.centers.shape[0] == 0:
        return (lambda x: torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device),
                torch.zeros_like)
    if aggregation == "smoothmin":
        return (lambda x: h_smoothmin(x, field, beta=beta),
                lambda x: grad_h_smoothmin(x, field, beta=beta))
    if aggregation == "min":
        return lambda x: h_min(x, field), lambda x: grad_h_min(x, field)
    if aggregation == "single":
        if field.centers.shape[0] != 1:
            raise ValueError("aggregation='single' requires exactly one obstacle")
        return (lambda x: h_circles_each(x, field)[..., 0],
                lambda x: grad_h_circles_each(x, field)[..., 0, :])
    raise ValueError(f"Unknown obstacle aggregation: {aggregation}")
