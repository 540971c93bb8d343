"""Circular-obstacle safety value h(x) > 0 in feature-last form (port of
tube_mpc_tpu/systems/obstacles.py:23-90, 118-149): the smooth-min, the exact min and
the single-obstacle aggregations.

This is the ``logsumexp`` form that the closed loop's propagation uses
(``aug.f_hat`` and ``aug.init_b0``). The lane kernels use the min-shifted
component form of ops/lanes.py instead; the two agree only to rounding and are
kept apart on purpose. The kernels take the smooth-min and the min; 'single' is here so
that a config that asks for it builds as in the JAX package, and
utils/config.validate_for_engine refuses it before any kernel is built.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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


def make_h(field: CircleField, *, aggregation: str = "smoothmin",
           beta: float = 20.0) -> Callable[[Tensor], Tensor]:
    if aggregation == "smoothmin":
        return lambda x: h_smoothmin(x, field, beta=beta)
    if aggregation == "min":
        return lambda x: h_min(x, field)
    if aggregation == "single":
        if field.centers.shape[0] != 1:
            raise ValueError("aggregation='single' requires exactly one obstacle")
        return lambda x: h_circles_each(x, field)[..., 0]
    raise ValueError(f"Unknown obstacle aggregation: {aggregation}")
