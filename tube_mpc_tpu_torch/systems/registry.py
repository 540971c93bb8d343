"""System registry: a family's name to its feature-last System, its component form
for the lane kernels, and its default start (port of tube_mpc_tpu/systems/registry.py:21-137).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import Tensor

from ..ops import lanes as L
from .base import System
from .cartpole import CartPoleConfig, make_cartpole
from .double_integrator import DoubleIntegratorConfig, make_double_integrator
from .dubins import DubinsConfig, make_dubins
from .obstacles import CircleField
from .quadrotor2d import Quadrotor2DConfig, make_quadrotor2d


def build(
    name: str,
    *,
    dt: float,
    control_bounds: Dict[str, Any],
    disturbance: Dict[str, Any],
    target,
    obstacles: Optional[CircleField],
    aggregation: str,
    beta: float,
    device,
    dtype=torch.float32,
    extra: Optional[Dict[str, Any]] = None,
) -> System:
    """The feature-last System of family ``name`` on ``device`` in ``dtype``."""
    extra = extra or {}
    w_low = tuple(disturbance.get("w_low", ()))
    w_high = tuple(disturbance.get("w_high", ()))
    kw = dict(device=device, dtype=dtype)

    if name == "dubins":
        cfg = DubinsConfig(
            dt=dt,
            v_min=float(control_bounds.get("v_min", -control_bounds.get("v_max", 10.0))),
            v_max=float(control_bounds.get("v_max", 10.0)),
            omega_max=float(control_bounds.get("omega_max", math.pi)),
            w_low=w_low or DubinsConfig.w_low,
            w_high=w_high or DubinsConfig.w_high,
            x_target=tuple(target),
        )
        return make_dubins(cfg, obstacles=obstacles, aggregation=aggregation, beta=beta, **kw)
    if name == "double_integrator":
        cfg = DoubleIntegratorConfig(
            dt=dt,
            a_max=float(control_bounds.get("a_max", 5.0)),
            w_low=w_low or DoubleIntegratorConfig.w_low,
            w_high=w_high or DoubleIntegratorConfig.w_high,
            x_target=tuple(target),
        )
        return make_double_integrator(cfg, obstacles=obstacles, aggregation=aggregation,
                                      beta=beta, **kw)
    if name == "cartpole":
        cfg = CartPoleConfig(
            dt=dt,
            f_max=float(control_bounds.get("f_max", 20.0)),
            x_lim=float(extra.get("x_lim", 2.4)),
            w_low=w_low or CartPoleConfig.w_low,
            w_high=w_high or CartPoleConfig.w_high,
            x_target=tuple(target),
        )
        return make_cartpole(cfg, **kw)
    if name == "quadrotor2d":
        cfg = Quadrotor2DConfig(
            dt=dt,
            t_min=float(control_bounds.get("t_min", 0.0)),
            t_max=float(control_bounds.get("t_max", 8.0)),
            w_low=w_low or Quadrotor2DConfig.w_low,
            w_high=w_high or Quadrotor2DConfig.w_high,
            x_target=tuple(target),
        )
        return make_quadrotor2d(cfg, obstacles=obstacles, aggregation=aggregation, beta=beta,
                                **kw)
    raise ValueError(f"Unknown system: {name!r} (have: dubins, double_integrator, cartpole, "
                     "quadrotor2d)")


def default_x0(name: str, nx: int, *, device, dtype=torch.float32) -> Tensor:
    if name == "dubins":
        return torch.as_tensor([0.0, 0.0, math.pi / 4], dtype=dtype, device=device)
    if name == "cartpole":
        return torch.as_tensor([0.0, 0.0, math.pi, 0.0], dtype=dtype, device=device)  # hanging down
    return torch.zeros((nx,), dtype=dtype, device=device)


def build_components(
    name: str,
    *,
    dt: float,
    control_bounds: Dict[str, Any],
    obstacles,                      # sequence of {"center": [..], "radius": r} or None
    aggregation: str,
    beta: float,
    extra: Optional[Dict[str, Any]] = None,
) -> L.ComponentSystem:
    """The component form (ops/lanes.py) that the lane kernels run for family ``name``:
    the same math as ``build``'s System."""
    extra = extra or {}
    centers = [tuple(o["center"]) for o in (obstacles or [])]
    radii = [float(o["radius"]) for o in (obstacles or [])]

    if name == "dubins":
        v_max = float(control_bounds.get("v_max", 10.0))
        return L.dubins_components(
            dt=dt, v_min=float(control_bounds.get("v_min", -v_max)), v_max=v_max,
            omega_max=float(control_bounds.get("omega_max", math.pi)),
            centers=centers, radii=radii, aggregation=aggregation, beta=beta,
        )
    if name == "double_integrator":
        return L.double_integrator_components(
            dt=dt, a_max=float(control_bounds.get("a_max", 5.0)),
            centers=centers, radii=radii, aggregation=aggregation, beta=beta,
        )
    if name == "cartpole":
        return L.cartpole_components(
            dt=dt, f_max=float(control_bounds.get("f_max", 20.0)),
            x_lim=float(extra.get("x_lim", 2.4)),
        )
    if name == "quadrotor2d":
        return L.quadrotor2d_components(
            dt=dt, t_min=float(control_bounds.get("t_min", 0.0)),
            t_max=float(control_bounds.get("t_max", 8.0)),
            centers=centers, radii=radii, aggregation=aggregation, beta=beta,
        )
    raise ValueError(f"No component form for system {name!r}")
