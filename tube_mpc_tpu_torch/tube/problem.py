"""The two tube-MPC OCP layers from (system, DBaS augmentation, weights), over B lanes
(port of tube_mpc_tpu/tube/problem.py:32-153):

  nominal   (Problem 5): theta = NominalTheta(w, bp)
      stage (Q⊙(x-x*))·(x-x*) + (R⊙u)·u + q_b b², terminal with Qf and q_b b_N²
  ancillary (Problem 6): theta = AuxTheta(w, bp, X_ref, U_ref)
      tracking of (X_ref, U_ref) with the same structure.

Every leaf of theta is per lane: [B, d] weights, [B] scalars, X_ref [B, N+1, nx] and
U_ref [B, N, nu]; ``expand_lanes`` gives shared values that shape. The references live
inside the ancillary theta, so gradients reach them through the solve's backward: that
is the whole coupled-bilevel mechanism. Angle dims can be wrapped (the receding-horizon
runs with a heading target): the reference angle is re-anchored so that the cost and
its analytic derivatives see the wrapped error.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from ..ops import costs as C
from ..ops.dbas import AugmentedDynamics, BarrierParams
from ..solvers.ocp import OCP, lane_view
from ..systems.base import System


class NominalTheta(NamedTuple):
    w: C.CostWeights
    bp: BarrierParams


class AuxTheta(NamedTuple):
    w: C.CostWeights
    bp: BarrierParams
    X_ref: Tensor  # [B, N+1, nx], the physical part of the nominal plan
    U_ref: Tensor  # [B, N, nu]


def expand_lanes(tree, lanes: int):
    """Every leaf of a tree of named tuples shared by ``lanes`` lanes: [*F] -> [B, *F]."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(expand_lanes(v, lanes) for v in tree))
    return tree.expand((lanes,) + tuple(tree.shape))


def _weights(w: C.CostWeights, ndim: int) -> C.CostWeights:
    """The lanes' weights against states [B, ..., nx+1] of ``ndim`` dims."""
    return C.CostWeights(Q=lane_view(w.Q, ndim), R=lane_view(w.R, ndim),
                         Qf=lane_view(w.Qf, ndim), qb=lane_view(w.qb, ndim - 1))


def _barrier(bp: BarrierParams, ndim: int) -> BarrierParams:
    """The lanes' barrier parameters against states of ``ndim`` dims."""
    return BarrierParams(*(lane_view(v, ndim - 1) for v in bp))


def _wrap_ref(x: Tensor, ref: Tensor, angle_dims: Tuple[int, ...]) -> Tensor:
    """ref with ref'[i] = x[i] - wrap(x[i] - ref[i]) in the angle dims, so that x - ref' is
    the wrapped error."""
    if not angle_dims:
        return ref
    ref = ref.expand(x.shape)
    cols = [x[..., i] - C.wrap_angle(x[..., i] - ref[..., i]) if i in angle_dims
            else ref[..., i] for i in range(x.shape[-1])]
    return torch.stack(cols, dim=-1)


def _dynamics(aug: AugmentedDynamics):
    def f(x_hat, u, th):
        return aug.f_hat(x_hat, u, _barrier(th.bp, x_hat.ndim))

    def f_jac(x_hat, u, th):
        return aug.f_hat_jac(x_hat, u, _barrier(th.bp, x_hat.ndim))

    return f, f_jac


def make_nominal_ocp(
    system: System,
    aug: AugmentedDynamics,
    target: Tensor,
    *,
    angle_dims: Tuple[int, ...] = (),
    feasible_h: bool = False,
) -> OCP:
    """The goal-reaching OCP on the augmented state (target [nx], shared by the lanes)."""
    nx = system.nx
    u_ref0 = torch.zeros((system.nu,), dtype=target.dtype, device=target.device)
    f, f_jac = _dynamics(aug)

    def _target(x_hat):
        return _wrap_ref(x_hat[..., :nx], target, angle_dims)

    def stage_cost(X, U, th: NominalTheta):
        return C.stage_cost(X, U, _weights(th.w, X.ndim), _target(X), u_ref0)

    def terminal_cost(xN, th: NominalTheta):
        return C.terminal_cost(xN, _weights(th.w, xN.ndim), _target(xN))

    def stage_derivs(X, U, th: NominalTheta):
        return C.stage_derivs(X, U, _weights(th.w, X.ndim), _target(X), u_ref0)

    def terminal_derivs(xN, th: NominalTheta):
        return C.terminal_derivs(xN, _weights(th.w, xN.ndim), _target(xN))

    feasible = None
    if feasible_h:
        def feasible(X, th: NominalTheta):  # noqa: F811
            return aug.h_eff(X[..., :nx], _barrier(th.bp, X.ndim)) > 0.0

    return OCP(f=f, f_jac=f_jac, stage_cost=stage_cost, terminal_cost=terminal_cost,
               stage_derivs=stage_derivs, terminal_derivs=terminal_derivs,
               u_min=system.u_min, u_max=system.u_max, feasible=feasible)


def make_aux_ocp(
    system: System,
    aug: AugmentedDynamics,
    *,
    angle_dims: Tuple[int, ...] = (),
) -> OCP:
    """The tracking OCP on the augmented state: stage k tracks (X_ref[k], U_ref[k]), the
    terminal tracks X_ref[N] with Qf."""
    nx = system.nx
    f, f_jac = _dynamics(aug)

    def _refs(X, U, th: AuxTheta):
        x_ref = _wrap_ref(X[..., :nx], lane_view(th.X_ref[:, :-1], X.ndim), angle_dims)
        return x_ref, lane_view(th.U_ref, U.ndim)

    def _ref_N(xN, th: AuxTheta):
        return _wrap_ref(xN[..., :nx], lane_view(th.X_ref[:, -1], xN.ndim), angle_dims)

    def stage_cost(X, U, th: AuxTheta):
        return C.stage_cost(X, U, _weights(th.w, X.ndim), *_refs(X, U, th))

    def terminal_cost(xN, th: AuxTheta):
        return C.terminal_cost(xN, _weights(th.w, xN.ndim), _ref_N(xN, th))

    def stage_derivs(X, U, th: AuxTheta):
        return C.stage_derivs(X, U, _weights(th.w, X.ndim), *_refs(X, U, th))

    def terminal_derivs(xN, th: AuxTheta):
        return C.terminal_derivs(xN, _weights(th.w, xN.ndim), _ref_N(xN, th))

    return OCP(f=f, f_jac=f_jac, stage_cost=stage_cost, terminal_cost=terminal_cost,
               stage_derivs=stage_derivs, terminal_derivs=terminal_derivs,
               u_min=system.u_min, u_max=system.u_max)
