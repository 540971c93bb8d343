"""Public interface to the lane kernels for tube-MPC problems (port of
tube_mpc_tpu/tube/lane_interface.py:26-313).

Bridges the feature-last [B, ...] API to the [.., B] lane layout: builds the
LaneProblem from a ComponentSystem, packs weights and barrier parameters into
const rows, and transposes operands once at entry and once at exit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
from torch import Tensor

from ..device import DeviceLike, check_on, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import BarrierParams
from ..ops.lanes import ComponentSystem, augmented_lin_fn, augmented_step_fn
from ..ops.cuda.lane_sensitivity import lane_sensitivity_grads
from ..ops.cuda.lane_solver import LaneProblem, lane_ilqr_solve, rollout
from ..solvers.ilqr import ILQRConfig
from ..utils.profiling import annotate
from .params import AuxAdapt


def make_lane_problem(sys_c: ComponentSystem, *, barrier_type: str = "inverse",
                      eps: float = 1e-6) -> LaneProblem:
    return LaneProblem(
        n=sys_c.n, m=sys_c.m,
        f_hat=augmented_step_fn(sys_c, barrier_type=barrier_type, eps=eps),
        f_hat_lin=augmented_lin_fn(sys_c, barrier_type=barrier_type, eps=eps),
        u_min=sys_c.u_min, u_max=sys_c.u_max, spec=sys_c.spec,
        barrier_type=barrier_type, eps=eps,
    )


def _rows(x: Tensor) -> Tensor:
    """[B, ..., d] feature-last -> [..., d, B] lane-major, contiguous."""
    return torch.movedim(x, 0, -1).contiguous()


def _unrows(x: Tensor) -> Tensor:
    return torch.movedim(x, -1, 0)


def _with_barrier_row(X_ref: Tensor) -> Tensor:
    return torch.cat([X_ref, X_ref.new_zeros(X_ref.shape[:-1] + (1,))], dim=-1)


def _build_C(pb: LaneProblem, w: CostWeights, bp: BarrierParams, B: int, dtype,
             device) -> Tensor:
    """Const rows [nc, B]; vector weights shared [d] or per lane [B, d]; qb,
    alpha, gamma, tight scalar or per lane [B]."""

    def comp(v, i) -> Tensor:
        v = torch.as_tensor(v, dtype=dtype, device=device)
        if v.ndim == 2:
            return v[:, i]
        return v[i].expand(B)

    def scal(v) -> Tensor:
        return torch.as_tensor(v, dtype=dtype, device=device).expand(B)

    rows = (
        [2.0 * comp(w.Q, i) for i in range(pb.n)] + [2.0 * scal(w.qb)]
        + [2.0 * comp(w.R, a) for a in range(pb.m)]
        + [2.0 * comp(w.Qf, i) for i in range(pb.n)] + [2.0 * scal(w.qb)]
        + [scal(bp.alpha), scal(bp.gamma), scal(bp.tight)]
    )
    return torch.stack(rows, dim=0)


def tube_ilqr_solve_lanes(
    pb: LaneProblem,
    cfg: ILQRConfig,
    *,
    w: CostWeights,
    bp: BarrierParams,
    x_hat0: Tensor,      # [B, n̂]
    U_init: Tensor,      # [B, N, m]
    X_ref: Tensor,       # [B, N+1, n] (or [N+1, n] shared: goal tracking)
    U_ref: Tensor,       # [B, N, m]   (or [N, m] shared)
    device: DeviceLike = None,
    with_lane_iters: bool = False,
    compact_caps: Tuple[int, ...] = (),
) -> Tuple:
    """Solve B tube OCPs at once on the lane kernels; returns
    (X_hat [B, N+1, n̂], U [B, N, m]), then each lane's iterations [B] with
    ``with_lane_iters``; ``compact_caps`` runs the
    straggler compaction, bitwise equal to the uncompacted solve (lane_ilqr_solve).
    Runs on the card unless device='cpu'. The checks, the clamp, the transposes, the
    const rows and the first rollout run under the span ``lane.solve_setup``."""
    with annotate("lane.solve_setup"):
        dev = resolve_device(device)
        check_on(dev, (x_hat0, U_init, X_ref, U_ref), "tube_ilqr_solve_lanes")
        B, N, m = U_init.shape
        dtype = x_hat0.dtype
        if X_ref.ndim == 2:
            X_ref = X_ref[None].expand((B,) + tuple(X_ref.shape))
        if U_ref.ndim == 2:
            U_ref = U_ref[None].expand((B,) + tuple(U_ref.shape))

        u_min = torch.as_tensor(pb.u_min, dtype=dtype, device=dev)
        u_max = torch.as_tensor(pb.u_max, dtype=dtype, device=dev)
        U0_r = _rows(torch.minimum(u_max, torch.maximum(u_min, U_init)))
        x0_r = _rows(x_hat0)
        Xr_r = _rows(_with_barrier_row(X_ref))
        Ur_r = _rows(U_ref)
        C = _build_C(pb, w, bp, B, dtype, dev)
        X0_r = rollout(pb, x0_r, U0_r, Xr_r, Ur_r, C)

    out = lane_ilqr_solve(
        pb, x_hat0=x0_r, U0=U0_r, X0=X0_r, X_ref=Xr_r, U_ref=Ur_r, C=C,
        max_iter=cfg.max_iter, tol=cfg.tol, reg=cfg.reg, alphas=cfg.alphas,
        with_lane_iters=with_lane_iters, compact_caps=compact_caps,
    )
    return (_unrows(out[0]), _unrows(out[1])) + out[2:]


def tube_sensitivity_grads_lanes(
    pb: LaneProblem,
    *,
    w: CostWeights,
    bp: BarrierParams,
    X_hat: Tensor,    # [B, N+1, n̂] solved aux trajectory
    U: Tensor,        # [B, N, m]
    X_ref: Tensor,    # [B, N+1, n] physical reference (nominal plan)
    U_ref: Tensor,    # [B, N, m]
    reg: float = 1e-9,
    active_tol: float = 1e-8,
    device: DeviceLike = None,
) -> AuxAdapt:
    """Per-lane gradients of the upper loss L = ||x* - x̄||² + ||b*||² with respect to
    the ancillary (Q [B, n], R [B, m], qb [B]), from the δz sensitivity."""
    dev = resolve_device(device)
    check_on(dev, (X_hat, U, X_ref, U_ref), "tube_sensitivity_grads_lanes")
    B = U.shape[0]
    dtype = U.dtype
    C = _build_C(pb, w, bp, B, dtype, dev)
    gx, gr = lane_sensitivity_grads(
        pb, X=_rows(X_hat), U=_rows(U), X_ref=_rows(_with_barrier_row(X_ref)),
        U_ref=_rows(U_ref), C=C, reg=reg, active_tol=active_tol,
    )
    return AuxAdapt(Q=_unrows(gx[: pb.n]), R=_unrows(gr), qb=gx[pb.n])


class GenericAuxGrads(NamedTuple):
    """Per-lane gradients of the upper loss with respect to the MAPPED generic
    ancillary parameters θ = (Q, R, Qf, qb, α, γ); the chain rule to the raw
    parameters is the caller's."""

    Q: Tensor      # [B, n]
    R: Tensor      # [B, m]
    Qf: Tensor     # [B, n]
    qb: Tensor     # [B]
    alpha: Tensor  # [B]
    gamma: Tensor  # [B]


class GenericNominalGrads(NamedTuple):
    """Per-lane coupled-bilevel gradients with respect to the MAPPED nominal
    parameters θ̄ = (Q, R, Qf, qb, α, γ, tight)."""

    Q: Tensor
    R: Tensor
    Qf: Tensor
    qb: Tensor
    alpha: Tensor
    gamma: Tensor
    tight: Tensor


def tube_sensitivity_grads_lanes_generic(
    pb: LaneProblem,
    *,
    w: CostWeights,
    bp: BarrierParams,
    X_hat: Tensor,    # [B, N+1, n̂]
    U: Tensor,        # [B, N, m]
    X_ref: Tensor,    # [B, N+1, n]
    U_ref: Tensor,    # [B, N, m]
    reg: float = 1e-9,
    active_tol: float = 1e-8,
    emit_ref_grads: bool = False,
    device: DeviceLike = None,
) -> Union[GenericAuxGrads, Tuple[GenericAuxGrads, Tensor, Tensor]]:
    """Generic-path gradients on the lane kernels: the full θ with the separate
    terminal Qf and the barrier dynamics parameters (α, γ) by the
    Σ_k δλ_{k+1}ᵀ ∂f̂/∂θ term.

    emit_ref_grads=True also returns (g_Xref [B, N+1, n̂], g_Uref [B, N, m]),
    ∂L/∂(X_ref, U_ref) with the barrier row zeroed and the terminal row from the
    terminal weights: the upper gradients of the coupled nominal sweep."""
    dev = resolve_device(device)
    check_on(dev, (X_hat, U, X_ref, U_ref), "tube_sensitivity_grads_lanes_generic")
    B = U.shape[0]
    dtype = U.dtype
    C = _build_C(pb, w, bp, B, dtype, dev)
    out = lane_sensitivity_grads(
        pb, X=_rows(X_hat), U=_rows(U), X_ref=_rows(_with_barrier_row(X_ref)),
        U_ref=_rows(U_ref), C=C, reg=reg, active_tol=active_tol,
        generic=True, emit_ref_grads=emit_ref_grads,
    )
    gx, gr, gxt, gdyn = out[:4]
    grads = GenericAuxGrads(
        Q=_unrows(gx[: pb.n]), R=_unrows(gr), Qf=_unrows(gxt[: pb.n]),
        qb=gx[pb.n] + gxt[pb.n], alpha=gdyn[0], gamma=gdyn[1],
    )
    if not emit_ref_grads:
        return grads
    gxr, gur, gxrN = out[4:]
    # The barrier row of X_ref is a structural 0, not a parameter of the
    # ancillary cost: its cotangent is masked out.
    mask = torch.as_tensor([1.0] * pb.n + [0.0], dtype=dtype, device=dev)
    g_Xref = torch.cat([_unrows(gxr), _unrows(gxrN)[:, None]], dim=1) * mask
    return grads, g_Xref, _unrows(gur)


def tube_sensitivity_grads_lanes_nominal_coupled(
    pb: LaneProblem,
    *,
    w: CostWeights,
    bp: BarrierParams,
    X_hat: Tensor,     # [B, N+1, n̂] solved NOMINAL trajectory
    U: Tensor,         # [B, N, m]
    target: Tensor,    # [n] goal (the nominal stage tracks the fixed target)
    upper_gX: Tensor,  # [B, N+1, n̂] upper gradients, the ancillary reference cotangents
    upper_gU: Tensor,  # [B, N, m]
    reg: float = 1e-9,
    active_tol: float = 1e-8,
    device: DeviceLike = None,
) -> GenericNominalGrads:
    """Coupled-bilevel nominal gradients: the δz sweep runs with the caller's upper
    gradients (the ancillary solve's ∂L/∂(X_ref, U_ref)) in place of the tube
    loss, and accumulates the full θ̄ gradient with the barrier dynamics
    parameters and the nominal tightening."""
    dev = resolve_device(device)
    check_on(dev, (X_hat, U, target, upper_gX, upper_gU),
             "tube_sensitivity_grads_lanes_nominal_coupled")
    B, N, m = U.shape
    dtype = U.dtype
    Xr = target[None, None].expand(B, N + 1, pb.n)
    Ur = torch.zeros((B, N, m), dtype=dtype, device=dev)
    C = _build_C(pb, w, bp, B, dtype, dev)
    gx, gr, gxt, gdyn = lane_sensitivity_grads(
        pb, X=_rows(X_hat), U=_rows(U), X_ref=_rows(_with_barrier_row(Xr)), U_ref=_rows(Ur),
        C=C, reg=reg, active_tol=active_tol, generic=True,
        upper_gx=_rows(upper_gX), upper_gu=_rows(upper_gU),
    )
    return GenericNominalGrads(
        Q=_unrows(gx[: pb.n]), R=_unrows(gr), Qf=_unrows(gxt[: pb.n]),
        qb=gx[pb.n] + gxt[pb.n], alpha=gdyn[0], gamma=gdyn[1], tight=gdyn[2],
    )
