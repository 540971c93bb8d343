"""Batched closed-loop Algorithm 2 on the lane kernels, independent mode (port of
tube_mpc_tpu/tube/lane_closed_loop.py:47-262).

B adaptive tube-MPC closed loops advance together, one Python step per time step:
two lane iLQR solves (nominal, ancillary), the δz sensitivity and closed-form
weight gradients, the projected momentum update, and the disturbed propagation.
Every lane adapts its own (Q, R, q_b).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from ..device import DeviceLike, check_on, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import AugmentedDynamics, BarrierParams
from ..ops.lanes import ComponentSystem
from ..systems.base import System
from .closed_loop import ClosedLoopLog, TubeMPCConfig
from .lane_interface import make_lane_problem, tube_ilqr_solve_lanes, tube_sensitivity_grads_lanes
from .params import AuxAdapt, momentum_update, project_aux_adapt


class LaneLoopState(NamedTuple):
    x: Tensor         # [B, nx]
    b: Tensor         # [B]
    x_bar: Tensor     # [B, nx]
    b_bar: Tensor     # [B]
    U_nom_ws: Tensor  # [B, N, nu]
    U_aux_ws: Tensor  # [B, N, nu]
    adapt: AuxAdapt   # per lane
    vel: AuxAdapt


def _shift(U: Tensor) -> Tensor:
    """Receding-horizon warm start: drop the applied control, repeat the last."""
    return torch.cat([U[:, 1:], U[:, -1:]], dim=1)


def make_paper_lane_step(
    system: System,
    aug: AugmentedDynamics,
    pb,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    bp: BarrierParams,
    target: Tensor,
    B: int,
    dtype,
    device: DeviceLike = None,
) -> Callable[[LaneLoopState, Tensor], tuple]:
    """The per-step body: (state, w_t [B, nx]) -> (new state, log tuple)."""
    dev = resolve_device(device)
    nx, nu = system.nx, system.nu
    N = cfg.N
    nom_cfg = cfg.nominal_ilqr()
    aux_cfg = cfg.aux_ilqr()
    X_ref_nom = target[None, None].expand(B, N + 1, nx)
    U_ref_nom = torch.zeros((B, N, nu), dtype=dtype, device=dev)

    def step(state: LaneLoopState, w_t: Tensor):
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        X_nom, U_nom = tube_ilqr_solve_lanes(
            pb, nom_cfg, w=w_nominal, bp=bp, x_hat0=x_hat_bar, U_init=state.U_nom_ws,
            X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev,
        )
        X_ref = X_nom[..., :nx]

        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        w_aux = CostWeights(Q=state.adapt.Q, R=state.adapt.R, Qf=state.adapt.Q, qb=state.adapt.qb)
        X_aux, U_aux = tube_ilqr_solve_lanes(
            pb, aux_cfg, w=w_aux, bp=bp, x_hat0=x_hat, U_init=state.U_aux_ws,
            X_ref=X_ref, U_ref=U_nom, device=dev,
        )

        dx = X_aux[..., :nx] - X_ref
        db = X_aux[..., nx]
        L = torch.sum(dx * dx, dim=(-2, -1)) + torch.sum(db * db, dim=-1)

        grads = tube_sensitivity_grads_lanes(
            pb, w=CostWeights(Q=state.adapt.Q, R=state.adapt.R, Qf=state.adapt.Q, qb=state.adapt.qb),
            bp=bp, X_hat=X_aux, U=U_aux, X_ref=X_ref, U_ref=U_nom, reg=1e-9, device=dev,
        )
        # Fault isolation: a lane whose gradient or loss is not finite (the true
        # sensitivity overflows f32 in barrier-violating regimes) skips this
        # update and keeps its weights, instead of poisoning them for good.
        ok = (
            torch.isfinite(grads.Q).all(dim=-1)
            & torch.isfinite(grads.R).all(dim=-1)
            & torch.isfinite(grads.qb)
            & torch.isfinite(L)
        )
        zero = torch.zeros((), dtype=dtype, device=dev)
        grads = AuxAdapt(
            Q=torch.where(ok[:, None], grads.Q, zero),
            R=torch.where(ok[:, None], grads.R, zero),
            qb=torch.where(ok, grads.qb, zero),
        )
        adapt, vel = momentum_update(state.adapt, grads, state.vel, cfg.adapt, project_aux_adapt)

        u = U_aux[:, 0]
        x_hat_next = aug.f_hat(x_hat, u, bp)
        u_bar = U_nom[:, 0]
        x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp)

        new_state = LaneLoopState(
            x=x_hat_next[..., :nx] + w_t,
            b=x_hat_next[..., nx],
            x_bar=x_hat_bar_next[..., :nx],
            b_bar=x_hat_bar_next[..., nx],
            U_nom_ws=_shift(U_nom),
            U_aux_ws=_shift(U_aux),
            adapt=adapt,
            vel=vel,
        )
        log = (state.x, u, state.x_bar, u_bar, state.b, L, adapt.Q, adapt.R, adapt.qb)
        return new_state, log

    return step


def paper_lane_init_state(
    system: System, aug: AugmentedDynamics, cfg: TubeMPCConfig,
    *, aux_init: AuxAdapt, bp: BarrierParams, x0: Tensor, B: int, dtype,
) -> LaneLoopState:
    nx, nu = system.nx, system.nu
    if x0.ndim == 1:
        x0 = x0.expand(B, nx)
    aux_init = AuxAdapt(
        Q=aux_init.Q.expand(B, nx).clone(),
        R=aux_init.R.expand(B, nu).clone(),
        qb=aux_init.qb.expand(B).clone(),
    )
    b0 = aug.init_b0(x0, bp)
    zeros_U = torch.zeros((B, cfg.N, nu), dtype=dtype, device=x0.device)
    return LaneLoopState(
        x=x0, b=b0, x_bar=x0, b_bar=b0,
        U_nom_ws=zeros_U, U_aux_ws=zeros_U.clone(),
        adapt=aux_init,
        vel=AuxAdapt(*(torch.zeros_like(t) for t in aux_init)),
    )


def run_paper_closed_loop_lanes(
    system: System,
    aug: AugmentedDynamics,
    sys_c: ComponentSystem,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,                                   # [nx] shared or [B, nx]
    target: Tensor,
    w_seqs: Optional[Tensor] = None,              # [B, H, nx]
    generator: Optional[torch.Generator] = None,
    batch: Optional[int] = None,
    eps: float = 1e-4,
    barrier_type: str = "inverse",
    device: DeviceLike = None,
) -> ClosedLoopLog:
    """Run H steps of B closed loops; returns a ClosedLoopLog of [B, H, ...].

    Disturbances are ``w_seqs``, or drawn from ``generator`` for ``batch`` lanes.
    Runs on the card unless device='cpu'."""
    dev = resolve_device(device)
    H = cfg.H
    if w_seqs is None:
        if generator is None or batch is None:
            raise ValueError("provide w_seqs or (generator, batch)")
        w_seqs = system.sample_disturbance(generator, (batch, H), dtype=target.dtype)
    check_on(dev, (x0, target, w_seqs), "run_paper_closed_loop_lanes")
    B = w_seqs.shape[0]
    dtype = w_seqs.dtype

    pb = make_lane_problem(sys_c, barrier_type=barrier_type, eps=eps)
    step = make_paper_lane_step(
        system, aug, pb, cfg, w_nominal=w_nominal, bp=bp, target=target,
        B=B, dtype=dtype, device=dev,
    )
    state = paper_lane_init_state(system, aug, cfg, aux_init=aux_init, bp=bp, x0=x0, B=B, dtype=dtype)
    logs = []
    for t in range(H):
        state, log = step(state, w_seqs[:, t])
        logs.append(log)
    return ClosedLoopLog(*(torch.stack(field, dim=1) for field in zip(*logs)))
