"""Scenario-parallel engines: independent sweeps, tube verification, and population
Algorithm 2 with the adaptation gradient summed over a device mesh (port of
tube_mpc_tpu/parallel/scenarios.py).

1. ``vmap_paper_closed_loop``: B independent adaptive closed loops (each scenario adapts
   its own θ), the XLA engine's paper loop (tube/closed_loop.py) with the scenarios as
   its lanes.
2. ``tube_verification``: fixed controller weights, B disturbance draws, tube statistics
   (largest and mean tracking deviation, least safety margin, collision rate), on the XLA
   engine or, given a ComponentSystem, on the lane kernels.
3. ``run_population_adaptation``: ONE θ adapted online from the mean gradient over B
   scenarios. Every scenario solves its own nominal and ancillary problems each step;
   the gradient is the mean over the scenarios whose loss and gradient are finite. With
   a mesh (parallel/mesh.py) each rank runs its share of the scenarios and the sums behind
   that mean are all_reduce'd over the ranks every step, so θ stays the same on each.

Disturbances are ``w_seqs`` [B, H, nx], or drawn from ``keys`` [B, 2], one [H, nx] a key
(utils/prng.py), bitwise as the JAX package draws them from the same keys.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from ..device import DeviceLike, check_on, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import AugmentedDynamics, BarrierParams
from ..solvers.diff_ilqr import make_diff_ilqr
from ..solvers.ilqr import ilqr_solve
from ..systems.base import System
from ..tube.closed_loop import (
    ClosedLoopLog,
    TubeMPCConfig,
    _disturbances,
    _shift,
    _upper_loss,
    run_paper_closed_loop,
)
from ..tube.params import AdaptConfig, AuxAdapt, momentum_update, project_aux_adapt
from ..tube.problem import AuxTheta, NominalTheta, expand_lanes, make_aux_ocp, make_nominal_ocp


# ---------------------------------------------------------------------------
# 1. Independent scenario sweep (per-scenario adaptation).
# ---------------------------------------------------------------------------

def vmap_paper_closed_loop(system: System, aug: AugmentedDynamics, cfg: TubeMPCConfig, *,
                           w_nominal: CostWeights, aux_init: AuxAdapt, bp: BarrierParams,
                           x0: Tensor, target: Tensor, w_seqs: Optional[Tensor] = None,
                           keys: Optional[Tensor] = None,
                           device: DeviceLike = None) -> ClosedLoopLog:
    """B independent adaptive closed loops under the disturbances ``w_seqs`` [B, H, nx]
    (or drawn from ``keys`` [B, 2], one [H, nx] a key); a ClosedLoopLog of [B, H, ...].
    Runs on the card unless device='cpu'."""
    return run_paper_closed_loop(system, aug, cfg, w_nominal=w_nominal, aux_init=aux_init,
                                 bp=bp, x0=x0, target=target, w_seq=w_seqs, key=keys,
                                 device=device)


# ---------------------------------------------------------------------------
# 2. Tube verification: fixed controller, batched disturbances, tube statistics.
# ---------------------------------------------------------------------------

class TubeStats(NamedTuple):
    max_deviation: Tensor    # [] max_t,b ||x_b(t) - x̄_b(t)||
    mean_deviation: Tensor   # []
    min_safety: Tensor       # [] min_t,b h(x_b(t))
    collision_rate: Tensor   # [] share of the scenarios with min_t h <= 0
    deviations: Tensor       # [B, H] each scenario's tracking deviation over time


def tube_verification(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    w_aux: CostWeights,
    bp: BarrierParams,
    x0: Tensor,
    target: Tensor,
    w_seqs: Optional[Tensor] = None,
    keys: Optional[Tensor] = None,
    h_exact=None,
    sys_c=None,
    eps: float = 1e-4,
    device: DeviceLike = None,
) -> Tuple[ClosedLoopLog, TubeStats]:
    """Monte-Carlo tube check: B closed loops with the ancillary weights FIXED at
    ``w_aux`` (the adaptation runs with lr = 0 and no momentum), then the deviation and
    safety statistics against each scenario's disturbance-free nominal trajectory, with
    ``h_exact`` (default ``system.h``) as the safety function.

    The disturbances are ``w_seqs`` [B, H, nx] or one [H, nx] drawn from each of ``keys``
    [B, 2]. The loops run on the XLA engine, or with ``sys_c`` (a ComponentSystem,
    ops/lanes.py) on the lane kernels, from the same disturbances either way. Runs on the
    card unless device='cpu'."""
    dev = resolve_device(device)
    if h_exact is None:
        h_exact = system.h
    adapt_off = TubeMPCConfig(
        N=cfg.N, H=cfg.H,
        nominal_max_iter=cfg.nominal_max_iter, aux_max_iter=cfg.aux_max_iter,
        tol=cfg.tol, reg=cfg.reg, alphas=cfg.alphas,
        adapt=AdaptConfig(lr=0.0, momentum=0.0),  # frozen weights
    )
    aux_init = AuxAdapt(Q=w_aux.Q, R=w_aux.R, qb=w_aux.qb)
    w_seqs = _disturbances(system, cfg.H, w_seqs, keys, x0.dtype)
    kw = dict(w_nominal=w_nominal, aux_init=aux_init, bp=bp, x0=x0, target=target,
              device=dev)
    if sys_c is not None:
        from ..tube.lane_closed_loop import run_paper_closed_loop_lanes

        logs = run_paper_closed_loop_lanes(system, aug, sys_c, adapt_off, w_seqs=w_seqs,
                                           eps=eps, **kw)
    else:
        logs = run_paper_closed_loop(system, aug, adapt_off, w_seq=w_seqs, **kw)
    deviations = torch.linalg.norm(logs.x_real - logs.x_bar, dim=-1)   # [B, H]
    h_vals = h_exact(logs.x_real)                                     # [B, H]
    collided = torch.any(h_vals <= 0.0, dim=-1)
    stats = TubeStats(
        max_deviation=torch.max(deviations),
        mean_deviation=torch.mean(deviations),
        min_safety=torch.min(h_vals),
        collision_rate=torch.mean(collided.to(deviations.dtype)),
        deviations=deviations,
    )
    return logs, stats


# ---------------------------------------------------------------------------
# 3. Population Algorithm 2: one θ, its gradient the mean over every scenario.
# ---------------------------------------------------------------------------

class PopulationState(NamedTuple):
    x: Tensor         # [B, nx]
    b: Tensor         # [B]
    x_bar: Tensor     # [B, nx]
    b_bar: Tensor     # [B]
    U_nom_ws: Tensor  # [B, N, nu]
    U_aux_ws: Tensor  # [B, N, nu]
    adapt: AuxAdapt   # shared: Q [nx], R [nu], qb []
    vel: AuxAdapt


class PopulationLog(NamedTuple):
    loss_mean: Tensor    # [H] mean over the scenarios with a finite loss and gradient
    Q_hist: Tensor       # [H, nx]
    R_hist: Tensor       # [H, nu]
    qb_hist: Tensor      # [H]
    finite_frac: Tensor  # [H] share of the scenarios that count (1.0: all)


def _population_step(system, aug, cfg, w_nominal, bp, target, group):
    """The step (state, w_t) -> (state, (loss mean, Q, R, qb, finite share)) over this
    rank's scenarios; the sums behind the means all_reduce'd over ``group`` if given."""
    nx = system.nx
    ocp_nom = make_nominal_ocp(system, aug, target)
    ocp_aux = make_aux_ocp(system, aug)
    solve_aux = make_diff_ilqr(ocp_aux, cfg.aux_ilqr())

    def step(state: PopulationState, w_t: Tensor):
        lanes = state.x.shape[0]
        bp_l = expand_lanes(bp, lanes)
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        X_nom, U_nom = ilqr_solve(ocp_nom, cfg.nominal_ilqr(),
                                  NominalTheta(w=expand_lanes(w_nominal, lanes), bp=bp_l),
                                  x_hat_bar, state.U_nom_ws)
        X_ref = X_nom[..., :nx]

        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        # Each scenario's gradient, from its own copy of θ (the backward of the sum of the
        # losses reaches each copy from its own scenario only), then a finite-masked mean:
        # one blown-up scenario must not poison the shared update through the sum.
        with torch.enable_grad():
            theta = AuxAdapt(*(v.expand((lanes,) + tuple(v.shape)).clone().requires_grad_()
                               for v in state.adapt))
            w_aux = CostWeights(Q=theta.Q, R=theta.R, Qf=theta.Q, qb=theta.qb)
            th = AuxTheta(w=w_aux, bp=bp_l, X_ref=X_ref.detach(), U_ref=U_nom.detach())
            X_aux, U_aux = solve_aux(th, x_hat, state.U_aux_ws)
            L_i = _upper_loss(X_aux, X_ref, nx)
            g_i = torch.autograd.grad(torch.sum(L_i), list(theta))
        X_aux, U_aux, L_i = X_aux.detach(), U_aux.detach(), L_i.detach()

        ok = torch.isfinite(L_i)
        for g in g_i:
            ok = ok & torch.isfinite(g.reshape(lanes, -1)).all(dim=-1)
        zero = L_i.new_zeros(())
        g_sum = [torch.where(ok.reshape((-1,) + (1,) * (g.ndim - 1)), g, zero).sum(dim=0)
                 for g in g_i]
        packed = torch.cat([g.reshape(-1) for g in g_sum] + [
            torch.where(ok, L_i, zero).sum()[None], ok.to(L_i.dtype).sum()[None],
            L_i.new_tensor([lanes])])
        if group is not None:
            # the exact global masked mean: the numerators, the healthy count and B summed
            dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
        *sums, L_sum, cnt, B_total = packed.split([g.numel() for g in g_sum] + [1, 1, 1])
        denom = torch.clamp(cnt[0], min=1.0)
        grads = AuxAdapt(*(s.reshape(g.shape) / denom for s, g in zip(sums, g_sum)))
        L = L_sum[0] / denom
        finite_frac = cnt[0] / B_total[0]

        adapt, vel = momentum_update(state.adapt, grads, state.vel, cfg.adapt, project_aux_adapt)

        u = U_aux[:, 0]
        x_hat_next = aug.f_hat(x_hat, u, bp)
        u_bar = U_nom[:, 0]
        x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp)
        new_state = PopulationState(
            x=x_hat_next[..., :nx] + w_t, b=x_hat_next[..., nx],
            x_bar=x_hat_bar_next[..., :nx], b_bar=x_hat_bar_next[..., nx],
            U_nom_ws=_shift(U_nom), U_aux_ws=_shift(U_aux), adapt=adapt, vel=vel)
        return new_state, (L, adapt.Q, adapt.R, adapt.qb, finite_frac)

    return step


def _population_init(system: System, aug: AugmentedDynamics, cfg: TubeMPCConfig, *,
                          aux_init: AuxAdapt, bp: BarrierParams,
                          x0_batch: Tensor) -> PopulationState:
    """Each scenario at its start x0_batch [B, nx] with zero warm starts; θ shared, as given,
    with zero velocity."""
    b0 = aug.init_b0(x0_batch, bp)
    zeros_U = x0_batch.new_zeros((x0_batch.shape[0], cfg.N, system.nu))
    return PopulationState(x=x0_batch, b=b0, x_bar=x0_batch, b_bar=b0, U_nom_ws=zeros_U,
                           U_aux_ws=zeros_U, adapt=aux_init,
                           vel=AuxAdapt(*(torch.zeros_like(v) for v in aux_init)))


def run_population_adaptation(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0_batch: Tensor,   # [B, nx]
    target: Tensor,
    w_seqs: Tensor,     # [B, H, nx]
    mesh=None,
    device: DeviceLike = None,
) -> Tuple[PopulationLog, AuxAdapt]:
    """Algorithm 2 with ONE θ trained on B scenarios at once, on the XLA engine: returns
    (the PopulationLog [H, ...], the final θ).

    With ``mesh`` (parallel/mesh.py::make_mesh), SPMD: every rank calls it with every
    scenario, runs B / (the mesh's size) of them, and all_reduces the gradient's sums each
    step, so the log and θ are the same on every rank. B must be a multiple of the mesh's
    size. Runs on the card unless device='cpu'."""
    dev = resolve_device(device)
    check_on(dev, (x0_batch, target, w_seqs, *w_nominal, *aux_init, *bp),
             "run_population_adaptation")
    group = None
    if mesh is not None:
        B, world = w_seqs.shape[0], mesh.size()
        if B % world != 0:
            raise ValueError(f"global batch {B} not divisible by mesh size {world}")
        group = mesh.get_group()
        lo = dist.get_rank(group) * (B // world)
        x0_batch, w_seqs = x0_batch[lo:lo + B // world], w_seqs[lo:lo + B // world]
    step = _population_step(system, aug, cfg, w_nominal, bp, target, group)
    state = _population_init(system, aug, cfg, aux_init=aux_init, bp=bp, x0_batch=x0_batch)
    logs = []
    for t in range(w_seqs.shape[1]):
        state, log = step(state, w_seqs[:, t])
        logs.append(log)
    return PopulationLog(*(torch.stack(field) for field in zip(*logs))), state.adapt
