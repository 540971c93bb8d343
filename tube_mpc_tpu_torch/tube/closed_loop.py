"""Closed-loop two-layer tube MPC with online Algorithm-2 adaptation on the feature-major
(XLA) engine, over B lanes (port of tube_mpc_tpu/tube/closed_loop.py:48-654):

- paper path (``run_paper_closed_loop``): fixed nominal MPC, the ancillary weights
  (Q, R, q_b) adapted by projected momentum descent on L = ||x* - x̄||² + ||b*||²,
  one update a step, the gradient by torch.autograd.grad through the differentiable
  ancillary solve (solvers/diff_ilqr.py);
- ``make_paper_closed_loop_diff``: the same loop, differentiable end to end in the
  nominal weights and the start (the hypergradient);
- generic path (``run_generic_closed_loop``): softplus/tanh raw θ̄ and θ, and with
  ``cfg.adapt_nominal`` the coupled nominal adaptation through the ancillary problem's
  reference;
- ``run_nominal_receding``: nominal-only receding horizon with success/collision stops.

The JAX package scans one scenario's H steps and vmaps the scenarios; here the H steps
are a Python loop and the scenarios a batch dim in front. Each lane's update is its own:
the gradient-norm clip is taken per lane, as each vmapped lane takes it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..device import DeviceLike, check_on, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import AugmentedDynamics, BarrierParams
from ..solvers.diff_ilqr import make_diff_ilqr, make_ift_regrad
from ..solvers.ilqr import ILQRConfig, ilqr_solve
from ..solvers.sensitivity import ddp_sensitivity
from ..solvers.weight_grads import grads_aux_from_deltas
from ..systems.base import System
from ..utils.checkpoint import run_steps
from ..utils.debug import located_check
from .params import (
    AdaptConfig,
    AuxAdapt,
    RawAuxTheta,
    RawNominalTheta,
    momentum_update,
    project_aux_adapt,
    project_raw,
)
from .problem import AuxTheta, NominalTheta, expand_lanes, make_aux_ocp, make_nominal_ocp


@dataclasses.dataclass(frozen=True)
class TubeMPCConfig:
    N: int
    H: int
    nominal_max_iter: int = 10
    aux_max_iter: int = 20
    tol: float = 1e-3
    reg: float = 1e-6
    alphas: Tuple[float, ...] = (1.0,)
    adapt: AdaptConfig = AdaptConfig(lr=5e-2, momentum=0.9)
    adapt_nominal: bool = False
    adapt_ancillary: bool = True
    # "reference": L treats the nominal plan as constant, and dL/dθ̄ reaches the
    # nominal parameters only through the ancillary problem's reference. "full":
    # the exact bilevel gradient, with the explicit ∂L/∂x̄ term as well.
    coupling: str = "reference"

    def nominal_ilqr(self) -> ILQRConfig:
        return ILQRConfig(max_iter=self.nominal_max_iter, tol=self.tol, reg=self.reg, alphas=self.alphas)

    def aux_ilqr(self) -> ILQRConfig:
        return ILQRConfig(max_iter=self.aux_max_iter, tol=self.tol, reg=self.reg, alphas=self.alphas)


class ClosedLoopLog(NamedTuple):
    """Per-step trajectories, [B, H, ...] (both engines)."""

    x_real: Tensor   # state at the start of each step
    u_real: Tensor   # applied ancillary control
    x_bar: Tensor    # nominal state
    u_bar: Tensor    # applied nominal control
    b_real: Tensor   # barrier state
    loss: Tensor     # upper loss L per step
    Q_hist: Tensor   # adapted ancillary Q (post-update)
    R_hist: Tensor
    qb_hist: Tensor


def _shift(U: Tensor) -> Tensor:
    """Receding-horizon warm start: drop the applied control, repeat the last."""
    return torch.cat([U[:, 1:], U[:, -1:]], dim=1)


def _upper_loss(X_aux: Tensor, x_nom: Tensor, nx: int) -> Tensor:
    """L = ||x* - x̄||² + ||b*||² over each lane's plan: [B]."""
    return (torch.sum((X_aux[..., :nx] - x_nom) ** 2, dim=(-2, -1))
            + torch.sum(X_aux[..., nx] ** 2, dim=-1))


def _lane_update(params, grads, vel, cfg: AdaptConfig, project_fn):
    """momentum_update with the gradient-norm clip taken per lane (leaves [B, ...])."""
    if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
        gnorm = torch.sqrt(sum(torch.sum((g * g).reshape(g.shape[0], -1), dim=-1)
                               for g in grads))
        clip = torch.as_tensor(cfg.grad_clip_norm, dtype=gnorm.dtype, device=gnorm.device)
        scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0)
        grads = type(grads)(*(g * scale.reshape((-1,) + (1,) * (g.ndim - 1)) for g in grads))
        cfg = dataclasses.replace(cfg, grad_clip_norm=0.0)
    return momentum_update(params, grads, vel, cfg, project_fn)


def _disturbances(system: System, H: int, w_seq, key, dtype) -> Tensor:
    """w_seq as [B, H, nx] ([H, nx] is one lane), or else drawn from ``key``: one key [2]
    draws one lane's [H, nx], a batch of keys [B, 2] one [H, nx] each, as the JAX package's
    loop under jax.vmap over its keys."""
    if w_seq is None:
        if key is None:
            raise ValueError("provide either w_seq or key")
        w_seq = system.sample_disturbance(key, (H,), dtype=dtype)
    return w_seq[None] if w_seq.ndim == 2 else w_seq


def _stack_logs(logs) -> ClosedLoopLog:
    return ClosedLoopLog(*(torch.stack(field, dim=1) for field in zip(*logs)))


def _with_grads(tree, requires: bool = True):
    """A named tuple of fresh leaves that require grad: the variables of a gradient."""
    return type(tree)(*(leaf.detach().requires_grad_(requires) for leaf in tree))


# ---------------------------------------------------------------------------
# Paper path: fixed nominal, ancillary (Q, R, q_b) adapted.
# ---------------------------------------------------------------------------

class PaperLoopState(NamedTuple):
    x: Tensor         # [B, nx]
    b: Tensor         # [B]
    x_bar: Tensor     # [B, nx]
    b_bar: Tensor     # [B]
    U_nom_ws: Tensor  # [B, N, nu]
    U_aux_ws: Tensor  # [B, N, nu]
    adapt: AuxAdapt   # [B, ..] leaves
    vel: AuxAdapt


def make_paper_step(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    bp: BarrierParams,
    target: Tensor,
    debug_checks: bool = False,
):
    """The per-step transition of the paper path: (state, w_t [B, nx]) -> (state, log).

    w_nominal and bp are shared by the lanes. debug_checks: a located finite check at
    each phase (A nominal solve, B ancillary solve, C loss and gradient, D propagation)
    that raises FloatingPointError naming the first failing one."""
    nx = system.nx
    ocp_nom = make_nominal_ocp(system, aug, target)
    ocp_aux = make_aux_ocp(system, aug)
    solve_aux = make_diff_ilqr(ocp_aux, cfg.aux_ilqr())

    def _chk(x, phase):
        return located_check(x, phase, enabled=debug_checks)

    def step(state: PaperLoopState, w_t: Tensor):
        lanes = state.x.shape[0]
        bp_l = expand_lanes(bp, lanes)
        # (A) nominal MPC from the nominal state
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        X_nom, U_nom = ilqr_solve(ocp_nom, cfg.nominal_ilqr(),
                                  NominalTheta(w=expand_lanes(w_nominal, lanes), bp=bp_l),
                                  x_hat_bar, state.U_nom_ws)
        X_nom = _chk(X_nom, "phase A: nominal iLQR solve X (tube_mpc.py:859)")
        U_nom = _chk(U_nom, "phase A: nominal iLQR solve U (tube_mpc.py:859)")
        X_ref = X_nom[..., :nx]

        # (B) ancillary MPC from the real state, (C) the upper loss and its gradient
        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        with torch.enable_grad():
            adapt_v = _with_grads(state.adapt)
            w_aux = CostWeights(Q=adapt_v.Q, R=adapt_v.R, Qf=adapt_v.Q, qb=adapt_v.qb)
            th = AuxTheta(w=w_aux, bp=bp_l, X_ref=X_ref, U_ref=U_nom)
            X_aux, U_aux = solve_aux(th, x_hat, state.U_aux_ws)
            L = _upper_loss(X_aux, X_ref, nx)
            grads = AuxAdapt(*torch.autograd.grad(torch.sum(L), list(adapt_v)))
        X_aux, U_aux, L = X_aux.detach(), U_aux.detach(), L.detach()
        X_aux = _chk(X_aux, "phase B: ancillary iLQR solve X (tube_mpc.py:910)")
        L = _chk(L, "phase C: upper loss (tube_mpc.py:915-919)")
        grads = AuxAdapt(*(_chk(g, "phase C: sensitivity/IFT gradient (tube_mpc.py:958-976)")
                           for g in grads))

        adapt, vel = _lane_update(state.adapt, grads, state.vel, cfg.adapt, project_aux_adapt)

        # (D) the true step with its disturbance; the barrier state propagates on f(x, u)
        u = U_aux[:, 0]
        x_hat_next = _chk(aug.f_hat(x_hat, u, bp),
                          "phase D: true step propagation (tube_mpc.py:991-996)")
        u_bar = U_nom[:, 0]
        x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp)

        new_state = PaperLoopState(
            x=x_hat_next[..., :nx] + w_t, b=x_hat_next[..., nx],
            x_bar=x_hat_bar_next[..., :nx], b_bar=x_hat_bar_next[..., nx],
            U_nom_ws=_shift(U_nom), U_aux_ws=_shift(U_aux), adapt=adapt, vel=vel)
        log = (state.x, u, state.x_bar, u_bar, state.b, L, adapt.Q, adapt.R, adapt.qb)
        return new_state, log

    return step


def paper_init_state(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,
    lanes: int,
) -> PaperLoopState:
    """x0 [nx] or [B, nx] and aux_init's leaves shared or per lane, made per lane."""
    nx, nu = system.nx, system.nu
    x0 = x0.expand(lanes, nx)
    aux_init = AuxAdapt(Q=aux_init.Q.expand(lanes, nx), R=aux_init.R.expand(lanes, nu),
                        qb=aux_init.qb.expand(lanes))
    b0 = aug.init_b0(x0, bp)
    zeros_U = torch.zeros((lanes, cfg.N, nu), dtype=x0.dtype, device=x0.device)
    return PaperLoopState(x=x0, b=b0, x_bar=x0, b_bar=b0, U_nom_ws=zeros_U,
                          U_aux_ws=zeros_U, adapt=aux_init,
                          vel=AuxAdapt(*(torch.zeros_like(t) for t in aux_init)))


def run_paper_closed_loop(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,
    target: Tensor,
    w_seq: Optional[Tensor] = None,
    key: Optional[Tensor] = None,
    debug_checks: bool = False,
    device: DeviceLike = None,
    ckpt_dir: Optional[str] = None,
    segment_len: Optional[int] = None,
) -> ClosedLoopLog:
    """H steps of the paper path on B lanes; returns a ClosedLoopLog of [B, H, ...].

    Disturbances are w_seq ([B, H, nx], or [H, nx] for one lane), or drawn from ``key``:
    [H, nx] from one key [2] (one lane), one [H, nx] from each of a batch of keys [B, 2].
    With ``ckpt_dir`` the loop runs in resumable segments of ``segment_len`` steps
    (utils/checkpoint.py), bitwise the same. Runs on the card unless device='cpu'."""
    dev = resolve_device(device)
    w_seq = _disturbances(system, cfg.H, w_seq, key, target.dtype)
    check_on(dev, (x0, target, w_seq, *w_nominal, *aux_init, *bp), "run_paper_closed_loop")
    step = make_paper_step(system, aug, cfg, w_nominal=w_nominal, bp=bp, target=target,
                           debug_checks=debug_checks)
    state = paper_init_state(system, aug, cfg, aux_init=aux_init, bp=bp, x0=x0,
                             lanes=w_seq.shape[0])
    return run_steps(step, state, w_seq, ClosedLoopLog, ckpt_dir=ckpt_dir,
                     segment_len=segment_len, cfg=cfg,
                     inputs=(state, w_nominal, bp, target))[1]


def make_paper_closed_loop_diff(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    bp: BarrierParams,
    target: Tensor,
    exact_hessians: bool = True,
):
    """A paper closed loop differentiable end to end:
    ``loop(w_nominal, aux_init, x0, w_seq) -> ClosedLoopLog``, through which
    torch.autograd.grad reaches (w_nominal, x0).

    Both solves are implicit-function Functions, and the Algorithm-2 gradient is the
    explicit closed-form pipeline (ddp_sensitivity + weight_grads) rather than an inner
    autograd.grad, so one outer gradient traverses the whole loop: solves, sensitivity
    sweeps, momentum updates, warm-start shifts. exact_hessians applies to the outer
    solves' backward only; the Algorithm-2 gradient stays on the Gauss-Newton pipeline,
    so the forward loop is run_paper_closed_loop's."""
    nx = system.nx
    ocp_nom = make_nominal_ocp(system, aug, target)
    ocp_aux = make_aux_ocp(system, aug)
    solve_nom = make_diff_ilqr(ocp_nom, cfg.nominal_ilqr(), exact_hessians=exact_hessians)
    solve_aux = make_diff_ilqr(ocp_aux, cfg.aux_ilqr(), exact_hessians=exact_hessians)

    def step(w_nominal: CostWeights, state: PaperLoopState, w_t: Tensor):
        lanes = state.x.shape[0]
        bp_l = expand_lanes(bp, lanes)
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        X_nom, U_nom = solve_nom(NominalTheta(w=expand_lanes(w_nominal, lanes), bp=bp_l),
                                 x_hat_bar, state.U_nom_ws)
        X_ref, U_ref = X_nom[..., :nx], U_nom

        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        w_aux = CostWeights(Q=state.adapt.Q, R=state.adapt.R, Qf=state.adapt.Q,
                            qb=state.adapt.qb)
        th_aux = AuxTheta(w=w_aux, bp=bp_l, X_ref=X_ref, U_ref=U_ref)
        X_aux, U_aux = solve_aux(th_aux, x_hat, state.U_aux_ws)
        L = _upper_loss(X_aux, X_ref, nx)

        # closed-form Algorithm-2 gradient: the rows of dL/dX_aux are [2(x - x̄), 2b]
        g_X = torch.cat([2.0 * (X_aux[..., :nx] - X_ref), 2.0 * X_aux[..., nx:]], dim=-1)
        sens = ddp_sensitivity(ocp_aux, th_aux, X_aux, U_aux, g_X, torch.zeros_like(U_aux))
        grads = grads_aux_from_deltas(X_aux, U_aux, X_ref, U_ref, sens)
        adapt, vel = _lane_update(state.adapt, grads, state.vel, cfg.adapt, project_aux_adapt)

        u = U_aux[:, 0]
        x_hat_next = aug.f_hat(x_hat, u, bp)
        u_bar = U_nom[:, 0]
        x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp)
        new_state = PaperLoopState(
            x=x_hat_next[..., :nx] + w_t, b=x_hat_next[..., nx],
            x_bar=x_hat_bar_next[..., :nx], b_bar=x_hat_bar_next[..., nx],
            U_nom_ws=_shift(U_nom), U_aux_ws=_shift(U_aux), adapt=adapt, vel=vel)
        return new_state, (state.x, u, state.x_bar, u_bar, state.b, L, adapt.Q, adapt.R,
                           adapt.qb)

    def loop(w_nominal: CostWeights, aux_init: AuxAdapt, x0: Tensor,
             w_seq: Tensor) -> ClosedLoopLog:
        w_seq = w_seq[None] if w_seq.ndim == 2 else w_seq
        state = paper_init_state(system, aug, cfg, aux_init=aux_init, bp=bp, x0=x0,
                                 lanes=w_seq.shape[0])
        logs = []
        for t in range(cfg.H):
            state, log = step(w_nominal, state, w_seq[:, t])
            logs.append(log)
        return _stack_logs(logs)

    return loop


# ---------------------------------------------------------------------------
# Generic path: raw-reparameterised θ̄ and θ, optional coupled nominal adaptation.
# ---------------------------------------------------------------------------

class GenericLoopState(NamedTuple):
    x: Tensor
    b: Tensor
    x_bar: Tensor
    b_bar: Tensor
    U_nom_ws: Tensor
    U_aux_ws: Tensor
    raw_nom: RawNominalTheta   # [B, ..] leaves
    raw_aux: RawAuxTheta
    vel_nom: RawNominalTheta
    vel_aux: RawAuxTheta


def _nominal_theta(raw: RawNominalTheta) -> NominalTheta:
    return NominalTheta(
        w=CostWeights(Q=raw.Q(), R=raw.R(), Qf=raw.Qf(), qb=raw.qb()),
        bp=BarrierParams(alpha=raw.alpha(), gamma=raw.gamma(), tight=raw.tight()),
    )


def _aux_theta(raw: RawAuxTheta, X_ref: Tensor, U_ref: Tensor) -> AuxTheta:
    alpha = raw.alpha()
    return AuxTheta(
        w=CostWeights(Q=raw.Q(), R=raw.R(), Qf=raw.Qf(), qb=raw.qb()),
        bp=BarrierParams(alpha=alpha, gamma=raw.gamma(), tight=torch.zeros_like(alpha)),
        X_ref=X_ref,
        U_ref=U_ref,
    )


def _per_lane_raw(raw, lanes: int):
    """A raw θ's leaves, shared ([d], []) or per lane, as [B, d] and [B] copies."""
    def leaf(name: str, v: Tensor) -> Tensor:
        shape = (lanes, v.shape[-1]) if name in ("Q_raw", "R_raw", "Qf_raw") else (lanes,)
        return v.expand(shape).clone()

    return type(raw)(*(leaf(name, v) for name, v in zip(raw._fields, raw)))


def run_generic_closed_loop(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    raw_nom_init: RawNominalTheta,
    raw_aux_init: RawAuxTheta,
    x0: Tensor,
    target: Tensor,
    w_seq: Optional[Tensor] = None,
    key: Optional[Tensor] = None,
    debug_checks: bool = False,
    device: DeviceLike = None,
) -> Tuple[ClosedLoopLog, Tuple[RawNominalTheta, RawAuxTheta]]:
    """The generic bilevel path on B lanes: adapt θ (and with cfg.adapt_nominal the
    coupled θ̄). Returns (ClosedLoopLog [B, H, ...], (final raw θ̄, final raw θ)).

    The coupled gradient needs no hand-wired chain: with cfg.adapt_nominal the ancillary
    references stay differentiable, and torch.autograd.grad routes the cotangents through
    the ancillary solve's backward into the nominal solve's and on into θ̄.
    cfg.adapt.steps > 1 re-derives the gradient at this step's fixed trajectories while θ
    moves (make_ift_regrad). Disturbances and devices as run_paper_closed_loop."""
    nx, nu = system.nx, system.nu
    if cfg.adapt.steps < 1:
        raise ValueError("adapt.steps must be >= 1")
    if cfg.coupling not in ("reference", "full"):
        raise ValueError(f"coupling must be 'reference' or 'full', not {cfg.coupling!r}")
    dev = resolve_device(device)
    w_seq = _disturbances(system, cfg.H, w_seq, key, target.dtype)
    check_on(dev, (x0, target, w_seq, *raw_nom_init, *raw_aux_init), "run_generic_closed_loop")
    lanes = w_seq.shape[0]

    def _chk(x, phase):
        return located_check(x, phase, enabled=debug_checks)

    ocp_nom = make_nominal_ocp(system, aug, target)
    ocp_aux = make_aux_ocp(system, aug)
    solve_nom = make_diff_ilqr(ocp_nom, cfg.nominal_ilqr())
    solve_aux = make_diff_ilqr(ocp_aux, cfg.aux_ilqr())
    regrad_nom = make_ift_regrad(ocp_nom)
    regrad_aux = make_ift_regrad(ocp_aux)

    def upper(raw_nom, raw_aux, nominal, ancillary):
        """(L [B], X_nom, U_nom, X_aux, U_aux) from the two solves (or regrads) in θ."""
        X_nom, U_nom = nominal(_nominal_theta(raw_nom))
        X_ref, U_ref = X_nom[..., :nx], U_nom
        if not cfg.adapt_nominal:
            X_ref, U_ref = X_ref.detach(), U_ref.detach()
        X_aux, U_aux = ancillary(_aux_theta(raw_aux, X_ref, U_ref))
        x_nom_in_L = X_nom[..., :nx]
        if cfg.coupling == "reference":
            x_nom_in_L = x_nom_in_L.detach()
        return _upper_loss(X_aux, x_nom_in_L, nx), X_nom, U_nom, X_aux, U_aux

    def gradients(raw_nom, raw_aux, nominal, ancillary):
        """(L, solves, g θ̄ or None, g θ): torch.autograd.grad of the lanes' summed loss."""
        with torch.enable_grad():
            rn, ra = _with_grads(raw_nom, cfg.adapt_nominal), _with_grads(raw_aux)
            L, *solves = upper(rn, ra, nominal, ancillary)
            wanted = list(ra) + (list(rn) if cfg.adapt_nominal else [])
            got = torch.autograd.grad(torch.sum(L), wanted, allow_unused=True)
        got = [torch.zeros_like(v) if g is None else g for v, g in zip(wanted, got)]
        g_aux = RawAuxTheta(*got[:len(ra)])
        g_nom = RawNominalTheta(*got[len(ra):]) if cfg.adapt_nominal else None
        return L.detach(), [s.detach() for s in solves], g_nom, g_aux

    def step(state: GenericLoopState, w_t: Tensor):
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        L, (X_nom, U_nom, X_aux, U_aux), g_nom, g_aux = gradients(
            state.raw_nom, state.raw_aux,
            lambda th: solve_nom(th, x_hat_bar, state.U_nom_ws),
            lambda th: solve_aux(th, x_hat, state.U_aux_ws))
        X_nom = _chk(X_nom, "phase A: nominal iLQR solve X (tube_mpc.py:291-321)")
        X_aux = _chk(X_aux, "phase B: ancillary iLQR solve X (tube_mpc.py:358-399)")
        L = _chk(L, "phase C: upper loss (tube_mpc.py:412-414)")
        for g in g_aux:
            _chk(g, "phase C: IFT gradient wrt theta (ift.py:35-92)")
        if cfg.adapt_nominal:
            for g in g_nom:
                _chk(g, "phase C: coupled IFT gradient wrt theta-bar (tube_mpc.py:586-599)")

        raw_nom, vel_nom = state.raw_nom, state.vel_nom
        raw_aux, vel_aux = state.raw_aux, state.vel_aux
        for inner in range(cfg.adapt.steps):
            if inner:
                # iterations 2..steps: the same composition on this step's fixed
                # trajectories; only the sensitivity and IFT rerun with the updated θ
                _, _, g_nom, g_aux = gradients(
                    raw_nom, raw_aux,
                    lambda th: regrad_nom(th, x_hat_bar, X_nom, U_nom),
                    lambda th: regrad_aux(th, x_hat, X_aux, U_aux))
            if cfg.adapt_nominal:
                raw_nom, vel_nom = _lane_update(raw_nom, g_nom, vel_nom, cfg.adapt, project_raw)
            if cfg.adapt_ancillary:
                raw_aux, vel_aux = _lane_update(raw_aux, g_aux, vel_aux, cfg.adapt, project_raw)

        # the true and nominal steps with the barrier parameters after this step's update
        alpha = raw_aux.alpha()
        bp_aux = BarrierParams(alpha=alpha, gamma=raw_aux.gamma(), tight=torch.zeros_like(alpha))
        bp_nom = BarrierParams(alpha=raw_nom.alpha(), gamma=raw_nom.gamma(), tight=raw_nom.tight())
        u = U_aux[:, 0]
        x_hat_next = aug.f_hat(x_hat, u, bp_aux)
        u_bar = U_nom[:, 0]
        x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp_nom)
        new_state = GenericLoopState(
            x=x_hat_next[..., :nx] + w_t, b=x_hat_next[..., nx],
            x_bar=x_hat_bar_next[..., :nx], b_bar=x_hat_bar_next[..., nx],
            U_nom_ws=_shift(U_nom), U_aux_ws=_shift(U_aux),
            raw_nom=raw_nom, raw_aux=raw_aux, vel_nom=vel_nom, vel_aux=vel_aux)
        log = (state.x, u, state.x_bar, u_bar, state.b, L, raw_aux.Q(), raw_aux.R(), raw_aux.qb())
        return new_state, log

    x0 = x0.expand(lanes, nx)
    raw_nom = _per_lane_raw(raw_nom_init, lanes)
    raw_aux = _per_lane_raw(raw_aux_init, lanes)
    alpha = raw_aux.alpha()
    b0 = aug.init_b0(x0, BarrierParams(alpha=alpha, gamma=raw_aux.gamma(),
                                       tight=torch.zeros_like(alpha)))
    b_bar0 = aug.init_b0(x0, _nominal_theta(raw_nom).bp)
    zeros_U = torch.zeros((lanes, cfg.N, nu), dtype=x0.dtype, device=x0.device)
    state = GenericLoopState(
        x=x0, b=b0, x_bar=x0, b_bar=b_bar0, U_nom_ws=zeros_U, U_aux_ws=zeros_U,
        raw_nom=raw_nom, raw_aux=raw_aux,
        vel_nom=RawNominalTheta(*(torch.zeros_like(v) for v in raw_nom)),
        vel_aux=RawAuxTheta(*(torch.zeros_like(v) for v in raw_aux)))
    logs = []
    for t in range(cfg.H):
        state, log = step(state, w_seq[:, t])
        logs.append(log)
    return _stack_logs(logs), (state.raw_nom, state.raw_aux)


# ---------------------------------------------------------------------------
# Nominal-only receding horizon (the validation harness of run_nominal).
# ---------------------------------------------------------------------------

class NominalRecedingState(NamedTuple):
    """The receding loop's carry, per lane."""

    t: Tensor          # [] int64, the step
    x: Tensor          # [B, nx]
    b: Tensor          # [B]
    U_ws: Tensor       # [B, N, nu]
    done: Tensor       # [B] bool
    success: Tensor    # [B] bool
    success_t: Tensor  # [B] int64 (H if never)
    collided: Tensor   # [B] bool


class NominalRecedingResult(NamedTuple):
    x: Tensor          # [B, H, nx]
    u: Tensor          # [B, H, nu]
    b: Tensor          # [B, H]
    ran: Tensor        # [B, H] bool: the step ran (before success or collision)
    success: Tensor    # [B] bool
    success_t: Tensor  # [B] int64 (H if never)
    collided: Tensor   # [B] bool


def nominal_receding_init_state(aug: AugmentedDynamics, cfg: TubeMPCConfig, *,
                                bp: BarrierParams, x0: Tensor,
                                warm_start: Optional[Tensor] = None) -> NominalRecedingState:
    """The carry at t = 0: x0 [nx] is one lane; warm_start [N, nu] or [B, N, nu]."""
    x0 = x0[None] if x0.ndim == 1 else x0
    lanes, nu = x0.shape[0], aug.nu
    if warm_start is None:
        warm_start = torch.zeros((cfg.N, nu), dtype=x0.dtype, device=x0.device)
    false = torch.zeros((lanes,), dtype=torch.bool, device=x0.device)
    return NominalRecedingState(
        t=torch.zeros((), dtype=torch.int64, device=x0.device), x=x0, b=aug.init_b0(x0, bp),
        U_ws=warm_start.expand(lanes, cfg.N, nu), done=false, success=false,
        success_t=torch.full((lanes,), cfg.H, dtype=torch.int64, device=x0.device),
        collided=false)


def make_nominal_receding_step(system: System, aug: AugmentedDynamics, cfg: TubeMPCConfig, *,
                               w_nominal: CostWeights, bp: BarrierParams, target: Tensor,
                               h_exact=None, success_radius: float = 0.25,
                               angle_dims: Tuple[int, ...] = (2,)):
    """One receding step: state -> (state, (x, u, b, ran)). A lane that reached the goal
    or collided keeps its state (the JAX scan's freeze); h_exact, the exact safety value,
    decides the collision (default: system.h)."""
    nx = system.nx
    ocp = make_nominal_ocp(system, aug, target, angle_dims=angle_dims)
    h_exact = h_exact if h_exact is not None else system.h

    def step(state: NominalRecedingState):
        lanes = state.x.shape[0]
        theta = NominalTheta(w=expand_lanes(w_nominal, lanes), bp=expand_lanes(bp, lanes))
        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        _, U = ilqr_solve(ocp, cfg.nominal_ilqr(), theta, x_hat, state.U_ws)
        u = U[:, 0]
        x_hat_next = aug.f_hat(x_hat, u, bp)

        ran = ~state.done
        now_collided = ran & (h_exact(state.x) <= 0.0)
        dist = torch.linalg.vector_norm(state.x[:, :2] - target[:2], dim=-1)
        now_success = ran & ~now_collided & (dist <= success_radius)
        frozen = state.done | now_collided | now_success
        new = NominalRecedingState(
            t=state.t + 1,
            x=torch.where(frozen[:, None], state.x, x_hat_next[:, :nx]),
            b=torch.where(frozen, state.b, x_hat_next[:, nx]),
            U_ws=torch.where(frozen[:, None, None], state.U_ws, _shift(U)),
            done=frozen, success=state.success | now_success,
            success_t=torch.where(now_success, state.t, state.success_t),
            collided=state.collided | now_collided)
        return new, (state.x, u, state.b, ran)

    return step


def run_nominal_receding(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    bp: BarrierParams,
    x0: Tensor,
    target: Tensor,
    h_exact=None,
    success_radius: float = 0.25,
    angle_dims: Tuple[int, ...] = (2,),
    warm_start: Optional[Tensor] = None,
    device: DeviceLike = None,
) -> NominalRecedingResult:
    """Receding-horizon nominal-only MPC with success/collision stopping over H steps, on
    the lanes of x0 ([nx] is one lane); ``ran`` masks each lane's live prefix."""
    dev = resolve_device(device)
    check_on(dev, (x0, target, *w_nominal, *bp), "run_nominal_receding")
    step = make_nominal_receding_step(system, aug, cfg, w_nominal=w_nominal, bp=bp,
                                      target=target, h_exact=h_exact,
                                      success_radius=success_radius, angle_dims=angle_dims)
    state = nominal_receding_init_state(aug, cfg, bp=bp, x0=x0, warm_start=warm_start)
    logs = []
    for _ in range(cfg.H):
        state, log = step(state)
        logs.append(log)
    xs, us, bs, ran = (torch.stack(field, dim=1) for field in zip(*logs))
    return NominalRecedingResult(x=xs, u=us, b=bs, ran=ran, success=state.success,
                                 success_t=state.success_t, collided=state.collided)
