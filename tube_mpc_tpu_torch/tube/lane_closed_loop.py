"""Batched closed-loop Algorithm 2 on the lane kernels (port of
tube_mpc_tpu/tube/lane_closed_loop.py), with the solves' straggler compaction and
iteration telemetry.

B adaptive tube-MPC closed loops advance together, one Python step per time step:
two lane iLQR solves (nominal, ancillary), the δz sensitivity and its gradients,
the projected momentum update, and the disturbed propagation.
- paper path (``run_paper_closed_loop_lanes``): every lane adapts its own
  ancillary (Q, R, q_b), or with ``population=True`` the lanes share one (Q, R, q_b),
  updated with the finite-masked mean of their gradients;
  ``run_paper_closed_loop_lanes_sharded`` runs the same loop over the ranks of a
  ``torch.distributed`` device mesh (parallel/mesh.py), its lanes split among them;
- generic path (``run_generic_closed_loop_lanes``): every lane adapts its own raw
  ancillary θ (weights with a separate Qf, and the barrier α, γ), and with
  ``cfg.adapt_nominal`` its raw nominal θ̄ too, by the coupled bilevel chain.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from ..device import DeviceLike, check_on, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import AugmentedDynamics, BarrierParams
from ..ops.lanes import ComponentSystem
from ..systems.base import System
from ..utils.checkpoint import LaneShards, run_steps
from ..utils.profiling import annotate
from .closed_loop import ClosedLoopLog, TubeMPCConfig
from .lane_interface import (
    make_lane_problem,
    tube_ilqr_solve_lanes,
    tube_sensitivity_grads_lanes,
    tube_sensitivity_grads_lanes_generic,
    tube_sensitivity_grads_lanes_nominal_coupled,
)
from .params import (
    AuxAdapt,
    RawAuxTheta,
    RawNominalTheta,
    momentum_update,
    project_aux_adapt,
    project_raw,
)


class LaneLoopState(NamedTuple):
    x: Tensor         # [B, nx]
    b: Tensor         # [B]
    x_bar: Tensor     # [B, nx]
    b_bar: Tensor     # [B]
    U_nom_ws: Tensor  # [B, N, nu]
    U_aux_ws: Tensor  # [B, N, nu]
    adapt: AuxAdapt   # per lane ([B, ..] leaves), or shared in population mode
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
    population: bool = False,
    group: Optional[dist.ProcessGroup] = None,
    iter_telemetry: bool = False,
    nom_compact_caps: Tuple[int, ...] = (),
    aux_compact_caps: Tuple[int, ...] = (),
) -> Callable[[LaneLoopState, Tensor], tuple]:
    """The per-step body: (state, w_t [B, nx]) -> (new state, log tuple).

    population: the lanes share one θ (Q [nx], R [nu], qb []), updated with the mean of
    the lanes' finite gradients: Σ over the finite lanes / max(their count, 1). group: a
    process group over which that mean is taken (the sharded loop; B is then this
    rank's lanes): one all_reduce(SUM) a step of (Σ Q, Σ R, Σ qb, count) packed in one
    tensor, before the division, so that θ stays the same on every rank.

    iter_telemetry appends each lane's solver iterations (nominal, ancillary; [B] int32
    each) to the log tuple: a step costs the most lanes' iterations, and the useful work
    is their mean. nom_compact_caps and aux_compact_caps: the two solves' straggler
    compaction (lane_ilqr_solve), bitwise equal to none.

    Spans (utils/profiling.py::annotate): ``tube.step`` around the whole body, and in it
    ``tube.nominal_solve``, ``tube.ancillary_solve``, ``tube.sensitivity`` (the tube loss
    and its gradients), ``tube.update`` (the finite mask, the population mean, the
    momentum update) and ``tube.propagate`` (f̂, the new carry, the shifted warm starts
    and the log row)."""
    dev = resolve_device(device)
    nx, nu = system.nx, system.nu
    N = cfg.N
    nom_cfg = cfg.nominal_ilqr()
    aux_cfg = cfg.aux_ilqr()
    X_ref_nom = target[None, None].expand(B, N + 1, nx)
    U_ref_nom = torch.zeros((B, N, nu), dtype=dtype, device=dev)

    def body(state: LaneLoopState, w_t: Tensor):
        with annotate("tube.nominal_solve"):
            x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
            nom_out = tube_ilqr_solve_lanes(
                pb, nom_cfg, w=w_nominal, bp=bp, x_hat0=x_hat_bar, U_init=state.U_nom_ws,
                X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev, with_lane_iters=iter_telemetry,
                compact_caps=nom_compact_caps,
            )
            X_nom, U_nom = nom_out[:2]
            X_ref = X_nom[..., :nx]

        with annotate("tube.ancillary_solve"):
            x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
            w_aux = CostWeights(Q=state.adapt.Q, R=state.adapt.R, Qf=state.adapt.Q,
                                qb=state.adapt.qb)
            aux_out = tube_ilqr_solve_lanes(
                pb, aux_cfg, w=w_aux, bp=bp, x_hat0=x_hat, U_init=state.U_aux_ws,
                X_ref=X_ref, U_ref=U_nom, device=dev, with_lane_iters=iter_telemetry,
                compact_caps=aux_compact_caps,
            )
            X_aux, U_aux = aux_out[:2]

        with annotate("tube.sensitivity"):
            dx = X_aux[..., :nx] - X_ref
            db = X_aux[..., nx]
            L = torch.sum(dx * dx, dim=(-2, -1)) + torch.sum(db * db, dim=-1)

            Q, R, qb = state.adapt
            if population:
                Q, R, qb = Q.expand(B, nx), R.expand(B, nu), qb.expand(B)
            grads = tube_sensitivity_grads_lanes(
                pb, w=CostWeights(Q=Q, R=R, Qf=Q, qb=qb), bp=bp, X_hat=X_aux, U=U_aux,
                X_ref=X_ref, U_ref=U_nom, reg=1e-9, device=dev,
            )

        with annotate("tube.update"):
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
            if population:
                grads = _population_mean(grads, ok, group)
            adapt, vel = momentum_update(state.adapt, grads, state.vel, cfg.adapt,
                                         project_aux_adapt)

        with annotate("tube.propagate"):
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
            log = (state.x, u, state.x_bar, u_bar, state.b, L,
                   adapt.Q.expand(B, nx), adapt.R.expand(B, nu), adapt.qb.expand(B))
            if iter_telemetry:
                log += (nom_out[2], aux_out[2])
        return new_state, log

    return _spanned_step(body)


def _spanned_step(body: Callable) -> Callable:
    """The step ``body`` run under the span ``tube.step``, in which every other span of
    the step nests: the step's phases, each solve's, each kernel's."""
    def step(state, w_t: Tensor):
        with annotate("tube.step"):
            return body(state, w_t)

    return step


def _population_mean(grads: AuxAdapt, ok: Tensor, group) -> AuxAdapt:
    """The shared θ's gradient from the lanes' masked gradients [B, ..]: their sums and
    the count of finite lanes ``ok``, summed over ``group``'s ranks too (one all_reduce of
    one packed tensor), then the sums / max(count, 1)."""
    nx, nu = grads.Q.shape[-1], grads.R.shape[-1]
    packed = torch.cat([grads.Q.sum(dim=0), grads.R.sum(dim=0), grads.qb.sum(dim=0)[None],
                        ok.to(grads.qb.dtype).sum()[None]])
    if group is not None:
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    sums = packed[:-1] / torch.clamp(packed[-1], min=1.0)
    return AuxAdapt(Q=sums[:nx], R=sums[nx:nx + nu], qb=sums[nx + nu])


def paper_lane_init_state(
    system: System, aug: AugmentedDynamics, cfg: TubeMPCConfig,
    *, aux_init: AuxAdapt, bp: BarrierParams, x0: Tensor, B: int, dtype,
    population: bool = False,
) -> LaneLoopState:
    """x0 [nx] or [B, nx]; θ per lane, or shared (as given) with ``population``; zero
    velocities and warm starts."""
    nx, nu = system.nx, system.nu
    if x0.ndim == 1:
        x0 = x0.expand(B, nx)
    if not population:
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
    key: Optional[Tensor] = None,
    batch: Optional[int] = None,
    eps: float = 1e-4,
    barrier_type: str = "inverse",
    population: bool = False,
    device: DeviceLike = None,
    nom_compact_caps: Tuple[int, ...] = (),
    aux_compact_caps: Tuple[int, ...] = (),
    ckpt_dir: Optional[str] = None,
    segment_len: Optional[int] = None,
) -> ClosedLoopLog:
    """Run H steps of B closed loops; returns a ClosedLoopLog of [B, H, ...].

    Disturbances are ``w_seqs``, or [batch, H, nx] drawn from one ``key``.
    population: one θ shared by the lanes (make_paper_lane_step); the log holds it for
    every lane. The caps are the solves' straggler compaction (make_paper_lane_step). With
    ``ckpt_dir`` the loop runs in resumable segments of ``segment_len`` steps
    (utils/checkpoint.py), bitwise the same. Runs on the card unless device='cpu'."""
    dev = resolve_device(device)
    if w_seqs is None:
        if key is None or batch is None:
            raise ValueError("provide w_seqs or (key, batch)")
        w_seqs = system.sample_disturbance(key, (batch, cfg.H), dtype=target.dtype)
    return _paper_lanes(system, aug, sys_c, cfg, w_nominal=w_nominal, aux_init=aux_init, bp=bp,
                        x0=x0, target=target, w_seqs=w_seqs, eps=eps, barrier_type=barrier_type,
                        population=population, dev=dev, shards=None,
                        nom_compact_caps=nom_compact_caps, aux_compact_caps=aux_compact_caps,
                        ckpt_dir=ckpt_dir, segment_len=segment_len)


def run_paper_closed_loop_lanes_sharded(
    system: System,
    aug: AugmentedDynamics,
    sys_c: ComponentSystem,
    cfg: TubeMPCConfig,
    *,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,          # [nx] shared or [B, nx]
    target: Tensor,
    w_seqs: Tensor,      # [B, H, nx], the whole run's
    mesh,
    eps: float = 1e-4,
    barrier_type: str = "inverse",
    population: bool = False,
    device: DeviceLike = None,
    ckpt_dir: Optional[str] = None,
    segment_len: Optional[int] = None,
) -> ClosedLoopLog:
    """run_paper_closed_loop_lanes over the ranks of ``mesh`` (a 1-D DeviceMesh,
    parallel/mesh.py::make_mesh), SPMD: every rank calls it with the whole run's inputs,
    steps B / (the mesh's size) of the lanes, and returns the whole run's [B, H, ...] log
    (one all_gather at the end). In population mode the shared θ's gradient is the mean
    over every rank's lanes (make_paper_lane_step's group), so θ is the same on every rank.

    With ``ckpt_dir`` (on a file system every rank sees): after each segment of
    ``segment_len`` steps rank 0 writes the whole run's carry and logs, gathered from every
    rank, in the files of run_paper_closed_loop_lanes; the fingerprint also holds the mesh's
    size and the mode, so a run on another number of ranks refuses the checkpoint. Each
    rank resumes from its own lanes of it."""
    B = w_seqs.shape[0]
    world = mesh.size()
    if B % world != 0:
        raise ValueError(f"global batch {B} not divisible by mesh size {world}")
    dev = resolve_device(device)
    group = mesh.get_group()
    shards = LaneShards(group=group, rank=dist.get_rank(group), world=world, lanes=B // world,
                        shared=("adapt", "vel") if population else ())
    return _paper_lanes(system, aug, sys_c, cfg, w_nominal=w_nominal, aux_init=aux_init, bp=bp,
                        x0=x0, target=target, w_seqs=w_seqs, eps=eps, barrier_type=barrier_type,
                        population=population, dev=dev, shards=shards, ckpt_dir=ckpt_dir,
                        segment_len=segment_len)


def _paper_lanes(system, aug, sys_c, cfg, *, w_nominal, aux_init, bp, x0, target, w_seqs, eps,
                 barrier_type, population, dev, shards: Optional[LaneShards],
                 nom_compact_caps=(), aux_compact_caps=(), ckpt_dir, segment_len):
    """The paper loop, plain or sharded; ``shards``: the sharded loop's split of the lanes."""
    if not cfg.adapt_ancillary or cfg.adapt_nominal:
        raise ValueError("the paper loop adapts the ancillary θ only: it takes adapt_ancillary="
                         "True and adapt_nominal=False (run_generic_closed_loop_lanes adapts θ̄)")
    check_on(dev, (x0, target, w_seqs), "run_paper_closed_loop_lanes")
    B = w_seqs.shape[0]
    dtype = w_seqs.dtype

    pb = make_lane_problem(sys_c, barrier_type=barrier_type, eps=eps)
    step = make_paper_lane_step(
        system, aug, pb, cfg, w_nominal=w_nominal, bp=bp, target=target,
        B=B if shards is None else shards.lanes, dtype=dtype, device=dev, population=population,
        group=shards.group if shards is not None and population else None,
        nom_compact_caps=nom_compact_caps, aux_compact_caps=aux_compact_caps,
    )
    state = paper_lane_init_state(system, aug, cfg, aux_init=aux_init, bp=bp, x0=x0, B=B,
                                  dtype=dtype, population=population)
    fingerprint = (None if shards is None
                   else {"mesh_devices": shards.world, "population": population})
    return run_steps(step, state, w_seqs, ClosedLoopLog, ckpt_dir=ckpt_dir,
                     segment_len=segment_len, cfg=cfg, inputs=(state, w_nominal, bp, target),
                     shards=shards, fingerprint=fingerprint)[1]


class GenericLaneState(NamedTuple):
    x: Tensor         # [B, nx]
    b: Tensor         # [B]
    x_bar: Tensor     # [B, nx]
    b_bar: Tensor     # [B]
    U_nom_ws: Tensor  # [B, N, nu]
    U_aux_ws: Tensor  # [B, N, nu]
    raw_aux: RawAuxTheta      # [B, ..] leaves
    vel_aux: RawAuxTheta
    raw_nom: RawNominalTheta  # [B, ..] leaves (fixed unless cfg.adapt_nominal)
    vel_nom: RawNominalTheta


def _raw_chain(raw, g):
    """Mapped-space gradients ``g`` (fields Q, R, Qf, qb, alpha, gamma[, tight]) to
    the raw space of ``raw`` (a RawAuxTheta or RawNominalTheta), leaf by leaf:
    softplus' = sigmoid(raw), and tanh' = 1 - tanh² for gamma."""
    def leaf(name: str, r: Tensor) -> Tensor:
        if name == "gamma_raw":
            th = torch.tanh(r)
            return g.gamma * (1.0 - th * th)
        return getattr(g, name[:-len("_raw")]) * torch.sigmoid(r)

    return type(raw)(*(leaf(name, r) for name, r in zip(raw._fields, raw)))


def _aux_params(raw: RawAuxTheta, zero_t: Tensor):
    return (CostWeights(Q=raw.Q(), R=raw.R(), Qf=raw.Qf(), qb=raw.qb()),
            BarrierParams(alpha=raw.alpha(), gamma=raw.gamma(), tight=zero_t))


def _nom_params(raw: RawNominalTheta):
    return (CostWeights(Q=raw.Q(), R=raw.R(), Qf=raw.Qf(), qb=raw.qb()),
            BarrierParams(alpha=raw.alpha(), gamma=raw.gamma(), tight=raw.tight()))


def _finite_lanes(ok: Tensor, tree) -> Tensor:
    for leaf in tree:
        ok = ok & (torch.isfinite(leaf).all(dim=-1) if leaf.ndim == 2 else torch.isfinite(leaf))
    return ok


def _mask(tree, ok: Tensor):
    zero = torch.zeros((), dtype=tree[0].dtype, device=ok.device)
    return type(tree)(*(torch.where(ok[:, None] if v.ndim == 2 else ok, v, zero) for v in tree))


def make_generic_lane_step(
    system: System,
    aug: AugmentedDynamics,
    pb,
    cfg: TubeMPCConfig,
    *,
    target: Tensor,
    B: int,
    dtype,
    device: DeviceLike = None,
    nom_compact_caps: Tuple[int, ...] = (),
    aux_compact_caps: Tuple[int, ...] = (),
) -> Callable[[GenericLaneState, Tensor], tuple]:
    """The per-step body of the generic/coupled loop: (state, w_t [B, nx]) ->
    (new state, log tuple). The caps as in make_paper_lane_step.

    cfg.adapt.steps > 1 runs the reference's inner adaptation loop: iterations
    2..steps re-derive the gradient at this step's FIXED trajectories while θ
    moves, i.e. they rerun the sensitivity sweeps with the updated weights and
    barrier parameters on the same (X, U); the solves are not repeated.

    Spans as in make_paper_lane_step; ``tube.sensitivity`` and ``tube.update`` once for
    each of those iterations."""
    dev = resolve_device(device)
    adapt_nominal = cfg.adapt_nominal
    nx, nu = system.nx, system.nu
    N = cfg.N
    nom_cfg = cfg.nominal_ilqr()
    aux_cfg = cfg.aux_ilqr()
    zero_t = torch.zeros((B,), dtype=dtype, device=dev)
    X_ref_nom = target[None, None].expand(B, N + 1, nx)
    U_ref_nom = torch.zeros((B, N, nu), dtype=dtype, device=dev)

    def body(state: GenericLaneState, w_t: Tensor):
        raw, rawn = state.raw_aux, state.raw_nom
        with annotate("tube.nominal_solve"):
            w_nom, bp_nom = _nom_params(rawn)
            x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
            X_nom, U_nom = tube_ilqr_solve_lanes(
                pb, nom_cfg, w=w_nom, bp=bp_nom, x_hat0=x_hat_bar, U_init=state.U_nom_ws,
                X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev, compact_caps=nom_compact_caps,
            )
            X_ref = X_nom[..., :nx]

        with annotate("tube.ancillary_solve"):
            w_aux, bp_aux = _aux_params(raw, zero_t)
            x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
            X_aux, U_aux = tube_ilqr_solve_lanes(
                pb, aux_cfg, w=w_aux, bp=bp_aux, x_hat0=x_hat, U_init=state.U_aux_ws,
                X_ref=X_ref, U_ref=U_nom, device=dev, compact_caps=aux_compact_caps,
            )

        with annotate("tube.sensitivity"):
            dx = X_aux[..., :nx] - X_ref
            db = X_aux[..., nx]
            L = torch.sum(dx * dx, dim=(-2, -1)) + torch.sum(db * db, dim=-1)

        def grads_at(raw_i: RawAuxTheta, rawn_i: RawNominalTheta):
            """Raw-space gradients at the fixed trajectories with θ = (raw_i, rawn_i)."""
            w_aux_i, bp_aux_i = _aux_params(raw_i, zero_t)
            aux_out = tube_sensitivity_grads_lanes_generic(
                pb, w=w_aux_i, bp=bp_aux_i, X_hat=X_aux, U=U_aux, X_ref=X_ref, U_ref=U_nom,
                reg=1e-9, emit_ref_grads=adapt_nominal, device=dev,
            )
            if not adapt_nominal:
                return _raw_chain(raw_i, aux_out), None
            g, g_Xref, g_Uref = aux_out
            if cfg.coupling == "full":
                # the explicit ∂L/∂x̄ = -2 (x* - x̄) on the physical rows
                expl = torch.cat([-2.0 * dx, dx.new_zeros((B, N + 1, 1))], dim=-1)
                g_Xref = g_Xref + expl
            w_nom_i, bp_nom_i = _nom_params(rawn_i)
            gn = tube_sensitivity_grads_lanes_nominal_coupled(
                pb, w=w_nom_i, bp=bp_nom_i, X_hat=X_nom, U=U_nom, target=target,
                upper_gX=g_Xref, upper_gU=g_Uref, reg=1e-9, device=dev,
            )
            return _raw_chain(raw_i, g), _raw_chain(rawn_i, gn)

        raw_new, vel_new = raw, state.vel_aux
        rawn_new, veln_new = rawn, state.vel_nom
        for _ in range(cfg.adapt.steps):
            with annotate("tube.sensitivity"):
                g_raw, gn_raw = grads_at(raw_new, rawn_new)
            with annotate("tube.update"):
                # Fault isolation: a lane whose loss or any gradient leaf is not
                # finite skips this update (see make_paper_lane_step).
                ok = _finite_lanes(torch.isfinite(L), g_raw)
                if adapt_nominal:
                    ok = _finite_lanes(ok, gn_raw)
                raw_new, vel_new = momentum_update(raw_new, _mask(g_raw, ok), vel_new,
                                                   cfg.adapt, project_raw)
                if adapt_nominal:
                    rawn_new, veln_new = momentum_update(rawn_new, _mask(gn_raw, ok), veln_new,
                                                         cfg.adapt, project_raw)

        with annotate("tube.propagate"):
            # propagate with the barrier parameters after this step's update
            _, bp_aux_post = _aux_params(raw_new, zero_t)
            _, bp_nom_post = _nom_params(rawn_new)
            u = U_aux[:, 0]
            x_hat_next = aug.f_hat(x_hat, u, bp_aux_post)
            u_bar = U_nom[:, 0]
            x_hat_bar_next = aug.f_hat(x_hat_bar, u_bar, bp_nom_post)

            new_state = GenericLaneState(
                x=x_hat_next[..., :nx] + w_t,
                b=x_hat_next[..., nx],
                x_bar=x_hat_bar_next[..., :nx],
                b_bar=x_hat_bar_next[..., nx],
                U_nom_ws=_shift(U_nom),
                U_aux_ws=_shift(U_aux),
                raw_aux=raw_new,
                vel_aux=vel_new,
                raw_nom=rawn_new,
                vel_nom=veln_new,
            )
            log = (state.x, u, state.x_bar, u_bar, state.b, L, raw_new.Q(), raw_new.R(),
                   raw_new.qb())
        return new_state, log

    return _spanned_step(body)


def generic_lane_init_state(
    system: System,
    aug: AugmentedDynamics,
    cfg: TubeMPCConfig,
    *,
    raw_nom: RawNominalTheta,
    raw_aux_init: RawAuxTheta,
    x0: Tensor,
    B: int,
    dtype,
) -> GenericLaneState:
    """Every raw leaf per lane ([B] or [B, d]; the nominal ones too, so that the
    coupled chain can adapt them lane by lane), zero velocities and warm starts."""
    nx, nu = system.nx, system.nu
    if x0.ndim == 1:
        x0 = x0.expand(B, nx)

    def per_lane(tree):
        def leaf(name, v):
            v = torch.as_tensor(v, dtype=dtype, device=x0.device)
            shape = (B, v.shape[-1]) if name in ("Q_raw", "R_raw", "Qf_raw") else (B,)
            return v.expand(shape).clone()
        return type(tree)(*(leaf(name, v) for name, v in zip(tree._fields, tree)))

    raw_aux = per_lane(raw_aux_init)
    raw_nom_l = per_lane(raw_nom)
    zero_t = torch.zeros((B,), dtype=dtype, device=x0.device)
    b0 = aug.init_b0(x0, _aux_params(raw_aux, zero_t)[1])
    b_bar0 = aug.init_b0(x0, _nom_params(raw_nom_l)[1])
    zeros_U = torch.zeros((B, cfg.N, nu), dtype=dtype, device=x0.device)
    return GenericLaneState(
        x=x0, b=b0, x_bar=x0, b_bar=b_bar0,
        U_nom_ws=zeros_U, U_aux_ws=zeros_U.clone(),
        raw_aux=raw_aux,
        vel_aux=RawAuxTheta(*(torch.zeros_like(t) for t in raw_aux)),
        raw_nom=raw_nom_l,
        vel_nom=RawNominalTheta(*(torch.zeros_like(t) for t in raw_nom_l)),
    )


def run_generic_closed_loop_lanes(
    system: System,
    aug: AugmentedDynamics,
    sys_c: ComponentSystem,
    cfg: TubeMPCConfig,
    *,
    raw_nom: RawNominalTheta,        # shared [d]/[] leaves or per lane [B, d]/[B]
    raw_aux_init: RawAuxTheta,
    x0: Tensor,                      # [nx] shared or [B, nx]
    target: Tensor,
    w_seqs: Optional[Tensor] = None,  # [B, H, nx]
    key: Optional[Tensor] = None,
    batch: Optional[int] = None,
    eps: float = 1e-6,
    barrier_type: str = "inverse",
    device: DeviceLike = None,
    nom_compact_caps: Tuple[int, ...] = (),
    aux_compact_caps: Tuple[int, ...] = (),
    ckpt_dir: Optional[str] = None,
    segment_len: Optional[int] = None,
) -> Tuple[ClosedLoopLog, Tuple[RawAuxTheta, RawNominalTheta]]:
    """Run H steps of B generic-path closed loops (raw softplus/tanh θ, adaptive
    barrier α/γ); returns (a ClosedLoopLog of [B, H, ...], (final raw ancillary θ,
    final raw nominal θ̄)).

    The nominal problem uses the fixed mapped θ̄ unless cfg.adapt_nominal: then the
    coupled bilevel chain runs on the lane kernels. The ancillary sweep also emits
    ∂L/∂(X_ref, U_ref), a second sweep on the nominal problem takes them as upper
    gradients and accumulates the full θ̄ gradient (weights and α/γ/tight), and both
    raw sets update by projected momentum. cfg.coupling="full" adds the explicit
    ∂L/∂x̄ term. cfg.adapt.steps > 1 runs the inner fixed-trajectory loop.

    Disturbances are ``w_seqs``, or [batch, H, nx] drawn from one ``key``. The
    caps and ``ckpt_dir`` as in run_paper_closed_loop_lanes. Runs on the card unless
    device='cpu'."""
    if cfg.adapt.steps < 1:
        raise ValueError("adapt.steps must be >= 1")
    if cfg.coupling not in ("reference", "full"):
        raise ValueError(f"coupling must be 'reference' or 'full', not {cfg.coupling!r}")
    if not cfg.adapt_ancillary:
        raise ValueError("the lane loops always adapt the ancillary θ; adapt_ancillary=False "
                         "is not supported")
    dev = resolve_device(device)
    H = cfg.H
    if w_seqs is None:
        if key is None or batch is None:
            raise ValueError("provide w_seqs or (key, batch)")
        w_seqs = system.sample_disturbance(key, (batch, H), dtype=target.dtype)
    check_on(dev, (x0, target, w_seqs, *raw_nom, *raw_aux_init), "run_generic_closed_loop_lanes")
    B = w_seqs.shape[0]
    dtype = w_seqs.dtype

    pb = make_lane_problem(sys_c, barrier_type=barrier_type, eps=eps)
    step = make_generic_lane_step(system, aug, pb, cfg, target=target, B=B, dtype=dtype, device=dev,
                                  nom_compact_caps=nom_compact_caps,
                                  aux_compact_caps=aux_compact_caps)
    state = generic_lane_init_state(system, aug, cfg, raw_nom=raw_nom, raw_aux_init=raw_aux_init,
                                    x0=x0, B=B, dtype=dtype)
    state, log = run_steps(step, state, w_seqs, ClosedLoopLog, ckpt_dir=ckpt_dir,
                           segment_len=segment_len, cfg=cfg, inputs=(state, target))
    return log, (state.raw_aux, state.raw_nom)
