"""Experiment runners: config -> closed loop -> run-dir artifacts (port of
tube_mpc_tpu/runners.py:28-488).

``run_experiment`` runs a config's closed loop on one of two engines, on the card unless
the caller asks for the CPU, and writes the JAX package's artifacts and summary:
- engine="lanes": the lane kernels (their plain versions on the CPU), always f32;
- engine="xla": the feature-major solvers (tube/closed_loop.py) as batched PyTorch
  operations, in the config's dtype (use_float64 is honoured).
Paper mode is paper_dubins_mode and not adapt_nominal; otherwise the generic loop runs,
and adapt_nominal selects its coupled bilevel chain. ``run_nominal`` and
``run_nominal_single`` are the nominal-only receding horizon and single solve.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .systems.obstacles import h_min
from .tube.closed_loop import (
    ClosedLoopLog,
    run_generic_closed_loop,
    run_nominal_receding,
    run_paper_closed_loop,
)
from .tube.lane_closed_loop import run_generic_closed_loop_lanes, run_paper_closed_loop_lanes
from .tube.params import RawAuxTheta, RawNominalTheta
from .utils.config import (
    ExperimentConfig,
    build_experiment,
    lane_components,
    validate_for_engine,
)
from .utils.debug import check_finite_log
from .utils.io import as_float64, save_closed_loop_log, save_json
from .utils.prng import PRNGKey, split


def raw_thetas(cfg: ExperimentConfig, device: torch.device) -> Tuple[RawNominalTheta, RawAuxTheta]:
    """The generic loop's initial raw θ̄ and θ: the config's numbers taken as raw values
    (not mapped through inv_softplus, as the JAX runner takes them), with its fallbacks:
    Qf to Q; the ancillary Q, R to the nominal ones; the ancillary Qf to its own Q, then
    the nominal Q."""
    t = lambda v: torch.as_tensor(v, dtype=cfg.dtype, device=device)
    cn, ca, db = cfg.cost_nominal, cfg.cost_auxiliary, cfg.dbas
    raw_nom = RawNominalTheta(
        Q_raw=t(list(cn.Q)), R_raw=t(list(cn.R)), Qf_raw=t(list(cn.Qf or cn.Q)),
        qb_raw=t(cn.q_b), alpha_raw=t(db.alpha), gamma_raw=t(db.gamma),
        tight_raw=t(db.nominal_tightening))
    raw_aux = RawAuxTheta(
        Q_raw=t(list(ca.Q or cn.Q)), R_raw=t(list(ca.R or cn.R)),
        Qf_raw=t(list(ca.Qf or ca.Q or cn.Q)), qb_raw=t(ca.q_b), alpha_raw=t(db.alpha),
        gamma_raw=t(db.gamma))
    return raw_nom, raw_aux


def parse_compact_caps(caps: Optional[str]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(ancillary caps, nominal caps) of "c1,c2[;n1,n2]"; None or "" is no compaction."""
    parts = str(caps or "").split(";")
    aux = tuple(int(c) for c in parts[0].split(",") if c)
    nom = tuple(int(c) for c in parts[1].split(",") if c) if len(parts) > 1 else ()
    return aux, nom


def run_experiment(cfg: ExperimentConfig, run_dir: str, *, w_seq=None,
                   batch: Optional[int] = None, engine: str = "lanes",
                   device: DeviceLike = None, checkpoint_every: Optional[int] = None,
                   compact_caps: Optional[str] = None) -> Dict[str, Any]:
    """Closed-loop adaptive tube MPC; returns {"summary", "log"} (the summary also written
    to run_dir). Runs on the card unless device='cpu'.

    engine="lanes" is always float32, as the JAX lane engine: a use_float64 config is
    rebuilt at f32 and the summary's dtype says so. engine="xla" runs in the config's
    dtype. Disturbances are ``w_seq`` ([H, nx] or [B, H, nx]), or else drawn for ``batch``
    lanes (default 1) from key = PRNGKey(cfg.seed) on the run's device (utils/prng.py),
    bitwise as the JAX runner draws them: the lane engine [B, H, nx] from the key, the XLA
    engine [H, nx] from the key for one lane and one [H, nx] from each of split(key, B)
    for B > 1. Lane 0 is saved as the single-run artifacts; with more than one lane,
    every field also as <field>_batch.npy.

    checkpoint_every: run the closed loop in resumable segments of this many steps, the
    carry written to <run_dir>/ckpt after each (utils/checkpoint.py); the same call with
    the same run_dir resumes after the last segment written, and the result is bitwise
    that of an uninterrupted run. Every lane-engine mode takes it; the XLA engine takes it
    in paper mode for one trajectory. compact_caps (lane engine): "c1,c2[;n1,n2]", the
    straggler compaction caps of the ancillary solves and, after ';', of the nominal ones
    (lane_ilqr_solve), bitwise equal to none.
    """
    if engine not in ("lanes", "xla"):
        raise ValueError(f"unknown engine {engine!r} (xla or lanes)")
    if engine == "xla" and compact_caps:
        raise ValueError("compact_caps is a lanes-engine feature (--engine lanes)")
    B = int(batch) if batch else 0
    if B > 1 and w_seq is not None:
        raise ValueError("batch mode samples disturbances; don't pass w_seq")
    if engine == "lanes" and not cfg.adaptation.adapt_ancillary:
        raise ValueError(
            "adaptation.adapt_ancillary: false is refused: the lane loops always adapt the "
            "ancillary θ (the JAX lane loops ignore the key and adapt it anyway; ROADMAP.md, "
            "queue C)")
    paper_mode = cfg.paper_dubins_mode and not cfg.adaptation.adapt_nominal
    if engine == "xla" and checkpoint_every and (not paper_mode or B > 1):
        raise ValueError("checkpoint_every requires paper mode, single trajectory")
    forced_f32 = engine == "lanes" and cfg.use_float64
    if forced_f32:
        cfg = dataclasses.replace(cfg, use_float64=False)
    built = build_experiment(cfg, paper_mode=paper_mode, device=device)
    validate_for_engine(built, engine)
    dev = built.device

    draw: Dict[str, Any] = {}
    if w_seq is not None:
        w_seq = torch.as_tensor(np.asarray(w_seq), dtype=cfg.dtype, device=dev)
        if w_seq.ndim == 2:
            w_seq = w_seq[None]
        B = w_seq.shape[0]
    else:
        B = max(B, 1)
        key = PRNGKey(cfg.seed, dev)
        if engine == "lanes":
            draw = dict(key=key, batch=B)
        else:
            draw = dict(key=split(key, B) if B > 1 else key)
    ckpt = dict(ckpt_dir=os.path.join(run_dir, "ckpt"),
                segment_len=int(checkpoint_every)) if checkpoint_every else {}
    if engine == "xla":
        return _run_experiment_xla(cfg, built, run_dir, w_seq=w_seq, draw=draw, B=B,
                                   paper_mode=paper_mode, ckpt=ckpt)

    sys_c = lane_components(cfg)
    aux_caps, nom_caps = parse_compact_caps(compact_caps)
    loop_kw = dict(x0=built.x0, target=built.target, w_seqs=w_seq, eps=cfg.dbas.eps,
                   barrier_type=cfg.dbas.barrier_type, device=dev, aux_compact_caps=aux_caps,
                   nom_compact_caps=nom_caps, **draw, **ckpt)

    t0 = time.perf_counter()
    if paper_mode:
        log = run_paper_closed_loop_lanes(
            built.system, built.aug, sys_c, built.tube_cfg, w_nominal=built.w_nominal,
            aux_init=built.aux_init, bp=built.bp, **loop_kw)
    else:
        raw_nom, raw_aux = raw_thetas(cfg, dev)
        log, _ = run_generic_closed_loop_lanes(
            built.system, built.aug, sys_c, built.tube_cfg, raw_nom=raw_nom,
            raw_aux_init=raw_aux, **loop_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return _finish_lanes(cfg, run_dir, log, wall, B=B, paper_mode=paper_mode,
                         forced_f32=forced_f32)


def _run_experiment_xla(cfg: ExperimentConfig, built, run_dir: str, *, w_seq, draw,
                        B: int, paper_mode: bool, ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The XLA engine's branch of run_experiment: the paper or generic loop of
    tube/closed_loop.py over the B lanes, with debug_numerics' located checks armed (and
    ``ckpt``'s ckpt_dir and segment_len in paper mode);
    B = 1 writes _finish_single's summary, B > 1 the population summary."""
    dev = built.device
    kw = dict(x0=built.x0, target=built.target, w_seq=w_seq, debug_checks=cfg.debug_numerics,
              device=dev, **draw)
    t0 = time.perf_counter()
    if paper_mode:
        log = run_paper_closed_loop(
            built.system, built.aug, built.tube_cfg, w_nominal=built.w_nominal,
            aux_init=built.aux_init, bp=built.bp, **kw, **ckpt)
    else:
        raw_nom, raw_aux = raw_thetas(cfg, dev)
        log, _ = run_generic_closed_loop(
            built.system, built.aug, built.tube_cfg, raw_nom_init=raw_nom,
            raw_aux_init=raw_aux, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    mode = "paper" if paper_mode else "generic"

    if cfg.debug_numerics:
        check_finite_log(log)
    if B == 1:
        return _finish_single(cfg, run_dir, log, mode, wall)

    H = cfg.system.task_horizon_H
    os.makedirs(run_dir, exist_ok=True)
    for name, arr in log._asdict().items():
        np.save(os.path.join(run_dir, f"{name}_batch.npy"), as_float64(arr))
    save_closed_loop_log(run_dir, ClosedLoopLog(*(leaf[0] for leaf in log)))
    final_losses = as_float64(log.loss[:, -1])
    summary = {
        "system": cfg.system.name,
        "mode": mode,
        "engine": "xla",
        "dtype": _dtype_name(cfg),
        "H": H,
        "N": cfg.system.horizon_N,
        "batch": B,
        "final_state": as_float64(log.x_real[0, -1]).tolist(),
        "final_barrier_state": float(as_float64(log.b_real[0, -1])),
        "final_loss": float(final_losses[0]),
        "final_loss_mean": float(final_losses.mean()),
        "final_loss_std": float(final_losses.std()),
        "final_loss_max": float(final_losses.max()),
        "wall_time_s": wall,
        "solves_per_sec": 2 * H * B / wall,
    }
    save_json(run_dir, "results_summary.json", summary)
    return {"summary": summary, "log": log}


def _dtype_name(cfg: ExperimentConfig) -> str:
    return "float64" if cfg.use_float64 else "float32"


def _finish_single(cfg: ExperimentConfig, run_dir: str, log: ClosedLoopLog, mode: str,
                   wall: float) -> Dict[str, Any]:
    """One lane's artifacts and the JAX runner's single-run summary keys (and the port's
    engine and dtype)."""
    H = cfg.system.task_horizon_H
    save_closed_loop_log(run_dir, ClosedLoopLog(*(leaf[0] for leaf in log)))
    summary = {
        "system": cfg.system.name,
        "mode": mode,
        "engine": "xla",
        "dtype": _dtype_name(cfg),
        "H": H,
        "N": cfg.system.horizon_N,
        "final_state": as_float64(log.x_real[0, -1]).tolist(),
        "final_barrier_state": float(as_float64(log.b_real[0, -1])),
        "final_loss": float(as_float64(log.loss[0, -1])),
        "wall_time_s": wall,
        "solves_per_sec": 2 * H / wall,
    }
    save_json(run_dir, "results_summary.json", summary)
    return {"summary": summary, "log": log}


def _finish_lanes(cfg: ExperimentConfig, run_dir: str, log: ClosedLoopLog, wall: float, *,
                  B: int, paper_mode: bool, forced_f32: bool) -> Dict[str, Any]:
    if cfg.debug_numerics:
        check_finite_log(log)

    H = cfg.system.task_horizon_H
    os.makedirs(run_dir, exist_ok=True)
    if B > 1:
        for name, arr in log._asdict().items():
            np.save(os.path.join(run_dir, f"{name}_batch.npy"), as_float64(arr))
    save_closed_loop_log(run_dir, ClosedLoopLog(*(leaf[0] for leaf in log)))
    final_losses = as_float64(log.loss[:, -1])
    finite = np.isfinite(final_losses)
    summary = {
        "system": cfg.system.name,
        "mode": "paper" if paper_mode else "generic",
        "engine": "lanes",
        "dtype": "float32" + (" (forced; lanes engine is f32-only)" if forced_f32 else ""),
        "H": H,
        "N": cfg.system.horizon_N,
        "batch": B,
        "final_state": as_float64(log.x_real[0, -1]).tolist(),
        "final_barrier_state": float(as_float64(log.b_real[0, -1])),
        "final_loss": float(final_losses[0]),
        # lanes whose numerics blew up are excluded and counted
        "final_loss_mean_finite": float(final_losses[finite].mean()) if finite.any() else None,
        "final_loss_median_finite": float(np.median(final_losses[finite])) if finite.any() else None,
        "finite_lane_frac": float(finite.mean()),
        "wall_time_s": wall,
        "solves_per_sec": 2 * H * B / wall,
    }
    save_json(run_dir, "results_summary.json", summary)
    return {"summary": summary, "log": log}


def run_nominal_single(cfg: ExperimentConfig, run_dir: str, *, feasible_filter: bool = False,
                       device: DeviceLike = None) -> Dict[str, Any]:
    """One nominal solve from x0: the angle-wrapped OCP with the v = v_max warm start
    (the first control at its upper bound), saving the plan as x_bar_single.npy and
    u_bar_single.npy. feasible_filter: the strict-feasibility line-search filter."""
    from .solvers.ilqr import ilqr_solve
    from .tube.problem import NominalTheta, expand_lanes, make_nominal_ocp

    built = build_experiment(cfg, paper_mode=False, device=device)
    system, aug = built.system, built.aug
    ocp = make_nominal_ocp(system, aug, built.target, angle_dims=system.angle_dims,
                           feasible_h=feasible_filter)
    theta = NominalTheta(w=expand_lanes(built.w_nominal, 1), bp=expand_lanes(built.bp, 1))
    b0 = aug.init_b0(built.x0, built.bp)
    x_hat0 = torch.cat([built.x0, b0[None]])[None]
    U_ws = torch.zeros((1, cfg.system.horizon_N, system.nu), dtype=cfg.dtype, device=built.device)
    U_ws[..., 0] = system.u_max[0]
    X_hat, U = ilqr_solve(ocp, built.tube_cfg.nominal_ilqr(), theta, x_hat0, U_ws)
    X_hat, U = X_hat[0], U[0]

    x_plan = as_float64(X_hat[:, :system.nx])
    u_plan = as_float64(U)
    os.makedirs(run_dir, exist_ok=True)
    np.save(os.path.join(run_dir, "x_bar_single.npy"), x_plan)
    np.save(os.path.join(run_dir, "u_bar_single.npy"), u_plan)
    summary = {
        "system": cfg.system.name,
        "mode": "nominal_only",
        "N": cfg.system.horizon_N,
        "x0": x_plan[0].tolist(),
        "xN": x_plan[-1].tolist(),
        "min_h_on_plan": (float(as_float64(system.h(X_hat[:, :system.nx])).min())
                          if system.h is not None else None),
    }
    save_json(run_dir, "results_summary.json", summary)
    return {"summary": summary, "X": X_hat, "U": U}


def run_nominal(cfg: ExperimentConfig, run_dir: str, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The nominal-only receding horizon with success/collision checks (the exact min
    over the obstacles decides a collision); saves the live prefix of the run."""
    built = build_experiment(cfg, paper_mode=False, device=device)
    h_exact = None
    if built.field is not None:
        field = built.field
        h_exact = lambda x: h_min(x, field)
    res = run_nominal_receding(
        built.system, built.aug, built.tube_cfg, w_nominal=built.w_nominal, bp=built.bp,
        x0=built.x0, target=built.target, h_exact=h_exact,
        angle_dims=built.system.angle_dims, device=built.device)

    ran = as_float64(res.ran[0]) > 0
    h_ran = int(ran.sum())
    xs = as_float64(res.x[0])[:h_ran]
    us = as_float64(res.u[0])[:h_ran]
    bs = as_float64(res.b[0])[:h_ran]
    os.makedirs(run_dir, exist_ok=True)
    for name, arr in (("x_bar", xs), ("u_bar", us), ("x_real", xs), ("u_real", us),
                      ("b_real", bs), ("loss", np.zeros((h_ran,), dtype=np.float64))):
        np.save(os.path.join(run_dir, f"{name}.npy"), arr)
    success_t = int(res.success_t[0])
    summary = {
        "system": cfg.system.name,
        "mode": "nominal_receding",
        "H_ran": h_ran,
        "success": bool(res.success[0]),
        "success_t": None if success_t >= cfg.system.task_horizon_H else success_t,
        "collided": bool(res.collided[0]),
        "final_state": xs[-1].tolist() if h_ran else as_float64(built.x0).tolist(),
    }
    save_json(run_dir, "results_summary.json", summary)
    return {"summary": summary, "result": res}
