"""Experiment runner: config -> lane closed loop -> run-dir artifacts (port of the lane
engine's branch of tube_mpc_tpu/runners.py:28-65, 196-371).

``run_experiment`` runs a config's closed loop on the lane kernels, on the card unless
the caller asks for the CPU (where the kernels' plain versions run), and writes the JAX
package's artifacts and summary. Paper mode is paper_dubins_mode and not adapt_nominal;
otherwise the generic loop runs, and adapt_nominal selects its coupled bilevel chain.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .tube.closed_loop import ClosedLoopLog
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


def run_experiment(cfg: ExperimentConfig, run_dir: str, *, w_seq=None,
                   batch: Optional[int] = None, engine: str = "lanes",
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Closed-loop adaptive tube MPC on the lane kernels; returns {"summary", "log"} (the
    summary also written to run_dir). Runs on the card unless device='cpu'.

    Always float32, as the JAX lane engine: a use_float64 config is rebuilt at f32 and
    the summary's dtype says so. Disturbances are ``w_seq`` ([H, nx] or [B, H, nx]), or
    else drawn for ``batch`` lanes (default 1) from a torch.Generator on the run's device
    seeded with cfg.seed. That draw is not the JAX runner's jax.random.PRNGKey(cfg.seed)
    draw, which the port cannot replay: the same config gives other disturbances, and
    so another run, than the JAX package's unless w_seq is passed. Lane 0 is saved as the
    single-run artifacts; with more than one lane, every field also as <field>_batch.npy.
    """
    if engine == "xla":
        raise ValueError("engine='xla' is not ported yet (ROADMAP.md, queue A item 7); "
                         "the port runs the lane engine, engine='lanes'")
    if engine != "lanes":
        raise ValueError(f"unknown engine {engine!r} (the port runs 'lanes')")
    B = int(batch) if batch else 0
    if B > 1 and w_seq is not None:
        raise ValueError("batch mode samples disturbances; don't pass w_seq")
    if not cfg.adaptation.adapt_ancillary:
        raise ValueError(
            "adaptation.adapt_ancillary: false is refused: the lane loops always adapt the "
            "ancillary θ (the JAX lane loops ignore the key and adapt it anyway; ROADMAP.md, "
            "queue C)")
    paper_mode = cfg.paper_dubins_mode and not cfg.adaptation.adapt_nominal
    forced_f32 = cfg.use_float64
    if forced_f32:
        cfg = dataclasses.replace(cfg, use_float64=False)
    built = build_experiment(cfg, paper_mode=paper_mode, device=device)
    validate_for_engine(built, "lanes")
    dev = built.device

    sys_c = lane_components(cfg)
    draw: Dict[str, Any] = {}
    if w_seq is not None:
        w_seq = torch.as_tensor(np.asarray(w_seq), dtype=cfg.dtype, device=dev)
        if w_seq.ndim == 2:
            w_seq = w_seq[None]
        B = w_seq.shape[0]
    else:
        B = max(B, 1)
        draw = dict(generator=torch.Generator(device=dev).manual_seed(cfg.seed), batch=B)
    loop_kw = dict(x0=built.x0, target=built.target, w_seqs=w_seq, eps=cfg.dbas.eps,
                   barrier_type=cfg.dbas.barrier_type, device=dev, **draw)

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
