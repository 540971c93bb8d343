"""Run-directory artifacts (port of tube_mpc_tpu/utils/io.py): the same files as the JAX
package writes, so that plot_results.py and the agreement tools read them unchanged:

  x_real.npy u_real.npy x_bar.npy u_bar.npy b_real.npy loss.npy
  Qa_history.npy Ra_history.npy qba_history.npy
  config_used.json results_summary.json
"""
from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from typing import Any, Dict

import numpy as np
import torch


def make_run_dir(out_dir: str, run_name: str) -> str:
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    run_dir = os.path.join(out_dir, f"{run_name}_{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def as_float64(a) -> np.ndarray:
    """A tensor (on any device) or array as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def save_closed_loop_log(run_dir: str, log) -> None:
    """Persist a ClosedLoopLog, each field fetched once and written as float64."""
    os.makedirs(run_dir, exist_ok=True)
    arrs = {
        "x_real": log.x_real,
        "u_real": log.u_real,
        "x_bar": log.x_bar,
        "u_bar": log.u_bar,
        "b_real": log.b_real,
        "loss": log.loss,
        "Qa_history": log.Q_hist,
        "Ra_history": log.R_hist,
        "qba_history": log.qb_hist,
    }
    for name, a in arrs.items():
        np.save(os.path.join(run_dir, f"{name}.npy"), as_float64(a))


def save_json(run_dir: str, name: str, payload: Dict[str, Any]) -> None:
    with open(os.path.join(run_dir, name), "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, ensure_ascii=False, default=_json_default)


def _json_default(o):
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    if isinstance(o, (np.ndarray, np.generic)):
        return np.asarray(o).tolist()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def load_run(run_dir: str) -> Dict[str, np.ndarray]:
    out = {}
    for f in os.listdir(run_dir):
        if f.endswith(".npy"):
            out[f[:-4]] = np.load(os.path.join(run_dir, f))
    return out
