"""The generic and coupled lane closed loops of the port and of the JAX package on
the same numbers: the shared body of tests/test_torch_lane_generic_*.py, one
case per file (each JAX reference run takes tens of seconds in interpret mode).

The setup is tests/test_lane_generic.py:27-62 at B=2, N=6, H=3 in f64: the Dubins
paper setup, x0 near an obstacle (so the barrier's quadratic branch runs and the
α/γ terms are non-zero), per-lane raw parameters from the same numbers, and
disturbances drawn once with numpy. The JAX side runs its Pallas kernels in
interpret mode; the port runs its plain versions on the CPU. Tolerances are those
of tests/test_lane_generic.py:88-95, 219-225.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.presets import PAPER_OBSTACLES
from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.tube.closed_loop import TubeMPCConfig as JTubeMPCConfig
from tube_mpc_tpu.tube.lane_closed_loop import (
    run_generic_closed_loop_lanes as j_run_generic_closed_loop_lanes,
)
from tube_mpc_tpu.tube.params import AdaptConfig as JAdaptConfig
from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta

from tube_mpc_tpu_torch.convert import raw_aux_from_numpy, raw_nom_from_numpy, setup_from_numpy
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_generic_closed_loop_lanes

from test_torch_lane_closed_loop import setup_as_numpy

F64 = jnp.float64
B, N, H = 2, 6, 3
EPS = 1e-4
RAW_NOM = dict(Q_raw=[1.0, 1.0, 0.0], R_raw=[1.0, 1.0], Qf_raw=[100.0] * 3, qb_raw=1.0,
               alpha_raw=0.01, gamma_raw=0.1, tight_raw=0.02)
RAW_AUX = dict(Q_raw=[1.0, 1.0, 0.5], R_raw=[1.0, 1.0], Qf_raw=[2.0, 2.0, 1.0], qb_raw=1.0,
               alpha_raw=0.5, gamma_raw=0.2)
X0 = [3.2, 1.0, np.pi / 4]   # h(x0) = 0.64 < alpha: the barrier's quadratic branch

CASES = {  # name: (adapt.steps, adapt_nominal, coupling, seed of the disturbances)
    "generic_steps2": (2, False, "reference", 4),
    "coupled": (1, True, "reference", 2),
    "coupled_full": (1, True, "full", 3),
}

# (rtol, atol) per field, tests/test_lane_generic.py:88-95, 219-225
TOL = {
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-7), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-7, 1e-10), "R_hist": (1e-7, 1e-10), "qb_hist": (1e-7, 1e-10),
}
RAW_TOL = (1e-7, 1e-10)
FIELDS = list(ClosedLoopLog._fields) + [f"raw_aux.{f}" for f in RAW_AUX] + [
    f"raw_nom.{f}" for f in RAW_NOM]


def run_case(name):
    """(port log, (port raw_aux, raw_nom), JAX log, (JAX raw_aux, raw_nom), initial raws)."""
    steps, adapt_nominal, coupling, seed = CASES[name]
    js = j_dubins_paper_setup(N=N, H=H, dtype=F64)
    j_cfg = JTubeMPCConfig(
        N=N, H=H, nominal_max_iter=3, aux_max_iter=3, tol=1e-6, reg=1e-6,
        alphas=(1.0, 0.5, 0.1, 0.0),
        adapt=JAdaptConfig(lr=5e-2, momentum=0.9, steps=steps, project=True),
        adapt_nominal=adapt_nominal, adapt_ancillary=True, coupling=coupling,
    )
    js = dataclasses.replace(js, cfg=j_cfg)
    d = setup_as_numpy(js, eps=EPS)
    d["cfg"].update(adapt_nominal=adapt_nominal, adapt_ancillary=True, coupling=coupling)
    w_seqs = np.random.default_rng(seed).uniform(-0.05, 0.05, size=(B, H, 3))

    s = setup_from_numpy(d, device="cpu", dtype=torch.float64)
    assert s.cfg.adapt.steps == steps and s.cfg.adapt_nominal == adapt_nominal
    assert s.cfg.coupling == coupling
    port, port_raws = run_generic_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg,
        raw_nom=raw_nom_from_numpy(RAW_NOM, device="cpu", dtype=torch.float64),
        raw_aux_init=raw_aux_from_numpy(RAW_AUX, device="cpu", dtype=torch.float64),
        x0=torch.as_tensor(X0, dtype=torch.float64), target=s.target,
        w_seqs=torch.as_tensor(w_seqs), eps=EPS, device="cpu",
    )
    j_sys_c = j_dubins_components(
        dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
        centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=20.0,
    )
    j = lambda v: jnp.asarray(v, dtype=F64)
    ref, ref_raws = j_run_generic_closed_loop_lanes(
        js.system, js.aug, j_sys_c, js.cfg,
        raw_nom=JRawNominalTheta(**{k: j(v) for k, v in RAW_NOM.items()}),
        raw_aux_init=JRawAuxTheta(**{k: j(v) for k, v in RAW_AUX.items()}),
        x0=j(X0), target=js.target, w_seqs=j(w_seqs), eps=EPS, block_b=128, interpret=True,
    )
    return port, port_raws, ref, ref_raws


def field_values(run, field):
    """(port tensor, JAX numpy array, tolerance) of a log field or a final raw leaf."""
    port, port_raws, ref, ref_raws = run
    if field in TOL:
        return getattr(port, field), np.asarray(getattr(ref, field)), TOL[field]
    tree, leaf = field.split(".")
    i = 0 if tree == "raw_aux" else 1
    return getattr(port_raws[i], leaf), np.asarray(getattr(ref_raws[i], leaf)), RAW_TOL


def check_field(run, field):
    p, r, (rtol, atol) = field_values(run, field)
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64, (tuple(p.shape), r.shape)
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


def moved(run, field):
    """Whether a final raw leaf moved from its initial value on some lane."""
    tree, leaf = field.split(".")
    init = (RAW_AUX if tree == "raw_aux" else RAW_NOM)[leaf]
    p, _, _ = field_values(run, field)
    return bool((p - torch.as_tensor(init, dtype=p.dtype)).abs().max() > 0)
