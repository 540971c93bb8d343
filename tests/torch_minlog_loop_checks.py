"""The port's lane closed loops on a configuration with the exact-min aggregation or the
log barrier (tests/torch_minlog_cases.py) against the JAX package's, at B=3, N=6, H=3 in
f64: the tests of tests/test_torch_minlog_loop_<case>.py, each of which names its case,
its loop and its changes to the config with the fixtures ``minlog``, ``kind`` ("paper" or
"coupled") and ``changes`` ({"section.key": value}).

Both packages build the same YAML (paper mode, or adaptation.adapt_nominal: true for the
coupled chain with its runner's raw θ̄, θ), and the disturbances are drawn once with numpy
within the config's bounds. The JAX side runs its Pallas kernels in interpret mode; the
port runs its plain versions on the CPU. Tolerances are the JAX package's own
(tests/test_lane_closed_loop.py:45-50, tests/test_lane_generic.py:88-95, 219-225).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.tube.lane_closed_loop import (
    run_generic_closed_loop_lanes as j_run_generic_closed_loop_lanes,
)
from tube_mpc_tpu.tube.lane_closed_loop import (
    run_paper_closed_loop_lanes as j_run_paper_closed_loop_lanes,
)
from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta
from tube_mpc_tpu.utils.config import build_experiment as j_build_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config

from tube_mpc_tpu_torch.presets import config_coupled_setup, config_setup
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import (
    run_generic_closed_loop_lanes,
    run_paper_closed_loop_lanes,
)
from tube_mpc_tpu_torch.utils.config import parse_config

from torch_family_generic_checks import RAW_TOL
from torch_family_generic_checks import TOL as COUPLED_TOL
from torch_family_loop_checks import TOL as PAPER_TOL
from torch_minlog_cases import jax_components, raw_of

B, N, H = 3, 6, 3


def jax_raws(ycfg):
    """The JAX runner's raw θ̄, θ of a config (tube_mpc_tpu/runners.py:283-300)."""
    j = lambda v: jnp.asarray(v, dtype=jnp.float64)
    cn, ca, db = ycfg.cost_nominal, ycfg.cost_auxiliary, ycfg.dbas
    raw_nom = JRawNominalTheta(
        Q_raw=j(list(cn.Q)), R_raw=j(list(cn.R)), Qf_raw=j(list(cn.Qf or cn.Q)), qb_raw=j(cn.q_b),
        alpha_raw=j(db.alpha), gamma_raw=j(db.gamma), tight_raw=j(db.nominal_tightening))
    raw_aux = JRawAuxTheta(
        Q_raw=j(list(ca.Q or cn.Q)), R_raw=j(list(ca.R or cn.R)),
        Qf_raw=j(list(ca.Qf or ca.Q or cn.Q)), qb_raw=j(ca.q_b), alpha_raw=j(db.alpha),
        gamma_raw=j(db.gamma))
    return raw_nom, raw_aux


@pytest.fixture(scope="module")
def loops(minlog, kind, changes):
    """(port log, JAX log, port final raws or None, JAX final raws or None, port
    setup, JAX TubeMPCConfig)."""
    raw = raw_of(minlog, **changes,
                 **({"adaptation.adapt_nominal": True} if kind == "coupled" else {}))
    ycfg = dataclasses.replace(j_parse_config(raw), use_float64=True)
    built = j_build_experiment(ycfg, paper_mode=kind == "paper")
    cfg = dataclasses.replace(built.tube_cfg, N=N, H=H)
    j_sys_c = jax_components(minlog)
    bt, eps = ycfg.dbas.barrier_type, ycfg.dbas.eps
    w_low = np.asarray(ycfg.system.disturbance["w_low"])
    w_high = np.asarray(ycfg.system.disturbance["w_high"])
    w_seqs = np.random.default_rng(3).uniform(w_low, w_high, size=(B, H, len(w_low)))
    jkw = dict(x0=built.x0, target=built.target, w_seqs=jnp.asarray(w_seqs), eps=eps,
               barrier_type=bt, block_b=128, interpret=True)
    if kind == "paper":
        s = config_setup(parse_config(raw), N=N, H=H, device="cpu", dtype=torch.float64)
        port = run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target, w_seqs=torch.as_tensor(w_seqs), eps=s.eps,
            barrier_type=s.barrier_type, device="cpu")
        ref = j_run_paper_closed_loop_lanes(
            built.system, built.aug, j_sys_c, cfg, w_nominal=built.w_nominal,
            aux_init=built.aux_init, bp=built.bp, **jkw)
        return port, ref, None, None, s, cfg
    s, raw_nom, raw_aux = config_coupled_setup(parse_config(raw), N=N, H=H, device="cpu",
                                               dtype=torch.float64)
    port, port_raws = run_generic_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, raw_nom=raw_nom, raw_aux_init=raw_aux, x0=s.x0,
        target=s.target, w_seqs=torch.as_tensor(w_seqs), eps=s.eps, barrier_type=s.barrier_type,
        device="cpu")
    j_raw_nom, j_raw_aux = jax_raws(ycfg)
    ref, ref_raws = j_run_generic_closed_loop_lanes(
        built.system, built.aug, j_sys_c, cfg, raw_nom=j_raw_nom,
        raw_aux_init=j_raw_aux, **jkw)
    return port, ref, port_raws, ref_raws, s, cfg


def test_setup_matches_build_experiment(loops):
    """The port's setup of the config is the JAX package's: its TubeMPCConfig."""
    s, cfg = loops[4], loops[5]
    assert dataclasses.asdict(s.cfg) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("field", ClosedLoopLog._fields)
def test_loop_matches_jax(loops, kind, field):
    port, ref = loops[0], loops[1]
    p, r = getattr(port, field), np.asarray(getattr(ref, field))
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64
    rtol, atol = (PAPER_TOL if kind == "paper" else COUPLED_TOL)[field]
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("tree", ["raw_aux", "raw_nom"])
def test_final_raws_match_jax(loops, kind, tree):
    """The coupled loop's final raw θ, θ̄ (the paper loop has none: it checks its adapted
    weights' histories above)."""
    if kind == "paper":
        assert loops[2] is None and loops[3] is None
        return
    i = ["raw_aux", "raw_nom"].index(tree)
    for name, v in loops[2][i]._asdict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(loops[3][i], name)),
                                   rtol=RAW_TOL[0], atol=RAW_TOL[1], err_msg=name)


def test_loop_adapts_and_stays_finite(loops):
    """Every logged value is finite and the ancillary weights move."""
    port = loops[0]
    for field in ClosedLoopLog._fields:
        assert bool(torch.isfinite(getattr(port, field)).all()), field
    assert not bool(torch.equal(port.Q_hist[:, -1], port.Q_hist[:, 0])) or not bool(
        torch.equal(port.R_hist[:, -1], port.R_hist[:, 0]))
