"""The port's parallel/scenarios.py on one device against the JAX package's, on
tests/test_parallel.py's setup in f64 on the CPU (tests/torch_scenario_cases.py): the
independent sweep (vmap_paper_closed_loop), the tube verification on both engines (the
lane engine's Pallas kernels in interpret mode on the JAX side, the plain versions on the
port's) and the population Algorithm 2 (run_population_adaptation, mesh=None), with and
without a poisoned scenario (tests/test_parallel.py:109-133). Disturbances: the JAX
package's per-key draws, passed to the port as w_seqs. Tolerances: the XLA paper loop's
(tests/test_torch_xla_paper_loop.py:43-44, from tests/test_closed_loop.py:139-143).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tube_mpc_tpu.tube.lane_closed_loop as j_lane_closed_loop
from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.parallel.scenarios import run_population_adaptation as j_run_population
from tube_mpc_tpu.parallel.scenarios import tube_verification as j_tube_verification
from tube_mpc_tpu.parallel.scenarios import vmap_paper_closed_loop as j_vmap_paper_closed_loop
from tube_mpc_tpu.systems.obstacles import CircleField as JCircleField
from tube_mpc_tpu.systems.obstacles import h_min as j_h_min

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.parallel import (
    TubeStats,
    run_population_adaptation,
    tube_verification,
    vmap_paper_closed_loop,
)
from tube_mpc_tpu_torch.parallel.scenarios import PopulationLog
from tube_mpc_tpu_torch.systems.obstacles import h_min
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog

from torch_scenario_cases import F64, W_AUX, draws, jax_setup, port_setup
from torch_xla_cases import close, t64

STATE_TOL = (1e-6, 1e-8)
HIST_TOL = (1e-5, 1e-8)
HIST = ("loss", "Q_hist", "R_hist", "qb_hist")


def field_tol(field):
    return HIST_TOL if field in HIST else STATE_TOL


@pytest.fixture(scope="module")
def setups():
    return jax_setup(), port_setup()


def test_vmap_paper_closed_loop_matches_jax(setups):
    (system, aug, cfg, kw, x0, aux, _), s = setups
    keys, w = draws(system, 0, 4, cfg.H)
    ref = j_vmap_paper_closed_loop(system, aug, cfg, aux_init=aux, x0=x0, keys=keys, **kw)
    mine = vmap_paper_closed_loop(s.system, s.aug, s.cfg, w_nominal=s.w_nominal,
                                  aux_init=s.aux_init, bp=s.bp, x0=s.x0, target=s.target,
                                  w_seqs=t64(w), device="cpu")
    assert isinstance(mine, ClosedLoopLog) and tuple(mine.x_real.shape) == (4, cfg.H, 3)
    for field in ClosedLoopLog._fields:
        close(getattr(mine, field), getattr(ref, field), *field_tol(field), field)
    # different disturbances: each scenario adapted its own weights
    assert not torch.equal(mine.Q_hist[0, -1], mine.Q_hist[1, -1])


@pytest.mark.parametrize("engine", ["xla", "lanes"])
def test_tube_verification_matches_jax(setups, engine, monkeypatch):
    (system, aug, cfg, kw, x0, _, j_sys_c), s = setups
    B = 4
    keys, w = draws(system, 1, B, cfg.H)
    if engine == "lanes":   # the JAX lane loop's kernels in interpret mode on the CPU
        monkeypatch.setattr(j_lane_closed_loop, "run_paper_closed_loop_lanes", functools.partial(
            j_lane_closed_loop.run_paper_closed_loop_lanes, block_b=128, interpret=True))
    j_w_aux = JCostWeights.create(W_AUX["Q"], W_AUX["R"], W_AUX["Qf"], W_AUX["qb"], dtype=F64)
    field, j_field = s.field, JCircleField(centers=jnp.asarray(s.field.centers.numpy()),
                                           radii=jnp.asarray(s.field.radii.numpy()))
    ref_logs, ref = j_tube_verification(
        system, aug, cfg, w_aux=j_w_aux, x0=x0, keys=keys, h_exact=lambda x: j_h_min(x, j_field),
        sys_c=j_sys_c if engine == "lanes" else None, **kw)
    w_aux = CostWeights(*(t64(W_AUX[f]) for f in CostWeights._fields))
    logs, stats = tube_verification(
        s.system, s.aug, s.cfg, w_nominal=s.w_nominal, w_aux=w_aux, bp=s.bp, x0=s.x0,
        target=s.target, w_seqs=t64(w), h_exact=lambda x: h_min(x, field),
        sys_c=s.sys_c if engine == "lanes" else None, eps=s.eps, device="cpu")
    assert isinstance(stats, TubeStats) and tuple(stats.deviations.shape) == (B, cfg.H)
    for name in TubeStats._fields:
        close(getattr(stats, name), getattr(ref, name), *STATE_TOL, name)
    for name in ClosedLoopLog._fields:
        close(getattr(logs, name), getattr(ref_logs, name), *field_tol(name), name)
    # the weights stay fixed: no adaptation with lr = 0
    assert torch.equal(logs.Q_hist[:, 0], logs.Q_hist[:, -1])
    assert torch.equal(logs.Q_hist[:, -1], w_aux.Q.expand(B, 3))
    assert float(stats.min_safety) > 0.0 and float(stats.collision_rate) == 0.0


B_POP, POISONED = 8, 3


@pytest.fixture(scope="module")
def population(setups):
    """The JAX and the port's population runs at B=8 from one draw: all scenarios healthy,
    and scenario POISONED started at NaN; the JAX runs share one compiled loop."""
    (system, aug, cfg, kw, x0, aux, _), s = setups
    w = np.asarray(system.sample_disturbance(jax.random.PRNGKey(2), (B_POP, cfg.H), dtype=F64))
    x0_b = np.tile(np.asarray(x0), (B_POP, 1))
    x0_poisoned = x0_b.copy()
    x0_poisoned[POISONED] = np.nan
    j_run = jax.jit(lambda x, ws: j_run_population(system, aug, cfg, aux_init=aux, x0_batch=x,
                                                    w_seqs=ws, mesh=None, **kw))

    def port(x, ws):
        return run_population_adaptation(s.system, s.aug, s.cfg, w_nominal=s.w_nominal,
                                         aux_init=s.aux_init, bp=s.bp, x0_batch=t64(x),
                                         target=s.target, w_seqs=t64(ws), device="cpu")

    return dict(w=w, x0=x0_b, x0_poisoned=x0_poisoned, port=port, aux=s.aux_init,
                mine=port(x0_b, w), ref=j_run(jnp.asarray(x0_b), jnp.asarray(w)),
                mine_poisoned=port(x0_poisoned, w),
                ref_poisoned=j_run(jnp.asarray(x0_poisoned), jnp.asarray(w)))


@pytest.mark.parametrize("case", ["healthy", "poisoned"])
def test_population_adaptation_matches_jax(population, case):
    sfx = "" if case == "healthy" else "_poisoned"
    (log, final), (ref_log, ref_final) = population["mine" + sfx], population["ref" + sfx]
    assert isinstance(log, PopulationLog) and tuple(log.Q_hist.shape) == (4, 3)
    for name in PopulationLog._fields:
        close(getattr(log, name), getattr(ref_log, name), *HIST_TOL, name)
    for name in ("Q", "R", "qb"):
        close(getattr(final, name), getattr(ref_final, name), *HIST_TOL, name)
    # the shared θ adapted (tiny lr·H, so any drift counts)
    assert float((final.Q - population["aux"].Q).abs().max()) > 0


def test_population_masks_a_poisoned_scenario(population):
    """One scenario started at NaN is left out of the shared update: the log is finite,
    finite_frac is 7/8, and θ and the loss equal the run without that scenario."""
    log, final = population["mine_poisoned"]
    assert bool(torch.isfinite(log.loss_mean).all()) and bool(torch.isfinite(final.Q).all())
    np.testing.assert_allclose(log.finite_frac.numpy(), (B_POP - 1) / B_POP)
    keep = [i for i in range(B_POP) if i != POISONED]
    log_ref, final_ref = population["port"](population["x0"][keep], population["w"][keep])
    np.testing.assert_allclose(final.Q.numpy(), final_ref.Q.numpy(), rtol=1e-12)
    np.testing.assert_allclose(log.loss_mean.numpy(), log_ref.loss_mean.numpy(), rtol=1e-12)
    for name in ("Q_hist", "R_hist", "qb_hist"):
        np.testing.assert_allclose(getattr(log, name).numpy(), getattr(log_ref, name).numpy(),
                                   rtol=1e-12, err_msg=name)
