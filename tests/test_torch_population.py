"""Population mode of the port's paper lane closed loop (one θ shared by the lanes, its
gradient the mean of the lanes' finite gradients) against the JAX package's
run_paper_closed_loop_lanes(population=True).

Both run the Dubins paper setup at B=4, N=6, H=3 in f64, three iterations per solve and
the alphas (1, 0.5, 0), from the same numbers (convert.setup_from_numpy) and the same
disturbances, drawn once with numpy: the JAX side with its Pallas kernels in interpret
mode, the port with their plain versions on the CPU. Tolerances are
tests/test_torch_lane_closed_loop.py's TOL (the JAX package's own,
tests/test_lane_closed_loop.py:45-50). Also: a lane started at NaN is left out of the mean
(the θ history equals, at rtol 1e-12, that of the run without the lane), and a population
checkpoint resumes bitwise and is refused by an independent run, and the other way round.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.presets import PAPER_OBSTACLES
from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.tube.lane_closed_loop import (
    run_paper_closed_loop_lanes as j_run_paper_closed_loop_lanes,
)

from tube_mpc_tpu_torch.convert import setup_from_numpy
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

from test_torch_lane_closed_loop import SETUP, TOL, setup_as_numpy

F64 = jnp.float64
B = 4
DEAD = 2   # the lane started at NaN
THETA = ("Q_hist", "R_hist", "qb_hist")


@pytest.fixture(scope="module")
def case():
    js = j_dubins_paper_setup(dtype=F64, **SETUP)
    s = setup_from_numpy(setup_as_numpy(js), device="cpu", dtype=torch.float64)
    w = np.random.default_rng(4).uniform(-0.05, 0.05, size=(B, SETUP["H"], 3))
    x0 = np.tile(np.asarray(js.x0), (B, 1))
    x0_dead = x0.copy()
    x0_dead[DEAD] = np.nan
    j_sys_c = j_dubins_components(
        dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
        centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=20.0,
    )

    # jitted once: the run with the NaN lane takes the compiled loop of the first
    jax_run = jax.jit(lambda x0_: j_run_paper_closed_loop_lanes(
        js.system, js.aug, j_sys_c, js.cfg, w_nominal=js.w_nominal, aux_init=js.aux_init,
        bp=js.bp, x0=x0_, target=js.target, w_seqs=jnp.asarray(w), eps=1e-4,
        block_b=128, interpret=True, population=True))

    def port_run(x0_, w_=w, **kw):
        kw.setdefault("population", True)
        return run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=torch.as_tensor(x0_), target=s.target, w_seqs=torch.as_tensor(w_),
            eps=s.eps, device="cpu", **kw)

    return dict(s=s, w=w, x0=x0, x0_dead=x0_dead, port_run=port_run,
                port=port_run(x0), ref=jax_run(x0),
                port_dead=port_run(x0_dead), ref_dead=jax_run(x0_dead))


@pytest.mark.parametrize("field", ClosedLoopLog._fields)
def test_population_log_matches_jax(case, field):
    p, r = getattr(case["port"], field), np.asarray(getattr(case["ref"], field))
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64
    rtol, atol = TOL[field]
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


def test_population_theta_is_shared_and_moves(case):
    port = case["port"]
    for field in THETA:
        h = getattr(port, field)
        assert torch.equal(h, h[:1].expand_as(h)), field
    assert bool(torch.isfinite(port.loss).all())
    assert not torch.equal(port.Q_hist[0, -1], case["s"].aux_init.Q)


def test_a_nan_lane_is_left_out_of_the_mean(case):
    """θ from the run with a lane started at NaN equals θ from the run without that lane
    (rtol 1e-12: the sums differ only in order), and the JAX run with the same NaN lane."""
    keep = [i for i in range(B) if i != DEAD]
    dead = case["port_dead"]
    assert bool(torch.isnan(dead.loss[DEAD]).all())
    without = case["port_run"](case["x0"][keep], case["w"][keep])
    for field in THETA:
        got = getattr(dead, field)
        assert bool(torch.isfinite(got).all()), field
        np.testing.assert_allclose(got[0].numpy(), getattr(without, field)[0].numpy(),
                                   rtol=1e-12, atol=0.0, err_msg=field)
        rtol, atol = TOL[field]
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(case["ref_dead"], field)),
                                   rtol=rtol, atol=atol, err_msg=field)
    # the healthy lanes' own fields, against the JAX run
    for field in ("x_real", "u_real", "loss"):
        rtol, atol = TOL[field]
        np.testing.assert_allclose(getattr(dead, field)[keep].numpy(),
                                   np.asarray(getattr(case["ref_dead"], field))[keep],
                                   rtol=rtol, atol=atol, err_msg=field)


@pytest.mark.parametrize("population", [True, False])
def test_checkpoint_resumes_bitwise_and_refuses_the_other_mode(case, tmp_path, population):
    run = case["port_run"]
    mono = case["port"] if population else run(case["x0"], population=False)
    ck = str(tmp_path / "ck")
    full = run(case["x0"], population=population, ckpt_dir=ck, segment_len=2)
    os.remove(os.path.join(ck, "state_3.npz"))
    os.remove(os.path.join(ck, "logs_3.npz"))
    resumed = run(case["x0"], population=population, ckpt_dir=ck, segment_len=2)
    for field in ClosedLoopLog._fields:
        assert torch.equal(getattr(full, field), getattr(mono, field)), field
        assert torch.equal(getattr(resumed, field), getattr(mono, field)), field
    with pytest.raises(ValueError, match="different run"):
        run(case["x0"], population=not population, ckpt_dir=ck, segment_len=2)
