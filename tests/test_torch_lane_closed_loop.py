"""The whole slice: the port's paper lane closed loop against the JAX package's.

Both run the Dubins paper setup at B=3, N=6, H=3 in f64, three iterations per
solve and the alphas (1, 0.5, 0), from the same numbers: the port's setup is
carried across from the JAX setup's leaves with convert.setup_from_numpy, and the
disturbances are drawn once with numpy. The JAX side runs its Pallas kernels in
interpret mode; the port runs its plain versions on the CPU. Tolerances are the
JAX package's own (tests/test_lane_closed_loop.py:45-50).
"""
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

F64 = jnp.float64
B = 3
SETUP = dict(N=6, H=3, nominal_max_iter=3, aux_max_iter=3, alphas=(1.0, 0.5, 0.0))
# (rtol, atol) per field, as in tests/test_lane_closed_loop.py:45-50
TOL = {
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-8), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-8, 1e-11), "R_hist": (1e-8, 1e-11), "qb_hist": (1e-8, 1e-11),
}


def setup_as_numpy(s, *, beta=20.0, eps=1e-4):
    """A JAX DubinsPaperSetup as the plain numbers convert.setup_from_numpy takes."""
    c, a = s.cfg, s.cfg.adapt
    return dict(
        cfg=dict(N=c.N, H=c.H, nominal_max_iter=c.nominal_max_iter, aux_max_iter=c.aux_max_iter,
                 tol=c.tol, reg=c.reg, alphas=c.alphas,
                 adapt=dict(lr=a.lr, momentum=a.momentum, steps=a.steps,
                            grad_clip_norm=a.grad_clip_norm, project=a.project)),
        w_nominal={f: np.asarray(getattr(s.w_nominal, f)) for f in ("Q", "R", "Qf", "qb")},
        aux_init={f: np.asarray(getattr(s.aux_init, f)) for f in ("Q", "R", "qb")},
        bp={f: np.asarray(getattr(s.bp, f)) for f in ("alpha", "gamma", "tight")},
        x0=np.asarray(s.x0), target=np.asarray(s.target),
        centers=np.asarray(s.field.centers), radii=np.asarray(s.field.radii),
        beta=beta, eps=eps,
    )


@pytest.fixture(scope="module")
def logs():
    js = j_dubins_paper_setup(dtype=F64, **SETUP)
    rng = np.random.default_rng(0)
    w_seqs = rng.uniform(-0.05, 0.05, size=(B, SETUP["H"], 3))

    s = setup_from_numpy(setup_as_numpy(js), device="cpu", dtype=torch.float64)
    port = run_paper_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp,
        x0=s.x0, target=s.target, w_seqs=torch.as_tensor(w_seqs), eps=s.eps, device="cpu",
    )
    j_sys_c = j_dubins_components(
        dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
        centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=20.0,
    )
    ref = j_run_paper_closed_loop_lanes(
        js.system, js.aug, j_sys_c, js.cfg, w_nominal=js.w_nominal, aux_init=js.aux_init,
        bp=js.bp, x0=js.x0, target=js.target, w_seqs=jnp.asarray(w_seqs),
        eps=1e-4, block_b=128, interpret=True,
    )
    return port, ref


@pytest.mark.parametrize("field", ClosedLoopLog._fields)
def test_closed_loop_log_matches_jax(logs, field):
    port, ref = logs
    p, r = getattr(port, field), np.asarray(getattr(ref, field))
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64
    rtol, atol = TOL[field]
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


def test_closed_loop_adapts_and_stays_finite(logs):
    """The weights move from their initial values and every logged value is finite."""
    port, _ = logs
    for field in ClosedLoopLog._fields:
        assert bool(torch.isfinite(getattr(port, field)).all()), field
    assert not bool(torch.equal(port.Q_hist[:, -1], torch.ones_like(port.Q_hist[:, -1])))
