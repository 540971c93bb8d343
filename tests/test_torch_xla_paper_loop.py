"""The port's feature-major paper closed loop (tube/closed_loop.py) against the JAX
package's vmapped run_paper_closed_loop, in f64 on the CPU, B=3, N=8, H=4, on
configs/dubins.yaml (its gradient clip on, so each lane's own clip runs) and on the same
config with the exact-min aggregation, from a start half a unit off the bisector of the
first two obstacles (at the shipped start the nominal plan runs along it, where the
min's derivative turns on one ulp of h_i and the reference's own jit rounding decides:
tests/test_torch_minlog_loop_dubins.py). Tolerances: rtol 1e-6 on the states and controls,
1e-5 on the loss and the weight histories, atol 1e-8 (tests/test_closed_loop.py:139-143).

Also: one step from a JAX loop state carried across (convert.paper_state_from_numpy);
make_paper_closed_loop_diff's hypergradient ∂loss[-1]/∂(w_nominal, x0) against jax.grad
through the JAX one (rtol 1e-7, atol 1e-10, as the sensitivity's); and the port's XLA
paper loop against the port's lane paper loop on the same draw, at
tests/test_lane_closed_loop.py:45-50's tolerances (the two engines are equivalent, not
bitwise: the XLA Riccati carries a scaled V).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.tube.closed_loop import make_paper_closed_loop_diff as j_make_diff
from tube_mpc_tpu.tube.closed_loop import make_paper_step as j_make_paper_step
from tube_mpc_tpu.tube.closed_loop import paper_init_state as j_paper_init_state
from tube_mpc_tpu.tube.closed_loop import run_paper_closed_loop as j_run_paper_closed_loop

from tube_mpc_tpu_torch.convert import paper_state_from_numpy
from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.presets import dubins_paper_setup
from tube_mpc_tpu_torch.tube.closed_loop import (
    ClosedLoopLog,
    make_paper_closed_loop_diff,
    make_paper_step,
    run_paper_closed_loop,
)
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

from torch_xla_cases import built_pair, close, disturbances, raw_of, t64

B, N, H = 3, 8, 4
STATE_TOL = (1e-6, 1e-8)
HIST_TOL = (1e-5, 1e-8)
CASES = {"smoothmin": {},
         "min_off_bisector": {"environment.obstacle_aggregation": "min",
                              "system.x0": [0.0, 0.5, 0.7853981633974483]}}


def run_both(raw, w):
    jb, pb = built_pair(raw, paper_mode=True)
    mine = run_paper_closed_loop(pb.system, pb.aug, pb.tube_cfg, w_nominal=pb.w_nominal,
                                 aux_init=pb.aux_init, bp=pb.bp, x0=pb.x0, target=pb.target,
                                 w_seq=t64(w), device="cpu")
    ref = jax.jit(jax.vmap(lambda ws: j_run_paper_closed_loop(
        jb.system, jb.aug, jb.tube_cfg, w_nominal=jb.w_nominal, aux_init=jb.aux_init,
        bp=jb.bp, x0=jb.x0, target=jb.target, w_seq=ws)))(jnp.asarray(w))
    return mine, ref, jb, pb


@pytest.fixture(scope="module", params=list(CASES))
def loops(request):
    raw = raw_of("dubins", N, H, **CASES[request.param])
    return (request.param,) + run_both(raw, disturbances(raw, B, H, seed=3))


def test_paper_loop_matches_the_jax_loop(loops):
    case, mine, ref, _, _ = loops
    assert isinstance(mine, ClosedLoopLog) and mine.x_real.shape == (B, H, 3)
    for field in ClosedLoopLog._fields:
        rtol, atol = HIST_TOL if field in ("loss", "Q_hist", "R_hist", "qb_hist") else STATE_TOL
        close(getattr(mine, field), getattr(ref, field), rtol, atol, f"{case} {field}")
    assert np.all(np.isfinite(mine.loss.numpy()))
    # the adaptation moved every lane's weights, each by its own clipped step
    assert not torch.equal(mine.Q_hist[0, -1], mine.Q_hist[1, -1])


def test_one_step_from_a_jax_state(loops):
    """make_paper_step from a JAX state after one step, carried across per lane."""
    case, _, _, jb, pb = loops
    raw = raw_of("dubins", N, H, **CASES[case])
    w = disturbances(raw, B, 2, seed=4)
    jstep = j_make_paper_step(jb.system, jb.aug, jb.tube_cfg, w_nominal=jb.w_nominal,
                              bp=jb.bp, target=jb.target)
    init = j_paper_init_state(jb.system, jb.aug, jb.tube_cfg, aux_init=jb.aux_init, bp=jb.bp,
                              x0=jb.x0)
    one = jax.jit(jax.vmap(jstep))
    s1, _ = one(jax.tree.map(lambda v: jnp.broadcast_to(v, (B,) + v.shape), init),
                jnp.asarray(w[:, 0]))
    _, logs = one(s1, jnp.asarray(w[:, 1]))
    state = paper_state_from_numpy(jax.tree.map(np.asarray, s1), device="cpu",
                                   dtype=torch.float64)
    step = make_paper_step(pb.system, pb.aug, pb.tube_cfg, w_nominal=pb.w_nominal, bp=pb.bp,
                           target=pb.target)
    _, log = step(state, t64(w[:, 1]))
    for got, want, name in zip(log, logs, ClosedLoopLog._fields):
        rtol, atol = HIST_TOL if name in ("loss", "Q_hist", "R_hist", "qb_hist") else STATE_TOL
        close(got, want, rtol, atol, name)


def test_hypergradient_matches_jax_grad():
    """∂loss[-1]/∂(w_nominal, x0) through every solve, sensitivity sweep, momentum update
    and shift of a two-step loop (exact Hessians in the outer solves' backward)."""
    Nh, Hh = 6, 2
    kw = dict(N=Nh, H=Hh, nominal_max_iter=4, aux_max_iter=4, alphas=(1.0, 0.5, 0.1, 0.0))
    js = j_dubins_paper_setup(dtype=jnp.float64, **kw)
    ps = dubins_paper_setup(device="cpu", dtype=torch.float64, **kw)
    w = np.random.default_rng(5).uniform(-0.05, 0.05, size=(Hh, 3))
    jloop = j_make_diff(js.system, js.aug, js.cfg, bp=js.bp, target=js.target)
    jg = jax.jit(jax.grad(lambda wn, x0: jloop(wn, js.aux_init, x0, jnp.asarray(w)).loss[-1],
                          argnums=(0, 1)))(js.w_nominal, js.x0)
    loop = make_paper_closed_loop_diff(ps.system, ps.aug, ps.cfg, bp=ps.bp, target=ps.target)
    wn = CostWeights(*(v.clone().requires_grad_() for v in ps.w_nominal))
    x0 = ps.x0.clone().requires_grad_()
    log = loop(wn, ps.aux_init, x0, t64(w))
    grads = torch.autograd.grad(log.loss[0, -1], list(wn) + [x0])
    for got, want, name in zip(grads, list(jg[0]) + [jg[1]], ("Q", "R", "Qf", "qb", "x0")):
        close(got, want, 1e-7, 1e-10, name)
    assert float(torch.abs(grads[0]).max()) > 0.0 and float(torch.abs(grads[-1]).max()) > 0.0
    # forward: the same loop as run_paper_closed_loop
    plain = run_paper_closed_loop(ps.system, ps.aug, ps.cfg, w_nominal=ps.w_nominal,
                                  aux_init=ps.aux_init, bp=ps.bp, x0=ps.x0, target=ps.target,
                                  w_seq=t64(w), device="cpu")
    for got, want in zip(log, plain):
        close(got, want.numpy(), 1e-12, 1e-14)


def test_xla_paper_loop_matches_the_lane_paper_loop():
    """The port's two engines on one draw: tests/test_lane_closed_loop.py's setup and
    tolerances (1e-7/1e-8 on states, controls and loss; 1e-8/1e-11 on the weights)."""
    s = dubins_paper_setup(N=N, H=5, device="cpu", dtype=torch.float64, nominal_max_iter=4,
                           aux_max_iter=4, alphas=(1.0, 0.5, 0.1, 0.0))
    w = t64(np.random.default_rng(6).uniform(-0.05, 0.05, size=(B, 5, 3)))
    lane = run_paper_closed_loop_lanes(s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal,
                                       aux_init=s.aux_init, bp=s.bp, x0=s.x0, target=s.target,
                                       w_seqs=w, eps=s.eps, device="cpu")
    xla = run_paper_closed_loop(s.system, s.aug, s.cfg, w_nominal=s.w_nominal,
                                aux_init=s.aux_init, bp=s.bp, x0=s.x0, target=s.target,
                                w_seq=w, device="cpu")
    for field in ("u_real", "x_real", "loss"):
        close(getattr(xla, field), getattr(lane, field).numpy(), 1e-7, 1e-8, field)
    for field in ("Q_hist", "R_hist", "qb_hist"):
        close(getattr(xla, field), getattr(lane, field).numpy(), 1e-8, 1e-11, field)
