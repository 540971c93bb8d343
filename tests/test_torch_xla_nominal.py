"""The port's nominal-only receding horizon (tube/closed_loop.run_nominal_receding)
against the JAX package's vmapped one, in f64 on the CPU, N=8, H=6, at rtol 1e-7, atol
1e-9 (tests/test_nominal_receding.py:86-87), with the stops exactly: on dubins.yaml with
the runner's exact-min collision check, and on a single-obstacle config (the `single`
aggregation, which only this engine runs). Three lanes each: one starts near the goal
and reaches its success radius, one starts on the boundary of the obstacle at (4, 2)
(h = 0) and stops at once (collided), one runs all H steps. (A start deep inside an
obstacle makes b ~ 1e12 and costs ~1e24, whose candidates the line search tells apart
only by the summation order's rounding: no start for a comparison.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.systems.obstacles import h_min as j_h_min
from tube_mpc_tpu.tube.closed_loop import run_nominal_receding as j_run_nominal_receding

from tube_mpc_tpu_torch.convert import nominal_receding_state_from_numpy
from tube_mpc_tpu_torch.systems.obstacles import h_min
from tube_mpc_tpu_torch.tube.closed_loop import (
    make_nominal_receding_step,
    nominal_receding_init_state,
    run_nominal_receding,
)

from torch_xla_cases import built_pair, close, raw_of, t64

N, H = 8, 6
STARTS = np.array([[9.9, 9.75, 0.8], [5.0, 2.0, 0.0], [1.0, 0.5, 0.3]])


def _single():
    raw = raw_of("dubins", N, H)
    raw["environment"].pop("obstacles")
    raw["environment"]["obstacle"] = {"center": [4.0, 2.0], "radius": 1.0}
    return raw


CASES = {"dubins_min_check": lambda: raw_of("dubins", N, H), "single": _single}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    raw = CASES[request.param]()
    jb, pb = built_pair(raw, paper_mode=False)
    exact = request.param == "dubins_min_check"
    h_t = (lambda x: h_min(x, pb.field)) if exact else None
    h_j = (lambda x: j_h_min(x, jb.field)) if exact else None
    mine = run_nominal_receding(pb.system, pb.aug, pb.tube_cfg, w_nominal=pb.w_nominal,
                                bp=pb.bp, x0=t64(STARTS), target=pb.target, h_exact=h_t,
                                angle_dims=pb.system.angle_dims, device="cpu")
    ref = jax.jit(jax.vmap(lambda x0: j_run_nominal_receding(
        jb.system, jb.aug, jb.tube_cfg, w_nominal=jb.w_nominal, bp=jb.bp, x0=x0,
        target=jb.target, h_exact=h_j, angle_dims=jb.system.angle_dims)))(jnp.asarray(STARTS))
    return request.param, mine, ref, pb, h_t


def test_receding_matches_the_jax_loop(runs):
    case, mine, ref, pb, _ = runs
    assert pb.cfg.environment.obstacle_aggregation == ("single" if case == "single" else "smoothmin")
    for field in ("x", "u", "b"):
        close(getattr(mine, field), getattr(ref, field), 1e-7, 1e-9, f"{case} {field}")
    for field in ("ran", "success", "success_t", "collided"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(), np.asarray(getattr(ref, field)),
                                      err_msg=field)
    # the three exits: success within H, collision at once, a run to the end
    assert mine.success.tolist() == [True, False, False]
    assert mine.collided.tolist() == [False, True, False]
    assert int(mine.success_t[0]) < H and mine.ran[1].tolist() == [True] + [False] * (H - 1)
    assert bool(mine.ran[2].all())


def test_a_carried_state_steps_as_the_loop(runs):
    """One step from a receding state carried across from numpy is the loop's next step."""
    _, mine, _, pb, h_t = runs
    step = make_nominal_receding_step(pb.system, pb.aug, pb.tube_cfg, w_nominal=pb.w_nominal,
                                      bp=pb.bp, target=pb.target, h_exact=h_t,
                                      angle_dims=pb.system.angle_dims)
    state, _ = step(nominal_receding_init_state(pb.aug, pb.tube_cfg, bp=pb.bp, x0=t64(STARTS)))
    carried = nominal_receding_state_from_numpy(
        {k: v.numpy() for k, v in state._asdict().items()}, device="cpu", dtype=torch.float64)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(carried, state))
    _, (x, u, b, ran) = step(carried)
    for got, field in ((x, "x"), (u, "u"), (b, "b"), (ran, "ran")):
        assert torch.equal(got, getattr(mine, field)[:, 1]), field
