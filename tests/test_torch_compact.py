"""The lane solver's iteration telemetry and straggler compaction in the port
(tube_mpc_tpu_torch/ops/cuda/lane_solver.py::lane_ilqr_solve), on the CPU.

- with_lane_iters equals the JAX package's exactly, and its maximum the JAX with_iters,
  on the problem of tests/test_lane_solver.py:135 (B=5, N=9; the JAX kernels in
  interpret mode), f64.
- compact_caps is bitwise equal to compact_caps=() on the problem of
  tests/test_lane_solver.py:173 (B=136, N=9), in f32 and f64, with caps (1,) (after one
  iteration no lane is converged: the full-width branch), (median,) and (1, median) (the
  compacted branch); lane_ilqr_solve.stages says which branch each ran.
- A lane whose x̂0 is not finite (b0 = inf): NaN in both packages, the other lanes within
  the solver's rtol 1e-12 of the JAX solve (tests/test_lane_solver.py:113-119), and the
  compacted solve bitwise equal to the uncompacted one.
The inputs come from numpy generators with fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.dbas import make_augmented as j_make_augmented
from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.systems.dubins import DubinsConfig, make_dubins
from tube_mpc_tpu.systems.obstacles import CircleField
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem
from tube_mpc_tpu.tube.lane_interface import tube_ilqr_solve_lanes as j_tube_ilqr_solve_lanes

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda import lane_solver
from tube_mpc_tpu_torch.ops.cuda.lane_solver import lane_ilqr_solve, stage_widths
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem, tube_ilqr_solve_lanes

OBS = [(4.0, 2.0), (2.0, 4.0), (6.0, 6.0)]
BETA, EPS = 20.0, 1e-4
ALPHAS = (1.0, 0.5, 0.1, 0.0)
MAX_ITER, TOL, REG = 6, 1e-3, 1e-3
N = 9
RTOL, ATOL = 1e-12, 1e-13
COMP = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi), centers=OBS,
            radii=[1.0] * len(OBS), aggregation="smoothmin", beta=BETA)


def problem(B, seed=3):
    """tests/test_lane_solver.py's solver problem at B lanes, as numpy f64: starts near
    the origin heading π/4 toward the goal (10, 10), b0 from the JAX augmentation, random
    warm starts."""
    rng = np.random.default_rng(seed)
    x0 = np.array([0.0, 0.0, np.pi / 4]) + 0.05 * rng.normal(size=(B, 3))
    field = CircleField(centers=jnp.asarray(OBS, dtype=jnp.float64),
                        radii=jnp.ones((len(OBS),), dtype=jnp.float64))
    system = make_dubins(DubinsConfig(dt=0.01), obstacles=field, aggregation="smoothmin",
                         beta=BETA, dtype=jnp.float64)
    bp = JBarrierParams.create(0.0, 0.0, 0.0, dtype=jnp.float64)
    b0 = np.asarray(j_make_augmented(system, eps=EPS).init_b0(jnp.asarray(x0), bp))
    return dict(x_hat0=np.concatenate([x0, b0[:, None]], axis=-1),
                U0=0.1 * rng.normal(size=(B, N, 2)),
                target=np.array([10.0, 10.0, np.pi / 4]))


def solve_port(p, dtype, **kw):
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    B = p["U0"].shape[0]
    pb = make_lane_problem(dubins_components(**COMP), eps=EPS)
    cfg = ILQRConfig(max_iter=MAX_ITER, tol=TOL, reg=REG, alphas=ALPHAS)
    w = CostWeights(Q=t([1.0, 1.0, 0.0]), R=t([1.0, 1.0]), Qf=t([100.0] * 3), qb=t(1.0))
    bp = BarrierParams(t(0.0), t(0.0), t(0.0))
    X_ref = t(p["target"])[None, None].expand(B, N + 1, 3)
    return tube_ilqr_solve_lanes(pb, cfg, w=w, bp=bp, x_hat0=t(p["x_hat0"]), U_init=t(p["U0"]),
                                 X_ref=X_ref, U_ref=torch.zeros((B, N, 2), dtype=dtype),
                                 device="cpu", **kw)


def solve_jax(p, **kw):
    f64 = jnp.float64
    B = p["U0"].shape[0]
    pb = j_make_lane_problem(j_dubins_components(**COMP), eps=EPS)
    cfg = JILQRConfig(max_iter=MAX_ITER, tol=TOL, reg=REG, alphas=ALPHAS)
    w = JCostWeights.create([1.0, 1.0, 0.0], [1.0, 1.0], [100.0] * 3, 1.0, dtype=f64)
    bp = JBarrierParams.create(0.0, 0.0, 0.0, dtype=f64)
    X_ref = jnp.broadcast_to(jnp.asarray(p["target"], f64)[None, None], (B, N + 1, 3))
    return j_tube_ilqr_solve_lanes(pb, cfg, w=w, bp=bp, x_hat0=jnp.asarray(p["x_hat0"], f64),
                                   U_init=jnp.asarray(p["U0"], f64), X_ref=X_ref,
                                   U_ref=jnp.zeros((B, N, 2), f64), block_b=128,
                                   interpret=True, **kw)


def test_iteration_telemetry_equals_the_jax_package():
    p = problem(5)
    X_t, U_t, lane_it = solve_port(p, torch.float64, with_lane_iters=True)
    X_p, U_p = solve_port(p, torch.float64)
    assert torch.equal(X_t, X_p) and torch.equal(U_t, U_p)   # telemetry changes no bit
    jX, jU, j_it, j_lane_it = solve_jax(p, with_iters=True, with_lane_iters=True)
    assert lane_it.dtype == torch.int32 and lane_it.shape == (5,)
    np.testing.assert_array_equal(lane_it.numpy(), np.asarray(j_lane_it))
    assert lane_it.min() >= 1 and int(lane_it.max()) == int(j_it) <= MAX_ITER
    np.testing.assert_allclose(U_t.numpy(), np.asarray(jU), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def uncompacted():
    """{dtype: (X, U, each lane's iterations)} of the B=136 problem without compaction."""
    p = problem(136)
    return p, {dt: solve_port(p, dt, with_lane_iters=True) for dt in (torch.float32,
                                                                        torch.float64)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("caps,stages", [
    ("one", {"compacted": 0, "full": 1}),
    ("median", {"compacted": 1, "full": 0}),
    ("one_median", {"compacted": 1, "full": 1}),
])
def test_compaction_is_bitwise_the_uncompacted_solve(uncompacted, dtype, caps, stages):
    p, ref = uncompacted
    X_p, U_p, lane_it = ref[dtype]
    mid = max(2, int(np.median(lane_it.numpy())))
    caps = {"one": (1,), "median": (mid,), "one_median": (1, mid)}[caps]
    # B=136 pads to 256 lanes in the JAX solver; its stages halve that to 128
    assert stage_widths(136, 1) == (128,)
    lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
    X_c, U_c = solve_port(p, dtype, compact_caps=caps)
    assert lane_ilqr_solve.stages == stages, caps
    assert torch.equal(X_c, X_p) and torch.equal(U_c, U_p), caps


def test_stage_widths_follow_the_jax_rule():
    """The JAX solver's widths at block_b=4096: B padded to whole blocks, halved at each
    stage, at least 128 lanes; a width not under the padded B keeps the whole batch."""
    assert stage_widths(16384, 3) == (8192, 4096, 2048)
    assert stage_widths(5, 2) == (5, 5)
    assert stage_widths(1000, 4) == (512, 256, 128, 128)
    assert stage_widths(12289, 2) == (8192, 4096)


def test_a_lane_that_is_not_finite():
    """b0 = inf on one lane: the port's initial rollout (K2 with zero gains) makes every
    row of that lane NaN where the JAX package's scan of f̂ keeps the positions finite;
    the solves agree all the same (NaN on that lane in both, the other lanes within the
    solver's tolerance), and the lane, never converged, is gathered by every compacted
    stage without reaching another lane."""
    p = problem(3)
    p["x_hat0"][1, 3] = np.inf
    X, U = solve_port(p, torch.float64)
    jX, jU = (np.asarray(a) for a in solve_jax(p))
    assert np.isnan(jU[1]).all() and torch.isnan(U[1]).all() and torch.isnan(X[1, 1:]).all()
    for lane in (0, 2):
        np.testing.assert_allclose(U[lane].numpy(), jU[lane], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(X[lane].numpy(), jX[lane], rtol=RTOL, atol=ATOL)

    wide = problem(136)
    wide["x_hat0"][7, 3] = np.inf
    for dtype in (torch.float32, torch.float64):
        X_p, U_p, lane_it = solve_port(wide, dtype, with_lane_iters=True)
        assert int(lane_it[7]) == MAX_ITER and torch.isnan(U_p[7]).all()
        assert torch.isfinite(U_p[torch.arange(136) != 7]).all()
        lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
        X_c, U_c = solve_port(wide, dtype, compact_caps=(4,))
        assert lane_ilqr_solve.stages == {"compacted": 1, "full": 0}
        assert torch.equal(U_c[~torch.isnan(U_c)], U_p[~torch.isnan(U_p)])
        assert torch.equal(torch.isnan(U_c), torch.isnan(U_p))
        assert torch.equal(torch.isnan(X_c), torch.isnan(X_p))
        assert torch.equal(X_c.nan_to_num(), X_p.nan_to_num())


def test_reset_launch_counts_resets_the_stage_counts():
    from tube_mpc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    lane_solver.lane_ilqr_solve.stages = {"compacted": 3, "full": 1}
    reset_launch_counts()
    assert lane_ilqr_solve.stages == {"compacted": 0, "full": 0}
    assert launch_counts(by_width=True) == {}
