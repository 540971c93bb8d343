"""The port's iLQR with ILQRConfig(horizon_parallel=True) (the Riccati sweep by
solvers/pscan.py's associative scan) against the JAX package's, vmapped over the lanes,
in f64 on the CPU, at the JAX package's solver tolerance rtol 1e-7, atol 1e-9
(tests/test_ilqr.py:196-197).

Two OCPs: tests/test_pscan.py's Dubins nominal OCP (n̂ = 4: the cofactor inverse of the
scan's combine), over three lanes whose starts differ, and the cart-pole's from its
config (n̂ = 5, m = 1: the combine's inverse by a batched solve)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.dbas import make_augmented as j_make_augmented
from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.solvers.ilqr import ilqr_solve as j_ilqr_solve
from tube_mpc_tpu.systems.dubins import DubinsConfig as JDubinsConfig
from tube_mpc_tpu.systems.dubins import make_dubins as j_make_dubins
from tube_mpc_tpu.systems.obstacles import CircleField as JCircleField
from tube_mpc_tpu.tube.problem import NominalTheta as JNominalTheta
from tube_mpc_tpu.tube.problem import make_nominal_ocp as j_make_nominal_ocp

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.dbas import BarrierParams, make_augmented
from tube_mpc_tpu_torch.solvers import ilqr
from tube_mpc_tpu_torch.solvers.diff_ilqr import make_diff_ilqr
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig, ilqr_solve
from tube_mpc_tpu_torch.systems.dubins import DubinsConfig, make_dubins
from tube_mpc_tpu_torch.systems.obstacles import CircleField
from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp

from torch_xla_cases import built_pair, close, raw_of, t64

RTOL, ATOL = 1e-7, 1e-9
F64 = torch.float64
DUBINS_N, CARTPOLE_N = 40, 12
DUBINS_STARTS = [[0.0, 0.0, np.pi / 4, 0.1], [0.5, -0.3, 0.6, 0.1], [1.0, 0.4, 1.1, 0.1]]
CARTPOLE_STARTS = [[0.0, 0.0, np.pi, 0.0], [0.3, -0.2, 2.5, 0.4], [-0.5, 0.1, 3.5, -0.3]]


def _dubins():
    """tests/test_pscan.py:94-117's OCP in both packages; its solver settings."""
    kw = dict(max_iter=10, tol=1e-3, reg=1e-6, alphas=(1.0, 0.5, 0.25, 0.1, 0.0))
    centers, radii, target = [[4.0, 2.0], [2.0, 4.0]], [1.0, 1.0], [10.0, 10.0, np.pi / 4]
    w = ([1.0, 1.0, 0.0], [1.0, 1.0], [1000.0] * 3, 1.0)

    jsys = j_make_dubins(JDubinsConfig(dt=0.01), obstacles=JCircleField(
        centers=jnp.asarray(centers), radii=jnp.asarray(radii)),
        aggregation="smoothmin", beta=20.0, dtype=jnp.float64)
    jaug = j_make_augmented(jsys, barrier_type="inverse", eps=1e-4)
    jocp = j_make_nominal_ocp(jsys, jaug, jnp.asarray(target))
    jtheta = JNominalTheta(w=JCostWeights.create(*w, dtype=jnp.float64),
                           bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=jnp.float64))

    system = make_dubins(DubinsConfig(dt=0.01), obstacles=CircleField(
        centers=t64(centers), radii=t64(radii)), aggregation="smoothmin", beta=20.0,
        device="cpu", dtype=F64)
    aug = make_augmented(system, barrier_type="inverse", eps=1e-4)
    ocp = make_nominal_ocp(system, aug, t64(target))
    theta = NominalTheta(w=CostWeights.create(*w, device="cpu", dtype=F64),
                         bp=BarrierParams.create(0.0, 0.0, 0.0, device="cpu", dtype=F64))
    x_hat0 = np.asarray(DUBINS_STARTS)
    U0 = np.zeros((len(x_hat0), DUBINS_N, 2))
    return (jocp, jtheta, JILQRConfig(horizon_parallel=True, **kw)), \
        (ocp, theta, ILQRConfig(horizon_parallel=True, **kw)), x_hat0, U0


def _cartpole():
    """The cart-pole's nominal OCP from configs/cartpole.yaml, as
    tests/test_torch_xla_ilqr.py builds it, with the scan's sweep."""
    jb, pb = built_pair(raw_of("cartpole", CARTPOLE_N, 2))
    kw = dict(max_iter=10, tol=1e-6, reg=1e-6, alphas=(1.0, 0.5, 0.25, 0.1, 0.0))
    x0 = np.asarray(CARTPOLE_STARTS)
    b0 = pb.aug.init_b0(t64(x0), pb.bp).numpy()
    x_hat0 = np.concatenate([x0, b0[:, None]], axis=1)
    lo, hi = pb.system.u_min.numpy(), pb.system.u_max.numpy()
    U0 = np.random.default_rng(0).uniform(lo, hi, size=(len(x0), CARTPOLE_N, 1)) * 0.3
    return (j_make_nominal_ocp(jb.system, jb.aug, jb.target), JNominalTheta(jb.w_nominal, jb.bp),
            JILQRConfig(horizon_parallel=True, **kw)), \
        (make_nominal_ocp(pb.system, pb.aug, pb.target), NominalTheta(pb.w_nominal, pb.bp),
         ILQRConfig(horizon_parallel=True, **kw)), x_hat0, U0


@pytest.fixture(scope="module", params=["dubins", "cartpole"])
def case(request):
    (jocp, jtheta, jcfg), (ocp, theta, cfg), x_hat0, U0 = {"dubins": _dubins,
                                                           "cartpole": _cartpole}[request.param]()
    ref = jax.jit(jax.vmap(lambda x, u: j_ilqr_solve(jocp, jcfg, jtheta, x, u)))(
        jnp.asarray(x_hat0), jnp.asarray(U0))
    lanes = len(x_hat0)
    theta = NominalTheta(expand_lanes(theta.w, lanes), expand_lanes(theta.bp, lanes))
    return dict(name=request.param, ocp=ocp, cfg=cfg, theta=theta, x_hat0=t64(x_hat0),
                U0=t64(U0), ref=ref)


def _solve(c, cfg=None):
    return ilqr_solve(c["ocp"], cfg or c["cfg"], c["theta"], c["x_hat0"], c["U0"])


def test_horizon_parallel_solve_matches_the_jax_solver(case):
    X, U = _solve(case)
    jX, jU = case["ref"]
    assert X.shape == jX.shape and U.shape == jU.shape
    close(X, jX, RTOL, ATOL, f"{case['name']} X")
    close(U, jU, RTOL, ATOL, f"{case['name']} U")


def test_horizon_parallel_solve_runs_the_scan(case, monkeypatch):
    """The flag routes every iteration's sweep through pscan.parallel_backward_pass and
    none through the sequential one."""
    from tube_mpc_tpu_torch.solvers import pscan

    calls = {"scan": 0, "sequential": 0}
    scan, sequential = pscan.parallel_backward_pass, ilqr._backward_pass

    def counted(key, fn):
        def run(*args):
            calls[key] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(pscan, "parallel_backward_pass", counted("scan", scan))
    monkeypatch.setattr(ilqr, "_backward_pass", counted("sequential", sequential))
    _solve(case)
    assert calls["scan"] >= 1 and calls["sequential"] == 0
    _solve(case, dataclasses.replace(case["cfg"], horizon_parallel=False))
    assert calls["sequential"] >= 1


def test_each_lane_exits_as_it_would_alone(case, monkeypatch):
    """Each lane's result is the one it gives in a batch of one; the solve stops when its
    last live lane does, so a max_iter of exactly the iterations it ran (counted at
    _linearize) gives the same bits."""
    ran, linearize = [0], ilqr._linearize

    def counted(*args):
        ran[0] += 1
        return linearize(*args)

    monkeypatch.setattr(ilqr, "_linearize", counted)
    X, U = _solve(case)
    assert 1 <= ran[0] <= case["cfg"].max_iter
    Xn, Un = _solve(case, dataclasses.replace(case["cfg"], max_iter=ran[0]))
    assert torch.equal(X, Xn) and torch.equal(U, Un)
    theta = case["theta"]
    for i in range(X.shape[0]):
        one = type(theta)(*(type(t)(*(v[i:i + 1] for v in t)) for t in theta))
        Xi, Ui = ilqr_solve(case["ocp"], case["cfg"], one, case["x_hat0"][i:i + 1],
                            case["U0"][i:i + 1])
        assert torch.equal(Xi[0], X[i]) and torch.equal(Ui[0], U[i])


def test_diff_ilqr_forward_takes_the_field(case):
    X, U = _solve(case)
    Xd, Ud = make_diff_ilqr(case["ocp"], case["cfg"])(case["theta"], case["x_hat0"], case["U0"])
    assert torch.equal(Xd, X) and torch.equal(Ud, U)


def test_horizon_parallel_matches_the_sequential_solve_on_dubins():
    """tests/test_pscan.py:92-121 in the port, on its start (lane 0): the split and the
    exact value updates differ by O(reg), and the nonlinear solves agree at its
    tolerances. (The other two starts' solves part by up to 3e-6 in U in the JAX package
    too; each solve is held against the JAX package's above.)"""
    _, (ocp, theta, cfg), x_hat0, U0 = _dubins()
    x_hat0, U0 = x_hat0[:1], U0[:1]
    theta = NominalTheta(expand_lanes(theta.w, 1), expand_lanes(theta.bp, 1))
    X_p, U_p = ilqr_solve(ocp, cfg, theta, t64(x_hat0), t64(U0))
    X_s, U_s = ilqr_solve(ocp, dataclasses.replace(cfg, horizon_parallel=False), theta,
                          t64(x_hat0), t64(U0))
    close(U_p, U_s.numpy(), 1e-5, 1e-7, "U")
    close(X_p, X_s.numpy(), 1e-5, 1e-7, "X")
