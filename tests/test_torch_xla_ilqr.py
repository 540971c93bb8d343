"""The port's feature-major iLQR (solvers/ilqr.py, solvers/ocp.py, tube/problem.py)
against the JAX package's vmapped ilqr_solve, in f64 on the CPU, at the JAX package's
tolerance rtol 1e-7, atol 1e-9 (tests/test_ilqr.py:196-197).

The Dubins case's four lanes take the while loop's every exit: lane 0 is still improving
at max_iter, lanes 1 and 3 converge before it, and lane 2 starts inside an obstacle, so
that with the feasibility filter every line-search candidate is infeasible (cost +inf):
it keeps its incumbent and stops after one iteration. The test holds the lanes to those
exits first, so that the comparison covers them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.solvers.ilqr import ilqr_solve as j_ilqr_solve
from tube_mpc_tpu.tube.problem import NominalTheta as JNominalTheta
from tube_mpc_tpu.tube.problem import make_nominal_ocp as j_make_nominal_ocp

from tube_mpc_tpu_torch.solvers import ilqr
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig, ilqr_solve
from tube_mpc_tpu_torch.solvers.ocp import rollout
from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp

from torch_xla_cases import built_pair, close, raw_of, t64

RTOL, ATOL = 1e-7, 1e-9
N = 8
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.0)
STARTS = {
    "dubins": [[0.0, 0.0, np.pi / 4], [1.0, 0.5, 0.3], [4.2, 2.1, 0.9], [3.0, 6.0, -1.0]],
    "cartpole": [[0.0, 0.0, np.pi, 0.0], [0.3, -0.2, 2.5, 0.4], [-0.5, 0.1, 3.5, -0.3]],
    "quadrotor2d": [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [1.0, 0.5, 0.2, 0.3, -0.1, 0.0]],
}


def _case(name, max_iter):
    jb, pb = built_pair(raw_of(name, N, 2))
    x0 = np.asarray(STARTS[name])
    lanes = len(x0)
    b0 = pb.aug.init_b0(t64(x0), pb.bp).numpy()
    x_hat0 = np.concatenate([x0, b0[:, None]], axis=1)
    lo, hi = pb.system.u_min.numpy(), pb.system.u_max.numpy()
    U0 = np.random.default_rng(0).uniform(lo, hi, size=(lanes, N, pb.system.nu)) * 0.3
    feasible = name == "dubins"
    ocp = make_nominal_ocp(pb.system, pb.aug, pb.target, feasible_h=feasible)
    cfg = ILQRConfig(max_iter=max_iter, tol=1e-6, reg=1e-6, alphas=ALPHAS)
    theta = NominalTheta(expand_lanes(pb.w_nominal, lanes), expand_lanes(pb.bp, lanes))
    jocp = j_make_nominal_ocp(jb.system, jb.aug, jb.target, feasible_h=feasible)
    jcfg = JILQRConfig(max_iter=max_iter, tol=1e-6, reg=1e-6, alphas=ALPHAS)
    ref = jax.jit(jax.vmap(lambda x, u: j_ilqr_solve(
        jocp, jcfg, JNominalTheta(jb.w_nominal, jb.bp), x, u)))(jnp.asarray(x_hat0),
                                                                jnp.asarray(U0))
    return dict(ocp=ocp, cfg=cfg, theta=theta, x_hat0=t64(x_hat0), U0=t64(U0), ref=ref)


@pytest.fixture(scope="module", params=list(STARTS))
def case(request):
    return request.param, _case(request.param, 5 if request.param == "dubins" else 10)


def test_ilqr_solve_matches_the_jax_solver(case):
    name, c = case
    X, U = ilqr_solve(c["ocp"], c["cfg"], c["theta"], c["x_hat0"], c["U0"])
    jX, jU = c["ref"]
    assert X.shape == jX.shape and U.shape == jU.shape
    close(X, jX, RTOL, ATOL, f"{name} X")
    close(U, jU, RTOL, ATOL, f"{name} U")


def test_each_lane_exits_as_it_would_alone(case, monkeypatch):
    """Each lane's result is the one it gives in a batch of one; the solve stops when its
    last live lane does, so a max_iter of exactly the iterations it ran (counted at
    _linearize) gives the same bits."""
    _, c = case
    ran, linearize = [0], ilqr._linearize

    def counted(*args):
        ran[0] += 1
        return linearize(*args)

    monkeypatch.setattr(ilqr, "_linearize", counted)
    X, U = ilqr_solve(c["ocp"], c["cfg"], c["theta"], c["x_hat0"], c["U0"])
    assert 1 <= ran[0] <= c["cfg"].max_iter
    Xn, Un = ilqr_solve(c["ocp"], dataclasses.replace(c["cfg"], max_iter=ran[0]), c["theta"],
                        c["x_hat0"], c["U0"])
    assert torch.equal(X, Xn) and torch.equal(U, Un)
    for i in range(X.shape[0]):
        one = type(c["theta"])(*(type(t)(*(v[i:i + 1] for v in t)) for t in c["theta"]))
        Xi, Ui = ilqr_solve(c["ocp"], c["cfg"], one, c["x_hat0"][i:i + 1], c["U0"][i:i + 1])
        assert torch.equal(Xi[0], X[i]) and torch.equal(Ui[0], U[i])


def test_the_dubins_lanes_take_every_exit():
    c = _case("dubins", 5)
    solve = lambda m: ilqr_solve(c["ocp"], dataclasses.replace(c["cfg"], max_iter=m),
                                 c["theta"], c["x_hat0"], c["U0"])[1]
    U4, U5, U6 = solve(4), solve(5), solve(6)
    assert not torch.equal(U4[0], U5[0]) and not torch.equal(U5[0], U6[0])   # at the cap
    for i in (1, 3):                                                           # converged
        assert torch.equal(U4[i], U5[i]) and torch.equal(U5[i], U6[i])
    # lane 2: every candidate infeasible; the incumbent (the clamped warm start) stays
    U_clamped = c["ocp"].clamp(c["U0"])
    assert torch.equal(U5[2], U_clamped[2])
    X0 = rollout(c["ocp"], c["theta"], c["x_hat0"], U_clamped)
    assert c["ocp"].feasible(X0, c["theta"])[2, 0].item() is False
    jX, jU = c["ref"]
    close(U5, jU, RTOL, ATOL)


def test_derivative_fallbacks_match_the_analytic_derivatives():
    """An OCP without f_jac, stage_derivs and terminal_derivs takes them by autodiff of its
    batched callables (solvers/ocp.py) and solves to the same plan."""
    c = _case("cartpole", 4)
    bare = dataclasses.replace(c["ocp"], f_jac=None, stage_derivs=None, terminal_derivs=None)
    X, U = ilqr_solve(c["ocp"], c["cfg"], c["theta"], c["x_hat0"], c["U0"])
    Xb, Ub = ilqr_solve(bare, c["cfg"], c["theta"], c["x_hat0"], c["U0"])
    close(Xb, X.numpy(), 1e-10, 1e-12)
    close(Ub, U.numpy(), 1e-10, 1e-12)
    Xs, Us = X[:, :-1], U
    for got, ref in zip(bare.stage_derivs_fn()(Xs, Us, c["theta"]),
                        c["ocp"].stage_derivs(Xs, Us, c["theta"])):
        close(got, ref.numpy(), 1e-12, 1e-12)
    for got, ref in zip(bare.jac_fn()(Xs, Us, c["theta"]), c["ocp"].f_jac(Xs, Us, c["theta"])):
        close(got, ref.numpy(), 1e-12, 1e-12)


def test_reduced_precision_products_are_refused():
    c = _case("dubins", 1)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="matmul_precision"):
            ilqr_solve(c["ocp"], c["cfg"], c["theta"], c["x_hat0"], c["U0"])
    finally:
        torch.set_float32_matmul_precision(before)
