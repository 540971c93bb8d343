"""The port's DDP sensitivity, IFT accumulation and differentiable solve
(solvers/sensitivity.py, ift.py, weight_grads.py, diff_ilqr.py) against the JAX
package's, in f64 on the CPU, on the Dubins ancillary problem (dubins.yaml, N=8) of three
lanes with their own weights and barrier parameters.

- ddp_sensitivity with both exact_hessians settings, on one KKT point given to both
  packages: rtol 1e-7, atol 1e-10 (tests/test_gradients.py:312-314);
- ift_gradient on those directions, and the torch.autograd.Function's θ and x0 gradients
  against jax.grad through make_diff_ilqr: the same tolerances;
- the closed-form Algorithm-2 weight gradients against the Function's:
  rtol 1e-9, atol 1e-12 (tests/test_gradients.py:358-360);
- a lane made NaN reaches no other lane's gradient; make_ift_regrad's backward is the
  solve's at the same point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.solvers.diff_ilqr import make_diff_ilqr as j_make_diff_ilqr
from tube_mpc_tpu.solvers.ift import ift_gradient as j_ift_gradient
from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.solvers.sensitivity import SensitivityResult as JSensitivityResult
from tube_mpc_tpu.solvers.sensitivity import ddp_sensitivity as j_ddp_sensitivity
from tube_mpc_tpu.tube.problem import AuxTheta as JAuxTheta
from tube_mpc_tpu.tube.problem import make_aux_ocp as j_make_aux_ocp

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.solvers.diff_ilqr import (
    make_diff_ilqr,
    make_ift_regrad,
    tree_flatten,
    tree_unflatten,
)
from tube_mpc_tpu_torch.solvers.ift import ift_gradient
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig, ilqr_solve
from tube_mpc_tpu_torch.solvers.sensitivity import ddp_sensitivity
from tube_mpc_tpu_torch.solvers.weight_grads import grads_aux_from_deltas
from tube_mpc_tpu_torch.tube.problem import (
    AuxTheta,
    NominalTheta,
    expand_lanes,
    make_aux_ocp,
    make_nominal_ocp,
)

from torch_xla_cases import built_pair, close, raw_of, t64

RTOL, ATOL = 1e-7, 1e-10
N, LANES = 8, 3
CFG = dict(max_iter=10, tol=1e-3, reg=1e-3, alphas=(1.0, 0.5, 0.25, 0.1, 0.0))
rng = np.random.default_rng(11)


def _jtheta(d):
    """The JAX AuxTheta of numpy leaves (one lane's, or the lanes' in front for vmap)."""
    return JAuxTheta(w=JCostWeights(*(jnp.asarray(d[k]) for k in ("Q", "R", "Qf", "qb"))),
                     bp=JBarrierParams(*(jnp.asarray(d[k]) for k in ("alpha", "gamma", "tight"))),
                     X_ref=jnp.asarray(d["X_ref"]), U_ref=jnp.asarray(d["U_ref"]))


def _ptheta(d):
    return AuxTheta(w=CostWeights(*(t64(d[k]) for k in ("Q", "R", "Qf", "qb"))),
                    bp=BarrierParams(*(t64(d[k]) for k in ("alpha", "gamma", "tight"))),
                    X_ref=t64(d["X_ref"]), U_ref=t64(d["U_ref"]))


@pytest.fixture(scope="module")
def problem():
    """The lanes' ancillary θ (numpy, lanes in front), start, warm start and solution."""
    jb, pb = built_pair(raw_of("dubins", N, 2))
    x0 = np.array([[0.0, 0.0, np.pi / 4], [0.5, 0.2, 0.6], [1.0, 0.4, 1.0]])
    b0 = pb.aug.init_b0(t64(x0), pb.bp).numpy()
    x_hat0 = np.concatenate([x0, b0[:, None]], axis=1)
    nom = make_nominal_ocp(pb.system, pb.aug, pb.target)
    Xn, Un = ilqr_solve(nom, ILQRConfig(**CFG),
                        NominalTheta(expand_lanes(pb.w_nominal, LANES),
                                     expand_lanes(pb.bp, LANES)),
                        t64(x_hat0), torch.zeros((LANES, N, 2), dtype=torch.float64))
    d = dict(Q=rng.uniform(0.5, 2.0, (LANES, 3)), R=rng.uniform(0.5, 2.0, (LANES, 2)),
             Qf=rng.uniform(0.5, 2.0, (LANES, 3)), qb=rng.uniform(0.5, 1.5, LANES),
             alpha=rng.uniform(0.02, 0.05, LANES), gamma=rng.uniform(0.1, 0.3, LANES),
             tight=np.zeros(LANES), X_ref=Xn[..., :3].numpy() + 0.05, U_ref=Un.numpy())
    ocp = make_aux_ocp(pb.system, pb.aug)
    U0 = np.zeros((LANES, N, 2))
    X, U = ilqr_solve(ocp, ILQRConfig(**CFG), _ptheta(d), t64(x_hat0), t64(U0))
    assert ocp.active_mask(U).any() and not ocp.active_mask(U).all()
    return dict(jb=jb, pb=pb, d=d, x_hat0=x_hat0, U0=U0, X=X, U=U, ocp=ocp,
                jocp=j_make_aux_ocp(jb.system, jb.aug))


@pytest.fixture(scope="module")
def upper():
    return rng.normal(size=(LANES, N + 1, 4)), rng.normal(size=(LANES, N, 2))


@pytest.mark.parametrize("exact", [False, True])
def test_ddp_sensitivity_matches_the_jax_sweeps(problem, upper, exact):
    p = problem
    gX, gU = upper
    sens = ddp_sensitivity(p["ocp"], _ptheta(p["d"]), p["X"], p["U"], t64(gX), t64(gU),
                           exact_hessians=exact)
    ref = jax.jit(jax.vmap(lambda th, X, U, gx, gu: j_ddp_sensitivity(
        p["jocp"], th, X, U, gx, gu, exact_hessians=exact)))(
        _jtheta(p["d"]), jnp.asarray(p["X"].numpy()), jnp.asarray(p["U"].numpy()),
        jnp.asarray(gX), jnp.asarray(gU))
    for got, want, name in zip(sens, ref, sens._fields):
        close(got, want, RTOL, ATOL, name)


def test_ift_gradient_matches_the_jax_accumulation(problem, upper):
    p = problem
    gX, gU = upper
    th = _ptheta(p["d"])
    sens = ddp_sensitivity(p["ocp"], th, p["X"], p["U"], t64(gX), t64(gU))
    got = ift_gradient(p["ocp"], th, p["X"], p["U"], sens)
    ref = jax.jit(jax.vmap(lambda th_, X, U, s_: j_ift_gradient(p["jocp"], th_, X, U, s_)))(
        _jtheta(p["d"]), jnp.asarray(p["X"].numpy()), jnp.asarray(p["U"].numpy()),
        JSensitivityResult(*(jnp.asarray(v.numpy()) for v in sens)))
    for g, r in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(ref)):
        close(g, r, RTOL, ATOL)


def _loss_weights():
    return rng.normal(size=(LANES, N + 1, 4)), rng.normal(size=(LANES, N, 2))


@pytest.mark.parametrize("exact", [False, True])
def test_function_gradients_match_jax_grad(problem, exact):
    """θ and x0 gradients of a loss on (X, U) through the port's Function against jax.grad
    through the JAX package's custom_vjp solve, each lane's (vmapped)."""
    p = problem
    cX, cU = _loss_weights()
    solve = make_diff_ilqr(p["ocp"], ILQRConfig(**CFG), exact_hessians=exact)
    leaves, spec = tree_flatten(_ptheta(p["d"]))
    leaves = [v.requires_grad_() for v in leaves]
    x0 = t64(p["x_hat0"]).requires_grad_()
    X, U = solve(tree_unflatten(spec, leaves), x0, t64(p["U0"]))
    loss = torch.sum(X * t64(cX)) + torch.sum(U * t64(cU))
    grads = torch.autograd.grad(loss, leaves + [x0])

    jsolve = j_make_diff_ilqr(p["jocp"], JILQRConfig(**CFG), exact_hessians=exact)

    def jloss(th, x, U0, cx, cu):
        Xj, Uj = jsolve(th, x, U0)
        return jnp.sum(Xj * cx) + jnp.sum(Uj * cu)

    g_th, g_x = jax.jit(jax.vmap(jax.grad(jloss, argnums=(0, 1))))(
        _jtheta(p["d"]), jnp.asarray(p["x_hat0"]), jnp.asarray(p["U0"]), jnp.asarray(cX),
        jnp.asarray(cU))
    for g, r, name in zip(grads[:-1], jax.tree_util.tree_leaves(g_th), range(len(leaves))):
        close(g, r, RTOL, ATOL, f"leaf {name}")
    close(grads[-1], g_x, RTOL, ATOL, "x0")


def test_closed_form_weight_gradients_match_the_function(problem):
    """Algorithm-2's closed-form (gQ, gR, gqb) from δz against torch.autograd.grad of the
    upper loss through the Function, with Qf tied to Q."""
    p = problem
    d = p["d"]
    Q, R, qb = (t64(d[k]).requires_grad_() for k in ("Q", "R", "qb"))
    th = AuxTheta(w=CostWeights(Q=Q, R=R, Qf=Q, qb=qb), bp=_ptheta(d).bp,
                  X_ref=t64(d["X_ref"]), U_ref=t64(d["U_ref"]))
    solve = make_diff_ilqr(p["ocp"], ILQRConfig(**CFG))
    X, U = solve(th, t64(p["x_hat0"]), t64(p["U0"]))
    X_ref = th.X_ref
    L = torch.sum((X[..., :3] - X_ref) ** 2) + torch.sum(X[..., 3] ** 2)
    gQ, gR, gqb = torch.autograd.grad(L, (Q, R, qb))
    X, U = X.detach(), U.detach()
    g_X = torch.cat([2.0 * (X[..., :3] - X_ref), 2.0 * X[..., 3:]], dim=-1)
    sens = ddp_sensitivity(p["ocp"], th, X, U, g_X, torch.zeros_like(U))
    cf = grads_aux_from_deltas(X, U, X_ref, th.U_ref, sens)
    close(cf.Q, gQ.numpy(), 1e-9, 1e-12, "Q")
    close(cf.R, gR.numpy(), 1e-9, 1e-12, "R")
    close(cf.qb, gqb.numpy(), 1e-9, 1e-12, "qb")


def test_a_nan_lane_reaches_no_other_lane_and_regrad_is_the_solves_backward(problem):
    p = problem
    cX, cU = _loss_weights()
    solve = make_diff_ilqr(p["ocp"], ILQRConfig(**CFG))
    regrad = make_ift_regrad(p["ocp"])

    def grads(x_hat0, lanes, via_regrad=False):
        leaves, spec = tree_flatten(_ptheta({k: v[lanes] for k, v in p["d"].items()}))
        leaves = [v.requires_grad_() for v in leaves]
        th = tree_unflatten(spec, leaves)
        X, U = solve(th, t64(x_hat0[lanes]), t64(p["U0"][lanes]))
        if via_regrad:
            X, U = regrad(th, t64(x_hat0[lanes]), X.detach(), U.detach())
        loss = torch.sum(X * t64(cX[lanes])) + torch.sum(U * t64(cU[lanes]))
        return torch.autograd.grad(loss, leaves)

    bad = p["x_hat0"].copy()
    bad[1, 3] = np.nan
    with_nan = grads(bad, [0, 1, 2])
    alone = grads(p["x_hat0"], [0, 2])
    assert any(bool(torch.isnan(g[1]).any()) for g in with_nan)
    for g, r in zip(with_nan, alone):
        assert torch.equal(g[[0, 2]], r)
    for g, r in zip(grads(p["x_hat0"], [0, 1, 2], via_regrad=True),
                    grads(p["x_hat0"], [0, 1, 2])):
        assert torch.equal(g, r)


def test_nominal_weight_gradients_and_sgd_match_the_jax_formulas():
    """grads_nominal_from_deltas and apply_sgd on the same numbers as the JAX package's."""
    from tube_mpc_tpu.solvers.weight_grads import apply_sgd as j_apply_sgd
    from tube_mpc_tpu.solvers.weight_grads import grads_nominal_from_deltas as j_nominal
    from tube_mpc_tpu.tube.params import AuxAdapt as JAuxAdapt

    from tube_mpc_tpu_torch.solvers.sensitivity import SensitivityResult
    from tube_mpc_tpu_torch.solvers.weight_grads import apply_sgd, grads_nominal_from_deltas
    from tube_mpc_tpu_torch.tube.params import AuxAdapt

    X, U = rng.normal(size=(LANES, N + 1, 4)), rng.normal(size=(LANES, N, 2))
    target = rng.normal(size=(LANES, 3))
    sens = [rng.normal(size=(LANES, N + 1, 4)), rng.normal(size=(LANES, N, 2)),
            rng.normal(size=(LANES, N + 1, 4))]
    got = grads_nominal_from_deltas(t64(X), t64(U), t64(target),
                                    SensitivityResult(*(t64(v) for v in sens)))
    ref = j_nominal(jnp.asarray(X), jnp.asarray(U), jnp.asarray(target),
                    JSensitivityResult(*(jnp.asarray(v) for v in sens)))
    for g, r in zip(got, ref):
        close(g, r, 1e-12, 0.0)
    p = AuxAdapt(*(t64(v) for v in (X[:, 0, :3], U[:, 0], X[:, 0, 3])))
    g = AuxAdapt(*(t64(v) for v in (sens[0][:, 0, :3], sens[1][:, 0], sens[0][:, 0, 3])))
    jp = JAuxAdapt(*(jnp.asarray(v.numpy()) for v in p))
    jg = JAuxAdapt(*(jnp.asarray(v.numpy()) for v in g))
    for a, b in zip(apply_sgd(p, g, 0.05), j_apply_sgd(jp, jg, 0.05)):
        close(a, b, 1e-15, 0.0)
