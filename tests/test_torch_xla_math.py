"""The feature-major math layer of the port against the JAX package's, on the CPU:
ops/linalg.py, the costs and their derivatives, the DBaS step and the augmented
Jacobian f_hat_jac of every system (the cart-pole's by autodiff, as the JAX package
takes it), and the obstacle aggregations' h and grad_h.

f64 at rtol 1e-12 (the solve's near-singular cases at atol 1e-12 of the solution's
scale), the JAX package's own tolerance for these functions (tests/test_math_layer.py).
The f32 branch of solve_spd (the scale-invariant resolve-or-zero adjugate) runs only in
f32, where both packages' operations agree to a few units of f32 rounding: 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops import barrier as jbar
from tube_mpc_tpu.ops import costs as jcosts
from tube_mpc_tpu.ops import linalg as jlin
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.systems import obstacles as jobs

from tube_mpc_tpu_torch.ops import barrier as tbar
from tube_mpc_tpu_torch.ops import costs as tcosts
from tube_mpc_tpu_torch.ops import linalg as tlin
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.systems import obstacles as tobs

from torch_xla_cases import built_pair, close, raw_of, t64

RTOL = 1e-12
rng = np.random.default_rng(7)


def _spd(batch, n, scale=1.0):
    M = rng.normal(size=batch + (n, n))
    return scale * (M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(n))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_spd_f64(n, rhs):
    A = _spd((5, 4), n)
    A[0, 0] = np.eye(n) * 1e-300 if n == 2 else A[0, 0]         # tiny pivots, still LU
    if n == 2:
        A[0, 1] = [[1.0, 2.0], [2.0, 4.0]]                       # exactly singular: X = 0
        A[0, 2] = [[0.0, 1.0], [1.0, 0.0]]                       # a zero first pivot: swap
        A[0, 3] = [[np.nan, 1.0], [1.0, 2.0]]                    # non-finite: X = 0
    B = rng.normal(size=(5, 4, n) if rhs == "vector" else (5, 4, n, 3))
    got = tlin.solve_spd(t64(A), t64(B))
    ref = jlin.solve_spd(jnp.asarray(A), jnp.asarray(B))
    close(got, ref, RTOL, 0.0)


def test_solve_spd_f32_takes_the_guarded_adjugate():
    A = _spd((64,), 2, scale=1e20).astype(np.float32)
    A[0] = [[1e22, 1e22], [1e22, 1e22 * (1 + 1e-9)]]             # rank 1 at f32: X = 0
    B = rng.normal(size=(64, 2, 5)).astype(np.float32)
    assert tlin.range_guard_default(torch.float32) and not tlin.range_guard_default(torch.float64)
    got = tlin.solve_spd(torch.as_tensor(A), torch.as_tensor(B))
    ref = jlin.solve_spd(jnp.asarray(A, dtype=jnp.float32), jnp.asarray(B, dtype=jnp.float32))
    assert got.dtype == torch.float32 and not got[0].any()
    close(got, ref, 1e-6, 1e-6 * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("active", [(False, False), (True, False), (False, True), (True, True)])
def test_masked_reduced_solve_and_regularize(active):
    A = _spd((6,), 2)
    B = rng.normal(size=(6, 2, 4))
    act = np.broadcast_to(np.asarray(active), (6, 2)).copy()
    got = tlin.masked_reduced_solve(t64(A), t64(B), torch.as_tensor(act))
    ref = jlin.masked_reduced_solve(jnp.asarray(A), jnp.asarray(B), jnp.asarray(act))
    close(got, ref, RTOL, 0.0)
    got_v = tlin.masked_reduced_solve(t64(A), t64(B[..., 0]), torch.as_tensor(act))
    close(got_v, jlin.masked_reduced_solve(jnp.asarray(A), jnp.asarray(B[..., 0]),
                                           jnp.asarray(act)), RTOL, 0.0)
    close(tlin.regularize(t64(A), 1e-3), jlin.regularize(jnp.asarray(A), 1e-3), RTOL, 0.0)


def test_costs_and_derivatives():
    nx, nu = 3, 2
    x_hat = rng.normal(size=(5, 7, nx + 1))
    u = rng.normal(size=(5, 7, nu))
    x_ref, u_ref = rng.normal(size=(5, 7, nx)), rng.normal(size=(5, 7, nu))
    w = dict(Q=rng.uniform(size=nx), R=rng.uniform(size=nu), Qf=rng.uniform(size=nx), qb=0.7)
    tw = tcosts.CostWeights(*(t64(w[k]) for k in ("Q", "R", "Qf", "qb")))
    jw = jcosts.CostWeights(*(jnp.asarray(w[k]) for k in ("Q", "R", "Qf", "qb")))
    T = lambda *a: [t64(v) for v in a]
    J = lambda *a: [jnp.asarray(v) for v in a]
    close(tcosts.stage_cost(*T(x_hat, u), tw, *T(x_ref, u_ref)),
          jcosts.stage_cost(*J(x_hat, u), jw, *J(x_ref, u_ref)), RTOL, 0.0)
    close(tcosts.terminal_cost(t64(x_hat), tw, t64(x_ref)),
          jcosts.terminal_cost(jnp.asarray(x_hat), jw, jnp.asarray(x_ref)), RTOL, 0.0)
    for got, ref in zip(tcosts.stage_derivs(*T(x_hat, u), tw, *T(x_ref, u_ref)),
                        jcosts.stage_derivs(*J(x_hat, u), jw, *J(x_ref, u_ref))):
        close(got, ref, RTOL, 0.0)
    for got, ref in zip(tcosts.terminal_derivs(t64(x_hat), tw, t64(x_ref)),
                        jcosts.terminal_derivs(jnp.asarray(x_hat), jw, jnp.asarray(x_ref))):
        close(got, ref, RTOL, 0.0)
    err = rng.uniform(-10, 10, size=50)
    close(tcosts.wrap_angle(t64(err)), jcosts.wrap_angle(jnp.asarray(err)), RTOL, 1e-15)


def test_dbas_step_and_init():
    field = (np.array([[4.0, 2.0], [2.0, 4.0], [6.0, 6.0]]), np.array([1.0, 1.0, 0.5]))
    th = tobs.CircleField(*(t64(a) for a in field))
    jh = jobs.CircleField(*(jnp.asarray(a) for a in field))
    x = np.column_stack([rng.uniform(0, 8, 40), rng.uniform(0, 8, 40), rng.uniform(-3, 3, 40)])
    u = rng.normal(size=(40, 2))
    b = rng.normal(size=40)
    f_t = lambda x_, u_: x_ + 0.1 * torch.cat([u_, u_[..., :1]], dim=-1)
    f_j = lambda x_, u_: x_ + 0.1 * jnp.concatenate([u_, u_[..., :1]], axis=-1)
    for bt in ("inverse", "log"):
        got = tbar.dbas_step(t64(x), t64(u), t64(b), f=f_t, h=lambda z: tobs.h_min(z, th),
                             alpha=0.05, gamma=0.3, barrier_type=bt, eps=1e-4)
        ref = jbar.dbas_step(jnp.asarray(x), jnp.asarray(u), jnp.asarray(b), f=f_j,
                             h=lambda z: jobs.h_min(z, jh), alpha=0.05, gamma=0.3,
                             barrier_type=bt, eps=1e-4)
        for g, r in zip(got, ref):
            close(g, r, RTOL, 0.0)
        close(tbar.dbas_init_b0(t64(x), h=lambda z: tobs.h_min(z, th), alpha=0.05,
                                barrier_type=bt, eps=1e-4),
              jbar.dbas_init_b0(jnp.asarray(x), h=lambda z: jobs.h_min(z, jh), alpha=0.05,
                                barrier_type=bt, eps=1e-4), RTOL, 0.0)


@pytest.mark.parametrize("aggregation,n_obs", [("smoothmin", 3), ("min", 3), ("single", 1),
                                                ("smoothmin", 0)])
def test_obstacle_h_and_gradient(aggregation, n_obs):
    centers = np.array([[4.0, 2.0], [2.0, 4.0], [4.0, 4.0]])[:n_obs].reshape(n_obs, 2)
    radii = np.array([1.0, 1.0, 0.7])[:n_obs]
    x = np.column_stack([rng.uniform(0, 8, 60), rng.uniform(0, 8, 60), rng.uniform(-3, 3, 60),
                         rng.normal(size=60)])
    x[0, :2] = [3.0, 3.0]                    # on the bisector of the first two: the argmin tie
    th, tg = tobs.make_h(tobs.CircleField(t64(centers), t64(radii)), aggregation=aggregation)
    jh, jg = jobs.make_h(jobs.CircleField(jnp.asarray(centers), jnp.asarray(radii)),
                         aggregation=aggregation)
    close(th(t64(x)), jh(jnp.asarray(x)), RTOL, 0.0)
    close(tg(t64(x)), jg(jnp.asarray(x)), RTOL, 1e-14)


@pytest.mark.parametrize("name", ["dubins", "double_integrator", "quadrotor2d", "cartpole"])
@pytest.mark.parametrize("barrier", ["inverse", "log"])
def test_augmented_jacobian_of_every_system(name, barrier):
    """aug.f_hat_jac (the systems' analytic Jacobians, the cart-pole's by
    torch.func.jacfwd, and the DBaS chain rule) and aug.f_hat against the JAX package's,
    with per-sample barrier parameters broadcast over extra dims as the solvers give them."""
    jb, pb = built_pair(raw_of(name, 6, 2, **{"dbas.barrier_type": barrier}))
    nx, nu = pb.system.nx, pb.system.nu
    x = rng.normal(size=(4, 5, nx)) * 2.0 + 3.0
    x_hat = np.concatenate([x, rng.uniform(0.1, 2.0, size=(4, 5, 1))], axis=-1)
    lo, hi = pb.system.u_min.numpy(), pb.system.u_max.numpy()
    u = rng.uniform(lo, hi, size=(4, 5, nu))
    bp = dict(alpha=rng.uniform(0.0, 0.3, size=(4, 1)), gamma=rng.uniform(-0.5, 0.5, size=(4, 1)),
              tight=rng.uniform(0.0, 0.1, size=(4, 1)))
    tbp = BarrierParams(*(t64(bp[k]) for k in ("alpha", "gamma", "tight")))
    A, Bm = pb.aug.f_hat_jac(t64(x_hat), t64(u), tbp)
    jfn = jax.vmap(jax.vmap(lambda xh, uu, a, g, s: jb.aug.f_hat_jac(xh, uu, JBarrierParams(a, g, s))))
    jargs = [jnp.asarray(np.broadcast_to(bp[k], (4, 5))) for k in ("alpha", "gamma", "tight")]
    jA, jB = jfn(jnp.asarray(x_hat), jnp.asarray(u), *jargs)
    scale = max(float(np.abs(np.asarray(jA)).max()), 1.0)
    close(A, jA, 1e-12, 1e-14 * scale, "A")
    close(Bm, jB, 1e-12, 1e-14 * max(float(np.abs(np.asarray(jB)).max()), 1.0), "B")
    jf = jax.vmap(jax.vmap(lambda xh, uu, a, g, s: jb.aug.f_hat(xh, uu, JBarrierParams(a, g, s))))
    close(pb.aug.f_hat(t64(x_hat), t64(u), tbp), jf(jnp.asarray(x_hat), jnp.asarray(u), *jargs),
          RTOL, 1e-15)
