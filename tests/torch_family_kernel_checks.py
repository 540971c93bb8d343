"""The lane kernels' plain versions on one family against the JAX package's Pallas
kernels in interpret mode, and the whole solve and sensitivity, in f64 on the CPU: the
tests of tests/test_torch_family_kernels_<family>.py (K1, K2, the solve) and
tests/test_torch_family_sensitivity_<family>.py (K3, K4, the gradients), each of which
names its family with a fixture ``family`` (files of their own, so that the test
workers spread them).

K1-K4 (ric_plain, fwd_plain, sbwd_plain, sfwd_plain) on the same numpy inputs
(torch_family_cases.kernel_inputs: rollouts of clamped random controls, so some sit at
a bound, from starts near and past the safe set's edge), the cart-pole with one control
(the m = 1 branches of K1 and K3); tube_ilqr_solve_lanes against the JAX one at the JAX
package's rtol 1e-11, atol 1e-12 (tests/test_lane_solver.py:259-268), and
tube_sensitivity_grads_lanes at rtol 1e-9, atol 1e-11 (tests/test_lane_sensitivity.py:97-99).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.tube.lane_interface import tube_ilqr_solve_lanes as j_tube_ilqr_solve_lanes
from tube_mpc_tpu.tube.lane_interface import (
    tube_sensitivity_grads_lanes as j_tube_sensitivity_grads_lanes,
)

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sfwd_plain
from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric_plain
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import (
    tube_ilqr_solve_lanes,
    tube_sensitivity_grads_lanes,
)

from torch_family_cases import jax_fwd, jax_ric, jax_sbwd, jax_sfwd, kernel_inputs, problems, t64

F64 = jnp.float64
N, B = 6, 3
REG_SENS, ACTIVE_TOL = 1e-9, 1e-8


@pytest.fixture(scope="module")
def case(family):
    pb, j_pb, s = problems(family)
    return dict(pb=pb, j_pb=j_pb, s=s, d=kernel_inputs(family, seed=11, N=N, B=B))


@pytest.fixture(scope="module")
def k1(case):
    pb, d = case["pb"], case["d"]
    X, C, nh, m = d["X"], d["C"], pb.n_hat, pb.m
    phix = C[nh + m:2 * nh + m] * (X[-1] - d["Xr"][-1])
    args = (X[:-1], d["U"], d["Xr"][:-1], d["Ur"], C, phix)
    return ric_plain(pb, 1e-3, *args), jax_ric(case["j_pb"], 1e-3, *(a.numpy() for a in args))


@pytest.mark.parametrize("out", ["K", "kff"])
def test_ric_matches_pallas_kernel(k1, out):
    """rtol 1e-11 and an atol of 1e-11 of the largest gain. Under jit, XLA rounds f̂'s
    Jacobian rows a few ulps away from the same operations run one by one (Dubins' too),
    and the Riccati recursion through the barrier-inflated rows of the lanes at the safe
    set's edge carries that to ~1e-11 of the gains (the double integrator's gains part by
    1.0e-11 relative at most); the JAX package holds its solve at rtol 1e-11 for the same
    reason."""
    i = ["K", "kff"].index(out)
    port, ref = k1[0][i], k1[1][i]
    assert port.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-11, atol=1e-11 * np.abs(ref).max())


@pytest.fixture(scope="module")
def k2(case, k1):
    d, pb, s = case["d"], case["pb"], case["s"]
    args = (d["x_hat0"], d["X"][:-1], d["U"], k1[0][0], k1[0][1], d["Xr"][:-1], d["Xr"][-1],
            d["Ur"], d["C"])
    return (fwd_plain(pb, s.cfg.alphas, *args),
            jax_fwd(case["j_pb"], s.cfg.alphas, *(a.numpy() for a in args)))


@pytest.mark.parametrize("out", ["X", "U", "cost"])
def test_fwd_matches_pallas_kernel(k2, out):
    port, ref = k2
    i = ["X", "U", "cost"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=1e-12, atol=1e-13)


@pytest.fixture(scope="module")
def k3(case):
    d, pb = case["d"], case["pb"]
    X, Xr = d["X"], d["Xr"]
    args = (d["U"], X[:-1], Xr[:-1], d["C"], X[-1], Xr[-1])
    port = sbwd_plain(pb, REG_SENS, ACTIVE_TOL, *args)
    ref = jax_sbwd(case["j_pb"], REG_SENS, ACTIVE_TOL, *(a.numpy() for a in args))
    return args, port, ref


@pytest.mark.parametrize("out", ["K", "kff"])
def test_sbwd_matches_pallas_kernel(k3, out):
    _, port, ref = k3
    i = ["K", "kff"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=1e-9, atol=1e-11)


def test_sbwd_zeroes_gains_of_controls_at_a_bound(case, k3):
    """The inputs hold controls at a bound, where K's row and kff are exactly zero."""
    pb, U = case["pb"], case["d"]["U"]
    lo = torch.as_tensor(pb.u_min, dtype=U.dtype)[None, :, None]
    hi = torch.as_tensor(pb.u_max, dtype=U.dtype)[None, :, None]
    at = (U <= lo + ACTIVE_TOL) | (U >= hi - ACTIVE_TOL)
    assert bool(at.any()) and not bool(at.all())
    K, kff = k3[1]
    assert bool((kff[at] == 0.0).all())
    assert bool((K.view(N, pb.m, pb.n_hat, B).permute(0, 1, 3, 2)[at] == 0.0).all())


@pytest.fixture(scope="module")
def k4(case, k3):
    d, pb = case["d"], case["pb"]
    K, kff = k3[1]
    X, Xr = d["X"], d["Xr"]
    args = (K, kff, X[:-1], Xr[:-1], d["U"], d["Ur"], d["C"], X[-1], Xr[-1])
    return sfwd_plain(pb, *args), jax_sfwd(case["j_pb"], *(a.numpy() for a in args))


@pytest.mark.parametrize("out", ["gx", "gr"])
def test_sfwd_matches_pallas_kernel(k4, out):
    port, ref = k4
    i = ["gx", "gr"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=1e-9, atol=1e-11)


def _solve_inputs(case):
    """Goal tracking of the family's target with its nominal weights and alphas, from
    perturbed starts: (the inputs as numpy, the solver's settings)."""
    pb, s = case["pb"], case["s"]
    rng = np.random.default_rng(5)
    n, m = pb.n, pb.m
    x0 = np.asarray(s.x0)[None] + 0.05 * rng.normal(size=(B, n))
    x_hat0 = np.concatenate([x0, rng.uniform(0.1, 1.0, B)[:, None]], axis=1)
    lo, hi = np.asarray(pb.u_min), np.asarray(pb.u_max)
    d = dict(x_hat0=x_hat0, U_init=rng.uniform(lo, hi, size=(B, N, m)),
             X_ref=np.broadcast_to(np.asarray(s.target), (B, N + 1, n)).copy(),
             U_ref=np.zeros((B, N, m)))
    w = {f: getattr(s.w_nominal, f).numpy() for f in ("Q", "R", "Qf", "qb")}
    return d, w, dict(max_iter=3, tol=1e-3, reg=1e-6, alphas=s.cfg.alphas)


def _port_solve(case):
    d, w, cfg_kw = _solve_inputs(case)
    return tube_ilqr_solve_lanes(
        case["pb"], ILQRConfig(**cfg_kw), w=CostWeights(**{k: t64(v) for k, v in w.items()}),
        bp=BarrierParams(t64(0.0), t64(0.0), t64(0.0)), device="cpu",
        **{k: t64(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def solved(case):
    """tube_ilqr_solve_lanes in both packages on the same numbers."""
    d, w, cfg_kw = _solve_inputs(case)
    jX, jU = j_tube_ilqr_solve_lanes(
        case["j_pb"], JILQRConfig(**cfg_kw),
        w=JCostWeights(**{k: jnp.asarray(v) for k, v in w.items()}),
        bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=F64), block_b=128, interpret=True,
        **{k: jnp.asarray(v) for k, v in d.items()})
    return _port_solve(case), (np.asarray(jX), np.asarray(jU))


@pytest.mark.parametrize("out", ["X", "U"])
def test_solve_matches_jax(solved, out):
    i = ["X", "U"].index(out)
    port, ref = solved[0][i], solved[1][i]
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-11, atol=1e-12)


@pytest.fixture(scope="module")
def grads(case):
    """The gradients of the upper loss at the port's solved trajectory, with per-lane
    weights, tracking the solve's own plan shifted (so the loss is not zero)."""
    pb, j_pb = case["pb"], case["j_pb"]
    X, U = _port_solve(case)
    rng = np.random.default_rng(9)
    n, m = pb.n, pb.m
    Q, R, qb = rng.uniform(0.5, 2.0, (B, n)), rng.uniform(0.5, 2.0, (B, m)), rng.uniform(0.2, 1.0, B)
    X_ref = X[..., :n].numpy() + 0.05 * rng.normal(size=(B, N + 1, n))
    U_ref = U.numpy() + 0.1 * rng.normal(size=(B, N, m))
    port = tube_sensitivity_grads_lanes(
        pb, w=CostWeights(Q=t64(Q), R=t64(R), Qf=t64(Q), qb=t64(qb)),
        bp=BarrierParams(t64(0.0), t64(0.0), t64(0.0)), X_hat=X, U=U, X_ref=t64(X_ref),
        U_ref=t64(U_ref), reg=REG_SENS, active_tol=ACTIVE_TOL, device="cpu")
    j = lambda a: jnp.asarray(np.asarray(a), dtype=F64)
    ref = j_tube_sensitivity_grads_lanes(
        j_pb, w=JCostWeights(Q=j(Q), R=j(R), Qf=j(Q), qb=j(qb)),
        bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=F64), X_hat=j(X), U=j(U),
        X_ref=j(X_ref), U_ref=j(U_ref), block_b=128, interpret=True)
    return port, ref


@pytest.mark.parametrize("out", ["Q", "R", "qb"])
def test_sensitivity_matches_jax(grads, out):
    port, ref = grads
    np.testing.assert_allclose(getattr(port, out).numpy(), np.asarray(getattr(ref, out)),
                               rtol=1e-9, atol=1e-11)
