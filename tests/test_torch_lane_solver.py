"""The port's lane solver against the JAX package's, in f64 on the CPU.

K1 and K2 (their plain versions) against the Pallas kernels run in interpret
mode on the same numpy inputs, and the whole tube_ilqr_solve_lanes at B=3 (not a
multiple of the JAX block) for goal tracking and reference tracking. Tolerances
are the JAX package's own (tests/test_lane_solver.py:113-119).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.ops.pallas import lane_solver as jls
from tube_mpc_tpu.presets import PAPER_ALPHAS, PAPER_OBSTACLES
from tube_mpc_tpu.solvers.ilqr import ILQRConfig as JILQRConfig
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem
from tube_mpc_tpu.tube.lane_interface import tube_ilqr_solve_lanes as j_tube_ilqr_solve_lanes

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric, ric_plain, rollout
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem, tube_ilqr_solve_lanes

F64 = jnp.float64
EPS, BETA = 1e-4, 20.0
B, N = 3, 6
BT = 128           # JAX lane block: B=3 pads to one block of 128 lanes
RTOL, ATOL = 1e-12, 1e-13
VMEM = pltpu.VMEM


def _problems():
    kw = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
              centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=BETA)
    return (make_lane_problem(dubins_components(**kw), eps=EPS),
            j_make_lane_problem(j_dubins_components(**kw), eps=EPS))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _padded(a, const_rows=False):
    """Pad the lane axis to the JAX block; padded const rows are 1 as in lane_ilqr_solve."""
    a = jls._pad_lanes(jnp.asarray(a, dtype=F64), BT)
    if const_rows:
        a = a.at[:, B:].set(1.0)
    return a


def kernel_inputs(seed):
    """A realistic kernel input: rollouts of random controls from three starts, one
    of them inside an obstacle, tracking a ramp with per-lane weights."""
    pb, _ = _problems()
    rng = np.random.default_rng(seed)
    x0 = np.array([[0.0, 0.0, np.pi / 4], [3.3, 2.2, 0.3], [1.5, 3.5, 1.0]])
    bp = BarrierParams(*(_t(v) for v in (np.array([0.0, 0.05, 0.1]), np.array([0.0, 0.3, -0.2]),
                                          np.array([0.0, 0.02, 0.0]))))
    b0 = np.array([0.2, 0.5, 0.1])
    x_hat0 = _t(np.concatenate([x0, b0[:, None]], axis=1).T)
    U = _t(np.stack([rng.uniform(-11.0, 11.0, (N, B)), rng.uniform(-3.5, 3.5, (N, B))], axis=1))
    U = torch.minimum(_t(pb.u_max)[None, :, None], torch.maximum(_t(pb.u_min)[None, :, None], U))
    ks = np.arange(N + 1)
    Xr = np.zeros((N + 1, 4, B))
    Xr[:, 0], Xr[:, 1], Xr[:, 2] = (0.05 * ks)[:, None], (0.04 * ks)[:, None], np.pi / 4
    Ur = np.broadcast_to(np.array([5.0, 0.1])[None, :, None], (N, 2, B)).copy()
    w = CostWeights(Q=_t(rng.uniform(0.5, 2.0, (B, 3))), R=_t(rng.uniform(0.5, 2.0, (B, 2))),
                    Qf=_t(rng.uniform(10.0, 100.0, (B, 3))), qb=_t(rng.uniform(0.2, 1.0, B)))
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X = rollout(pb, x_hat0, U.contiguous(), _t(Xr), _t(Ur), C)
    return dict(x_hat0=x_hat0, X=X, U=U, Xr=_t(Xr), Ur=_t(Ur), C=C)


def jax_ric(pb, reg, X, U, Xr, Ur, C, phix):
    nh, m, nc = pb.n_hat, pb.m, C.shape[0]
    kb_rev = lambda b, k: (N - 1 - k, 0, b)
    fixed = lambda b, k: (0, b)
    call = pl.pallas_call(
        functools.partial(jls._ric_kernel, pb, float(reg)),
        grid=(1, N),
        in_specs=[pl.BlockSpec((1, nh, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((nc, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM)],
        out_specs=[pl.BlockSpec((1, m * nh, BT), kb_rev, memory_space=VMEM),
                   pl.BlockSpec((1, m, BT), kb_rev, memory_space=VMEM)],
        out_shape=[jax.ShapeDtypeStruct((N, m * nh, BT), F64),
                   jax.ShapeDtypeStruct((N, m, BT), F64)],
        scratch_shapes=[VMEM((nh, BT), F64), VMEM((nh * nh, BT), F64), VMEM((1, BT), F64)],
        interpret=True,
    )
    K, kff = call(_padded(X), _padded(U), _padded(Xr), _padded(Ur), _padded(C, True), _padded(phix))
    return np.asarray(K)[..., :B], np.asarray(kff)[..., :B]


def jax_fwd(pb, alphas, x0, Xo, Uo, K, kff, Xr, XrN, Ur, C):
    nh, m, nc, na = pb.n_hat, pb.m, C.shape[0], len(alphas)
    kb = lambda b, k: (k, 0, b)
    fixed = lambda b, k: (0, b)
    call = pl.pallas_call(
        functools.partial(jls._fwd_kernel, pb, tuple(alphas), N),
        grid=(1, N),
        in_specs=[pl.BlockSpec((nh, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m * nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((nc, BT), fixed, memory_space=VMEM)],
        out_specs=[pl.BlockSpec((1, na * nh, BT), kb, memory_space=VMEM),
                   pl.BlockSpec((1, na * m, BT), kb, memory_space=VMEM),
                   pl.BlockSpec((na, BT), fixed, memory_space=VMEM)],
        out_shape=[jax.ShapeDtypeStruct((N, na * nh, BT), F64),
                   jax.ShapeDtypeStruct((N, na * m, BT), F64),
                   jax.ShapeDtypeStruct((na, BT), F64)],
        scratch_shapes=[VMEM((na * nh, BT), F64)],
        interpret=True,
    )
    outs = call(_padded(x0), _padded(Xo), _padded(Uo), _padded(K), _padded(kff), _padded(Xr),
                _padded(XrN), _padded(Ur), _padded(C, True))
    return tuple(np.asarray(o)[..., :B] for o in outs)


@pytest.fixture(scope="module")
def k1_case():
    pb, j_pb = _problems()
    d = kernel_inputs(seed=11)
    X, C = d["X"], d["C"]
    phix = C[6:10] * (X[-1] - d["Xr"][-1])
    args = (X[:-1], d["U"], d["Xr"][:-1], d["Ur"], C, phix)
    port = ric_plain(pb, 1e-3, *args)
    ref = jax_ric(j_pb, 1e-3, *(a.numpy() for a in args))
    return port, ref, d, pb, j_pb


@pytest.mark.parametrize("out", ["K", "kff"])
def test_ric_matches_pallas_kernel(k1_case, out):
    """rtol 1e-12, and an atol of 1e-12 of the largest gain: one lane starts
    inside an obstacle, where the barrier row's Jacobian is ~1e3 and the gains
    cancel, so a gain far below the lane's largest is accurate only to the
    rounding of the largest (measured: 2e-13 of it). The whole solve below is
    held at the JAX package's own rtol 1e-12, atol 1e-13."""
    port, ref, _, _, _ = k1_case
    i = ["K", "kff"].index(out)
    scale = np.abs(ref[i]).max()
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=1e-12 * scale)


def test_ric_wrapper_runs_plain_version_on_cpu(k1_case):
    port, _, d, pb, _ = k1_case
    X, C = d["X"], d["C"]
    phix = C[6:10] * (X[-1] - d["Xr"][-1])
    before = ric.launches
    K, kff = ric(pb, 1e-3, X[:-1], d["U"], d["Xr"][:-1], d["Ur"], C, phix)
    assert ric.launches == before  # plain versions are not kernel launches
    np.testing.assert_array_equal(K.numpy(), port[0].numpy())
    np.testing.assert_array_equal(kff.numpy(), port[1].numpy())


@pytest.mark.parametrize("out", ["X", "U", "cost"])
def test_fwd_matches_pallas_kernel(k1_case, out):
    port_ric, _, d, pb, j_pb = k1_case
    X = d["X"]
    args = (d["x_hat0"], X[:-1], d["U"], port_ric[0], port_ric[1], d["Xr"][:-1], d["Xr"][-1],
            d["Ur"], d["C"])
    port = fwd_plain(pb, PAPER_ALPHAS, *args)
    ref = jax_fwd(j_pb, PAPER_ALPHAS, *(a.numpy() for a in args))
    i = ["X", "U", "cost"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_rollout_is_the_plain_scan():
    """The initial rollout is K2 with zero gains; it must equal the scan of f̂."""
    pb, _ = _problems()
    d = kernel_inputs(seed=12)
    bp = BarrierParams(alpha=d["C"][10], gamma=d["C"][11], tight=d["C"][12])
    x = tuple(d["x_hat0"][i] for i in range(4))
    for k in range(N):
        x = pb.f_hat(x, tuple(d["U"][k, a] for a in range(2)), bp)
        np.testing.assert_array_equal(torch.stack(x).numpy(), d["X"][k + 1].numpy())


@pytest.fixture(scope="module", params=["goal", "reference"])
def solve_case(request):
    """tube_ilqr_solve_lanes in both packages on the same numbers."""
    pb, j_pb = _problems()
    rng = np.random.default_rng(5)
    cfg_kw = dict(max_iter=3, tol=1e-3, reg=1e-3, alphas=(1.0, 0.5, 0.1, 0.0))
    x0 = np.array([0.0, 0.0, np.pi / 4]) + 0.05 * rng.normal(size=(B, 3))
    x0[1, :2] = [3.4, 2.3]   # one lane starts inside an obstacle
    b0 = rng.uniform(0.1, 1.0, B)
    x_hat0 = np.concatenate([x0, b0[:, None]], axis=1)
    U0 = 3.0 * rng.normal(size=(B, N, 2))
    w = dict(Q=np.array([1.0, 1.0, 0.0]), R=np.array([1.0, 1.0]), Qf=np.array([100.0] * 3), qb=1.0)
    if request.param == "goal":
        X_ref = np.broadcast_to(np.array([10.0, 10.0, np.pi / 4]), (B, N + 1, 3)).copy()
        U_ref = np.zeros((B, N, 2))
    else:
        ks = np.arange(N + 1)
        X_ref = np.broadcast_to(np.stack([0.05 * ks, 0.04 * ks, np.full(N + 1, np.pi / 4)], -1),
                                (B, N + 1, 3)).copy()
        U_ref = np.broadcast_to(np.array([5.0, 0.1]), (B, N, 2)).copy()
    X, U = tube_ilqr_solve_lanes(
        pb, ILQRConfig(**cfg_kw), w=CostWeights(**{k: _t(v) for k, v in w.items()}),
        bp=BarrierParams(_t(0.0), _t(0.0), _t(0.0)), x_hat0=_t(x_hat0), U_init=_t(U0),
        X_ref=_t(X_ref), U_ref=_t(U_ref), device="cpu",
    )
    jw = JCostWeights(**{k: jnp.asarray(v, dtype=F64) for k, v in w.items()})
    jX, jU = j_tube_ilqr_solve_lanes(
        j_pb, JILQRConfig(**cfg_kw), w=jw, bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=F64),
        x_hat0=jnp.asarray(x_hat0), U_init=jnp.asarray(U0), X_ref=jnp.asarray(X_ref),
        U_ref=jnp.asarray(U_ref), block_b=BT, interpret=True,
    )
    return (X, U), (np.asarray(jX), np.asarray(jU))


@pytest.mark.parametrize("out", ["X", "U"])
def test_solve_matches_jax(solve_case, out):
    (X, U), (jX, jU) = solve_case
    port, ref = (X, jX) if out == "X" else (U, jU)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, rtol=RTOL, atol=ATOL)
