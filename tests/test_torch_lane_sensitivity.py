"""The port's lane sensitivity against the JAX package's, in f64 on the CPU.

K3 and K4 (their plain versions) against the Pallas kernels run in interpret mode,
and the whole tube_sensitivity_grads_lanes, on the same numbers: a solved
tracking problem whose references ask for more speed than the bound allows, so
that some controls sit at their bound and the active set is exercised.
Tolerances are the JAX package's own (tests/test_lane_sensitivity.py:97-99).
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
from tube_mpc_tpu.ops.pallas import lane_sensitivity as jsens
from tube_mpc_tpu.ops.pallas import lane_solver as jls
from tube_mpc_tpu.presets import PAPER_OBSTACLES
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem
from tube_mpc_tpu.tube.lane_interface import (
    tube_sensitivity_grads_lanes as j_tube_sensitivity_grads_lanes,
)

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd, sbwd_plain, sfwd, sfwd_plain
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import (
    _build_C,
    _rows,
    _with_barrier_row,
    make_lane_problem,
    tube_ilqr_solve_lanes,
    tube_sensitivity_grads_lanes,
)

F64 = jnp.float64
EPS, BETA = 1e-4, 20.0
B, N = 6, 9
BT = 128           # JAX lane block: B=6 pads to one block of 128 lanes
REG, ACTIVE_TOL = 1e-9, 1e-8
RTOL, ATOL = 1e-9, 1e-11
VMEM = pltpu.VMEM


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _padded(a, const_rows=False):
    """Pad the lane axis to the JAX block; padded const rows are 1 as in the JAX glue."""
    a = jls._pad_lanes(jnp.asarray(np.asarray(a), dtype=F64), BT)
    if const_rows:
        a = a.at[:, B:].set(1.0)
    return a


@pytest.fixture(scope="module")
def case():
    """A solved ancillary tracking problem with per-lane weights; references ask
    for v = 10 and more, so v saturates at its bound on some lanes and steps."""
    kw = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
              centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=BETA)
    pb = make_lane_problem(dubins_components(**kw), eps=EPS)
    j_pb = j_make_lane_problem(j_dubins_components(**kw), eps=EPS)
    rng = np.random.default_rng(7)
    Q = 1.0 + 0.3 * rng.uniform(size=(B, 3))
    R = 0.5 + 0.5 * rng.uniform(size=(B, 2))
    qb = 0.5 + 0.5 * rng.uniform(size=B)
    x0 = np.array([0.0, 0.0, np.pi / 4]) + 0.05 * rng.normal(size=(B, 3))
    x0[2, :2] = [3.3, 2.2]   # one lane starts inside an obstacle
    b0 = rng.uniform(0.1, 1.0, B)
    ks = np.arange(N + 1)
    X_ref = np.broadcast_to(np.stack([0.2 * ks, 0.15 * ks, np.full(N + 1, np.pi / 4)], -1),
                            (B, N + 1, 3)).copy()
    U_ref = np.broadcast_to(np.array([10.0, 0.0]), (B, N, 2)).copy()
    w = CostWeights(Q=_t(Q), R=_t(R), Qf=_t(Q), qb=_t(qb))
    bp = BarrierParams(_t(0.0), _t(0.0), _t(0.0))
    X, U = tube_ilqr_solve_lanes(
        pb, ILQRConfig(max_iter=8, tol=1e-6, reg=1e-6, alphas=(1.0, 0.5, 0.1, 0.0)),
        w=w, bp=bp, x_hat0=_t(np.concatenate([x0, b0[:, None]], axis=1)),
        U_init=torch.zeros((B, N, 2), dtype=torch.float64),
        X_ref=_t(X_ref), U_ref=_t(U_ref), device="cpu",
    )
    at_bound = (U >= 10.0 - ACTIVE_TOL) | (U <= -10.0 + ACTIVE_TOL)
    assert bool(at_bound.any()) and not bool(at_bound.all())
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    Xr_r = _rows(_with_barrier_row(_t(X_ref)))
    return dict(pb=pb, j_pb=j_pb, X=X, U=U, X_ref=X_ref, U_ref=U_ref, Q=Q, R=R, qb=qb,
                w=w, bp=bp, C=C, X_r=_rows(X), U_r=_rows(U), Xr_r=Xr_r, Ur_r=_rows(_t(U_ref)))


def jax_sbwd(pb, U, X, Xr, C, XN, XrN):
    nh, m, nc = pb.n_hat, pb.m, C.shape[0]
    kb_rev = lambda b, k: (N - 1 - k, 0, b)
    fixed = lambda b, k: (0, b)
    call = pl.pallas_call(
        functools.partial(jsens._sbwd_kernel, pb, REG, ACTIVE_TOL, False, False),
        grid=(1, N),
        in_specs=[pl.BlockSpec((1, m, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb_rev, memory_space=VMEM),
                  pl.BlockSpec((nc, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM)],
        out_specs=[pl.BlockSpec((1, m * nh, BT), kb_rev, memory_space=VMEM),
                   pl.BlockSpec((1, m, BT), kb_rev, memory_space=VMEM)],
        out_shape=[jax.ShapeDtypeStruct((N, m * nh, BT), F64),
                   jax.ShapeDtypeStruct((N, m, BT), F64)],
        scratch_shapes=[VMEM((nh * nh, BT), F64), VMEM((nh, BT), F64), VMEM((1, BT), F64)],
        interpret=True,
    )
    K, kff = call(_padded(U), _padded(X), _padded(Xr), _padded(C, True), _padded(XN),
                  _padded(XrN))
    return np.asarray(K)[..., :B], np.asarray(kff)[..., :B]


def jax_sfwd(pb, K, kff, X, Xr, U, Ur, C, XN, XrN):
    nh, m, nc = pb.n_hat, pb.m, C.shape[0]
    kb = lambda b, k: (k, 0, b)
    fixed = lambda b, k: (0, b)
    call = pl.pallas_call(
        functools.partial(jsens._sfwd_kernel, pb, N, False, False),
        grid=(1, N),
        in_specs=[pl.BlockSpec((1, m * nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, nh, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((1, m, BT), kb, memory_space=VMEM),
                  pl.BlockSpec((nc, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM),
                  pl.BlockSpec((nh, BT), fixed, memory_space=VMEM)],
        out_specs=[pl.BlockSpec((nh, BT), fixed, memory_space=VMEM),
                   pl.BlockSpec((m, BT), fixed, memory_space=VMEM)],
        out_shape=[jax.ShapeDtypeStruct((nh, BT), F64), jax.ShapeDtypeStruct((m, BT), F64)],
        scratch_shapes=[VMEM((nh, BT), F64)],
        interpret=True,
    )
    gx, gr = call(_padded(K), _padded(kff), _padded(X), _padded(Xr), _padded(U), _padded(Ur),
                  _padded(C, True), _padded(XN), _padded(XrN))
    return np.asarray(gx)[..., :B], np.asarray(gr)[..., :B]


@pytest.fixture(scope="module")
def k3_case(case):
    X_r, Xr_r, C = case["X_r"], case["Xr_r"], case["C"]
    args = (case["U_r"], X_r[:-1], Xr_r[:-1], C, X_r[-1], Xr_r[-1])
    port = sbwd_plain(case["pb"], REG, ACTIVE_TOL, *args)
    ref = jax_sbwd(case["j_pb"], *(a.numpy() for a in args))
    return args, port, ref


@pytest.mark.parametrize("out", ["K", "kff"])
def test_sbwd_matches_pallas_kernel(k3_case, out):
    _, port, ref = k3_case
    i = ["K", "kff"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_sbwd_zeroes_gains_of_clamped_controls(case, k3_case):
    """Where a control sits within active_tol of its bound, its row of K and its
    kff are exactly zero (identity row and column in the masked Q_uu)."""
    _, (K, kff), _ = k3_case
    U_r = case["U_r"]
    at_bound = (U_r >= 10.0 - ACTIVE_TOL) | (U_r <= -10.0 + ACTIVE_TOL)
    assert bool(at_bound.any())
    K_rows = K.view(N, 2, 4, B)
    assert bool((kff[at_bound] == 0.0).all())
    assert bool((K_rows.permute(0, 1, 3, 2)[at_bound] == 0.0).all())


@pytest.mark.parametrize("out", ["gx", "gr"])
def test_sfwd_matches_pallas_kernel(case, k3_case, out):
    _, (K, kff), _ = k3_case
    X_r, Xr_r = case["X_r"], case["Xr_r"]
    args = (K, kff, X_r[:-1], Xr_r[:-1], case["U_r"], case["Ur_r"], case["C"], X_r[-1], Xr_r[-1])
    port = sfwd_plain(case["pb"], *args)
    ref = jax_sfwd(case["j_pb"], *(a.numpy() for a in args))
    i = ["gx", "gr"].index(out)
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_wrappers_run_plain_versions_on_cpu(case, k3_case):
    args, (K, kff), _ = k3_case
    before = (sbwd.launches, sfwd.launches)
    K2, kff2 = sbwd(case["pb"], REG, ACTIVE_TOL, *args)
    X_r, Xr_r = case["X_r"], case["Xr_r"]
    sfwd(case["pb"], K2, kff2, X_r[:-1], Xr_r[:-1], case["U_r"], case["Ur_r"], case["C"],
         X_r[-1], Xr_r[-1])
    assert (sbwd.launches, sfwd.launches) == before  # plain versions are not kernel launches
    np.testing.assert_array_equal(K2.numpy(), K.numpy())
    np.testing.assert_array_equal(kff2.numpy(), kff.numpy())


@pytest.fixture(scope="module")
def grads_case(case):
    port = tube_sensitivity_grads_lanes(
        case["pb"], w=case["w"], bp=case["bp"], X_hat=case["X"], U=case["U"],
        X_ref=_t(case["X_ref"]), U_ref=_t(case["U_ref"]), reg=REG, active_tol=ACTIVE_TOL,
        device="cpu",
    )
    j = lambda a: jnp.asarray(np.asarray(a), dtype=F64)
    ref = j_tube_sensitivity_grads_lanes(
        case["j_pb"], w=JCostWeights(Q=j(case["Q"]), R=j(case["R"]), Qf=j(case["Q"]),
                                     qb=j(case["qb"])),
        bp=JBarrierParams.create(0.0, 0.0, 0.0, dtype=F64),
        X_hat=j(case["X"]), U=j(case["U"]), X_ref=j(case["X_ref"]), U_ref=j(case["U_ref"]),
        reg=REG, active_tol=ACTIVE_TOL, block_b=BT, interpret=True,
    )
    return port, ref


@pytest.mark.parametrize("field", ["Q", "R", "qb"])
def test_sensitivity_grads_match_jax(grads_case, field):
    port, ref = grads_case
    p, r = getattr(port, field), np.asarray(getattr(ref, field))
    assert tuple(p.shape) == r.shape
    np.testing.assert_allclose(p.numpy(), r, rtol=RTOL, atol=ATOL)
