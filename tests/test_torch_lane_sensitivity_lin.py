"""K3/K5's phase A in the port: the rows of every step of the backward δz sweep at once.

_sbwd_sweep (sbwd_plain, sbwd_upper_plain) first forms the rows of all N steps over
[N, B] (sbwd_lin_plain): f̂'s Jacobians A, Bm, the upper gradient g_x and g_u before the
carry's scale, and the active-set mask; then it runs the recursion, as the CUDA kernel
does. The batched rows are held at every k against the same rows formed step by step
(rtol 1e-15, as tests/test_torch_lane_solver_lin.py: the same operations; PyTorch's CPU
kernels may round a transcendental differently by the length of the row), for the tube
loss's upper gradient and for caller-supplied rows, and A, Bm against the JAX package's
jac_rows at tests/test_torch_math.py's tolerances, with per-lane barrier parameters,
lanes inside obstacles, headings all round and controls at their bounds, in f64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import augmented_step_fn as j_augmented_step_fn
from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.ops.lanes import jac_rows as j_jac_rows
from tube_mpc_tpu.presets import PAPER_OBSTACLES

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_lin_plain
from tube_mpc_tpu_torch.ops.cuda.lane_solver import _bp_from_C
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components, jac_rows
from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem

EPS, BETA = 1e-4, 20.0
B, N = 16, 7
NH, M = 4, 2
ACTIVE_TOL = 1e-8
V_MAX, OMEGA_MAX = 10.0, float(np.pi)
ROWS = ("A", "Bm", "g_x", "g_u", "am")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def case():
    kw = dict(dt=0.01, v_min=-V_MAX, v_max=V_MAX, omega_max=OMEGA_MAX, centers=PAPER_OBSTACLES,
              radii=[1.0] * 5, aggregation="smoothmin", beta=BETA)
    pb = make_lane_problem(dubins_components(**kw), eps=EPS)
    rng = np.random.default_rng(37)
    X = np.stack([rng.uniform(0.0, 10.0, (N, B)), rng.uniform(0.0, 10.0, (N, B)),
                  rng.uniform(-np.pi, np.pi, (N, B)), rng.uniform(0.0, 3.0, (N, B))], axis=1)
    X[:, :2, :4] = np.array([[4.3, 2.1, 6.0, 8.5], [2.2, 4.1, 6.4, 4.0]])  # inside obstacles
    U = np.stack([rng.uniform(-V_MAX, V_MAX, (N, B)), rng.uniform(-OMEGA_MAX, OMEGA_MAX, (N, B))],
                 axis=1)
    U[:, 0, 4:6] = [V_MAX, -V_MAX]                    # at a bound
    U[:, 1, 6:8] = [OMEGA_MAX - 0.5 * ACTIVE_TOL, -OMEGA_MAX]   # within active_tol of one
    Xr = X + rng.normal(size=X.shape)
    bp = BarrierParams(*(_t(v) for v in (rng.uniform(0.0, 0.2, B), rng.uniform(-0.5, 0.5, B),
                                          rng.uniform(0.0, 0.1, B))))
    w = CostWeights(Q=_t(rng.uniform(0.5, 2.0, (B, 3))), R=_t(rng.uniform(0.5, 2.0, (B, 2))),
                    Qf=_t(rng.uniform(10.0, 100.0, (B, 3))), qb=_t(rng.uniform(0.2, 1.0, B)))
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X, U, Xr = map(_t, (X, U, Xr))
    gX, gU = _t(rng.normal(size=(N, NH, B))), _t(rng.normal(size=(N, M, B)))
    names = ("A", "Bm", "g_x", "g_u", "am")
    tube = dict(zip(names, sbwd_lin_plain(pb, ACTIVE_TOL, U, X, C, 2.0 * (X - Xr))))
    upper = dict(zip(names, sbwd_lin_plain(pb, ACTIVE_TOL, U, X, C, gX, gU)))
    return dict(pb=pb, X=X, U=U, Xr=Xr, C=C, gX=gX, gU=gU, tube=tube, upper=upper,
                j_sys_c=j_dubins_components(**kw))


def _entries(rows, name):
    """(index, row) of every entry of one block of rows: A[i][j], Bm[i][a], else [i]."""
    if name in ("A", "Bm"):
        return [((i, j), r) for i, line in enumerate(rows) for j, r in enumerate(line)]
    return [((i,), r) for i, r in enumerate(rows)]


def _port_step(d, k, upper):
    """The rows of step k formed step by step, as the sweep did before its two phases."""
    pb, X, U = d["pb"], d["X"], d["U"]
    xs = tuple(X[k, i] for i in range(NH))
    us = tuple(U[k, a] for a in range(M))
    _, tangent = pb.f_hat_lin(xs, us, _bp_from_C(pb, d["C"]))
    A, Bm = jac_rows(tangent, NH, M, xs[0])
    if upper:
        g_x = [d["gX"][k, i] for i in range(NH)]
        g_u = [d["gU"][k, a] for a in range(M)]
    else:
        g_x = [2.0 * (xs[i] - d["Xr"][k, i]) for i in range(NH)]
        g_u = None
    zero = torch.zeros_like(us[0])
    am = [torch.where((us[a] <= pb.u_min[a] + ACTIVE_TOL) | (us[a] >= pb.u_max[a] - ACTIVE_TOL),
                      zero, torch.ones_like(zero)) for a in range(M)]
    return dict(A=A, Bm=Bm, g_x=g_x, g_u=g_u, am=am)


@pytest.mark.parametrize("name", ROWS)
def test_batched_rows_match_per_step_rows(case, name):
    for variant in ("tube", "upper"):
        rows = case[variant][name]
        if name == "g_u" and variant == "tube":
            assert rows is None   # the tube loss has g_u = 0
            continue
        got = _entries(rows, name)
        assert all(tuple(r.shape) == (N, B) for _, r in got)
        for k in range(N):
            ref = dict(_entries(_port_step(case, k, variant == "upper")[name], name))
            for idx, r in got:
                np.testing.assert_allclose(r[k].numpy(), ref[idx].numpy(), rtol=1e-15, atol=0.0,
                                           err_msg=f"{variant} {name}{list(idx)} at k={k}")


def test_mask_eliminates_exactly_the_controls_at_a_bound(case):
    """am is 0 where a control lies within active_tol of its bound and 1 elsewhere, and
    the case has both."""
    U = case["U"]
    for a, lim in enumerate((V_MAX, OMEGA_MAX)):
        at = (U[:, a] >= lim - ACTIVE_TOL) | (U[:, a] <= -lim + ACTIVE_TOL)
        assert bool(at.any()) and not bool(at.all())
        np.testing.assert_array_equal(case["tube"]["am"][a].numpy(), (~at).double().numpy())


@pytest.mark.parametrize("name", ["A", "Bm"])
def test_batched_rows_match_jax_jac_rows(case, name):
    j_f_hat = j_augmented_step_fn(case["j_sys_c"], eps=EPS)
    C = case["C"].numpy()
    j_bp = JBarrierParams(*(jnp.asarray(C[r]) for r in (10, 11, 12)))
    got = _entries(case["tube"][name], name)
    for k in range(N):
        A_ref, B_ref = j_jac_rows(lambda x, u: j_f_hat(x, u, j_bp),
                                  tuple(jnp.asarray(case["X"][k, i].numpy()) for i in range(NH)),
                                  tuple(jnp.asarray(case["U"][k, a].numpy()) for a in range(M)))
        ref = A_ref if name == "A" else B_ref
        for (i, j), r in got:
            np.testing.assert_allclose(r[k].numpy(), np.asarray(ref[i][j]), rtol=1e-9, atol=1e-12,
                                       err_msg=f"{name}[{i}][{j}] at k={k}")
