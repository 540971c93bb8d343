"""K1's phase A in the port: the linearisation of every step at once.

ric_plain first linearises all N steps in one call of f_hat_lin/jac_rows over
[N, B] rows (ric_lin_plain), then runs the recursion, as the CUDA kernel does. The
batched rows are held at every k against the port's per-step jac_rows (rtol 1e-15:
the same operations; PyTorch's CPU kernels may round a transcendental differently
by the length of the row) and against the JAX package's jac_rows at
tests/test_torch_math.py's tolerances, with per-lane barrier parameters, lanes
inside obstacles and headings all round, in f64.
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
from tube_mpc_tpu_torch.ops.cuda.lane_solver import _bp_from_C, ric_lin_plain
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components, jac_rows
from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem

EPS, BETA = 1e-4, 20.0
B, N = 16, 7
NH, M = 4, 2
ROWS = ("A", "Bm", "lx", "lu")


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _components():
    kw = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
              centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=BETA)
    return dubins_components(**kw), j_dubins_components(**kw)


@pytest.fixture(scope="module")
def case():
    sys_c, j_sys_c = _components()
    pb = make_lane_problem(sys_c, eps=EPS)
    rng = np.random.default_rng(31)
    X = np.stack([rng.uniform(0.0, 10.0, (N, B)), rng.uniform(0.0, 10.0, (N, B)),
                  rng.uniform(-np.pi, np.pi, (N, B)), rng.uniform(0.0, 3.0, (N, B))], axis=1)
    X[:, :2, :4] = np.array([[4.3, 2.1, 6.0, 8.5], [2.2, 4.1, 6.4, 4.0]])  # inside obstacles
    U = np.stack([rng.uniform(-10.0, 10.0, (N, B)), rng.uniform(-np.pi, np.pi, (N, B))], axis=1)
    Xr = X + rng.normal(size=X.shape)
    Ur = U + rng.normal(size=U.shape)
    bp = BarrierParams(*(_t(v) for v in (rng.uniform(0.0, 0.2, B), rng.uniform(-0.5, 0.5, B),
                                          rng.uniform(0.0, 0.1, B))))
    w = CostWeights(Q=_t(rng.uniform(0.5, 2.0, (B, 3))), R=_t(rng.uniform(0.5, 2.0, (B, 2))),
                    Qf=_t(rng.uniform(10.0, 100.0, (B, 3))), qb=_t(rng.uniform(0.2, 1.0, B)))
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X, U, Xr, Ur = map(_t, (X, U, Xr, Ur))
    batched = dict(zip(ROWS, ric_lin_plain(pb, X, U, Xr, Ur, C)))
    return dict(pb=pb, j_sys_c=j_sys_c, X=X, U=U, Xr=Xr, Ur=Ur, C=C, batched=batched)


def _entries(rows, name):
    """(index, row) of every entry of one block of rows: A[i][j], Bm[i][a], lx[i], lu[a]."""
    if name in ("A", "Bm"):
        return [((i, j), r) for i, line in enumerate(rows) for j, r in enumerate(line)]
    return [((i,), r) for i, r in enumerate(rows)]


def _port_step(d, k):
    """The port's per-step linearisation at step k, as ric_plain did it step by step."""
    pb, X, U, C = d["pb"], d["X"], d["U"], d["C"]
    xs = tuple(X[k, i] for i in range(NH))
    us = tuple(U[k, a] for a in range(M))
    _, tangent = pb.f_hat_lin(xs, us, _bp_from_C(pb, C))
    A, Bm = jac_rows(tangent, NH, M, xs[0])
    lx = [C[i] * (xs[i] - d["Xr"][k, i]) for i in range(NH)]
    lu = [C[NH + a] * (us[a] - d["Ur"][k, a]) for a in range(M)]
    return dict(A=A, Bm=Bm, lx=lx, lu=lu)


@pytest.mark.parametrize("name", ROWS)
def test_batched_rows_match_per_step_rows(case, name):
    got = _entries(case["batched"][name], name)
    assert all(tuple(r.shape) == (N, B) for _, r in got)
    for k in range(N):
        ref = dict(_entries(_port_step(case, k)[name], name))
        for idx, r in got:
            np.testing.assert_allclose(r[k].numpy(), ref[idx].numpy(), rtol=1e-15, atol=0.0,
                                       err_msg=f"{name}{list(idx)} at k={k}")


@pytest.mark.parametrize("name", ["A", "Bm"])
def test_batched_rows_match_jax_jac_rows(case, name):
    j_f_hat = j_augmented_step_fn(case["j_sys_c"], eps=EPS)
    C = case["C"].numpy()
    j_bp = JBarrierParams(*(jnp.asarray(C[r]) for r in (10, 11, 12)))
    got = _entries(case["batched"][name], name)
    for k in range(N):
        A_ref, B_ref = j_jac_rows(lambda x, u: j_f_hat(x, u, j_bp),
                                  tuple(jnp.asarray(case["X"][k, i].numpy()) for i in range(NH)),
                                  tuple(jnp.asarray(case["U"][k, a].numpy()) for a in range(M)))
        ref = A_ref if name == "A" else B_ref
        for (i, j), r in got:
            np.testing.assert_allclose(r[k].numpy(), np.asarray(ref[i][j]), rtol=1e-9, atol=1e-12,
                                       err_msg=f"{name}[{i}][{j}] at k={k}")
