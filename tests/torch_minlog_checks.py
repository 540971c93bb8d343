"""The lane kernels' plain versions on a configuration with the exact-min aggregation or
the log barrier (tests/torch_minlog_cases.py) against the JAX package's Pallas kernels in
interpret mode, and the whole solve and sensitivity, in f64 on the CPU: the tests of
tests/test_torch_minlog_solver_<case>.py (K1, K2, the solve) and
tests/test_torch_minlog_sensitivity_<case>.py (K3-K6, the gradients), each of which names
its case with a fixture ``minlog`` (files of their own, so that the test workers spread
them).

The inputs (torch_minlog_cases.kernel_inputs) start one lane on the bisector of two
obstacles, where the min chain ties, and one inside an obstacle or past the track
limit, where h - tight < eps and the log barrier's tangent is 0; both are counted, and a
count of 0 fails. Tolerances: K1, K2 and the solve at the JAX package's rtol 1e-12,
atol 1e-13 (tests/test_lane_solver.py:111-119); K3-K6 and the sensitivity at rtol 1e-9,
atol 1e-11 (tests/test_lane_sensitivity.py:97-99).
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
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import (
    sbwd_plain, sbwd_upper_plain, sfwd_plain,
)
from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric_plain
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import (
    tube_ilqr_solve_lanes,
    tube_sensitivity_grads_lanes,
)

from torch_family_cases import jax_fwd, jax_ric, jax_sbwd, jax_sfwd
from torch_family_generic_checks import jax_sbwd_generic, jax_sfwd_generic
from torch_minlog_cases import branch_counts, kernel_inputs, problems, t64

F64 = jnp.float64
N, B = 6, 3     # the shapes of torch_family_generic_checks' JAX kernels
REG_SENS, ACTIVE_TOL = 1e-9, 1e-8
SOLVER_TOL = (1e-12, 1e-13)
SENS_TOL = (1e-9, 1e-11)
SBWD_OUTS = ["K", "kff", "tVx", "Vxx", "LogS"]
SFWD_OUTS = ["gx", "gr", "gxt", "gdyn", "gxr", "gur", "gxrN"]


@pytest.fixture(scope="module")
def case(minlog):
    pb, j_pb, s = problems(minlog)
    d = kernel_inputs(minlog, seed=11, N=N, B=B)
    X, Xr = d["X"], d["Xr"]
    rng = np.random.default_rng(23)
    nh, m = pb.n_hat, pb.m
    return dict(pb=pb, j_pb=j_pb, s=s, d=d,
                bwd=(d["U"], X[:-1], Xr[:-1], d["C"], X[-1], Xr[-1]),
                upper=(t64(rng.normal(size=(N, nh, B))), t64(rng.normal(size=(N, m, B))),
                       t64(rng.normal(size=(nh, B)))))


def test_inputs_take_the_branches(case):
    """A lane starts on the min chain's tie (where the library takes the min), and a
    lane has h - tight < eps (where it takes the log barrier)."""
    pb, d = case["pb"], case["d"]
    ties, below = branch_counts(pb, d["X"], d["C"])
    if pb.spec.centers and pb.spec.aggregation == "min":
        assert ties > 0
    if pb.barrier_type == "log":
        assert below > 0


def close(port, ref, tol):
    assert tuple(port.shape) == np.shape(ref) and np.isfinite(ref).all()
    np.testing.assert_allclose(port.numpy(), ref, rtol=tol[0], atol=tol[1])


@pytest.fixture(scope="module")
def k1(case):
    pb, d = case["pb"], case["d"]
    X, C, nh, m = d["X"], d["C"], pb.n_hat, pb.m
    phix = C[nh + m:2 * nh + m] * (X[-1] - d["Xr"][-1])
    args = (X[:-1], d["U"], d["Xr"][:-1], d["Ur"], C, phix)
    return ric_plain(pb, 1e-3, *args), jax_ric(case["j_pb"], 1e-3, *(a.numpy() for a in args))


@pytest.mark.parametrize("out", ["K", "kff"])
def test_ric_matches_pallas_kernel(k1, out):
    i = ["K", "kff"].index(out)
    close(k1[0][i], k1[1][i], SOLVER_TOL)


@pytest.fixture(scope="module")
def k2(case, k1):
    d, pb, s = case["d"], case["pb"], case["s"]
    args = (d["x_hat0"], d["X"][:-1], d["U"], k1[0][0], k1[0][1], d["Xr"][:-1], d["Xr"][-1],
            d["Ur"], d["C"])
    return (fwd_plain(pb, s.cfg.alphas, *args),
            jax_fwd(case["j_pb"], s.cfg.alphas, *(a.numpy() for a in args)))


@pytest.mark.parametrize("out", ["X", "U", "cost"])
def test_fwd_matches_pallas_kernel(k2, out):
    i = ["X", "U", "cost"].index(out)
    close(k2[0][i], k2[1][i], SOLVER_TOL)


def _solve_inputs(case):
    """Goal tracking of the target with the nominal weights and alphas, from the kernel
    inputs' starts (one on the tie, one past the safe set's edge): (the inputs as numpy,
    the solver's settings)."""
    pb, s = case["pb"], case["s"]
    rng = np.random.default_rng(5)
    n, m = pb.n, pb.m
    x_hat0 = case["d"]["x_hat0"].numpy().T.copy()
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
    close(solved[0][i], solved[1][i], SOLVER_TOL)


@pytest.fixture(scope="module")
def k3(case):
    args = case["bwd"]
    return (sbwd_plain(case["pb"], REG_SENS, ACTIVE_TOL, *args),
            jax_sbwd(case["j_pb"], REG_SENS, ACTIVE_TOL, *(a.numpy() for a in args)))


@pytest.mark.parametrize("out", ["K", "kff"])
def test_sbwd_matches_pallas_kernel(k3, out):
    i = ["K", "kff"].index(out)
    close(k3[0][i], k3[1][i], SENS_TOL)


@pytest.fixture(scope="module")
def k4(case, k3):
    d = case["d"]
    K, kff = k3[0]
    X, Xr = d["X"], d["Xr"]
    args = (K, kff, X[:-1], Xr[:-1], d["U"], d["Ur"], d["C"], X[-1], Xr[-1])
    return sfwd_plain(case["pb"], *args), jax_sfwd(case["j_pb"], *(a.numpy() for a in args))


@pytest.mark.parametrize("out", ["gx", "gr"])
def test_sfwd_matches_pallas_kernel(k4, out):
    i = ["gx", "gr"].index(out)
    close(k4[0][i], k4[1][i], SENS_TOL)


@pytest.fixture(scope="module")
def k5(case):
    """{variant: (port outputs, JAX outputs)} of K5 generic and K5 with upper rows."""
    pb, bwd, upper = case["pb"], case["bwd"], case["upper"]
    U, X, _, C, _, _ = bwd
    np_bwd = [a.numpy() for a in bwd]
    return {
        "generic": (sbwd_plain(pb, REG_SENS, ACTIVE_TOL, *bwd, generic=True),
                    jax_sbwd_generic(case["j_pb"], *np_bwd)),
        "upper": (sbwd_upper_plain(pb, REG_SENS, ACTIVE_TOL, *upper, U, X, C),
                  jax_sbwd_generic(case["j_pb"], *np_bwd, upper=[u.numpy() for u in upper])),
    }


@pytest.mark.parametrize("variant", ["generic", "upper"])
@pytest.mark.parametrize("out", SBWD_OUTS)
def test_k5_matches_pallas_kernel(k5, variant, out):
    port, ref = k5[variant]
    i = SBWD_OUTS.index(out)
    close(port[i], ref[i], SENS_TOL)


@pytest.fixture(scope="module")
def k6(case, k5):
    """{variant: (port outputs, JAX outputs)} of K6 generic (on the upper sweep's gains
    and carry) and K6 with the reference cotangents (on the generic sweep's)."""
    pb, d = case["pb"], case["d"]
    X, Xr = d["X"], d["Xr"]
    out = {}
    for variant, sweep, emit in (("generic", "upper", False), ("ref", "generic", True)):
        K, kff, tVx, Vxx, LogS = k5[sweep][0]
        args = (K, kff, X[:-1], Xr[:-1], d["U"], d["Ur"], d["C"], X[-1], Xr[-1])
        port = sfwd_plain(pb, *args, value=(tVx, Vxx, LogS), emit_ref_grads=emit)
        ref = jax_sfwd_generic(case["j_pb"], *(a.numpy() for a in args + (tVx, Vxx, LogS)),
                               emit=emit)
        out[variant] = (port, ref)
    return out


@pytest.mark.parametrize("variant,out", [("generic", o) for o in SFWD_OUTS[:4]]
                         + [("ref", o) for o in SFWD_OUTS])
def test_k6_matches_pallas_kernel(k6, variant, out):
    port, ref = k6[variant]
    i = SFWD_OUTS.index(out)
    assert len(port) == len(ref)
    close(port[i], ref[i], SENS_TOL)


def test_k6_dynamics_terms(case, k6):
    """The γ and tightening rows of gdyn are not zero on some lane; the α row is an
    exact 0 with the log barrier, whose value does not depend on α, else not zero."""
    for variant in ("generic", "ref"):
        gdyn = k6[variant][0][3]
        assert bool((gdyn[1:].abs().amax(dim=1) > 0).all()), variant
        if case["pb"].barrier_type == "log":
            assert bool((gdyn[0] == 0.0).all()), variant
        else:
            assert float(gdyn[0].abs().max()) > 0, variant


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
    close(getattr(port, out), np.asarray(getattr(ref, out)), SENS_TOL)
