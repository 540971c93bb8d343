"""The premises of the cart-pole's K3/K5 (csrc/lane_sbwd.cu: CARTPOLE_LIT, CARTPOLE_COLS).

Its step x+ = [pos + dt vel, vel + dt x_acc, th + dt om, om + dt th_acc] gives f̂'s
Jacobians, formed by basis tangents as phase A forms them (the plain version's
jac_lin_plain), with

- rows 0 and 2 the literals 1, dt and +0 (1 at column i, dt at column i + 1) at any state
  and control, inf and NaN included, for every finite dt but -0: the kernels take them as
  literals and store rows 1, 3 and 4 only;
- rows 1 and 3 of columns 0, 1 and 4 (pos, vel, b) exactly 1 at (1, 1) and +0 elsewhere
  wherever the step's eleven Lin fields (CartPoleStep::Lin) are finite: along those
  columns every term of the acceleration rows is a product with a literal 0, and dx_i +
  dt (±0) is dx_i with +0 for 0 + (-0). Phase A writes those literals behind a warp's vote
  on the fields;
- a non-finite θ or ω breaks the second premise (the rows are NaN there), which is why
  the vote exists.

Held in f64 and f32 on inputs drawn by numpy from a seed, with both barriers, and the
plain K3 against the JAX package's _sbwd_kernel in interpret mode, also on lanes with a
non-finite ω. The kernels refuse constants for which the literals would differ:
tube_mpc_tpu_torch/ops/cuda/lane_solver.py::kernel_consts.
"""
import math

import numpy as np
import pytest
import torch

from tube_mpc_tpu_torch.ops import lanes
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain
from tube_mpc_tpu_torch.ops.cuda.lane_solver import jac_lin_plain, kernel_consts
from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

from torch_family_cases import jax_sbwd, kernel_inputs, problems

N, B, NX, M = 4, 40, 4, 1
NH = NX + 1
DTYPES = {"f64": torch.float64, "f32": torch.float32}
DTS = (0.02, 0.05, 1e-3, 1e-50, -0.03)   # cartpole.yaml's 0.02; 1e-50 is +0 in f32
BARRIERS = ("inverse", "log")
STATES = ("finite", "inf", "nan")
GUARDED = (0, 1, NX)                      # pos, vel and b: CARTPOLE_COLS' columns
CONSTS = dict(m_cart=1.0, m_pole=0.1, length=0.5, gravity=9.81)


def problem(dt=0.02, barrier="inverse", **consts):
    sys_c = lanes.cartpole_components(dt=dt, **{**CONSTS, **consts})
    return make_lane_problem(sys_c, barrier_type=barrier, eps=1e-4)


def inputs(dtype, states, seed=0, cols=(0, 1, NX)):
    """X [N, n̂, B], U [N, m, B], C [2n̂+m+3, B] from numpy's generator; with `states`
    "inf" or "nan" a third of the lanes carry it in one component of `cols` (x̂'s), and
    lane 1 in all of them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, NH, B)) * np.array([1.5, 2.0, 1.0, 3.0, 0.5])[None, :, None]
    U = rng.normal(size=(N, M, B)) * 8.0
    if states != "finite":
        v = np.inf if states == "inf" else np.nan
        for lane in range(0, B, 3):
            X[:, cols[lane % len(cols)], lane] = v if lane % 2 else -v
        X[:, list(cols), 1] = v
    C = rng.uniform(0.1, 2.0, size=(2 * NH + M + 3, B))
    C[2 * NH + M] = rng.uniform(0.0, 0.2, B)        # alpha
    C[2 * NH + M + 1] = rng.uniform(0.0, 0.5, B)    # gamma
    C[2 * NH + M + 2] = rng.uniform(0.0, 0.05, B)   # tight
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return t(X), t(U), t(C)


def lin_fields(X, U):
    """The eleven fields of CartPoleStep::Lin at every step and lane, by the plain
    version's operations (ops/lanes.py::cartpole_components)."""
    tm, mpl = CONSTS["m_cart"] + CONSTS["m_pole"], CONSTS["m_pole"] * CONSTS["length"]
    th, om, force = X[:, 2], X[:, 3], U[:, 0]
    div = lambda x, c: x / torch.full_like(x, c)
    s, c = torch.sin(th), torch.cos(th)
    p1 = mpl * om
    p2 = p1 * om
    temp = div(force + p2 * s, tm)
    nt = CONSTS["gravity"] * s - c * temp
    q1 = CONSTS["m_pole"] * c
    den = CONSTS["length"] * (4.0 / 3.0 - div(q1 * c, tm))
    r1 = mpl * (nt / den)
    inv_den2 = 1.0 / (den * den)
    return (s, c, om, p1, p2, temp, q1, nt, den, inv_den2, r1)


def column(A, Bm, i, c):
    return A[i][c] if c < NH else Bm[i][c - NH]


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def literal(i, c, dt, like):
    """lane_sbwd.cu's cartpole_lit (rows 0 and 2) and cartpole_col's rows 1 and 3 of the
    guarded columns: T(1), T(dt) or T(+0)."""
    if i in (0, 2):
        v = 1.0 if c == i else dt if c == i + 1 else 0.0
    else:
        v = 1.0 if (i, c) == (1, 1) else 0.0
    return torch.full_like(like, v)


@pytest.mark.parametrize("states", STATES)
@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("barrier", BARRIERS)
@pytest.mark.parametrize("dname", DTYPES)
def test_rows_0_and_2_are_the_literals(dname, barrier, dt, states):
    """jac_lin_plain's rows 0 and 2 of A and Bm equal T(1), T(dt) and T(+0) bit for bit at
    every step and lane, whatever the state and control (inf and NaN in θ, ω and the
    force too)."""
    X, U, C = inputs(DTYPES[dname], states, cols=(0, 2, 3))
    if states != "finite":
        U[:, 0, 2::5] = float(states)
    A, Bm = jac_lin_plain(problem(dt, barrier), X, U, C)
    for i in (0, 2):
        for c in range(NH + M):
            row = column(A, Bm, i, c)
            assert torch.equal(bits(row), bits(literal(i, c, dt, row))), (i, c, row.flatten()[:4])


@pytest.mark.parametrize("states", STATES)
@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("barrier", BARRIERS)
@pytest.mark.parametrize("dname", DTYPES)
def test_guarded_columns_are_the_literals_where_the_step_is_finite(dname, barrier, dt, states):
    """Rows 1 and 3 of columns 0, 1 and 4 are exactly 1 at (1, 1) and +0 (its sign bit
    clear: torch.signbit) elsewhere, at every (step, lane) whose Lin fields are all finite,
    here every one: pos, vel and b, which the fields do not read, carry the inf and NaN."""
    X, U, C = inputs(DTYPES[dname], states, seed=1)
    fields = lin_fields(X, U)
    finite = torch.stack([torch.isfinite(f) for f in fields]).all(0)
    assert finite.all()
    A, Bm = jac_lin_plain(problem(dt, barrier), X, U, C)
    for i in (1, 3):
        for c in GUARDED:
            row = column(A, Bm, i, c)
            want = literal(i, c, dt, row)
            assert torch.equal(bits(row), bits(want)), (i, c, row.flatten()[:4])
            assert not torch.signbit(row).any()


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("which", ("theta", "omega"))
def test_a_non_finite_theta_or_omega_breaks_the_guarded_columns(dname, which):
    """Where θ or ω is not finite (a Lin field is not), rows 1 and 3 of the guarded columns
    are NaN, not the literals: the kernel votes on the fields and sends such a warp down
    fhat_tan. Lanes whose fields are finite keep the literals beside them."""
    X, U, C = inputs(DTYPES[dname], "finite", seed=2)
    bad = torch.zeros((N, B), dtype=torch.bool)
    bad[:, 3:B:4] = True
    vals = torch.tensor([math.inf, -math.inf, math.nan], dtype=X.dtype)
    X[:, 2 if which == "theta" else 3][bad] = vals.repeat(int(bad.sum()))[:int(bad.sum())]
    fields = lin_fields(X, U)
    finite = torch.stack([torch.isfinite(f) for f in fields]).all(0)
    assert torch.equal(~finite, bad)
    A, Bm = jac_lin_plain(problem(), X, U, C)
    for i in (1, 3):
        for c in GUARDED:
            row = column(A, Bm, i, c)
            assert torch.isnan(row[bad]).all(), (i, c)
            want = literal(i, c, 0.02, row)
            assert torch.equal(bits(row[~bad]), bits(want[~bad])), (i, c)


@pytest.mark.parametrize("bad", (None, "omega"))
def test_plain_k3_matches_the_jax_kernel(bad):
    """The plain K3 (sbwd_plain, whose phase A the kernel's literals equal) against the JAX
    package's _sbwd_kernel in interpret mode at rtol 1e-9, f64, on realistic inputs; with
    "omega", one lane's ω is inf at one step, so its gains are NaN up to that step in
    both."""
    pb, j_pb, _ = problems("cartpole")
    d = kernel_inputs("cartpole", seed=23, N=6, B=3)
    X, Xr = d["X"].clone(), d["Xr"]
    if bad:
        X[3, 3, 2] = math.inf
    args = (d["U"], X[:-1], Xr[:-1], d["C"], X[-1], Xr[-1])
    port = sbwd_plain(pb, 1e-9, 1e-8, *args)
    ref = jax_sbwd(j_pb, 1e-9, 1e-8, *(a.numpy() for a in args))
    for mine, theirs in zip(port, ref):
        assert np.array_equal(np.isfinite(mine.numpy()), np.isfinite(theirs))
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-9, atol=1e-11)
    if bad:   # lane 2's gains at that step are not finite, the other lanes' are
        assert not np.isfinite(port[0].numpy()[3, :, 2]).all()
        assert np.isfinite(port[0].numpy()[:, :, :2]).all()


@pytest.mark.parametrize("const, value", [
    ("dt", math.inf), ("dt", math.nan), ("dt", -0.0), ("gravity", math.inf),
    ("m_pole", math.nan), ("length", math.inf), ("m_cart", -math.inf)])
def test_kernel_constants_refuse_constants_without_the_literals(const, value):
    """A constant that is not finite (or a dt of -0: 0 + dt * 1 is +0) gives other rows,
    so the kernels' constants refuse it; the configs' constants pass."""
    with pytest.raises(ValueError, match="finite constants"):
        kernel_consts(problem(**{const: value}))
    k = kernel_consts(problem())
    assert (k.dt, k.gravity, k.total_m) == (0.02, 9.81, 1.1)
