"""The premise of the double integrator's K1 and K3/K5 (csrc/lane_common.cuh, LINEAR): its
step x+ = [px + dt vx, py + dt vy, vx + dt ax, vy + dt ay] has a tangent that does not
depend on the point, so rows 0..3 of f̂'s Jacobians, formed by basis tangents as phase A
forms them (the plain version's jac_lin_plain, lane_solver.cu::lin_step), are the
constants 0, 1 and dt bit for bit: 1 on the diagonal, dt from v into p and from a into v,
+0 elsewhere. The kernels take those rows as literals and store only the barrier row.

Held in f64 and f32, at random finite states and controls and at states and controls with
inf and NaN entries, for several dt (a dt that rounds to +0 in f32 too, and a negative
one), and against JAX's jac_rows of the JAX package's augmented step on the same inputs.
The kernels refuse a dt that gives other rows (not finite, or -0):
tube_mpc_tpu_torch/ops/cuda/lane_solver.py::kernel_consts. Their phase A also forms the
balanced-equality factors of the min chain and of the barriers by select, the premise of
which (the four quotients are exact) is held last.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import augmented_step_fn as j_augmented_step_fn
from tube_mpc_tpu.ops.lanes import double_integrator_components as j_di_components
from tube_mpc_tpu.ops.lanes import jac_rows as j_jac_rows

from tube_mpc_tpu_torch.ops import lanes
from tube_mpc_tpu_torch.ops.cuda.lane_solver import jac_lin_plain, kernel_consts
from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

N, B, NX, M = 3, 24, 4, 2
CENTERS, RADII = ((4.0, 4.0), (1.0, 1.5)), (1.0, 0.5)
DTYPES = {"f64": torch.float64, "f32": torch.float32}
DTS = (0.05, 0.01, 0.1, 1e-3, 1e-50, -0.05)   # configs' 0.05; 1e-50 is +0 in f32
STATES = ("finite", "inf", "nan")


def tan_kind(i, c):
    """lane_common.cuh's DoubleIntegratorStep::tan_kind: 1 on the diagonal, 2 (dt) from v
    into p (column i + 2 of x̂) and from a into v (column n̂ + i - 2, a control), else 0."""
    if c == i:
        return 1
    if (i < 2 and c == i + 2) or (i >= 2 and c == NX + 1 + (i - 2)):
        return 2
    return 0


def inputs(dtype, states, seed=0):
    """X [N, n̂, B], U [N, m, B], C [2n̂+m+3, B]: random, and with `states` "inf" or "nan"
    a third of the lanes' states and controls set to it, one component each, and a few
    whole lanes."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, NX + 1, B)) * 3.0
    U = rng.normal(size=(N, M, B)) * 2.0
    if states != "finite":
        v = np.inf if states == "inf" else np.nan
        for lane in range(0, B, 3):
            X[:, lane % (NX + 1), lane] = v if lane % 2 else -v
            U[:, lane % M, lane] = v
        X[:, :, 1], U[:, :, 1] = v, v
    C = rng.uniform(0.1, 2.0, size=(2 * (NX + 1) + M + 3, B))
    C[2 * (NX + 1) + M] = rng.uniform(0.0, 0.2, B)    # alpha
    C[2 * (NX + 1) + M + 1] = rng.uniform(0.0, 0.5, B)  # gamma
    C[2 * (NX + 1) + M + 2] = rng.uniform(0.0, 0.05, B)  # tight
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return t(X), t(U), t(C)


def problem(dt):
    sys_c = lanes.double_integrator_components(dt=dt, a_max=2.0, centers=CENTERS, radii=RADII)
    return make_lane_problem(sys_c, eps=1e-4)


def constant(kind, dt, like):
    """The literal a kernel takes for tan_kind `kind`: T(0), T(1) or T(dt)."""
    return torch.full_like(like, (0.0, 1.0, dt)[kind])


def bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("states", STATES)
@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("dname", DTYPES)
def test_rows_off_the_barrier_row_are_the_constants(dname, dt, states):
    """jac_lin_plain's rows 0..3 of A and Bm equal T(0) (+0, the sign bit clear), T(1) and
    T(dt), bit for bit, at every step and lane, whatever the state and control."""
    X, U, C = inputs(DTYPES[dname], states)
    A, Bm = jac_lin_plain(problem(dt), X, U, C)
    for i in range(NX):
        for c in range(NX + 1 + M):
            row = A[i][c] if c <= NX else Bm[i][c - NX - 1]
            want = constant(tan_kind(i, c), dt, row)
            assert torch.equal(bits(row), bits(want)), (i, c, row.flatten()[:4])
    # the barrier row depends on the point: not a constant, and not finite on the
    # lanes that are not
    assert not torch.equal(A[NX][0], torch.full_like(A[NX][0], float(A[NX][0].flatten()[0])))


@pytest.mark.parametrize("states", STATES)
@pytest.mark.parametrize("dname", DTYPES)
def test_rows_match_jax_jac_rows(dname, states):
    """The same rows, and the constants, against jac_rows (jax.jvp by basis tangents) of
    the JAX package's augmented double-integrator step on the same inputs, bit for bit;
    the barrier rows equal where finite (the JAX form's order is the port's)."""
    dt = 0.05
    dtype = DTYPES[dname]
    jdt = jnp.float64 if dname == "f64" else jnp.float32
    X, U, C = inputs(dtype, states, seed=1)
    A, Bm = jac_lin_plain(problem(dt), X, U, C)
    base = 2 * (NX + 1) + M
    jf = j_augmented_step_fn(j_di_components(dt=dt, a_max=2.0, centers=CENTERS, radii=RADII),
                             eps=1e-4)
    for k in range(N):
        rows = lambda T, n: tuple(jnp.asarray(T[k, i].numpy(), dtype=jdt) for i in range(n))
        jbp = JBarrierParams(*(jnp.asarray(C[base + r].numpy(), dtype=jdt) for r in range(3)))
        jA, jB = j_jac_rows(lambda xx, uu: jf(xx, uu, jbp), rows(X, NX + 1), rows(U, M))
        for i in range(NX):
            for c in range(NX + 1 + M):
                mine = (A[i][c] if c <= NX else Bm[i][c - NX - 1])[k]
                ref = torch.as_tensor(np.array(jA[i][c] if c <= NX else jB[i][c - NX - 1]))
                assert torch.equal(bits(mine), bits(ref.to(dtype))), (k, i, c)
                assert torch.equal(bits(mine), bits(constant(tan_kind(i, c), dt, mine)))
        for c in range(NX + 1 + M):
            mine = (A[NX][c] if c <= NX else Bm[NX][c - NX - 1])[k]
            ref = torch.as_tensor(np.array(jA[NX][c] if c <= NX else jB[NX][c - NX - 1]))
            ok = torch.isfinite(ref)
            tol = 1e-12 if dname == "f64" else 1e-5
            np.testing.assert_allclose(mine[ok].double().numpy(), ref[ok].double().numpy(),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", (float("inf"), float("-inf"), float("nan"), -0.0))
def test_kernel_constants_refuse_a_dt_without_the_constant_rows(dt):
    """Where dt is not finite, or is -0, the rows are not those constants (0 + dt * 1 is
    +0, not -0; dt * 0 is NaN): the kernels' constants refuse it, so no launch takes the
    literals for other rows."""
    with pytest.raises(ValueError, match="finite"):
        kernel_consts(problem(dt))
    assert kernel_consts(problem(0.05)).dt == 0.05


@pytest.mark.parametrize("dname", DTYPES)
def test_equality_factors_by_select_are_the_quotients(dname):
    """The double integrator's K1 and K3/K5 form the balanced-equality factors of the min
    chain and of the barriers' max, (won ? 1 : 0) / (tie ? 2 : 1), by select
    (lane_common.cuh::select_chain, select_beq, with SelectFactors): each quotient is exact,
    so the select gives the division's bits, +0 where the operand lost."""
    dtype = DTYPES[dname]
    for won in (False, True):
        for tie in (False, True):
            quotient = (torch.tensor(1.0 if won else 0.0, dtype=dtype)
                        / torch.tensor(2.0 if tie else 1.0, dtype=dtype))
            selected = torch.tensor((0.5 if tie else 1.0) if won else 0.0, dtype=dtype)
            assert torch.equal(bits(quotient), bits(selected)), (won, tie)
