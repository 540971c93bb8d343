"""The port's generic and coupled lane sensitivity (K5, K6) against the JAX
package's, in f64 on the CPU.

Each plain variant (K5 generic, K5 generic with upper-gradient rows, K6 generic,
K6 generic with the reference cotangents) against the Pallas kernel run in
interpret mode, on the same numbers: a solved tracking problem with per-lane
barrier parameters, whose references ask for more speed than the bound allows
(so that some controls sit at their bound) and whose lanes start near or inside
obstacles (so that the barrier's α-relaxed branch runs and gα, gγ are non-zero).
Tolerances are those of tests/test_torch_lane_sensitivity.py.
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
from tube_mpc_tpu.presets import PAPER_OBSTACLES
from tube_mpc_tpu.tube import lane_interface as jli

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda import launch_counts
from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import (
    lane_sensitivity_grads,
    sbwd_generic,
    sbwd_plain,
    sbwd_upper,
    sbwd_upper_plain,
    sfwd_generic,
    sfwd_plain,
    sfwd_ref,
)
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import dubins_components
from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
from tube_mpc_tpu_torch.tube.lane_interface import (
    _build_C,
    _rows,
    _with_barrier_row,
    make_lane_problem,
    tube_ilqr_solve_lanes,
)

from test_torch_lane_sensitivity import ACTIVE_TOL, ATOL, BT, EPS, REG, RTOL, _padded, _t

F64 = jnp.float64
B, N = 6, 9
VMEM = pltpu.VMEM


@pytest.fixture(scope="module")
def case():
    """A solved ancillary tracking problem with per-lane weights and barrier
    parameters; references ask for v = 10 and more, so v saturates on some lanes."""
    kw = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
              centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=20.0)
    pb = make_lane_problem(dubins_components(**kw), eps=EPS)
    j_pb = jli.make_lane_problem(j_dubins_components(**kw), eps=EPS)
    rng = np.random.default_rng(11)
    Q = 1.0 + 0.3 * rng.uniform(size=(B, 3))
    R = 0.5 + 0.5 * rng.uniform(size=(B, 2))
    Qf = 2.0 + rng.uniform(size=(B, 3))
    Qf[5] = 5e7   # one lane's value-function carry passes 1e8 and is rescaled (LogS > 0)
    qb = 0.5 + 0.5 * rng.uniform(size=B)
    alpha = rng.uniform(0.3, 1.2, B)
    gamma = rng.uniform(-0.5, 0.5, B)
    tight = rng.uniform(0.0, 0.1, B)
    x0 = np.array([3.2, 1.0, np.pi / 4]) + 0.05 * rng.normal(size=(B, 3))
    x0[2, :2] = [3.3, 2.2]   # one lane starts inside an obstacle
    x0[4, :2] = [0.0, 0.0]   # one far from every obstacle
    b0 = rng.uniform(0.1, 1.0, B)
    ks = np.arange(N + 1)
    X_ref = (x0[:, None, :] + np.stack([0.2 * ks, 0.15 * ks, 0.0 * ks], -1)[None]).copy()
    U_ref = np.broadcast_to(np.array([10.0, 0.0]), (B, N, 2)).copy()
    w = CostWeights(Q=_t(Q), R=_t(R), Qf=_t(Qf), qb=_t(qb))
    bp = BarrierParams(_t(alpha), _t(gamma), _t(tight))
    X, U = tube_ilqr_solve_lanes(
        pb, ILQRConfig(max_iter=8, tol=1e-6, reg=1e-6, alphas=(1.0, 0.5, 0.1, 0.0)),
        w=w, bp=bp, x_hat0=_t(np.concatenate([x0, b0[:, None]], axis=1)),
        U_init=torch.zeros((B, N, 2), dtype=torch.float64),
        X_ref=_t(X_ref), U_ref=_t(U_ref), device="cpu",
    )
    at_bound = (U >= 10.0 - ACTIVE_TOL) | (U <= -10.0 + ACTIVE_TOL)
    assert bool(at_bound.any()) and not bool(at_bound.all())
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X_r, Xr_r = _rows(X), _rows(_with_barrier_row(_t(X_ref)))
    j = lambda a: jnp.asarray(np.asarray(a), dtype=F64)
    upper = (_t(rng.normal(size=(N, 4, B))), _t(rng.normal(size=(N, 2, B))),
             _t(rng.normal(size=(4, B))))
    return dict(
        pb=pb, j_pb=j_pb, X=X, U=U, X_ref=X_ref, U_ref=U_ref, w=w, bp=bp, C=C, upper=upper,
        j_w=JCostWeights(Q=j(Q), R=j(R), Qf=j(Qf), qb=j(qb)),
        j_bp=JBarrierParams(alpha=j(alpha), gamma=j(gamma), tight=j(tight)),
        bwd_args=(_rows(U), X_r[:-1], Xr_r[:-1], C, X_r[-1], Xr_r[-1]),
        fwd_args=(X_r[:-1], Xr_r[:-1], _rows(U), _rows(_t(U_ref)), C, X_r[-1], Xr_r[-1]),
    )


def jax_sbwd(pb, args, upper):
    """The JAX _sbwd_kernel with generic=True (and custom_upper with ``upper``),
    laid out as tube_mpc_tpu/ops/pallas/lane_sensitivity.py:336-388 does."""
    nh, m, nc = pb.n_hat, pb.m, args[3].shape[0]
    kb_rev = lambda b, k: (N - 1 - k, 0, b)
    fixed = lambda b, k: (0, b)
    step = lambda rows: pl.BlockSpec((1, rows, BT), kb_rev, memory_space=VMEM)
    term = lambda rows: pl.BlockSpec((rows, BT), fixed, memory_space=VMEM)
    in_specs = [step(m), step(nh), step(nh), term(nc), term(nh), term(nh)]
    ins = [_padded(args[0]), _padded(args[1]), _padded(args[2]), _padded(args[3], True),
           _padded(args[4]), _padded(args[5])]
    if upper is not None:
        in_specs = [step(nh), step(m), term(nh)] + in_specs
        ins = [_padded(u) for u in upper] + ins
    call = pl.pallas_call(
        functools.partial(jsens._sbwd_kernel, pb, REG, ACTIVE_TOL, True, upper is not None),
        grid=(1, N),
        in_specs=in_specs,
        out_specs=[step(m * nh), step(m), step(nh), step(nh * nh), step(1)],
        out_shape=[jax.ShapeDtypeStruct((N, r, BT), F64) for r in (m * nh, m, nh, nh * nh, 1)],
        scratch_shapes=[VMEM((nh * nh, BT), F64), VMEM((nh, BT), F64), VMEM((1, BT), F64)],
        interpret=True,
    )
    return [np.asarray(o)[..., :B] for o in call(*ins)]


def jax_sfwd(pb, args, emit):
    """The JAX _sfwd_kernel with generic=True (and emit_ref_grads with ``emit``):
    args = (K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS)."""
    nh, m, nc = pb.n_hat, pb.m, args[6].shape[0]
    kb = lambda b, k: (k, 0, b)
    fixed = lambda b, k: (0, b)
    step = lambda rows: pl.BlockSpec((1, rows, BT), kb, memory_space=VMEM)
    term = lambda rows: pl.BlockSpec((rows, BT), fixed, memory_space=VMEM)
    in_specs = [step(m * nh), step(m), step(nh), step(nh), step(m), step(m), term(nc),
                term(nh), term(nh), step(nh), step(nh * nh), step(1)]
    out_specs = [term(nh), term(m), term(nh), term(3)]
    out_shape = [jax.ShapeDtypeStruct((r, BT), F64) for r in (nh, m, nh, 3)]
    if emit:
        out_specs += [step(nh), step(m), term(nh)]
        out_shape += [jax.ShapeDtypeStruct((N, nh, BT), F64), jax.ShapeDtypeStruct((N, m, BT), F64),
                      jax.ShapeDtypeStruct((nh, BT), F64)]
    call = pl.pallas_call(
        functools.partial(jsens._sfwd_kernel, pb, N, True, emit),
        grid=(1, N), in_specs=in_specs, out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[VMEM((nh, BT), F64)], interpret=True,
    )
    ins = [_padded(a, const_rows=(i == 6)) for i, a in enumerate(args)]
    return [np.asarray(o)[..., :B] for o in call(*ins)]


SBWD_OUTS = ["K", "kff", "tVx", "Vxx", "LogS"]
SFWD_OUTS = ["gx", "gr", "gxt", "gdyn", "gxr", "gur", "gxrN"]


@pytest.fixture(scope="module")
def k5(case):
    """{variant: (port outputs, JAX outputs)} for K5 generic and K5 with upper rows."""
    out = {}
    U, X, _, C, _, _ = case["bwd_args"]
    for variant, upper in (("generic", None), ("upper", case["upper"])):
        if upper is None:
            port = sbwd_plain(case["pb"], REG, ACTIVE_TOL, *case["bwd_args"], generic=True)
        else:
            port = sbwd_upper_plain(case["pb"], REG, ACTIVE_TOL, *upper, U, X, C)
        ref = jax_sbwd(case["j_pb"], [a.numpy() for a in case["bwd_args"]],
                       None if upper is None else [u.numpy() for u in upper])
        out[variant] = (port, ref)
    return out


@pytest.mark.parametrize("variant", ["generic", "upper"])
@pytest.mark.parametrize("name", SBWD_OUTS)
def test_k5_matches_pallas_kernel(k5, variant, name):
    port, ref = k5[variant]
    i = SBWD_OUTS.index(name)
    assert tuple(port[i].shape) == ref[i].shape
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_k5_emits_the_carry_before_each_step(case, k5):
    """At k = N-1 the emitted carry is the terminal initialisation: tV_x = 2 (x_N -
    x_ref,N) (or gX_N with upper rows), V_xx = diag of the terminal C rows, LogS 0;
    a clamped control still gets zero gains."""
    (K, kff, tVx, Vxx, LogS), _ = k5["generic"]
    U_r, _, _, C, XN, XrN = case["bwd_args"]
    np.testing.assert_array_equal(tVx[N - 1].numpy(), (2.0 * (XN - XrN)).numpy())
    diag = torch.zeros((4, 4, B), dtype=torch.float64)
    for i in range(4):
        diag[i, i] = C[6 + i]
    np.testing.assert_array_equal(Vxx[N - 1].numpy(), diag.reshape(16, B).numpy())
    assert not bool(LogS[N - 1].any()) and float(LogS.max()) > 0.0
    np.testing.assert_array_equal(k5["upper"][0][2][N - 1].numpy(), case["upper"][2].numpy())
    at_bound = (U_r >= 10.0 - ACTIVE_TOL) | (U_r <= -10.0 + ACTIVE_TOL)
    assert bool((kff[at_bound] == 0.0).all())


@pytest.fixture(scope="module")
def k6(case, k5):
    """{variant: (port outputs, JAX outputs)} for K6 generic and K6 with the cotangents,
    on K5 generic's outputs."""
    K, kff, tVx, Vxx, LogS = k5["generic"][0]
    X, Xr, U, Ur, C, XN, XrN = case["fwd_args"]
    args = (K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS)
    out = {}
    for variant, emit in (("generic", False), ("ref", True)):
        port = sfwd_plain(case["pb"], *args[:9], value=(tVx, Vxx, LogS), emit_ref_grads=emit)
        ref = jax_sfwd(case["j_pb"], [a.numpy() for a in args], emit)
        out[variant] = (port, ref)
    return out


@pytest.mark.parametrize("variant,name", [("generic", n) for n in SFWD_OUTS[:4]]
                         + [("ref", n) for n in SFWD_OUTS])
def test_k6_matches_pallas_kernel(k6, variant, name):
    port, ref = k6[variant]
    i = SFWD_OUTS.index(name)
    assert len(port) == len(ref)
    assert tuple(port[i].shape) == ref[i].shape
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_k6_barrier_terms_are_live(k6):
    """The case runs the α-relaxed branch: gα and gγ are non-zero on some lane."""
    gdyn = k6["generic"][0][3]
    assert float(gdyn[0].abs().max()) > 0.0 and float(gdyn[1].abs().max()) > 0.0


def test_variant_wrappers_run_plain_versions_on_cpu(case, k5, k6):
    """On CPU tensors every variant's wrapper gives its plain version's numbers and
    counts no kernel launch."""
    before = launch_counts()
    U, X, _, C, _, _ = case["bwd_args"]
    K5 = sbwd_generic(case["pb"], REG, ACTIVE_TOL, *case["bwd_args"])
    K5u = sbwd_upper(case["pb"], REG, ACTIVE_TOL, *case["upper"], U, X, C)
    K, kff, tVx, Vxx, LogS = K5
    X, Xr, U, Ur, C, XN, XrN = case["fwd_args"]
    g6 = sfwd_generic(case["pb"], K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS)
    g6r = sfwd_ref(case["pb"], K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS)
    assert launch_counts() == before
    for got, want in ((K5, k5["generic"][0]), (K5u, k5["upper"][0]), (g6, k6["generic"][0]),
                      (g6r, k6["ref"][0])):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("generic,emit,upper", [(True, False, False), (True, True, False),
                                                (True, False, True), (False, False, True)])
def test_lane_sensitivity_grads_picks_the_variants(case, k5, k6, generic, emit, upper):
    """lane_sensitivity_grads runs the variants the JAX function's flags name, on the
    variants held against the Pallas kernels above; upper-gradient rows without
    ``generic`` run K5 with upper rows, then the paper rollout on its K and kff."""
    X_r = _rows(case["X"])
    Xr_r = _rows(_with_barrier_row(_t(case["X_ref"])))
    U_r, Ur_r = _rows(case["U"]), _rows(_t(case["U_ref"]))
    kw = dict(X=X_r, U=U_r, X_ref=Xr_r, U_ref=Ur_r, C=case["C"], reg=REG, active_tol=ACTIVE_TOL,
              generic=generic, emit_ref_grads=emit)
    if upper:
        gX, gU, gXN = case["upper"]
        kw.update(upper_gx=torch.cat([gX, gXN[None]], dim=0), upper_gu=gU)
    got = lane_sensitivity_grads(case["pb"], **kw)
    K, kff, tVx, Vxx, LogS = k5["upper" if upper else "generic"][0]
    fwd = (K, kff) + case["fwd_args"]
    if generic and not upper:
        want = k6["ref" if emit else "generic"][0]
    else:
        want = sfwd_plain(case["pb"], *fwd, value=(tVx, Vxx, LogS) if generic else None)
    assert len(got) == len(want) == (7 if emit else 4 if generic else 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
