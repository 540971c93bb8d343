"""The generic and coupled sensitivity kernels (K5, K6) and the coupled lane closed loop on
one family, against the JAX package in f64 on the CPU: the tests of
tests/test_torch_family_generic_<family>.py, each of which names its family with a fixture
``family`` (one file a family, so that the test workers spread them).

- The four K5/K6 plain versions (sbwd_plain with generic=True, sbwd_upper_plain,
  sfwd_plain with the carry rows, with and without the reference cotangents) against the
  Pallas kernels (``generic=True``, ``custom_upper``, ``emit_ref_grads``) in interpret mode,
  on torch_family_cases.kernel_inputs (rollouts of clamped random controls from starts
  near and past the safe set's edge, per-lane weights and barrier parameters, so that the
  active set and the α, γ, tight terms run), at the JAX package's rtol 1e-9, atol 1e-11
  (tests/test_lane_sensitivity.py:97-99).
- run_generic_closed_loop_lanes with adapt_nominal=True (the coupled bilevel chain) on
  configs/<family>.yaml with adaptation.adapt_nominal: true, as the CLI runs it
  (presets.family_coupled_setup against the JAX package's build_experiment and its
  runner's raw θ), at B=3, N=6, H=3, against the JAX loop in interpret mode, at
  tests/test_lane_generic.py:88-95, 219-225's tolerances.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.pallas import lane_sensitivity as jsens
from tube_mpc_tpu.tube.lane_closed_loop import (
    run_generic_closed_loop_lanes as j_run_generic_closed_loop_lanes,
)
from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta

from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sbwd_upper_plain, sfwd_plain
from tube_mpc_tpu_torch.presets import family_coupled_setup
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_generic_closed_loop_lanes

from torch_family_cases import (
    EPS, REPO, _cut, _kernel, _padded, jax_family, kernel_inputs, problems, t64,
)

N, B = 6, 3
REG_SENS, ACTIVE_TOL = 1e-9, 1e-8
RTOL, ATOL = 1e-9, 1e-11
SBWD_OUTS = ["K", "kff", "tVx", "Vxx", "LogS"]
SFWD_OUTS = ["gx", "gr", "gxt", "gdyn", "gxr", "gur", "gxrN"]


def jax_sbwd_generic(pb, U, X, Xr, C, XN, XrN, upper=None):
    """_sbwd_kernel with generic=True (and custom_upper with ``upper`` = (gX, gU, gXN)),
    laid out as tube_mpc_tpu/ops/pallas/lane_sensitivity.py:336-388 lays it out."""
    nh, m, nc = pb.n_hat, pb.m, C.shape[0]
    ins = [(m, True), (nh, True), (nh, True), (nc, False), (nh, False), (nh, False)]
    args = [_padded(U), _padded(X), _padded(Xr), _padded(C, True), _padded(XN), _padded(XrN)]
    if upper is not None:
        ins = [(nh, True), (m, True), (nh, False)] + ins
        args = [_padded(u) for u in upper] + args
    call = _kernel(functools.partial(jsens._sbwd_kernel, pb, REG_SENS, ACTIVE_TOL, True,
                                     upper is not None), N, ins,
                   [(m * nh, True), (m, True), (nh, True), (nh * nh, True), (1, True)],
                   [nh * nh, nh, 1], backward=True)
    return _cut(call(*args), B)


def jax_sfwd_generic(pb, K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS, emit):
    """_sfwd_kernel with generic=True (and emit_ref_grads with ``emit``)."""
    nh, m, nc = pb.n_hat, pb.m, C.shape[0]
    outs = [(nh, False), (m, False), (nh, False), (3, False)]
    if emit:
        outs += [(nh, True), (m, True), (nh, False)]
    call = _kernel(functools.partial(jsens._sfwd_kernel, pb, N, True, emit), N,
                   [(m * nh, True), (m, True), (nh, True), (nh, True), (m, True), (m, True),
                    (nc, False), (nh, False), (nh, False), (nh, True), (nh * nh, True),
                    (1, True)], outs, [nh], backward=False)
    args = [K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS]
    return _cut(call(*[_padded(a, const_rows=(i == 6)) for i, a in enumerate(args)]), B)


@pytest.fixture(scope="module")
def case(family):
    pb, j_pb, _ = problems(family)
    d = kernel_inputs(family, seed=17, N=N, B=B)
    rng = np.random.default_rng(23)
    X, Xr = d["X"], d["Xr"]
    nh, m = pb.n_hat, pb.m
    return dict(pb=pb, j_pb=j_pb, d=d,
                bwd=(d["U"], X[:-1], Xr[:-1], d["C"], X[-1], Xr[-1]),
                upper=(t64(rng.normal(size=(N, nh, B))), t64(rng.normal(size=(N, m, B))),
                       t64(rng.normal(size=(nh, B)))))


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
    assert tuple(port[i].shape) == ref[i].shape and np.isfinite(ref[i]).all()
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_k5_zeroes_gains_of_controls_at_a_bound(case, k5):
    """The inputs hold controls at a bound, where K's row and kff are exactly zero in
    both K5 variants."""
    pb, U = case["pb"], case["d"]["U"]
    lo = torch.as_tensor(pb.u_min, dtype=U.dtype)[None, :, None]
    hi = torch.as_tensor(pb.u_max, dtype=U.dtype)[None, :, None]
    at = (U <= lo + ACTIVE_TOL) | (U >= hi - ACTIVE_TOL)
    assert bool(at.any()) and not bool(at.all())
    for variant in ("generic", "upper"):
        K, kff = k5[variant][0][:2]
        assert bool((kff[at] == 0.0).all())
        assert bool((K.view(N, pb.m, pb.n_hat, B).permute(0, 1, 3, 2)[at] == 0.0).all())


@pytest.fixture(scope="module")
def k6(case, k5):
    """{variant: (port outputs, JAX outputs)} of K6 generic (on the upper sweep's gains
    and carry, as the coupled nominal sweep runs it) and K6 with the reference cotangents
    (on the generic sweep's, as the ancillary sweep runs it)."""
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
    assert len(port) == len(ref) and tuple(port[i].shape) == ref[i].shape
    assert np.isfinite(ref[i]).all()
    np.testing.assert_allclose(port[i].numpy(), ref[i], rtol=RTOL, atol=ATOL)


def test_k6_dynamics_terms_are_not_zero(k6):
    """The per-lane α, γ and tightening make every row of gdyn non-zero on some lane."""
    for variant in ("generic", "ref"):
        gdyn = k6[variant][0][3]
        assert bool((gdyn.abs().amax(dim=1) > 0).all()), variant


# ---- the coupled closed loop -------------------------------------------------------

H = 3
# (rtol, atol) per field, tests/test_lane_generic.py:88-95, 219-225
TOL = {
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-7), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-7, 1e-10), "R_hist": (1e-7, 1e-10), "qb_hist": (1e-7, 1e-10),
}
RAW_TOL = (1e-7, 1e-10)


def jax_coupled_setup(family):
    """The JAX package's build of configs/<family>.yaml with adaptation.adapt_nominal: true
    in f64 (generic mode), N and H replaced, and its runner's raw θ̄, θ
    (tube_mpc_tpu/runners.py:283-300): (built, TubeMPCConfig, raw θ̄, raw θ, ycfg)."""
    from tube_mpc_tpu.utils.config import build_experiment, load_config

    ycfg = load_config(str(REPO / "configs" / f"{family}.yaml"))
    ycfg = dataclasses.replace(ycfg, use_float64=True, adaptation=dataclasses.replace(
        ycfg.adaptation, adapt_nominal=True))
    built = build_experiment(ycfg)
    cfg = dataclasses.replace(built.tube_cfg, N=N, H=H)
    j = lambda v: jnp.asarray(v, dtype=jnp.float64)
    cn, ca, db = ycfg.cost_nominal, ycfg.cost_auxiliary, ycfg.dbas
    raw_nom = JRawNominalTheta(
        Q_raw=j(list(cn.Q)), R_raw=j(list(cn.R)), Qf_raw=j(list(cn.Qf or cn.Q)), qb_raw=j(cn.q_b),
        alpha_raw=j(db.alpha), gamma_raw=j(db.gamma), tight_raw=j(db.nominal_tightening))
    raw_aux = JRawAuxTheta(
        Q_raw=j(list(ca.Q or cn.Q)), R_raw=j(list(ca.R or cn.R)),
        Qf_raw=j(list(ca.Qf or ca.Q or cn.Q)), qb_raw=j(ca.q_b), alpha_raw=j(db.alpha),
        gamma_raw=j(db.gamma))
    return built, cfg, raw_nom, raw_aux, ycfg


@pytest.fixture(scope="module")
def loops(family):
    """(port log, port raws, JAX log, JAX raws, port setup, JAX TubeMPCConfig)."""
    built, cfg, j_raw_nom, j_raw_aux, ycfg = jax_coupled_setup(family)
    j_sys_c = jax_family(family, N=N, H=H)[2]
    s, raw_nom, raw_aux = family_coupled_setup(family, N=N, H=H, device="cpu",
                                               dtype=torch.float64)
    w_low = np.asarray(ycfg.system.disturbance["w_low"])
    w_high = np.asarray(ycfg.system.disturbance["w_high"])
    w_seqs = np.random.default_rng(3).uniform(w_low, w_high, size=(B, H, len(w_low)))
    port, port_raws = run_generic_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, raw_nom=raw_nom, raw_aux_init=raw_aux, x0=s.x0,
        target=s.target, w_seqs=torch.as_tensor(w_seqs), eps=s.eps, device="cpu")
    ref, ref_raws = j_run_generic_closed_loop_lanes(
        built.system, built.aug, j_sys_c, cfg, raw_nom=j_raw_nom, raw_aux_init=j_raw_aux,
        x0=built.x0, target=built.target, w_seqs=jnp.asarray(w_seqs), eps=EPS, block_b=128,
        interpret=True)
    return port, port_raws, ref, ref_raws, s, cfg


def test_coupled_setup_matches_build_experiment(loops):
    """The port's coupled setup is the JAX package's: its TubeMPCConfig (generic mode:
    the file's ilqr_reg, adapt_nominal) and its raw θ̄, θ, leaf by leaf."""
    s, cfg = loops[4], loops[5]
    assert dataclasses.asdict(s.cfg) == dataclasses.asdict(cfg)
    assert s.cfg.adapt_nominal and s.cfg.reg == 1e-3


@pytest.mark.parametrize("field", ClosedLoopLog._fields)
def test_coupled_loop_matches_jax(loops, field):
    port, _, ref, _, _, _ = loops
    p, r = getattr(port, field), np.asarray(getattr(ref, field))
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64
    rtol, atol = TOL[field]
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("tree", ["raw_aux", "raw_nom"])
def test_coupled_loop_final_raws_match_jax(loops, tree):
    _, port_raws, _, ref_raws, _, _ = loops
    i = ["raw_aux", "raw_nom"].index(tree)
    for name, v in port_raws[i]._asdict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(ref_raws[i], name)),
                                   rtol=RAW_TOL[0], atol=RAW_TOL[1], err_msg=name)


def test_coupled_loop_adapts_the_nominal_and_stays_finite(loops):
    """Every logged value and final raw leaf is finite, and the coupled chain moves the
    nominal weights."""
    port, port_raws, _, _, s, _ = loops
    for field in ClosedLoopLog._fields:
        assert bool(torch.isfinite(getattr(port, field)).all()), field
    for tree in port_raws:
        for name, v in tree._asdict().items():
            assert bool(torch.isfinite(v).all()), name
    raw_nom0 = family_coupled_setup(s.system.name, N=N, H=H, device="cpu",
                                    dtype=torch.float64)[1]
    assert not torch.equal(port_raws[1].Q_raw, raw_nom0.Q_raw.expand_as(port_raws[1].Q_raw))
