"""Shared cases of the family tests (tests/test_torch_family_*.py): the double
integrator, the planar quadrotor and the cart-pole as bench.py's BENCH_SYSTEM runs
them, built by both packages from the same numbers, in f64 on the CPU.

- ``jax_family``: the JAX package's ``build_experiment(load_config(configs/<name>.yaml),
  paper_mode=True)`` with N and H replaced, and its component form;
- ``setup_as_numpy``: that setup as the plain numbers convert.family_setup_from_numpy
  takes;
- ``kernel_inputs``: a realistic input of the lane kernels, rollouts of clamped random
  controls from three starts (one near or past the safe set's edge) with per-lane
  weights and barrier parameters;
- ``jax_ric``, ``jax_fwd``, ``jax_sbwd``, ``jax_sfwd``: the Pallas kernels K1-K4 in
  interpret mode on numpy inputs of any N and B (padded to one block of 128 lanes).
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tube_mpc_tpu.ops.pallas import lane_sensitivity as jsens
from tube_mpc_tpu.ops.pallas import lane_solver as jls
from tube_mpc_tpu.systems.registry import build_components as j_build_components
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem
from tube_mpc_tpu.utils.config import build_experiment, load_config

from tube_mpc_tpu_torch.convert import family_setup_from_numpy
from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_solver import rollout
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("double_integrator", "quadrotor2d", "cartpole")
F64 = jnp.float64
BT = 128           # JAX lane block: B pads to one block of 128 lanes
VMEM = pltpu.VMEM
EPS = 1e-4         # dbas.eps of every family's YAML


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def jax_family(name, *, N, H, **tube):
    """(built, its TubeMPCConfig with N, H and ``tube`` replaced, the JAX component form,
    the parsed YAML) of configs/<name>.yaml in f64."""
    ycfg = dataclasses.replace(load_config(str(REPO / "configs" / f"{name}.yaml")),
                               use_float64=True)
    built = build_experiment(ycfg, paper_mode=True)
    cfg = dataclasses.replace(built.tube_cfg, N=N, H=H, **tube)
    env = ycfg.environment
    j_sys_c = j_build_components(
        name, dt=ycfg.system.dt, control_bounds=dict(ycfg.system.control_bounds),
        obstacles=[dict(o) for o in env.obstacles] or None,
        aggregation=env.obstacle_aggregation, beta=env.obstacle_smoothmin_beta,
        extra=dict(ycfg.system.extra))
    return built, cfg, j_sys_c, ycfg


def setup_as_numpy(built, cfg, ycfg):
    """A JAX family setup as the plain numbers convert.family_setup_from_numpy takes."""
    a, sc, env = cfg.adapt, ycfg.system, ycfg.environment
    obs = [dict(o) for o in env.obstacles]
    return dict(
        cfg=dict(N=cfg.N, H=cfg.H, nominal_max_iter=cfg.nominal_max_iter,
                 aux_max_iter=cfg.aux_max_iter, tol=cfg.tol, reg=cfg.reg, alphas=cfg.alphas,
                 adapt=dict(lr=a.lr, momentum=a.momentum, steps=a.steps,
                            grad_clip_norm=a.grad_clip_norm, project=a.project)),
        w_nominal={f: np.asarray(getattr(built.w_nominal, f)) for f in ("Q", "R", "Qf", "qb")},
        aux_init={f: np.asarray(getattr(built.aux_init, f)) for f in ("Q", "R", "qb")},
        bp={f: np.asarray(getattr(built.bp, f)) for f in ("alpha", "gamma", "tight")},
        x0=np.asarray(built.x0), target=np.asarray(built.target),
        dt=sc.dt, control_bounds=dict(sc.control_bounds),
        w_low=list(sc.disturbance["w_low"]), w_high=list(sc.disturbance["w_high"]),
        centers=np.array([o["center"] for o in obs], dtype=np.float64).reshape(-1, 2),
        radii=np.array([o["radius"] for o in obs], dtype=np.float64),
        beta=env.obstacle_smoothmin_beta, eps=ycfg.dbas.eps, extra=dict(sc.extra),
    )


def problems(name):
    """(the port's LaneProblem, the JAX one, the port's setup) of family ``name``."""
    built, cfg, j_sys_c, ycfg = jax_family(name, N=6, H=3)
    s = family_setup_from_numpy(name, setup_as_numpy(built, cfg, ycfg), device="cpu",
                                dtype=torch.float64)
    return (make_lane_problem(s.sys_c, eps=EPS), j_make_lane_problem(j_sys_c, eps=EPS), s)


# Starts near or past the edge of the safe set (lane 1 inside an obstacle, or the cart
# near and past its track limit), and the controls' spread past their bounds.
EDGE = {"double_integrator": {1: (4.3, 3.8), 2: (1.0, 1.5)},
        "quadrotor2d": {1: (3.2, 2.7), 2: (5.0, 4.2)},
        "cartpole": {1: (2.35,), 2: (-2.5,)}}


def kernel_inputs(name, *, seed, N, B=3):
    """A realistic kernel input of family ``name``: rollouts of random controls (drawn
    past the bounds and clamped, so some sit at a bound) from B starts (lanes 1 and 2 at
    EDGE's), tracking a ramp towards the target, with per-lane weights and barrier
    parameters (three values each, repeated over the lanes)."""
    pb, _, s = problems(name)
    n, m = pb.n, pb.m
    rng = np.random.default_rng(seed)
    x0 = np.asarray(s.x0)[None] + 0.1 * rng.normal(size=(B, n))
    for lane, p in EDGE[name].items():
        x0[lane, :len(p)] = p
    b0 = rng.uniform(0.1, 1.0, B)
    x_hat0 = t64(np.concatenate([x0, b0[:, None]], axis=1).T)
    lo, hi = np.asarray(pb.u_min), np.asarray(pb.u_max)
    span = hi - lo
    U = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, size=(N, B, m)).transpose(0, 2, 1)
    U = np.clip(U, lo[None, :, None], hi[None, :, None])
    target = np.asarray(s.target)
    ks = np.arange(N + 1) / N
    Xr = np.zeros((N + 1, n + 1, B))
    Xr[:, :n] = (x0.mean(0)[None] + ks[:, None] * (target - x0.mean(0))[None])[..., None]
    Ur = np.broadcast_to(((lo + hi) / 2)[None, :, None], (N, m, B)).copy()
    bp = BarrierParams(*(t64(np.resize(v, B))
                         for v in ([0.0, 0.05, 0.1], [0.0, 0.3, -0.2], [0.0, 0.02, 0.0])))
    w = CostWeights(Q=t64(rng.uniform(0.5, 2.0, (B, n))), R=t64(rng.uniform(0.5, 2.0, (B, m))),
                    Qf=t64(rng.uniform(10.0, 100.0, (B, n))), qb=t64(rng.uniform(0.2, 1.0, B)))
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X = rollout(pb, x_hat0, t64(U).contiguous(), t64(Xr), t64(Ur), C)
    return dict(x_hat0=x_hat0, X=X, U=t64(U).contiguous(), Xr=t64(Xr), Ur=t64(Ur), C=C)


def _padded(a, const_rows=False):
    """Pad the lane axis to the JAX block; padded const rows are 1 as in the JAX glue."""
    B = np.shape(a)[-1]
    a = jls._pad_lanes(jnp.asarray(np.asarray(a), dtype=F64), BT)
    if const_rows:
        a = a.at[:, B:].set(1.0)
    return a


def _spec(shape, index):
    return pl.BlockSpec(shape, index, memory_space=VMEM)


def _kernel(kernel, N, ins, outs, scratch, backward):
    """pallas_call of ``kernel`` over the grid (1, N): ``ins`` and ``outs`` are (rows,
    per_step) pairs, a block [1, rows, BT] at step k (k from N-1 down when ``backward``)
    or [rows, BT] fixed."""
    step = (lambda b, k: (N - 1 - k, 0, b)) if backward else (lambda b, k: (k, 0, b))
    fixed = lambda b, k: (0, b)
    spec = lambda rows, per_step: (_spec((1, rows, BT), step) if per_step
                                   else _spec((rows, BT), fixed))
    shape = lambda rows, per_step: jax.ShapeDtypeStruct(((N,) if per_step else ()) + (rows, BT), F64)
    return pl.pallas_call(
        kernel, grid=(1, N), in_specs=[spec(*i) for i in ins],
        out_specs=[spec(*o) for o in outs], out_shape=[shape(*o) for o in outs],
        scratch_shapes=[VMEM((rows, BT), F64) for rows in scratch], interpret=True)


def _cut(outs, B):
    return tuple(np.asarray(o)[..., :B] for o in outs)


def jax_ric(pb, reg, X, U, Xr, Ur, C, phix):
    nh, m, nc, N, B = pb.n_hat, pb.m, C.shape[0], X.shape[0], X.shape[-1]
    call = _kernel(functools.partial(jls._ric_kernel, pb, float(reg)), N,
                   [(nh, True), (m, True), (nh, True), (m, True), (nc, False), (nh, False)],
                   [(m * nh, True), (m, True)], [nh, nh * nh, 1], backward=True)
    return _cut(call(_padded(X), _padded(U), _padded(Xr), _padded(Ur), _padded(C, True),
                     _padded(phix)), B)


def jax_fwd(pb, alphas, x0, Xo, Uo, K, kff, Xr, XrN, Ur, C):
    nh, m, nc, na, N, B = pb.n_hat, pb.m, C.shape[0], len(alphas), Xo.shape[0], Xo.shape[-1]
    call = _kernel(functools.partial(jls._fwd_kernel, pb, tuple(alphas), N), N,
                   [(nh, False), (nh, True), (m, True), (m * nh, True), (m, True), (nh, True),
                    (nh, False), (m, True), (nc, False)],
                   [(na * nh, True), (na * m, True), (na, False)], [na * nh], backward=False)
    return _cut(call(_padded(x0), _padded(Xo), _padded(Uo), _padded(K), _padded(kff),
                     _padded(Xr), _padded(XrN), _padded(Ur), _padded(C, True)), B)


def jax_sbwd(pb, reg, active_tol, U, X, Xr, C, XN, XrN):
    nh, m, nc, N, B = pb.n_hat, pb.m, C.shape[0], X.shape[0], X.shape[-1]
    call = _kernel(functools.partial(jsens._sbwd_kernel, pb, reg, active_tol, False, False), N,
                   [(m, True), (nh, True), (nh, True), (nc, False), (nh, False), (nh, False)],
                   [(m * nh, True), (m, True)], [nh * nh, nh, 1], backward=True)
    return _cut(call(_padded(U), _padded(X), _padded(Xr), _padded(C, True), _padded(XN),
                     _padded(XrN)), B)


def jax_sfwd(pb, K, kff, X, Xr, U, Ur, C, XN, XrN):
    nh, m, nc, N, B = pb.n_hat, pb.m, C.shape[0], X.shape[0], X.shape[-1]
    call = _kernel(functools.partial(jsens._sfwd_kernel, pb, N, False, False), N,
                   [(m * nh, True), (m, True), (nh, True), (nh, True), (m, True), (m, True),
                    (nc, False), (nh, False), (nh, False)],
                   [(nh, False), (m, False)], [nh], backward=False)
    return _cut(call(_padded(K), _padded(kff), _padded(X), _padded(Xr), _padded(U),
                     _padded(Ur), _padded(C, True), _padded(XN), _padded(XrN)), B)
