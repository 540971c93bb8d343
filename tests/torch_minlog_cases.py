"""Shared cases of the tests of the lane engine's other branches
(tests/test_torch_minlog_*.py): configurations derived from the shipped ones that take
the exact-min obstacle aggregation or the log barrier, built by both packages from the
same YAML, in f64 on the CPU.

- ``raw_of``: configs/<file>.yaml with a case's changes (a key's value None deletes it);
- ``jax_components``, ``problems``: the JAX component form of a case; the port's
  LaneProblem, the JAX one and the port's setup;
- ``kernel_inputs``: a realistic kernel input, rollouts of clamped random controls from
  three starts: one on the bisector of the first two obstacles (where the min chain
  ties) or at the cart-pole's track limit, one inside the first obstacle or past the
  track limit (h - tight < eps: the log barrier's zero branch), one near the start.
"""
import copy
from pathlib import Path

import numpy as np
import torch
import yaml

from tube_mpc_tpu.systems.registry import build_components as j_build_components
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem
from tube_mpc_tpu.utils.config import parse_config as j_parse_config

from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.ops.cuda.lane_solver import rollout
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.presets import config_setup
from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem
from tube_mpc_tpu_torch.utils.config import lane_components, parse_config

REPO = Path(__file__).resolve().parents[1]
# case: (the shipped config, its changes)
CASES = {
    "dubins_min_log": ("dubins", {"environment.obstacle_aggregation": "min",
                                  "dbas.barrier_type": "log"}),
    "double_integrator_min": ("double_integrator", {"environment.obstacle_aggregation": None}),
    "cartpole_log": ("cartpole", {"dbas.barrier_type": "log"}),
}


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def raw_of(case, N=None, H=None, **more):
    """The YAML of `case` as plain values, with N and H replaced where given and `more`
    "section.key" changes on top of the case's."""
    name, changes = CASES[case]
    with open(REPO / "configs" / f"{name}.yaml", "r", encoding="utf-8") as f:
        raw = copy.deepcopy(yaml.safe_load(f))
    if N is not None:
        raw["system"]["horizon_N"], raw["system"]["task_horizon_H"] = N, H
    for key, value in {**changes, **more}.items():
        section, leaf = key.split(".")
        if value is None:
            raw[section].pop(leaf)
        else:
            raw[section][leaf] = value
    return raw


def jax_components(case):
    """The JAX package's component form of `case` (its lane engine's)."""
    jcfg = j_parse_config(raw_of(case))
    env, sc = jcfg.environment, jcfg.system
    return j_build_components(
        sc.name, dt=sc.dt, control_bounds=dict(sc.control_bounds),
        obstacles=[dict(o) for o in env.obstacles] or None,
        aggregation=env.obstacle_aggregation, beta=env.obstacle_smoothmin_beta,
        extra=dict(sc.extra))


def problems(case, N=6, H=3):
    """(the port's LaneProblem, the JAX one, the port's paper setup) of `case` in f64."""
    cfg = parse_config(raw_of(case))
    bt, eps = cfg.dbas.barrier_type, cfg.dbas.eps
    s = config_setup(cfg, N=N, H=H, device="cpu", dtype=torch.float64)
    return (make_lane_problem(lane_components(cfg), barrier_type=bt, eps=eps),
            j_make_lane_problem(jax_components(case), barrier_type=bt, eps=eps), s)


def edge_starts(pb):
    """{lane: its start's leading rows}: lane 0 on the bisector of the first two obstacles
    (their midpoint; for the cart-pole the track limit, h = 0), lane 1 at the first
    obstacle's centre (for the cart-pole past the limit)."""
    sp = pb.spec
    if not sp.centers:
        return {0: (sp.x_lim,), 1: (-2.5,)}
    (ax, ay), (bx, by) = sp.centers[:2]
    return {0: ((ax + bx) / 2, (ay + by) / 2), 1: (ax, ay)}


def kernel_inputs(case, *, seed, N, B=3):
    """A realistic kernel input of `case`: rollouts of random controls (drawn past the
    bounds and clamped, so some sit at a bound) from edge_starts' starts and one near the
    setup's, tracking a ramp towards the target, with per-lane weights and barrier
    parameters."""
    pb, _, s = problems(case)
    n, m = pb.n, pb.m
    rng = np.random.default_rng(seed)
    x0 = np.asarray(s.x0)[None] + 0.1 * rng.normal(size=(B, n))
    for lane, p in edge_starts(pb).items():
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
    # γ is not 0 on the tie lane, so that its h(x)'s tangent, which f̂ weighs by γ, counts
    bp = BarrierParams(*(t64(v) for v in ([0.0, 0.05, 0.1], [0.25, 0.3, -0.2], [0.0, 0.02, 0.0])))
    w = CostWeights(Q=t64(rng.uniform(0.5, 2.0, (B, n))), R=t64(rng.uniform(0.5, 2.0, (B, m))),
                    Qf=t64(rng.uniform(10.0, 100.0, (B, n))), qb=t64(rng.uniform(0.2, 1.0, B)))
    C = _build_C(pb, w, bp, B, torch.float64, "cpu")
    X = rollout(pb, x_hat0, t64(U).contiguous(), t64(Xr), t64(Ur), C)
    return dict(x_hat0=x_hat0, X=X, U=t64(U).contiguous(), Xr=t64(Xr), Ur=t64(Ur), C=C)


def branch_counts(pb, X, C):
    """(ties, below): the (step, lane) pairs of X [N, n̂, B] at which the first two
    obstacles' h_i tie as the least of all, and those with h - tight < eps."""
    sp = pb.spec
    tight = C[2 * pb.n_hat + pb.m + 2]
    px, py = X[:, 0], X[:, 1]
    if not sp.centers:
        return 0, int((sp.x_lim * sp.x_lim - px * px - tight < pb.eps).sum())
    hs = torch.stack([(px - cx) * (px - cx) + (py - cy) * (py - cy) - r * r
                      for (cx, cy), r in zip(sp.centers, sp.radii)])
    h = hs.amin(dim=0)
    ties = int(((hs[0] == hs[1]) & (hs[0] == h)).sum())
    return ties, int((h - tight < pb.eps).sum())
