"""K4's plain version (sfwd_plain) against the JAX package's Pallas kernel _sfwd_kernel in
interpret mode, in f64 on the CPU, on the double integrator (smooth-min or exact min,
inverse or log barrier) and the cart-pole (inverse or log barrier), at the edges that the
card holds their K4 kernel to (chip_smoke.py: SFWD_STAGED, sfwd_edge_inputs): horizons of
N = 1, 2, 3, 4, 7 steps (fewer than, or not a multiple of, the kernel's chunks of three),
B = 1, 31, 33 lanes (one lane, and a 32-lane block less or more one), and K, kff or X not
finite (inf, -inf, NaN, inf) on four lanes.

Inputs: torch_family_cases.kernel_inputs (rollouts of seeded numpy draws) at N=7 and 33
lanes, the gains from sbwd_plain on them, each case their first N steps and first B lanes.
The JAX kernel pads the lanes to one block of 128 and treats each alone, so it runs once a
(system, N) on the 33 lanes. Tolerance: rtol 1e-9, atol 1e-11
(tests/test_lane_sensitivity.py:97-99); where JAX gives NaN or an infinity, the same.
"""
import functools
import importlib.util
import sys

import numpy as np
import pytest
import torch

from tube_mpc_tpu.systems.registry import build_components as j_build_components
from tube_mpc_tpu.tube.lane_interface import make_lane_problem as j_make_lane_problem

from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sfwd_plain
from tube_mpc_tpu_torch.systems.registry import build_components
from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

from torch_family_cases import EPS, REPO, jax_family, jax_sfwd, kernel_inputs

_spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
chip_smoke = sys.modules.setdefault("chip_smoke", importlib.util.module_from_spec(_spec))
_spec.loader.exec_module(chip_smoke)

VARIANTS = {  # library variant: (family, obstacle aggregation (None: the config's), barrier)
    "double_integrator": ("double_integrator", "smoothmin", "inverse"),
    "double_integrator_min": ("double_integrator", "min", "inverse"),
    "double_integrator_log": ("double_integrator", "smoothmin", "log"),
    "double_integrator_min_log": ("double_integrator", "min", "log"),
    "cartpole": ("cartpole", None, "inverse"),
    "cartpole_log": ("cartpole", None, "log"),
}
N_MAX, B_MAX = 7, 33
NONFINITE = slice(4, 8)   # four lanes within B_MAX
REG_SENS, ACTIVE_TOL = 1e-9, 1e-8
RTOL, ATOL = 1e-9, 1e-11


@functools.lru_cache(maxsize=None)
def problems(variant):
    """(the port's LaneProblem, the JAX one) of a library variant, from its family's config."""
    family, aggregation, barrier = VARIANTS[variant]
    ycfg = jax_family(family, N=6, H=3)[3]
    env, sc = ycfg.environment, ycfg.system
    kw = dict(dt=sc.dt, control_bounds=dict(sc.control_bounds),
              obstacles=[dict(o) for o in env.obstacles] or None,
              aggregation=aggregation or env.obstacle_aggregation,
              beta=env.obstacle_smoothmin_beta, extra=dict(sc.extra))
    return (make_lane_problem(build_components(family, **kw), barrier_type=barrier, eps=EPS),
            j_make_lane_problem(j_build_components(family, **kw), barrier_type=barrier, eps=EPS))


@functools.lru_cache(maxsize=None)
def inputs(variant):
    """K4's inputs (K, kff, X, Xr, U, Ur, C, XN, XrN) at N_MAX steps and B_MAX lanes."""
    pb = problems(variant)[0]
    d = kernel_inputs(VARIANTS[variant][0], seed=23 + list(VARIANTS).index(variant), N=N_MAX,
                      B=B_MAX)
    X, Xr, U, C = d["X"], d["Xr"], d["U"], d["C"]
    K, kff = sbwd_plain(pb, REG_SENS, ACTIVE_TOL, U, X[:-1], Xr[:-1], C, X[-1], Xr[-1])
    return (K, kff, X[:-1], Xr[:-1], U, d["Ur"], C, X[-1], Xr[-1])


def first(ins, N, B):
    """The first N steps and B lanes of K4's inputs."""
    return tuple((t[:N] if t.ndim == 3 else t)[..., :B] for t in ins)


@functools.lru_cache(maxsize=None)
def jax_at(variant, N):
    return jax_sfwd(problems(variant)[1], *(t.numpy() for t in first(inputs(variant), N, B_MAX)))


def assert_matches(port, ref, B):
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert p.shape == r[..., :B].shape
        np.testing.assert_allclose(p.numpy(), r[..., :B], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B", (1, 31, 33))
@pytest.mark.parametrize("N", (1, 2, 3, 4, 7))
@pytest.mark.parametrize("variant", VARIANTS)
def test_sfwd_plain_matches_pallas_kernel_at_short_horizons(variant, N, B):
    ref = jax_at(variant, N)
    assert all(np.isfinite(r).all() for r in ref)
    assert_matches(sfwd_plain(problems(variant)[0], *first(inputs(variant), N, B)), ref, B)


@pytest.mark.parametrize("what", ("K", "kff", "X"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_sfwd_plain_matches_pallas_kernel_on_lanes_not_finite(variant, what):
    """chip_smoke.sfwd_edge_inputs' inputs with `what` not finite on four lanes at every
    step: those lanes' sums are not finite, the others' are, in both."""
    edges = dict(chip_smoke.sfwd_edge_inputs(torch, inputs(variant), lanes=NONFINITE))
    ins = edges[f"{what} not finite on four lanes of one warp"]
    pb, j_pb = problems(variant)
    ref = jax_sfwd(j_pb, *(t.numpy() for t in ins))
    bad = np.zeros(B_MAX, dtype=bool)
    bad[NONFINITE] = True
    finite = np.all([np.isfinite(r).all(axis=0) for r in ref], axis=0)
    assert not finite[bad].any() and finite[~bad].all()
    assert_matches(sfwd_plain(pb, *ins), ref, B_MAX)
