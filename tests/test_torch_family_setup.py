"""The port's family setups against the JAX package's reading of the shipped YAML.

presets.family_paper_setup holds configs/<name>.yaml's numbers as Python constants (the
card's machine has no YAML reader); every field is pinned here against
``build_experiment(load_config("configs/<name>.yaml"), paper_mode=True)`` with N and H
replaced, as bench.py's BENCH_SYSTEM builds it, and convert.family_setup_from_numpy
carries the JAX setup across to the same setup.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tube_mpc_tpu_torch.convert import family_setup_from_numpy
from tube_mpc_tpu_torch.presets import family_paper_setup

from torch_family_cases import FAMILIES, jax_family, setup_as_numpy

N, H = 50, 300   # bench.py's forced sizes


def _same(mine, ref, what):
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=what)
    assert mine.dtype == torch.float64, what


@pytest.fixture(scope="module", params=FAMILIES)
def both(request):
    name = request.param
    built, cfg, j_sys_c, ycfg = jax_family(name, N=N, H=H)
    mine = family_paper_setup(name, N=N, H=H, device="cpu", dtype=torch.float64)
    return name, mine, built, cfg, j_sys_c, ycfg


def test_config_matches_build_experiment(both):
    _, mine, _, cfg, _, ycfg = both
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(cfg)
    assert mine.cfg.reg == 1e-6 and mine.cfg.tol == 1e-3   # the paper path's
    assert (mine.cfg.adapt.grad_clip_norm, mine.cfg.adapt.project) == (1.0, True)
    assert mine.eps == ycfg.dbas.eps and ycfg.dbas.barrier_type == "inverse"


def test_weights_barrier_start_and_target_match(both):
    _, mine, built, _, _, _ = both
    for f in ("Q", "R", "Qf", "qb"):
        _same(getattr(mine.w_nominal, f), getattr(built.w_nominal, f), f"w_nominal.{f}")
    for f in ("Q", "R", "qb"):
        _same(getattr(mine.aux_init, f), getattr(built.aux_init, f), f"aux_init.{f}")
    for f in ("alpha", "gamma", "tight"):
        _same(getattr(mine.bp, f), getattr(built.bp, f), f"bp.{f}")
    _same(mine.x0, built.x0, "x0")
    _same(mine.target, built.target, "target")


def test_system_and_components_match(both):
    name, mine, built, _, j_sys_c, ycfg = both
    js, ps = built.system, mine.system
    assert (ps.name, ps.nx, ps.nu) == (js.name, js.nx, js.nu) == (name, js.nx, js.nu)
    for f in ("u_min", "u_max", "x_target", "w_low", "w_high"):
        _same(getattr(ps, f), getattr(js, f), f)
    c = mine.sys_c
    assert (c.n, c.m, c.u_min, c.u_max) == (j_sys_c.n, j_sys_c.m, j_sys_c.u_min, j_sys_c.u_max)
    obs = [dict(o) for o in ycfg.environment.obstacles]
    assert c.spec.family == name and c.spec.dt == ycfg.system.dt
    assert c.spec.centers == tuple(tuple(float(v) for v in o["center"]) for o in obs)
    assert c.spec.radii == tuple(float(o["radius"]) for o in obs)
    if obs:
        assert c.spec.beta == ycfg.environment.obstacle_smoothmin_beta
        _same(mine.field.centers, built.field.centers, "centers")
        _same(mine.field.radii, built.field.radii, "radii")
    else:
        assert mine.field is None and built.field is None
        assert c.spec.x_lim == float(ycfg.system.extra["x_lim"])


def test_convert_carries_the_jax_setup_across(both):
    name, mine, built, cfg, _, ycfg = both
    s = family_setup_from_numpy(name, setup_as_numpy(built, cfg, ycfg), device="cpu",
                                dtype=torch.float64)
    assert s.cfg == mine.cfg and s.sys_c.spec == mine.sys_c.spec and s.eps == mine.eps
    for a, b in ((s.w_nominal, mine.w_nominal), (s.aux_init, mine.aux_init), (s.bp, mine.bp)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(s.x0, mine.x0) and torch.equal(s.target, mine.target)


def test_family_setup_is_f32_on_request_and_refuses_unknown_names():
    s = family_paper_setup("cartpole", N=4, H=2, device="cpu")
    assert s.x0.dtype == torch.float32 and s.system.u_max.dtype == torch.float32
    with pytest.raises(ValueError, match="no paper setup"):
        family_paper_setup("dubins", device="cpu")
