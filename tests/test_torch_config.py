"""The port's config layer (tube_mpc_tpu_torch/utils/config.py) against the JAX package's
(tube_mpc_tpu/utils/config.py), on the CPU.

Every leaf of ``build_experiment`` equals the JAX package's on the same YAML: the four
shipped configs in paper mode and in generic mode (adapt_nominal: true, and Dubins with
paper_dubins_mode: false), in f64 and as shipped in f32, a singular ``environment.obstacle``
and the cart-pole's ``environment: {}``. Parameters and tensors must be equal; the
systems' functions (f, h, f̂, the initial barrier state) must agree on random points, in
f64 at rtol 1e-12 and in f32 at rtol 1e-6 (the two libraries' transcendentals round
differently in the last bit). Then validate_for_engine's refusals, which come before any
kernel is built. load_config reads YAML through PyYAML, as the JAX package does.
"""
import copy
import dataclasses
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tube_mpc_tpu.utils import config as jcfg

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.ops.cuda import _build
from tube_mpc_tpu_torch.utils import config as pcfg

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("dubins", "double_integrator", "quadrotor2d", "cartpole")


def raw_of(name, **changes):
    """configs/<name>.yaml as a dict, with top-level or "section.key" changes."""
    with open(REPO / "configs" / f"{name}.yaml", "r", encoding="utf-8") as f:
        raw = copy.deepcopy(yaml.safe_load(f))
    for key, value in changes.items():
        if "." in key:
            section, leaf = key.split(".")
            raw.setdefault(section, {})[leaf] = value
        else:
            raw[key] = value
    return raw


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_tensor(p, j, what):
    a, b = _arr(p), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(p, j, rtol, what):
    a, b = _arr(p), np.asarray(j)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol, err_msg=what)


def check_built(raw, **kw):
    """Build ``raw`` in both packages and compare every leaf."""
    mine = pcfg.build_experiment(pcfg.parse_config(raw), device="cpu", **kw)
    ref = jcfg.build_experiment(jcfg.parse_config(raw), **kw)
    assert dataclasses.asdict(mine.cfg) == dataclasses.asdict(ref.cfg)
    assert dataclasses.asdict(mine.tube_cfg) == dataclasses.asdict(ref.tube_cfg)
    f64 = mine.cfg.use_float64
    assert mine.cfg.dtype == (torch.float64 if f64 else torch.float32)
    rtol = 1e-12 if f64 else 1e-6
    for tree in ("w_nominal", "aux_init", "w_aux_full", "bp"):
        p, j = getattr(mine, tree), getattr(ref, tree)
        assert p._fields == j._fields
        for f in p._fields:
            _same_tensor(getattr(p, f), getattr(j, f), f"{tree}.{f}")
    _same_tensor(mine.x0, ref.x0, "x0")
    _same_tensor(mine.target, ref.target, "target")
    if ref.field is None:
        assert mine.field is None
    else:
        _same_tensor(mine.field.centers, ref.field.centers, "field.centers")
        _same_tensor(mine.field.radii, ref.field.radii, "field.radii")

    ps, js = mine.system, ref.system
    assert (ps.name, ps.nx, ps.nu, tuple(ps.angle_dims)) == (js.name, js.nx, js.nu,
                                                           tuple(js.angle_dims))
    for f in ("u_min", "u_max", "x_target", "w_low", "w_high"):
        _same_tensor(getattr(ps, f), getattr(js, f), f"system.{f}")
    assert (mine.aug.nx_hat, mine.aug.nu) == (ref.aug.nx_hat, ref.aug.nu)

    # the functions on random points around the start and the target
    rng = np.random.default_rng(7)
    dt = np.float64 if f64 else np.float32
    nx, nu = js.nx, js.nu
    x = (np.asarray(ref.x0)[None] + rng.normal(scale=2.0, size=(16, nx))).astype(dt)
    u = rng.uniform(np.asarray(js.u_min), np.asarray(js.u_max), size=(16, nu)).astype(dt)
    b = rng.uniform(0.1, 2.0, size=(16, 1)).astype(dt)
    xh = np.concatenate([x, b], axis=1)
    pt, jt = (lambda a: torch.as_tensor(a)), jnp.asarray
    _close(ps.f(pt(x), pt(u)), js.f(jt(x), jt(u)), rtol, "system.f")
    _close(ps.h(pt(x)), js.h(jt(x)), rtol, "system.h")
    _close(mine.aug.f_hat(pt(xh), pt(u), mine.bp), ref.aug.f_hat(jt(xh), jt(u), ref.bp), rtol,
           "aug.f_hat")
    _close(mine.aug.init_b0(pt(x), mine.bp), ref.aug.init_b0(jt(x), ref.bp), rtol,
           "aug.init_b0")
    return mine, ref


CASES = [(name, mode, f64) for name in CONFIGS for mode in ("paper", "generic")
         for f64 in (True, False)]


@pytest.mark.parametrize("name,mode,f64", CASES, ids=[f"{n}-{m}-{'f64' if f else 'f32'}"
                                                      for n, m, f in CASES])
def test_build_experiment_matches_jax(name, mode, f64):
    raw = raw_of(name, use_float64=f64,
                 **({"adaptation.adapt_nominal": True} if mode == "generic" else {}))
    mine, _ = check_built(raw)
    assert mine.tube_cfg.reg == (1e-6 if mode == "paper" else raw["system"]["ilqr_reg"])
    assert mine.device == torch.device("cpu")


def test_build_experiment_matches_jax_without_paper_dubins_mode():
    """paper_dubins_mode: false selects the generic path too: reg is the file's ilqr_reg."""
    mine, _ = check_built(raw_of("dubins", use_float64=True, paper_dubins_mode=False))
    assert mine.tube_cfg.reg == 1e-3 and not mine.tube_cfg.adapt_nominal


def test_singular_obstacle_is_single_aggregation():
    raw = raw_of("dubins", use_float64=True)
    raw["environment"].pop("obstacles")
    raw["environment"]["obstacle"] = {"center": [5.0, 5.0], "radius": 1.5}
    mine, _ = check_built(raw)
    assert mine.cfg.environment.obstacle_aggregation == "single"
    assert len(mine.cfg.environment.obstacles) == 1


def test_empty_environment():
    """The cart-pole ships `environment: {}` (its h is the track limit); a circle system
    without obstacles has no h, and both packages refuse to build it."""
    raw = raw_of("cartpole", use_float64=True)
    assert raw["environment"] == {}
    mine, _ = check_built(raw)
    assert mine.cfg.environment.obstacle_aggregation == "min" and mine.field is None
    bare = raw_of("dubins", use_float64=True, environment={})
    with pytest.raises(ValueError, match="needs a safety function h"):
        jcfg.build_experiment(jcfg.parse_config(bare))
    with pytest.raises(ValueError, match="needs a safety function h"):
        pcfg.build_experiment(pcfg.parse_config(bare), device="cpu")


def test_defaults_and_fallbacks_match_jax():
    """A config with only the system's name and the obstacles: every default and
    fallback (Qf to ones, the ancillary weights, x0 from the registry, the aggregation
    "min", reg) as the JAX package's."""
    raw = {"system": {"name": "double_integrator", "target": [10.0, 10.0, 0.0, 0.0]},
           "cost_nominal": {"Q": [1.0] * 4, "R": [0.5, 0.5]},
           "cost_auxiliary": {"Q": [], "R": []},
           "environment": {"obstacles": [{"center": [4.0, 4.0], "radius": 1.0}]},
           "use_float64": True, "adaptation": {"adapt_nominal": False}}
    mine, _ = check_built(raw)
    assert mine.cfg.environment.obstacle_aggregation == "min"
    assert torch.equal(mine.w_nominal.Qf, torch.ones(4, dtype=torch.float64))
    assert torch.equal(mine.aux_init.Q, torch.ones(4, dtype=torch.float64))


def test_load_config_reads_the_yaml_as_the_jax_package():
    for name in CONFIGS:
        path = str(REPO / "configs" / f"{name}.yaml")
        assert pcfg.read_yaml(path) == yaml.safe_load(open(path, encoding="utf-8"))
        assert dataclasses.asdict(pcfg.load_config(path)) == dataclasses.asdict(
            jcfg.load_config(path))


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_pass_the_lane_engine_checks(name):
    built = pcfg.build_experiment(pcfg.load_config(str(REPO / "configs" / f"{name}.yaml")),
                                  device="cpu")
    pcfg.validate_for_engine(built, "lanes")


def _refusals():
    obstacle = raw_of("dubins")
    obstacle["environment"].pop("obstacles")
    obstacle["environment"]["obstacle"] = {"center": [5.0, 5.0], "radius": 1.5}
    return {
        "single": (obstacle, r"not 'single'.*unsupported aggregation for component form: "
                             r"single"),
    }


@pytest.mark.parametrize("what", ["single"])
def test_lane_engine_refuses_what_the_kernels_do_not_take(what, monkeypatch, tmp_path):
    """validate_for_engine refuses the single aggregation (a singular obstacle), which
    neither package's lane engine runs, with the JAX component forms' reason; the runner
    refuses it before it builds a kernel or runs a loop."""
    raw, match = _refusals()[what]
    built = pcfg.build_experiment(pcfg.parse_config(raw), device="cpu")
    with pytest.raises(ValueError, match=match):
        pcfg.validate_for_engine(built, "lanes")
    pcfg.validate_for_engine(built, "xla")   # no lane envelope for another engine
    monkeypatch.setattr(_build, "build", lambda *a, **k: pytest.fail("built a kernel"))
    for loop in ("run_paper_closed_loop_lanes", "run_generic_closed_loop_lanes"):
        monkeypatch.setattr(runners, loop, lambda *a, **k: pytest.fail("ran a loop"))
    with pytest.raises(ValueError, match=match):
        runners.run_experiment(pcfg.parse_config(raw), str(tmp_path / "run"), device="cpu")
    assert not (tmp_path / "run").exists()


def test_lane_engine_refuses_wide_control_spaces():
    """nu > 2, as the JAX package refuses it (tests/test_configs.py), naming the engine
    that runs it, which takes it."""
    fake = types.SimpleNamespace(
        system=types.SimpleNamespace(nu=3),
        cfg=types.SimpleNamespace(system=types.SimpleNamespace(name="wide_arm")))
    with pytest.raises(ValueError, match=r"nu <= 2.*Use --engine xla"):
        pcfg.validate_for_engine(fake, "lanes")
    with pytest.raises(ValueError, match="nu <= 2"):
        jcfg.validate_for_engine(fake, "lanes")
    pcfg.validate_for_engine(fake, "xla")


def test_build_experiment_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcfg.build_experiment(pcfg.load_config(str(REPO / "configs" / "dubins.yaml")))
