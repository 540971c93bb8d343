"""The port as a package: what it imports, how it resolves its device, and how a
setup and a loop state are carried across from the JAX package.
"""
import ast
import dataclasses
import importlib
import importlib.util
import re
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.tube.lane_closed_loop import generic_lane_init_state as j_generic_lane_init_state
from tube_mpc_tpu.tube.lane_closed_loop import paper_lane_init_state as j_paper_lane_init_state
from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta

import tube_mpc_tpu_torch
from tube_mpc_tpu_torch.convert import (
    generic_lane_state_from_numpy,
    lane_state_from_numpy,
    raw_aux_from_numpy,
    raw_nom_from_numpy,
    setup_from_numpy,
)
from tube_mpc_tpu_torch.device import resolve_device
from tube_mpc_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launch_counts
from tube_mpc_tpu_torch.ops.cuda import _build
from tube_mpc_tpu_torch.ops.cuda import lane_sensitivity as sens
from tube_mpc_tpu_torch.ops.cuda.lane_solver import kernel_consts, on_cpu
from tube_mpc_tpu_torch.ops.lanes import dubins_components
from tube_mpc_tpu_torch.presets import dubins_paper_setup, family_paper_setup
from tube_mpc_tpu_torch.tube.lane_closed_loop import (
    generic_lane_init_state,
    paper_lane_init_state,
    run_generic_closed_loop_lanes,
    run_paper_closed_loop_lanes,
)
from tube_mpc_tpu_torch.tube.lane_interface import (
    make_lane_problem,
    tube_ilqr_solve_lanes,
    tube_sensitivity_grads_lanes,
    tube_sensitivity_grads_lanes_generic,
    tube_sensitivity_grads_lanes_nominal_coupled,
)

from test_torch_lane_closed_loop import setup_as_numpy

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "tube_mpc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tube_mpc_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / "tools" / f"{name}.py" for name in ("port_kernel_ab", "ric_probe", "port_quick_check",
                                                    "riccati_asymmetry_probe")]


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert path.exists()
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_family_modules_are_held_by_the_no_jax_rule():
    """The no-JAX rule above covers every module of the package, the families' too."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {"systems/double_integrator.py", "systems/quadrotor2d.py", "systems/cartpole.py",
            "systems/registry.py", "presets.py", "convert.py", "ops/lanes.py"} <= held


def test_entry_point_modules_are_held_by_the_no_jax_rule():
    """The no-JAX rule above covers the experiment entry point's modules: the config
    layer, the run-directory artifacts, the finite check, the runner and the CLI."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {"utils/__init__.py", "utils/config.py", "utils/io.py", "utils/debug.py",
            "runners.py", "run_experiment.py"} <= held


def test_xla_engine_modules_are_held_by_the_no_jax_rule():
    """The no-JAX rule above covers the feature-major (XLA) engine's modules, its
    horizon-parallel sweep (solvers/pscan.py) and the two CLIs that run on it."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {"ops/linalg.py", "solvers/ocp.py", "solvers/ilqr.py", "solvers/sensitivity.py",
            "solvers/ift.py", "solvers/weight_grads.py", "solvers/diff_ilqr.py",
            "solvers/pscan.py", "tube/problem.py", "tube/closed_loop.py", "run_nominal.py",
            "gradient_check.py"} <= held


def test_checkpoint_profiling_and_plotting_modules_are_held_by_the_no_jax_rule():
    """The no-JAX rule above covers the checkpoint, profiling and plotting modules; the
    plotting module keeps its own copy of the JAX package's framework-free plot_run."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {"utils/checkpoint.py", "utils/profiling.py", "plotting.py"} <= held


def test_scenario_layer_modules_are_held_by_the_no_jax_rule():
    """The no-JAX rule above covers the scenario layer: the mesh, the scenario engines and
    the package that exports them, the JAX module's names."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/scenarios.py"} <= held
    from tube_mpc_tpu_torch import parallel

    assert parallel.__all__ == [
        "SCENARIO_AXIS", "make_mesh", "scenario_sharding", "replicated", "init_distributed",
        "vmap_paper_closed_loop", "tube_verification", "TubeStats", "run_population_adaptation"]


def test_prng_module_is_held_by_the_no_jax_rule():
    """The no-JAX rule above covers the threefry draws (utils/prng.py) that every entry
    point's disturbances come from, and no function of the package draws from a
    torch.Generator any more: each takes the JAX function's key."""
    held = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    assert "utils/prng.py" in held
    for path in _sources():
        if PKG in path.parents:
            assert "torch.Generator" not in path.read_text(), path.relative_to(REPO)


def test_package_imports_without_nvcc_and_builds_nothing():
    """Every module imports in a process whose PATH holds no nvcc, importing builds no
    kernel, and nothing imports matplotlib (only plot_run does, when called)."""
    code = (
        "import importlib, pkgutil, sys, tube_mpc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'tube_mpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from tube_mpc_tpu_torch.ops.cuda import _build\n"
        "assert not _build._LIBS and not _build.BUILD_LOG\n"
        "assert not any(n in sys.modules for n in ('jax', 'tube_mpc_tpu', 'matplotlib'))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(Path(sys.executable).parent), PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_every_module_imports_here():
    names = [m.name for m in pkgutil.walk_packages(tube_mpc_tpu_torch.__path__,
                                                   "tube_mpc_tpu_torch.")]
    assert "tube_mpc_tpu_torch.ops.cuda.lane_solver" in names
    for name in names:
        importlib.import_module(name)
    assert set(launch_counts()) == {"ric", "fwd", "sbwd", "sfwd", "sbwd_generic", "sbwd_upper",
                                    "sfwd_generic", "sfwd_ref"}


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card and no device='cpu' the entry points raise; they never carry
    on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dubins_paper_setup(N=4, H=2)
    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    B = 2
    x_hat0 = torch.zeros((B, 4), dtype=torch.float64)
    U = torch.zeros((B, 4, 2), dtype=torch.float64)
    X_ref = torch.zeros((B, 5, 3), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tube_ilqr_solve_lanes(pb, s.cfg.aux_ilqr(), w=s.w_nominal, bp=s.bp, x_hat0=x_hat0,
                              U_init=U, X_ref=X_ref, U_ref=U)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tube_sensitivity_grads_lanes(pb, w=s.w_nominal, bp=s.bp,
                                     X_hat=torch.zeros((B, 5, 4), dtype=torch.float64),
                                     U=U, X_ref=X_ref, U_ref=U)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target,
            w_seqs=torch.zeros((B, 2, 3), dtype=torch.float64), eps=s.eps)
    X_hat = torch.zeros((B, 5, 4), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tube_sensitivity_grads_lanes_generic(pb, w=s.w_nominal, bp=s.bp, X_hat=X_hat, U=U,
                                             X_ref=X_ref, U_ref=U, emit_ref_grads=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tube_sensitivity_grads_lanes_nominal_coupled(pb, w=s.w_nominal, bp=s.bp, X_hat=X_hat,
                                                     U=U, target=s.target, upper_gX=X_hat,
                                                     upper_gU=U)
    raws = dict(Q_raw=[1.0] * 3, R_raw=[1.0] * 2, Qf_raw=[1.0] * 3, qb_raw=1.0, alpha_raw=0.0,
                gamma_raw=0.0)
    coupled = dataclasses.replace(s.cfg, adapt_nominal=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_generic_closed_loop_lanes(
            s.system, s.aug, s.sys_c, coupled,
            raw_nom=raw_nom_from_numpy(dict(raws, tight_raw=0.0), "cpu", torch.float64),
            raw_aux_init=raw_aux_from_numpy(raws, "cpu", torch.float64), x0=s.x0,
            target=s.target, w_seqs=torch.zeros((B, 2, 3), dtype=torch.float64), eps=s.eps)
    from tube_mpc_tpu_torch.parallel import (
        make_mesh,
        run_population_adaptation,
        tube_verification,
    )

    w = torch.zeros((B, 2, 3), dtype=torch.float64)
    for sys_c in (None, s.sys_c):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tube_verification(s.system, s.aug, s.cfg, w_nominal=s.w_nominal, w_aux=s.w_nominal,
                              bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, sys_c=sys_c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_population_adaptation(s.system, s.aug, s.cfg, w_nominal=s.w_nominal,
                                  aux_init=s.aux_init, bp=s.bp, x0_batch=s.x0.expand(B, 3),
                                  target=s.target, w_seqs=w)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="requested but no CUDA device"):
        resolve_device("cuda")


def test_wrappers_take_cpu_or_cuda_tensors_only():
    cpu = torch.zeros(3)
    assert on_cpu(cpu, cpu)
    with pytest.raises(ValueError, match="lie on meta"):
        on_cpu(torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        on_cpu(cpu, torch.zeros(3, device="meta"))


def _c_entry_tensor_counts():
    """{entry point: number of tensor pointers} of the C entry points of csrc/lane_sbwd.cu
    and lane_sfwd.cu (each ends with N, B, the constants and the stream)."""
    src = "".join((PKG / "csrc" / f"{name}.cu").read_text() for name in ("lane_sbwd", "lane_sfwd"))
    out = {}
    for name, params in re.findall(r"int (lane_\w+?)_##SUFFIX\((.*?)\)", src, flags=re.S):
        out[name] = params.count("void*") - 1
    return out


def test_sensitivity_variants_launch_their_own_entry_points(monkeypatch):
    """Each variant's wrapper takes its plain version for CPU tensors and counts
    nothing; for CUDA tensors it calls its own C entry point with as many tensors as
    that entry takes, and counts one launch on its own counter only. (No card here:
    the device test and the launch itself are stood in for.)"""
    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    B, N = 3, 4
    rng = np.random.default_rng(5)
    t = lambda *shape: torch.as_tensor(rng.normal(size=shape))
    U, X, Xr, C, XN, XrN = t(N, 2, B), t(N, 4, B), t(N, 4, B), t(13, B).abs(), t(4, B), t(4, B)
    upper = (t(N, 4, B), t(N, 2, B), t(4, B))
    calls = {
        "sbwd": lambda: sens.sbwd(pb, 1e-9, 1e-8, U, X, Xr, C, XN, XrN),
        "sbwd_generic": lambda: sens.sbwd_generic(pb, 1e-9, 1e-8, U, X, Xr, C, XN, XrN),
        "sbwd_upper": lambda: sens.sbwd_upper(pb, 1e-9, 1e-8, *upper, U, X, C),
    }
    K, kff, tVx, Vxx, LogS = sens.sbwd_plain(pb, 1e-9, 1e-8, U, X, Xr, C, XN, XrN, generic=True)
    fwd = (K, kff, X, Xr, U, t(N, 2, B), C, XN, XrN)
    calls.update({
        "sfwd": lambda: sens.sfwd(pb, *fwd),
        "sfwd_generic": lambda: sens.sfwd_generic(pb, *fwd, tVx, Vxx, LogS),
        "sfwd_ref": lambda: sens.sfwd_ref(pb, *fwd, tVx, Vxx, LogS),
    })
    reset_launch_counts()
    plain = {name: call() for name, call in calls.items()}
    assert not any(launch_counts().values())
    assert [len(plain[n]) for n in calls] == [2, 5, 5, 2, 4, 7]

    entries = _c_entry_tensor_counts()
    launched = []

    def fake_launch(lib, fn, dtype, device, tensors, n, b, consts):
        assert lib == "lane_" + fn.split("_")[1] and lib in _build.SOURCES and (n, b) == (N, B)
        launched.append((fn, len(tensors)))

    monkeypatch.setattr(sens, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(sens, "launch", fake_launch)
    done = []
    for name, call in calls.items():
        out = call()
        done.append(name)
        assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in plain[name]]
        fn, n_tensors = launched[-1]
        assert fn == f"lane_{name}" and entries[fn] == n_tensors, (fn, n_tensors, entries)
        assert launch_counts() == {k: int(k in done) for k in KERNELS}
        assert launch_counts(by_system=True) == {(k, "dubins"): 1 for k in done}
    assert set(entries) == {f"lane_{name}" for name in calls}
    # a family's problem counts on that family's own counter
    fam = family_paper_setup("double_integrator", N=N, H=2, device="cpu", dtype=torch.float64)
    q = make_lane_problem(fam.sys_c, eps=fam.eps)
    nh, m = q.n_hat, q.m
    sens.sbwd_generic(q, 1e-9, 1e-8, t(N, m, B), t(N, nh, B), t(N, nh, B),
                      t(2 * nh + m + 3, B).abs(), t(nh, B), t(nh, B))
    assert launched[-1][0] == "lane_sbwd_generic"
    assert launch_counts(by_system=True)[("sbwd_generic", "double_integrator")] == 1
    assert launch_counts()["sbwd_generic"] == 2
    reset_launch_counts()
    assert launch_counts(by_system=True) == {}


@pytest.mark.parametrize("loop,change,match", [
    ("generic", dict(adapt_ancillary=False), "adapt_ancillary=False"),
    ("generic", dict(coupling="exact"), "coupling must be"),
    ("paper", dict(adapt_ancillary=False), "ancillary θ only"),
    ("paper", dict(adapt_nominal=True), "ancillary θ only"),
])
def test_lane_loops_refuse_modes_they_do_not_run(loop, change, match):
    """A TubeMPCConfig mode that a lane loop does not run raises before any work,
    rather than being ignored."""
    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    cfg = dataclasses.replace(s.cfg, **change)
    w = torch.zeros((2, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        if loop == "paper":
            run_paper_closed_loop_lanes(
                s.system, s.aug, s.sys_c, cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
                bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device="cpu")
        else:
            raws = dict(Q_raw=[1.0] * 3, R_raw=[1.0] * 2, Qf_raw=[1.0] * 3, qb_raw=1.0,
                        alpha_raw=0.0, gamma_raw=0.0)
            run_generic_closed_loop_lanes(
                s.system, s.aug, s.sys_c, cfg,
                raw_nom=raw_nom_from_numpy(dict(raws, tight_raw=0.0), "cpu", torch.float64),
                raw_aux_init=raw_aux_from_numpy(raws, "cpu", torch.float64), x0=s.x0,
                target=s.target, w_seqs=w, eps=s.eps, device="cpu")


def test_kernel_constants_refuse_what_the_kernels_do_not_take():
    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    k = kernel_consts(pb, reg=1e-6, alphas=(1.0, 0.5), active_tol=1e-8)
    assert (k.n_obs, k.n_alphas, k.reg, k.eps) == (5, 2, 1e-6, s.eps)
    assert k.act_lo[0] == -10.0 + 1e-8 and k.act_hi[1] == np.pi - 1e-8
    with pytest.raises(ValueError, match="at most 8 alphas"):
        kernel_consts(pb, alphas=(1.0,) * 9)
    many = dubins_components(dt=0.01, v_min=-1.0, v_max=1.0, omega_max=1.0,
                             centers=[(float(i), 0.0) for i in range(9)], radii=[0.5] * 9)
    with pytest.raises(ValueError, match="1 to 8 obstacles"):
        kernel_consts(make_lane_problem(many))
    # the constants carry the ids of the library variant that takes them
    assert (k.system, k.aggregation, k.barrier) == (0, 0, 0)
    log_pb = make_lane_problem(s.sys_c, barrier_type="log", eps=s.eps)
    k = kernel_consts(log_pb)
    assert (k.system, k.aggregation, k.barrier) == (0, 0, 1)
    min_c = dubins_components(dt=0.01, v_min=-1.0, v_max=1.0, omega_max=1.0,
                              centers=[(0.0, 0.0)], radii=[0.5], aggregation="min")
    k = kernel_consts(make_lane_problem(min_c, barrier_type="log"))
    assert (k.system, k.aggregation, k.barrier) == (0, 1, 1)
    assert _build.library_name("lane_sbwd", "dubins_min_log") == "lane_sbwd_min_log"
    with pytest.raises(ValueError, match="barriers"):
        kernel_consts(make_lane_problem(s.sys_c, barrier_type="exp", eps=s.eps))


@pytest.mark.parametrize("family,n_obs,m", [("double_integrator", 2, 2), ("quadrotor2d", 4, 2),
                                            ("cartpole", 0, 1)])
def test_kernel_constants_of_the_families(family, n_obs, m):
    """Each family's constants name its system and library; the bounds fill m entries;
    the products of constants are formed in double."""
    from tube_mpc_tpu_torch.presets import family_paper_setup

    s = family_paper_setup(family, N=4, H=2, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    k = kernel_consts(pb, reg=1e-6, alphas=s.cfg.alphas, active_tol=1e-8)
    assert (k.system, k.n_obs, k.n_alphas) == (_build.FAMILIES.index(family), n_obs,
                                               len(s.cfg.alphas))
    assert [k.u_max[a] for a in range(m)] == list(pb.u_max) and k.u_max[1] == (0.0 if m == 1 else
                                                                               pb.u_max[1])
    sp = pb.spec
    assert (k.total_m, k.mpl, k.x_lim2) == (sp.m_cart + sp.m_pole, sp.m_pole * sp.length,
                                             sp.x_lim * sp.x_lim)
    lib = _build.library_name("lane_solver", family)
    assert _build.LIBRARIES[lib] == ("lane_solver", family)
    assert f"-DLANE_SYSTEM={k.system}" in _build.flags(lib)
    assert _build.flags("lane_solver") == _build.NVCC_FLAGS   # Dubins: the default system


def test_kernel_constants_refuse_a_cartpole_with_obstacles_and_generic_family_kernels(monkeypatch):
    from tube_mpc_tpu_torch.ops import lanes
    from tube_mpc_tpu_torch.presets import family_paper_setup

    cp = lanes.cartpole_components(dt=0.02)
    bad = cp._replace(spec=dataclasses.replace(cp.spec, centers=((0.0, 0.0),), radii=(1.0,)))
    with pytest.raises(ValueError, match="takes no obstacles"):
        kernel_consts(make_lane_problem(bad))
    # the generic sensitivity kernels (K5) are built for every system: a family's wrapper
    # launches its own entry point with its system's constants
    s = family_paper_setup("double_integrator", N=4, H=2, device="cpu", dtype=torch.float64)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    B, N = 2, 4
    t = lambda *shape: torch.ones(shape, dtype=torch.float64)
    launched = []
    monkeypatch.setattr(sens, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(sens, "launch", lambda lib, fn, dtype, dev, tensors, n, b, consts:
                        launched.append((lib, fn, _build.FAMILIES[consts.system])))
    out = sens.sbwd_generic(pb, 1e-9, 1e-8, t(N, 2, B), t(N, 5, B), t(N, 5, B), t(15, B),
                            t(5, B), t(5, B))
    assert launched == [("lane_sbwd", "lane_sbwd_generic", "double_integrator")]
    assert [tuple(o.shape) for o in out] == [(N, 10, B), (N, 2, B), (N, 5, B), (N, 25, B),
                                              (N, 1, B)]


def test_build_needs_no_work_at_import_and_names_its_sources():
    assert _build.SOURCES == ("lane_solver", "lane_sbwd", "lane_sfwd")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        assert _build.library_path(name).parent == PKG / "_build"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cu*")), ids=lambda p: p.name)
def test_every_quoted_include_is_a_header_of_the_digest(path):
    """A kernel source includes, in quotes, only headers of _build.HEADERS, so that an edit
    to any of them changes every library's digest and rebuilds it."""
    quoted = re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), flags=re.M)
    assert set(quoted) <= set(_build.HEADERS), f"{path.name} includes {quoted}"
    for header in _build.HEADERS:
        assert (_build.CSRC / header).exists()


def test_an_edited_header_changes_every_librarys_digest(tmp_path, monkeypatch):
    for src in (PKG / "csrc").iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._digest(name) for name in _build.LIBRARIES}
    for header in _build.HEADERS:
        with open(tmp_path / header, "a") as f:
            f.write("\n// edited\n")
        after = {name: _build._digest(name) for name in _build.LIBRARIES}
        assert all(after[name] != before[name] for name in before), header
        before = after


@pytest.fixture(scope="module")
def jax_setup():
    return j_dubins_paper_setup(N=5, H=4, dtype=jnp.float64, nominal_max_iter=3,
                                aux_max_iter=4, alphas=(1.0, 0.5, 0.0))


def test_setup_round_trip(jax_setup):
    d = setup_as_numpy(jax_setup)
    s = setup_from_numpy(d, device="cpu", dtype=torch.float64)
    assert s.cfg.N == 5 and s.cfg.H == 4 and s.cfg.alphas == (1.0, 0.5, 0.0)
    assert (s.cfg.nominal_max_iter, s.cfg.aux_max_iter) == (3, 4)
    assert (s.cfg.tol, s.cfg.reg, s.cfg.adapt.lr, s.cfg.adapt.momentum) == (1e-3, 1e-6, 5e-2, 0.9)
    back = dict(
        w_nominal={f: getattr(s.w_nominal, f).numpy() for f in ("Q", "R", "Qf", "qb")},
        aux_init={f: getattr(s.aux_init, f).numpy() for f in ("Q", "R", "qb")},
        bp={f: getattr(s.bp, f).numpy() for f in ("alpha", "gamma", "tight")},
        x0=s.x0.numpy(), target=s.target.numpy(),
        centers=s.field.centers.numpy(), radii=s.field.radii.numpy(),
    )
    for key, value in back.items():
        ref = d[key]
        if isinstance(value, dict):
            for f in value:
                np.testing.assert_array_equal(value[f], ref[f])
        else:
            np.testing.assert_array_equal(value, ref)
    assert s.sys_c.spec.centers == tuple(tuple(c) for c in d["centers"].tolist())
    assert s.eps == 1e-4 and s.sys_c.spec.beta == 20.0
    # the port's own preset is the same setup
    p = dubins_paper_setup(N=5, H=4, device="cpu", dtype=torch.float64, nominal_max_iter=3,
                           aux_max_iter=4, alphas=(1.0, 0.5, 0.0))
    assert p.cfg == s.cfg
    np.testing.assert_array_equal(p.field.centers.numpy(), s.field.centers.numpy())


def test_lane_state_round_trip(jax_setup):
    js = jax_setup
    B = 4
    j_state = j_paper_lane_init_state(js.system, js.aug, js.cfg, aux_init=js.aux_init, bp=js.bp,
                                      x0=js.x0, B=B, dtype=jnp.float64)
    d = {f: np.asarray(getattr(j_state, f)) for f in ("x", "b", "x_bar", "b_bar",
                                                       "U_nom_ws", "U_aux_ws")}
    for f in ("adapt", "vel"):
        d[f] = {g: np.asarray(getattr(getattr(j_state, f), g)) for g in ("Q", "R", "qb")}
    state = lane_state_from_numpy(d, device="cpu", dtype=torch.float64)
    for f in ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), d[f])
    for f in ("adapt", "vel"):
        for g in ("Q", "R", "qb"):
            np.testing.assert_array_equal(getattr(getattr(state, f), g).numpy(), d[f][g])
    # the port's own initial state equals the JAX one (b0 through the logsumexp h)
    s = setup_from_numpy(setup_as_numpy(js), device="cpu", dtype=torch.float64)
    mine = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                 x0=s.x0, B=B, dtype=torch.float64)
    for f in ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws"):
        np.testing.assert_allclose(getattr(mine, f).numpy(), d[f], rtol=1e-12, atol=0.0)


def test_population_states_round_trip(jax_setup):
    """A population lane state (θ shared: [nx], [nu], []) and a population state of the
    scenarios (parallel/scenarios.py) carried across from the JAX package, leaf for leaf;
    the port's own initial states against the JAX ones."""
    from tube_mpc_tpu.parallel.scenarios import PopulationState as JPopulationState

    from tube_mpc_tpu_torch.convert import population_state_from_numpy
    from tube_mpc_tpu_torch.parallel.scenarios import PopulationState, _population_init

    js = jax_setup
    B = 3
    arrays = ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws")
    j_lane = j_paper_lane_init_state(js.system, js.aug, js.cfg, aux_init=js.aux_init, bp=js.bp,
                                     x0=js.x0, B=B, dtype=jnp.float64, population=True)
    x0_b = jnp.tile(js.x0, (B, 1)) + 0.1 * jnp.arange(B, dtype=jnp.float64)[:, None]
    b0 = js.aug.init_b0(x0_b, js.bp)
    zeros_U = jnp.zeros((B, js.cfg.N, 2), dtype=jnp.float64)
    j_pop = JPopulationState(x=x0_b, b=b0, x_bar=x0_b, b_bar=b0, U_nom_ws=zeros_U,
                             U_aux_ws=zeros_U, adapt=js.aux_init,
                             vel=type(js.aux_init)(*(jnp.zeros_like(v) for v in js.aux_init)))
    s = setup_from_numpy(setup_as_numpy(js), device="cpu", dtype=torch.float64)
    mine_lane = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                      x0=s.x0, B=B, dtype=torch.float64, population=True)
    mine_pop = _population_init(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                     x0_batch=torch.as_tensor(np.array(x0_b)))
    for convert_fn, j_state, mine in ((lane_state_from_numpy, j_lane, mine_lane),
                                      (population_state_from_numpy, j_pop, mine_pop)):
        d = {f: np.asarray(getattr(j_state, f)) for f in arrays}
        for f in ("adapt", "vel"):
            d[f] = {g: np.asarray(getattr(getattr(j_state, f), g)) for g in ("Q", "R", "qb")}
        state = convert_fn(d, device="cpu", dtype=torch.float64)
        assert type(state).__name__ == type(j_state).__name__
        assert tuple(state.adapt.Q.shape) == (3,) and tuple(state.adapt.qb.shape) == ()
        for f in arrays:
            np.testing.assert_array_equal(getattr(state, f).numpy(), d[f])
            np.testing.assert_allclose(getattr(mine, f).numpy(), d[f], rtol=1e-12, atol=0.0)
        for f in ("adapt", "vel"):
            for g in ("Q", "R", "qb"):
                np.testing.assert_array_equal(getattr(getattr(state, f), g).numpy(), d[f][g])
                np.testing.assert_array_equal(getattr(getattr(mine, f), g).numpy(), d[f][g])
    assert isinstance(population_state_from_numpy(d, "cpu", torch.float64), PopulationState)


def test_generic_lane_state_round_trip(jax_setup):
    """Raw parameters and a generic loop state carried across from the JAX package,
    and the port's own initial generic state against the JAX one."""
    js = jax_setup
    B = 3
    f64 = jnp.float64
    aux = dict(Q_raw=[1.0, 1.0, 0.5], R_raw=[1.0, 1.0], Qf_raw=[2.0, 2.0, 1.0], qb_raw=1.0,
               alpha_raw=0.5, gamma_raw=0.2)
    nom = dict(Q_raw=[1.0, 1.0, 0.0], R_raw=[1.0, 1.0], Qf_raw=[1000.0] * 3, qb_raw=1.0,
               alpha_raw=0.01, gamma_raw=0.1, tight_raw=0.02)
    x0 = [3.2, 1.0, np.pi / 4]
    j_state = j_generic_lane_init_state(
        js.system, js.aug, js.cfg,
        raw_nom=JRawNominalTheta(**{k: jnp.asarray(v, f64) for k, v in nom.items()}),
        raw_aux_init=JRawAuxTheta(**{k: jnp.asarray(v, f64) for k, v in aux.items()}),
        x0=jnp.asarray(x0, f64), B=B, dtype=f64)
    d = {f: np.asarray(getattr(j_state, f)) for f in ("x", "b", "x_bar", "b_bar", "U_nom_ws",
                                                       "U_aux_ws")}
    for f in ("raw_aux", "vel_aux", "raw_nom", "vel_nom"):
        d[f] = {g: np.asarray(v) for g, v in getattr(j_state, f)._asdict().items()}
    state = generic_lane_state_from_numpy(d, device="cpu", dtype=torch.float64)
    for f in ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), d[f])
    for f in ("raw_aux", "vel_aux", "raw_nom", "vel_nom"):
        tree = getattr(state, f)
        assert type(tree).__name__ == ("RawAuxTheta" if "aux" in f else "RawNominalTheta")
        for g, v in tree._asdict().items():
            np.testing.assert_array_equal(v.numpy(), d[f][g])
    s = setup_from_numpy(setup_as_numpy(js), device="cpu", dtype=torch.float64)
    mine = generic_lane_init_state(
        s.system, s.aug, s.cfg, raw_nom=raw_nom_from_numpy(nom, "cpu", torch.float64),
        raw_aux_init=raw_aux_from_numpy(aux, "cpu", torch.float64),
        x0=torch.as_tensor(x0, dtype=torch.float64), B=B, dtype=torch.float64)
    for f in ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws"):
        np.testing.assert_allclose(getattr(mine, f).numpy(), d[f], rtol=1e-12, atol=0.0)
    for f in ("raw_aux", "vel_aux", "raw_nom", "vel_nom"):
        for g, v in getattr(mine, f)._asdict().items():
            np.testing.assert_array_equal(v.numpy(), d[f][g])


def test_xla_values_round_trip():
    """The XLA engine's parameters and loop states carried across from numpy: every leaf
    as given, in the asked dtype, on the asked device."""
    from tube_mpc_tpu_torch import convert
    from tube_mpc_tpu_torch.tube.closed_loop import GenericLoopState, PaperLoopState

    rng = np.random.default_rng(2)
    B, N = 2, 4
    w = {k: rng.normal(size=(B, d) if d else (B,)) for k, d in (("Q", 3), ("R", 2), ("Qf", 3),
                                                               ("qb", 0))}
    bp = {k: rng.normal(size=(B,)) for k in ("alpha", "gamma", "tight")}
    adapt = {k: w[k] for k in ("Q", "R", "qb")}
    arrays = dict(x=rng.normal(size=(B, 3)), b=rng.normal(size=B), x_bar=rng.normal(size=(B, 3)),
                  b_bar=rng.normal(size=B), U_nom_ws=rng.normal(size=(B, N, 2)),
                  U_aux_ws=rng.normal(size=(B, N, 2)))
    raw_aux = dict(Q_raw=w["Q"], R_raw=w["R"], Qf_raw=w["Qf"], qb_raw=w["qb"],
                   alpha_raw=bp["alpha"], gamma_raw=bp["gamma"])
    raw_nom = dict(raw_aux, tight_raw=bp["tight"])

    def same(tree, ref):
        if isinstance(tree, tuple):
            for name, v in zip(tree._fields, tree):
                same(v, ref[name])
        else:
            assert tree.dtype == torch.float64 and tree.device.type == "cpu"
            np.testing.assert_array_equal(tree.numpy(), ref)

    cw = convert.cost_weights_from_numpy(w, "cpu", torch.float64)
    same(cw, w)
    same(convert.barrier_params_from_numpy(bp, "cpu", torch.float64), bp)
    same(convert.aux_adapt_from_numpy(adapt, "cpu", torch.float64), adapt)
    same(convert.nominal_theta_from_numpy(dict(w=w, bp=bp), "cpu", torch.float64),
         dict(w=w, bp=bp))
    aux = dict(w=w, bp=bp, X_ref=rng.normal(size=(B, N + 1, 3)), U_ref=rng.normal(size=(B, N, 2)))
    same(convert.aux_theta_from_numpy(aux, "cpu", torch.float64), aux)
    paper = dict(arrays, adapt=adapt, vel=adapt)
    state = convert.paper_state_from_numpy(paper, "cpu", torch.float64)
    assert isinstance(state, PaperLoopState)
    same(state, paper)
    generic = dict(arrays, raw_nom=raw_nom, raw_aux=raw_aux, vel_nom=raw_nom, vel_aux=raw_aux)
    state = convert.generic_state_from_numpy(generic, "cpu", torch.float64)
    assert isinstance(state, GenericLoopState)
    same(state, generic)
    f32 = convert.cost_weights_from_numpy(w, "cpu", torch.float32)
    assert f32.Q.dtype == torch.float32


def _ric_probe():
    spec = importlib.util.spec_from_file_location("ric_probe", REPO / "tools" / "ric_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("family, variant", [
    (family, variant) for family, variants in _ric_probe().VARIANTS.items() for variant in variants])
def test_probe_edits_match_the_sources(family, variant, tmp_path):
    """Each variant of tools/ric_probe.py applies to today's kernel sources (every edit
    matches as often as it says), so that an edit the kernels outgrew fails here and not
    on the card; only the files the variant names are edited (a variant may restate the
    sources' own value, as the quadrotor's cap4 does)."""
    probe = _ric_probe()
    csrc = PKG / "csrc"
    probe.variant_sources(csrc, probe.VARIANTS[family][variant], tmp_path)
    changed = {src.name for src in csrc.glob("*.cu*")
               if (tmp_path / src.name).read_text() != src.read_text()}
    assert changed <= {name for name, *_ in probe.VARIANTS[family][variant]}


def test_kernel_ab_compares_each_librarys_own_sass():
    """tools/port_kernel_ab.py compares a kernel's SASS within its library variant: the
    quadrotor's default and min + log libraries build the same symbol from different code,
    and a change in one of them is reported even where the other is unchanged."""
    spec = importlib.util.spec_from_file_location("port_kernel_ab",
                                                  REPO / "tools" / "port_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    sym = "_ZN4lane10fwd_kernelIfLi2ELi4EEEvPKT_"
    base = {("quadrotor2d", sym): (10, "a"), ("quadrotor2d_min_log", sym): (10, "b")}
    this = {("quadrotor2d", sym): (12, "c"), ("quadrotor2d_min_log", sym): (10, "b")}
    assert ab.changed_kernels(base, this) == (2, ["quadrotor2d: fwd_kernel<float, quadrotor2d, 4>"])
    assert ab.changed_kernels(base, dict(base)) == (2, [])
