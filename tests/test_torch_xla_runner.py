"""The port's XLA-engine entry points against the JAX package's, on the CPU:
runners.run_experiment(engine="xla") against tube_mpc_tpu.runners.run_experiment (its
default engine) on configs shrunk to N=6, H=3 under one disturbance draw, and the CLIs
python -m tube_mpc_tpu_torch.run_experiment --engine xla, .run_nominal and
.gradient_check at a tiny size.

- f64 (use_float64: true, honoured on this engine): every artifact at rtol 1e-6 on states
  and controls, 1e-5 on the loss and weight histories, atol 1e-8
  (tests/test_closed_loop.py:139-143); the Dubins paper config and the cart-pole's
  coupled one.
- f32: every artifact within 1e-3 of its largest magnitude, as tests/test_torch_runner.py
  holds the lane engine's f32 runs: both run the same operations in f32, and XLA and
  PyTorch round sin/cos/exp a last bit apart, which the solves' iterations carry on.
- The summaries carry the JAX runner's keys in its order, and the port's engine and dtype
  after mode; run_nominal's artifacts and summary at rtol 1e-7, atol 1e-9
  (tests/test_nominal_receding.py:86-87).

The JAX runner's generic branch takes no w_seq (it draws from PRNGKey(seed) whatever it is
given, tube_mpc_tpu/runners.py:137-144); the port's runner takes it, so the coupled case
gives the port the JAX runner's own draw.
"""
import copy
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tube_mpc_tpu.runners import run_experiment as j_run_experiment
from tube_mpc_tpu.runners import run_nominal as j_run_nominal
from tube_mpc_tpu.runners import run_nominal_single as j_run_nominal_single
from tube_mpc_tpu.utils.config import build_experiment as j_build_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config
from tube_mpc_tpu.utils.io import load_run as j_load_run

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.gradient_check import main as gradient_check_main
from tube_mpc_tpu_torch.run_experiment import main as run_experiment_main
from tube_mpc_tpu_torch.run_nominal import main as run_nominal_main
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.utils.config import parse_config
from tube_mpc_tpu_torch.utils.io import load_run

from torch_xla_cases import disturbances, raw_of

N, H = 6, 3
ARTIFACTS = ("x_real", "u_real", "x_bar", "u_bar", "b_real", "loss", "Qa_history",
             "Ra_history", "qba_history")
HISTORIES = ("loss", "Qa_history", "Ra_history", "qba_history")
CASES = {"dubins_f64": ("dubins", {}), "dubins_f32": ("dubins", {"use_float64": False}),
         "cartpole_coupled_f64": ("cartpole", {"adaptation.adapt_nominal": True})}


@pytest.fixture(scope="module", params=list(CASES))
def both(request, tmp_path_factory):
    name, changes = CASES[request.param]
    raw = raw_of(name, N, H, **changes)
    w = disturbances(raw, 1, H, seed=2)[0]
    jcfg = j_parse_config(raw)
    if not (jcfg.paper_dubins_mode and not jcfg.adaptation.adapt_nominal):
        w = np.asarray(j_build_experiment(jcfg).system.sample_disturbance(
            jax.random.PRNGKey(jcfg.seed), (H,), dtype=jcfg.dtype))
    tmp = tmp_path_factory.mktemp(request.param)
    mine = runners.run_experiment(parse_config(raw), str(tmp / "port"), w_seq=w, engine="xla",
                                  device="cpu")
    dtype = jnp.float64 if raw["use_float64"] else jnp.float32
    ref = j_run_experiment(jcfg, str(tmp / "jax"), w_seq=jnp.asarray(w, dtype=dtype))
    return request.param, raw, mine, ref, tmp / "port", tmp / "jax"


def test_xla_runner_matches_the_jax_runner(both):
    case, raw, mine, ref, port_dir, jax_dir = both
    ours, theirs = load_run(str(port_dir)), j_load_run(str(jax_dir))
    assert set(ours) == set(theirs) == set(ARTIFACTS)
    for name in ARTIFACTS:
        a, b = ours[name], theirs[name]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float64, name
        if raw["use_float64"]:
            rtol, atol = (1e-5, 1e-8) if name in HISTORIES else (1e-6, 1e-8)
        else:
            rtol, atol = 0.0, 1e-3 * max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{case} {name}")


def test_xla_summary_has_the_jax_runners_keys(both):
    case, raw, mine, ref, _, _ = both
    s, r = mine["summary"], ref["summary"]
    keys = list(r)
    assert list(s) == keys[:2] + ["engine", "dtype"] + keys[2:]
    assert s["engine"] == "xla"
    assert s["dtype"] == ("float64" if raw["use_float64"] else "float32")
    assert s["mode"] == r["mode"] == ("generic" if "coupled" in case else "paper")
    assert mine["log"].x_real.dtype == (torch.float64 if raw["use_float64"] else torch.float32)
    for key in ("final_state", "final_barrier_state", "final_loss"):
        np.testing.assert_allclose(s[key], r[key], rtol=1e-3 if "f32" in case else 1e-5,
                                   err_msg=key)
    assert s["solves_per_sec"] == pytest.approx(2 * H / s["wall_time_s"])


def test_xla_runner_population_summary_and_artifacts(tmp_path):
    raw = raw_of("dubins", N, H)
    res = runners.run_experiment(parse_config(raw), str(tmp_path), batch=2, engine="xla",
                                 device="cpu")
    s = res["summary"]
    assert list(s) == ["system", "mode", "engine", "dtype", "H", "N", "batch", "final_state",
                       "final_barrier_state", "final_loss", "final_loss_mean",
                       "final_loss_std", "final_loss_max", "wall_time_s", "solves_per_sec"]
    run = load_run(str(tmp_path))
    for art, field in zip(ARTIFACTS, ClosedLoopLog._fields):
        assert run[f"{field}_batch"].shape[:2] == (2, H)
        np.testing.assert_array_equal(run[art], run[f"{field}_batch"][0])
    final = run["loss_batch"][:, -1]
    assert s["batch"] == 2 and s["final_loss_max"] == float(final.max())
    assert s["final_loss_mean"] == pytest.approx(float(final.mean()))
    assert not np.array_equal(run["x_real_batch"][0], run["x_real_batch"][1])


def test_debug_numerics_names_the_failing_phase(tmp_path):
    """debug_numerics arms the located finite checks: a NaN disturbance makes the real
    state NaN, and the next step's ancillary solve is the phase that fails."""
    raw = raw_of("dubins", N, H, debug_numerics=True)
    w = disturbances(raw, 1, H, seed=2)[0]
    w[0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="phase B: ancillary iLQR solve"):
        runners.run_experiment(parse_config(raw), str(tmp_path / "a"), w_seq=w, engine="xla",
                               device="cpu")
    raw["debug_numerics"] = False
    res = runners.run_experiment(parse_config(raw), str(tmp_path / "b"), w_seq=w, engine="xla",
                                 device="cpu")
    assert np.isnan(res["summary"]["final_loss"])


def _write(tmp_path, raw, name="cfg.yaml"):
    raw = copy.deepcopy(raw)
    raw["out_dir"] = str(tmp_path / "out")
    path = tmp_path / name
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_cli_runs_the_xla_engine_in_the_configs_dtype(tmp_path, capsys):
    raw = raw_of("dubins", N, H)
    path = _write(tmp_path, raw)
    run_dir = tmp_path / "run"
    res = run_experiment_main(["--config", path, "--engine", "xla", "--device", "cpu",
                               "--run-dir", str(run_dir)])
    out = capsys.readouterr().out
    assert "float32-only" not in out and json.loads(out[out.index("{"):]) == res["summary"]
    assert res["summary"]["dtype"] == "float64" and res["summary"]["engine"] == "xla"
    assert {p.name for p in run_dir.iterdir()} == ({f"{a}.npy" for a in ARTIFACTS}
                                                    | {"config_used.json", "results_summary.json"})
    with pytest.raises(SystemExit) as e:
        run_experiment_main(["--config", path, "--engine", "xla", "--device", "cpu",
                             "--compact-caps", "1,4,8", "--run-dir", str(tmp_path / "no")])
    assert e.value.code == 2 and "lanes-engine feature" in capsys.readouterr().err
    assert not (tmp_path / "no").exists()


@pytest.mark.parametrize("mode", ["receding", "once"])
def test_run_nominal_cli_matches_the_jax_runner(mode, tmp_path, capsys):
    raw = raw_of("dubins", N, 8)
    path = _write(tmp_path, raw)
    res = run_nominal_main(["--config", path, "--device", "cpu", "--mode", mode])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == res["summary"]
    jrun = j_run_nominal if mode == "receding" else j_run_nominal_single
    ref = jrun(j_parse_config(raw), str(tmp_path / "jax"))
    ours, theirs = load_run(res["run_dir"]), j_load_run(str(tmp_path / "jax"))
    assert set(ours) == set(theirs)
    for name in theirs:
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-7, atol=1e-9, err_msg=name)
    s, r = res["summary"], ref["summary"]
    assert list(s) == list(r)
    for key, value in r.items():
        if isinstance(value, float) or isinstance(value, list):
            np.testing.assert_allclose(s[key], value, rtol=1e-7, atol=1e-9, err_msg=key)
        else:
            assert s[key] == value, key
    assert (tmp_path / "out").exists() and "config_used.json" in {
        p.name for p in (tmp_path / "out").iterdir().__next__().iterdir()}


def test_gradient_check_cli(tmp_path, capsys):
    """The root CLI's JSON, finite, with the finite difference and the analytic
    hypergradient agreeing in sign and within a factor of 2 (the root CLI's own test,
    tests/test_gradient_check_cli.py: FD differentiates the algorithm's plateaus)."""
    out = tmp_path / "gc.json"
    res = gradient_check_main(["--config", "configs/dubins.yaml", "--device", "cpu",
                               "--json-out", str(out)])
    assert "Finite-difference vs analytic check" in capsys.readouterr().out
    written = json.loads(out.read_text())
    assert written == res
    assert list(res) == ["baseline_loss", "loss_plus", "loss_minus", "fd_dL_dQ0",
                         "analytic_dL_dQ0", "rel_err"]
    assert all(math.isfinite(v) for v in res.values())
    fd, an = res["fd_dL_dQ0"], res["analytic_dL_dQ0"]
    assert fd != 0.0 and an != 0.0 and (fd < 0) == (an < 0)
    assert 0.5 <= abs(an / fd) <= 2.0


def test_xla_entry_points_run_on_the_card_unless_asked(tmp_path, monkeypatch):
    """With no card and no --device cpu the XLA engine's CLIs and loops raise; nothing
    carries on quietly on the CPU."""
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.tube.closed_loop import run_paper_closed_loop

    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write(tmp_path, raw_of("dubins", N, H))
    for main, argv in ((run_experiment_main, ["--engine", "xla", "--run-dir", str(tmp_path / "r")]),
                       (run_nominal_main, []), (gradient_check_main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", path] + argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_paper_closed_loop(s.system, s.aug, s.cfg, w_nominal=s.w_nominal,
                              aux_init=s.aux_init, bp=s.bp, x0=s.x0, target=s.target,
                              w_seq=torch.zeros((1, 2, 3), dtype=torch.float64))
