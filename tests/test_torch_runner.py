"""The port's experiment entry point (tube_mpc_tpu_torch/runners.py and the CLI
tube_mpc_tpu_torch/run_experiment.py) against the JAX package's lane-engine runner, on the
CPU.

- run_experiment against the JAX runner (engine="lanes", its Pallas kernels in interpret
  mode) on the same disturbances, both in f32 as the lane engine forces: the Dubins config
  in paper mode and the cart-pole config in coupled mode (adapt_nominal: true), shrunk to
  N=6, H=3. Tolerance: every artifact within 1e-3 of its largest magnitude. The two run
  the same operations in f32, but XLA and PyTorch round sin/cos/exp and their fusions a
  last bit apart, and up to 15 iLQR iterations a solve and three steps of adaptation carry
  that to 2e-4 of the cart-pole's controls (measured); the summaries carry the same keys.
- The runner's artifacts bitwise against a direct call of the port's loop on the same
  built objects.
- The CLI writes every artifact and takes every flag of the root CLI: the lane engine
  compacts with the root CLI's default caps (bitwise equal to --compact-caps ''), a
  checkpointed run resumed through --run-dir writes the uninterrupted run's artifacts,
  --profile writes a trace, --plot and plot: true write the figures. It refuses what the
  root CLI's runner refuses: --compact-caps on the XLA engine, and a checkpointed XLA run
  of more than one paper trajectory.
"""
import copy
import os
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tube_mpc_tpu.runners import run_experiment as j_run_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config
from tube_mpc_tpu.utils.io import load_run as j_load_run

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.run_experiment import main
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import (
    run_generic_closed_loop_lanes,
    run_paper_closed_loop_lanes,
)
from tube_mpc_tpu_torch.utils.config import build_experiment, lane_components, parse_config
from tube_mpc_tpu_torch.utils.io import load_run

REPO = Path(__file__).resolve().parents[1]
N, H = 6, 3
ARTIFACTS = ("x_real", "u_real", "x_bar", "u_bar", "b_real", "loss", "Qa_history",
             "Ra_history", "qba_history")
SCALE_TOL = 1e-3


def raw_of(name, **changes):
    """configs/<name>.yaml shrunk to N=6, H=3, with "section.key" changes."""
    with open(REPO / "configs" / f"{name}.yaml", "r", encoding="utf-8") as f:
        raw = copy.deepcopy(yaml.safe_load(f))
    raw["system"]["horizon_N"], raw["system"]["task_horizon_H"] = N, H
    for key, value in changes.items():
        section, leaf = key.split(".")
        raw[section][leaf] = value
    return raw


def disturbances(raw, seed=1):
    lo = np.asarray(raw["system"]["disturbance"]["w_low"])
    hi = np.asarray(raw["system"]["disturbance"]["w_high"])
    return np.random.default_rng(seed).uniform(lo, hi, size=(H, len(lo))).astype(np.float32)


def write_yaml(tmp_path, raw, name="cfg.yaml"):
    path = tmp_path / name
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(raw, f)
    return str(path)


CASES = {"dubins_paper": ("dubins", {}),
         "cartpole_coupled": ("cartpole", {"adaptation.adapt_nominal": True})}


@pytest.fixture(scope="module", params=list(CASES))
def both(request, tmp_path_factory):
    """(case, port results, JAX results, port run dir, JAX run dir, the raw config)."""
    name, changes = CASES[request.param]
    raw = raw_of(name, **changes)
    w = disturbances(raw)
    tmp = tmp_path_factory.mktemp(request.param)
    mine = runners.run_experiment(parse_config(raw), str(tmp / "port"), w_seq=w, device="cpu")
    ref = j_run_experiment(j_parse_config(raw), str(tmp / "jax"),
                           w_seq=jnp.asarray(w, dtype=jnp.float32), engine="lanes")
    return request.param, mine, ref, tmp / "port", tmp / "jax", raw


def test_runner_matches_the_jax_runner(both):
    case, mine, ref, port_dir, jax_dir, _ = both
    assert mine["summary"]["mode"] == ("paper" if case == "dubins_paper" else "generic")
    ours, theirs = load_run(str(port_dir)), j_load_run(str(jax_dir))
    assert set(ours) == set(theirs) == set(ARTIFACTS)
    for name in ARTIFACTS:
        a, b = ours[name], theirs[name]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float64, name
        np.testing.assert_allclose(a, b, rtol=0, atol=SCALE_TOL * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)


def test_summary_has_the_jax_runners_keys_and_values(both):
    _, mine, ref, port_dir, _, _ = both
    s, r = mine["summary"], ref["summary"]
    assert list(s) == list(r)
    for key in ("system", "mode", "engine", "dtype", "H", "N", "batch", "finite_lane_frac"):
        assert s[key] == r[key], key
    for key in ("final_state", "final_barrier_state", "final_loss", "final_loss_mean_finite",
                "final_loss_median_finite"):
        np.testing.assert_allclose(s[key], r[key], rtol=SCALE_TOL, err_msg=key)
    assert s["solves_per_sec"] == pytest.approx(2 * H * 1 / s["wall_time_s"])
    with open(port_dir / "results_summary.json", encoding="utf-8") as f:
        assert json.load(f) == s


@pytest.mark.parametrize("case", list(CASES))
def test_runner_artifacts_are_the_loops_own(case, tmp_path):
    """The runner writes lane 0 of the port's loop, called directly on the same built
    objects and disturbances, bitwise; with a batch, every lane as <field>_batch.npy."""
    name, changes = CASES[case]
    raw = raw_of(name, **changes)
    cfg = parse_config(raw)
    rng = np.random.default_rng(2)
    lo = np.asarray(raw["system"]["disturbance"]["w_low"])
    hi = np.asarray(raw["system"]["disturbance"]["w_high"])
    w = rng.uniform(lo, hi, size=(2, H, len(lo))).astype(np.float32)
    res = runners.run_experiment(cfg, str(tmp_path), w_seq=w, device="cpu")
    built = build_experiment(cfg, device="cpu")
    kw = dict(x0=built.x0, target=built.target, w_seqs=torch.as_tensor(w), eps=cfg.dbas.eps,
              device="cpu")
    if case == "dubins_paper":
        log = run_paper_closed_loop_lanes(
            built.system, built.aug, lane_components(cfg), built.tube_cfg,
            w_nominal=built.w_nominal, aux_init=built.aux_init, bp=built.bp, **kw)
    else:
        raw_nom, raw_aux = runners.raw_thetas(cfg, torch.device("cpu"))
        log, _ = run_generic_closed_loop_lanes(
            built.system, built.aug, lane_components(cfg), built.tube_cfg, raw_nom=raw_nom,
            raw_aux_init=raw_aux, **kw)
    run = load_run(str(tmp_path))
    for art, field in zip(ARTIFACTS, ClosedLoopLog._fields):
        np.testing.assert_array_equal(run[art], getattr(log, field)[0].double().numpy(), art)
        np.testing.assert_array_equal(run[f"{field}_batch"], getattr(log, field).double().numpy())
    assert res["summary"]["batch"] == 2
    assert res["summary"]["solves_per_sec"] == 2 * H * 2 / res["summary"]["wall_time_s"]


def test_runner_draws_seeded_disturbances_and_refuses_what_it_does_not_run(tmp_path):
    cfg = parse_config(raw_of("cartpole"))
    a = runners.run_experiment(cfg, str(tmp_path / "a"), batch=2, device="cpu")
    b = runners.run_experiment(cfg, str(tmp_path / "b"), batch=2, device="cpu")
    assert torch.equal(a["log"].x_real, b["log"].x_real) and a["log"].x_real.shape[0] == 2
    with pytest.raises(ValueError, match="don't pass w_seq"):
        runners.run_experiment(cfg, str(tmp_path / "c"), batch=2,
                               w_seq=np.zeros((H, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="unknown engine 'pallas'"):
        runners.run_experiment(cfg, str(tmp_path / "c"), engine="pallas", device="cpu")


def test_runner_forces_f32_and_checks_finiteness_when_asked(tmp_path, monkeypatch):
    raw = raw_of("cartpole")
    raw["use_float64"] = raw["debug_numerics"] = True
    res = runners.run_experiment(parse_config(raw), str(tmp_path / "a"), device="cpu")
    assert res["summary"]["dtype"] == "float32 (forced; lanes engine is f32-only)"
    assert res["log"].x_real.dtype == torch.float32
    seen = []
    monkeypatch.setattr(runners, "check_finite_log", lambda log: seen.append(log))
    runners.run_experiment(parse_config(raw), str(tmp_path / "b"), device="cpu")
    assert len(seen) == 1 and isinstance(seen[0], ClosedLoopLog)


def test_adapt_ancillary_false_is_refused(tmp_path):
    """The JAX lane loops ignore adapt_ancillary: false and adapt the ancillary θ anyway
    (tests/test_torch_runner_adapt_ancillary.py pins that); the port refuses it."""
    cfg = parse_config(raw_of("dubins", **{"adaptation.adapt_ancillary": False}))
    with pytest.raises(ValueError, match=r"adapt_ancillary: false is refused.*queue C"):
        runners.run_experiment(cfg, str(tmp_path / "run"), device="cpu")
    path = write_yaml(tmp_path, raw_of("dubins", **{"adaptation.adapt_ancillary": False}))
    with pytest.raises(ValueError, match="queue C"):
        main(["--config", path, "--device", "cpu", "--run-dir", str(tmp_path / "cli")])


def test_cli_writes_every_artifact(tmp_path, capsys):
    raw = raw_of("dubins")
    path = write_yaml(tmp_path, raw)
    run_dir = tmp_path / "run"
    res = main(["--config", path, "--batch", "2", "--run-dir", str(run_dir), "--device", "cpu",
                "--compact-caps", ""])
    out = capsys.readouterr().out
    assert f"Saved run to: {run_dir}" in out
    printed = json.loads(out[out.index("{"):])
    assert printed == res["summary"] and res["run_dir"] == str(run_dir)
    files = {p.name for p in run_dir.iterdir()}
    assert files == ({f"{a}.npy" for a in ARTIFACTS}
                     | {f"{f}_batch.npy" for f in ClosedLoopLog._fields}
                     | {"config_used.json", "results_summary.json"})
    with open(run_dir / "config_used.json", encoding="utf-8") as f:
        assert json.load(f) == raw
    run = load_run(str(run_dir))
    assert run["x_real"].shape == (H, 3) and run["x_real_batch"].shape == (2, H, 3)
    assert res["log"].x_real.device.type == "cpu"


def cli(tmp_path, raw, *argv, name="run"):
    """main() on `raw` (written to <name>.yaml) into tmp_path/<name> on the CPU: (its
    results, the run's artifacts)."""
    path = write_yaml(tmp_path, raw, f"{name}.yaml")
    res = main(["--config", path, "--device", "cpu", "--run-dir", str(tmp_path / name)]
               + list(argv))
    return res, load_run(str(tmp_path / name))


def same_run(a, b):
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("clip,caps", [(1.0, "1,4,8"), (0.0, "2,5,8")])
def test_cli_compacts_with_the_root_clis_default_caps(clip, caps, tmp_path, monkeypatch):
    """Without --compact-caps the lane engine takes the root CLI's default caps ('1,4,8'
    when the config clips gradients, '2,5,8' when not); the run is bitwise the run with
    --compact-caps '' (none)."""
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import lane_ilqr_solve

    seen = []
    real = runners.run_experiment
    monkeypatch.setattr(runners, "run_experiment",
                        lambda *a, **k: seen.append(k["compact_caps"]) or real(*a, **k))
    raw = raw_of("dubins", **{"adaptation.grad_clip_norm": clip})
    lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
    _, compacted = cli(tmp_path, raw, "--batch", "2", name="default")
    assert seen == [caps]
    if caps == "1,4,8":
        # the default caps are the ancillary solve's; after one iteration no lane is
        # converged, so each ancillary solve runs its next stage (at this size every lane
        # converges within two, so '2,5,8' leaves no stage to run)
        assert lane_ilqr_solve.stages["full"] >= H
    lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
    _, plain = cli(tmp_path, raw, "--batch", "2", "--compact-caps", "", name="none")
    assert seen == [caps, ""] and lane_ilqr_solve.stages == {"compacted": 0, "full": 0}
    same_run(compacted, plain)


@pytest.mark.parametrize("case", ["dubins_paper", "dubins_coupled"])
def test_cli_resumes_a_checkpointed_run(case, tmp_path):
    """--checkpoint-every 2 writes <run_dir>/ckpt; with its last segment deleted (a run
    killed there), the same command with --run-dir resumes it and writes the
    uninterrupted run's artifacts, which are those of a run without checkpoints."""
    from tube_mpc_tpu_torch.utils.checkpoint import _logs_path, latest_checkpoint

    raw = raw_of("dubins", **({"adaptation.adapt_nominal": True} if "coupled" in case else {}))
    _, plain = cli(tmp_path, raw, "--batch", "2", name="plain")
    argv = ("--batch", "2", "--checkpoint-every", "2")
    res, whole = cli(tmp_path, raw, *argv)
    ck = tmp_path / "run" / "ckpt"
    assert sorted(p.name for p in ck.glob("state_*.npz")) == ["state_2.npz", "state_3.npz"]
    last = latest_checkpoint(str(ck))
    for f in (last, _logs_path(last)):
        os.remove(f)
    resumed, again = cli(tmp_path, raw, *argv)
    same_run(whole, plain)
    same_run(again, whole)
    assert resumed["summary"]["final_loss"] == res["summary"]["final_loss"]


def test_cli_checkpoints_one_xla_paper_trajectory(tmp_path):
    raw = raw_of("dubins")
    _, plain = cli(tmp_path, raw, "--engine", "xla", name="plain")
    _, ckpt = cli(tmp_path, raw, "--engine", "xla", "--checkpoint-every", "2")
    assert {p.name for p in (tmp_path / "run" / "ckpt").glob("state_*.npz")} == {
        "state_2.npz", "state_3.npz"}
    same_run(ckpt, plain)


def test_cli_profile_writes_a_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    cli(tmp_path, raw_of("dubins"), "--profile", str(trace_dir))
    (trace_file,) = trace_dir.iterdir()
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert trace_file.name.endswith(".pt.trace.json") and events


@pytest.mark.parametrize("how", ["--plot", "plot: true"])
def test_cli_plots_the_run(how, tmp_path, capsys):
    raw = raw_of("dubins")
    argv = []
    if how == "--plot":
        argv = ["--plot"]
    else:
        raw["plot"] = True
    cli(tmp_path, raw, *argv)
    assert "Plots saved." in capsys.readouterr().out
    figures = {"traj_xy.png", "states.png", "controls.png", "barrier_and_loss.png",
               "adaptive_params.png"}
    assert figures <= {p.name for p in (tmp_path / "run").iterdir()}


@pytest.mark.parametrize("argv,match", [
    (["--engine", "xla", "--compact-caps", "1,4,8"], "--compact-caps: compact_caps is a "
                                                      "lanes-engine feature"),
    (["--checkpoint-every", "0"], "--checkpoint-every must be >= 1"),
])
def test_cli_refuses_flags_whose_feature_is_not_ported(argv, match, tmp_path, capsys):
    """Compaction is a feature of the lane engine only; a checkpoint needs a segment."""
    path = write_yaml(tmp_path, raw_of("dubins"))
    with pytest.raises(SystemExit) as e:
        main(["--config", path, "--device", "cpu", "--run-dir", str(tmp_path / "run")] + argv)
    assert e.value.code == 2
    assert re.search(match, capsys.readouterr().err.replace("\n", " "))
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("changes,argv", [({}, ["--batch", "2"]),
                                          ({"adaptation.adapt_nominal": True}, [])])
def test_cli_refuses_an_xla_checkpoint_of_more_than_one_paper_trajectory(changes, argv,
                                                                         tmp_path):
    """As the root CLI's runner: the XLA engine checkpoints one paper-mode trajectory."""
    path = write_yaml(tmp_path, raw_of("dubins", **changes))
    with pytest.raises(ValueError, match="checkpoint_every requires paper mode, single "
                                         "trajectory"):
        main(["--config", path, "--device", "cpu", "--run-dir", str(tmp_path / "run"),
              "--engine", "xla", "--checkpoint-every", "2"] + argv)
    assert not (tmp_path / "run").exists()


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_yaml(tmp_path, raw_of("dubins"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", path, "--run-dir", str(tmp_path / "run")])


def test_io_and_finite_check_match_the_jax_package(tmp_path):
    """save_closed_loop_log writes the JAX package's files and values from the same log,
    and check_finite_log raises the JAX package's located message."""
    from tube_mpc_tpu.tube.closed_loop import ClosedLoopLog as JClosedLoopLog
    from tube_mpc_tpu.utils.debug import check_finite_log as j_check_finite_log
    from tube_mpc_tpu.utils.io import save_closed_loop_log as j_save_closed_loop_log

    from tube_mpc_tpu_torch.utils.debug import check_finite_log
    from tube_mpc_tpu_torch.utils.io import save_closed_loop_log

    rng = np.random.default_rng(4)
    shapes = [(H, 3), (H, 2), (H, 3), (H, 2), (H,), (H,), (H, 3), (H, 2), (H,)]
    leaves = [rng.normal(size=s).astype(np.float32) for s in shapes]
    save_closed_loop_log(str(tmp_path / "port"), ClosedLoopLog(*map(torch.as_tensor, leaves)))
    j_save_closed_loop_log(str(tmp_path / "jax"), JClosedLoopLog(*map(jnp.asarray, leaves)))
    ours, theirs = load_run(str(tmp_path / "port")), j_load_run(str(tmp_path / "jax"))
    assert set(ours) == set(theirs) == set(ARTIFACTS)
    for name in ARTIFACTS:
        assert ours[name].dtype == np.float64
        np.testing.assert_array_equal(ours[name], theirs[name])
    leaves[5][1] = np.nan
    with pytest.raises(FloatingPointError) as j_err:
        j_check_finite_log(JClosedLoopLog(*map(jnp.asarray, leaves)))
    with pytest.raises(FloatingPointError) as err:
        check_finite_log(ClosedLoopLog(*map(torch.as_tensor, leaves)))
    assert str(err.value) == str(j_err.value) and str(err.value).startswith(
        "[NUMERIC-FAIL] log.loss: 1 non-finite entries")
