"""The port's profiling helpers (tube_mpc_tpu_torch/utils/profiling.py) and its plotting
(tube_mpc_tpu_torch/plotting.py), on the CPU, as tests/test_profiling.py and
tests/test_plotting.py hold the JAX package's: Timer's phases and report, a trace
written with its annotation, the trace refused on the card when there is none, and the
five figures from a run directory (the same files as the JAX package's plot_run
writes)."""
import json
import os

import numpy as np
import pytest
import torch

from tube_mpc_tpu.plotting import plot_run as j_plot_run

from tube_mpc_tpu_torch.plotting import plot_run
from tube_mpc_tpu_torch.utils.profiling import Timer, annotate, trace

FIGS = ["traj_xy.png", "states.png", "controls.png", "barrier_and_loss.png",
        "adaptive_params.png"]


def test_timer_phases_and_report():
    timer = Timer()
    x = torch.ones(8)
    with timer.phase("first", sync=None):
        y = x * 2.0
    with timer.phase("steady", sync=y):
        y = x * 2.0
    with timer.phase("steady", sync={"out": (y, [y])}):
        y = x * 2.0
    assert timer.counts == {"first": 1, "steady": 2}
    assert all(t >= 0.0 for t in timer.times.values())
    rep = timer.report()
    assert "first" in rep and "steady" in rep and "n=2" in rep


def test_trace_writes_a_chrome_trace_with_its_annotation(tmp_path):
    d = tmp_path / "trace"
    with trace(str(d), device="cpu"):
        with annotate("phase_under_test"):
            torch.ones(4).add_(1.0)
    files = list(d.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "phase_under_test" for e in events)


def test_trace_on_the_card_needs_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()


def _write_run_dir(d):
    H = 12
    rng = np.random.default_rng(0)
    np.save(d / "x_real.npy", rng.normal(size=(H + 1, 3)))
    np.save(d / "x_bar.npy", rng.normal(size=(H + 1, 3)))
    np.save(d / "u_real.npy", rng.normal(size=(H, 2)))
    np.save(d / "u_bar.npy", rng.normal(size=(H, 2)))
    np.save(d / "b_real.npy", rng.uniform(0.1, 2.0, size=(H + 1,)))
    np.save(d / "loss.npy", rng.uniform(0.0, 5.0, size=(H,)))
    np.save(d / "Qa_history.npy", rng.uniform(1.0, 2.0, size=(H, 4)))
    np.save(d / "Ra_history.npy", rng.uniform(0.1, 0.2, size=(H, 2)))
    np.save(d / "qba_history.npy", rng.uniform(0.5, 1.5, size=(H,)))


@pytest.mark.parametrize("obstacles", [None, [{"center": [0.5, 0.5], "radius": 0.3}]])
def test_plot_run_writes_all_five_figures(tmp_path, obstacles):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    for d in (ours, theirs):
        d.mkdir()
        _write_run_dir(d)
    written = plot_run(str(ours), obstacles=obstacles)
    assert sorted(os.path.basename(p) for p in written) == sorted(FIGS)
    for p in written:
        assert os.path.getsize(p) > 1000  # a rendered PNG, not a stub
    assert ([os.path.basename(p) for p in written]
            == [os.path.basename(p) for p in j_plot_run(str(theirs), obstacles=obstacles)])


def test_run_nominal_cli_plots_the_receding_horizon(tmp_path, capsys):
    """The port's run_nominal takes --plot as the root one does: the figures of a run
    without adaptation (no weight histories: four of the five)."""
    import yaml

    from tube_mpc_tpu_torch.run_nominal import main as run_nominal_main

    from torch_xla_cases import raw_of

    raw = raw_of("dubins", 6, 4)
    raw["out_dir"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    res = run_nominal_main(["--config", str(path), "--device", "cpu", "--plot"])
    assert "Plots saved." in capsys.readouterr().out
    assert {p.name for p in os.scandir(res["run_dir"])} >= set(FIGS) - {"adaptive_params.png"}
