"""The check that decides `correct`, driven through a whole run on the CPU at a small size
(the program's kernels' plain versions; the run skips its look for a card), with the
cell's own limits: a sound run is correct; the control (the reference in bfloat16 put in
the program's place) fails a number; and each fault the paper cell can have, planted in the
timed path (bench_port/faults.py), makes `correct` false."""
import pytest
import torch

from bench_port import run as bench
from bench_port.faults import planted
from bench_port.modes.paper import Control

CELLS = ["dubins.paper.b32768", "quadrotor2d.paper.b32768"]


def small_cell(name):
    cell = bench.load_cell(name)
    cell["config"]["values"]["system"].update(horizon_N=8, task_horizon_H=4)
    cell["traffic"] = dict(cell["traffic"], batch=6, warmup_episodes=1,
                           check=dict(steps_per_episode=3, lanes_per_step=6, samples=18))
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = bench.run(small_cell(name), 2 ** 31 + 101, 0.0, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] == 6 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = small_cell(name)
    mode = bench.prepare(cell, "cpu")
    win = bench.window(mode, 2 ** 31 + 202, 0.0)
    nums = mode.check(win["kept"], bench.check_seed(7), 18,
                      candidate=Control(cell["config"], torch.bfloat16))
    assert any(v > cell["limits"][k] for k, v in nums.items()), nums


# The quadrotor's solves returning their warm start on half of the lanes are read on the
# card at the cell's size (PERF.md): at this size its warm start lies within 10% of the
# solve's cost, under the limit that the cell's sound float32 solves need.
FAULT_CASES = [(n, f) for n in CELLS for f in ("unchanged", "half", "altered")]
FAULT_CASES.append((CELLS[0], "warm_half"))


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_fault_is_not_correct(name, fault):
    with planted(fault):
        out = bench.run(small_cell(name), 2 ** 31 + 303, 0.0, False, "cpu")
    assert not out["correct"], out["checks"]


def test_unscattered_compaction_is_not_correct():
    # the Dubins horizon (N=50) over 160 lanes: after the first cap some lanes are still
    # unconverged and fit in a compacted stage of 128 lanes (stage_widths), whose results
    # the fault drops; every kept pair is judged
    cell = small_cell(CELLS[0])
    cell["config"]["values"]["system"].update(horizon_N=50, task_horizon_H=2)
    cell["traffic"].update(batch=160, check=dict(steps_per_episode=2, lanes_per_step=160,
                                                 samples=320))
    with planted("no_scatter") as stage:
        out = bench.run(cell, 2 ** 31 + 404, 0.0, False, "cpu")
    assert stage.compacted > 0
    assert not out["correct"], out["checks"]
