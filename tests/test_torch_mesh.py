"""The port's multi-process scenario mesh, on two gloo processes on the CPU
(tests/torch_mesh_worker.py, started with a file:// rendezvous under the test's own
directory): the sharded lane paper loop against the one-process loop (independent mode
bitwise, each lane computed alone; population mode at rtol 1e-10, atol 1e-12, as
tests/test_lane_mesh.py:57-59, 77-82, the sums over the lanes taken in another order),
its checkpoint resumed bitwise and refused with another mesh size, a batch the ranks do
not divide refused, and run_population_adaptation over the mesh against mesh=None at
rtol 1e-12 (tests/test_multiprocess.py:67-71); every output the same on both ranks.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tube_mpc_tpu_torch.parallel import run_population_adaptation
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

from torch_mesh_worker import case, lane_kw, population_kw

TESTS = Path(__file__).resolve().parent
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, after both processes ended within their time limit."""
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS.parent), str(TESTS)]))
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_mesh_worker.py"),
                               str(out / "init"), str(WORLD), str(r), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The one-process runs of the same workload."""
    s, w, x0 = case()
    loop = {p: run_paper_closed_loop_lanes(s.system, s.aug, s.sys_c, s.cfg, population=p,
                                           **lane_kw(s, w, x0)) for p in (False, True)}
    return s, loop, run_population_adaptation(s.system, s.aug, s.cfg, **population_kw(s, w, x0))


def test_every_output_is_the_same_on_both_ranks(ranks):
    r0, r1 = ranks
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("mode", ["independent", "ckpt", "resumed"])
def test_sharded_independent_loop_is_bitwise_the_one_process_loop(ranks, single, mode):
    prefix = "independent." if mode == "independent" else f"independent.{mode}."
    for f in ClosedLoopLog._fields:
        np.testing.assert_array_equal(ranks[0][prefix + f], getattr(single[1][False], f).numpy(),
                                      err_msg=f)


def test_sharded_population_loop_matches_the_one_process_loop(ranks, single):
    s, loop, _ = single
    for f in ClosedLoopLog._fields:
        np.testing.assert_allclose(ranks[0][f"population.{f}"], getattr(loop[True], f).numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=f)
    Q = ranks[0]["population.Q_hist"]
    assert (Q == Q[:1]).all()   # one θ for every lane of both ranks
    assert np.max(np.abs(Q[:, -1] - s.aux_init.Q.numpy())) > 0   # and it moved


def test_sharded_population_checkpoint_resumes_bitwise(ranks):
    for f in ClosedLoopLog._fields:
        mono = ranks[0][f"population.{f}"]
        np.testing.assert_array_equal(ranks[0][f"population.ckpt.{f}"], mono, err_msg=f)
        np.testing.assert_array_equal(ranks[0][f"population.resumed.{f}"], mono, err_msg=f)


@pytest.mark.parametrize("key", ["independent.tampered_refused", "population.tampered_refused",
                                 "indivisible_refused"])
def test_refusals(ranks, key):
    """A checkpoint of another mesh size is refused as a different run; so is a batch
    that the ranks do not divide."""
    assert bool(ranks[0][key]) and bool(ranks[1][key])


def test_population_adaptation_over_the_mesh_matches_one_device(ranks, single):
    s, _, (log, final) = single
    for f, v in log._asdict().items():
        np.testing.assert_allclose(ranks[0][f"adaptation.{f}"], v.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    for f, v in final._asdict().items():
        np.testing.assert_allclose(ranks[0][f"adaptation.final.{f}"], v.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    assert float(np.min(ranks[0]["adaptation.finite_frac"])) == 1.0
    assert float(torch.max(torch.abs(final.Q - s.aux_init.Q))) > 0
