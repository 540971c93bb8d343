"""The port's experiment runner (tube_mpc_tpu_torch/runners.py) against the JAX package's
lane-engine runner on a configuration with the exact-min aggregation or the log barrier
(tests/torch_minlog_cases.py), shrunk to N=6, H=3, on the same disturbances, both in f32
as the lane engine forces, its Pallas kernels in interpret mode: the tests of
tests/test_torch_minlog_runner_<case>.py, each of which names its case and its changes
with the fixtures ``minlog`` and ``changes``. Tolerance: tests/test_torch_runner.py's
SCALE_TOL, every artifact within 1e-3 of its largest magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tube_mpc_tpu.runners import run_experiment as j_run_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config
from tube_mpc_tpu.utils.io import load_run as j_load_run

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.utils.config import parse_config
from tube_mpc_tpu_torch.utils.io import load_run

from torch_minlog_cases import raw_of

N, H = 6, 3
ARTIFACTS = ("x_real", "u_real", "x_bar", "u_bar", "b_real", "loss", "Qa_history",
             "Ra_history", "qba_history")
SCALE_TOL = 1e-3


@pytest.fixture(scope="module")
def both(minlog, changes, tmp_path_factory):
    """(port results, JAX results, port run dir, JAX run dir, the raw config)."""
    raw = raw_of(minlog, N=N, H=H, **changes)
    lo = np.asarray(raw["system"]["disturbance"]["w_low"])
    hi = np.asarray(raw["system"]["disturbance"]["w_high"])
    w = np.random.default_rng(1).uniform(lo, hi, size=(H, len(lo))).astype(np.float32)
    tmp = tmp_path_factory.mktemp(minlog)
    mine = runners.run_experiment(parse_config(raw), str(tmp / "port"), w_seq=w, device="cpu")
    ref = j_run_experiment(j_parse_config(raw), str(tmp / "jax"),
                           w_seq=jnp.asarray(w, dtype=jnp.float32), engine="lanes")
    return mine, ref, tmp / "port", tmp / "jax", raw


@pytest.mark.parametrize("name", ARTIFACTS)
def test_runner_matches_the_jax_runner(both, name):
    _, _, port_dir, jax_dir, _ = both
    a, b = load_run(str(port_dir))[name], j_load_run(str(jax_dir))[name]
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64, name
    np.testing.assert_allclose(a, b, rtol=0, atol=SCALE_TOL * max(np.abs(b).max(), 1e-30))


def test_summary_matches_the_jax_runners(both):
    mine, ref, _, _, raw = both
    s, r = mine["summary"], ref["summary"]
    assert list(s) == list(r)
    for key in ("system", "mode", "engine", "dtype", "H", "N", "batch", "finite_lane_frac"):
        assert s[key] == r[key], key
    for key in ("final_state", "final_barrier_state", "final_loss", "final_loss_mean_finite",
                "final_loss_median_finite"):
        np.testing.assert_allclose(s[key], r[key], rtol=SCALE_TOL, err_msg=key)
    paper = raw.get("paper_dubins_mode", True) and not raw["adaptation"]["adapt_nominal"]
    assert s["mode"] == ("paper" if paper else "generic")
