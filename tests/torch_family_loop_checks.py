"""The whole slice on one family: the port's paper lane closed loop against the JAX
package's, the tests of tests/test_torch_family_loop_<family>.py, each of which names
its family with a fixture ``family`` (one file a family, so that the test workers
spread them).

Both run bench.py's BENCH_SYSTEM setup of the family (configs/<name>.yaml in paper
mode, the file's iteration caps and alphas) at B=3, N=6, H=3 in f64, from the same
numbers: the port's setup is carried across from the JAX setup with
convert.family_setup_from_numpy, and the disturbances are drawn once with numpy within
the family's bounds. The JAX side runs its Pallas kernels in interpret mode; the port
runs its plain versions on the CPU. Tolerances are the JAX package's own
(tests/test_lane_closed_loop.py:45-50).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.tube.lane_closed_loop import (
    run_paper_closed_loop_lanes as j_run_paper_closed_loop_lanes,
)

from tube_mpc_tpu_torch.convert import family_setup_from_numpy
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

from torch_family_cases import EPS, jax_family, setup_as_numpy

B, N, H = 3, 6, 3
# (rtol, atol) per field, as in tests/test_lane_closed_loop.py:45-50
TOL = {
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-8), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-8, 1e-11), "R_hist": (1e-8, 1e-11), "qb_hist": (1e-8, 1e-11),
}


@pytest.fixture(scope="module")
def logs(family):
    built, cfg, j_sys_c, ycfg = jax_family(family, N=N, H=H)
    rng = np.random.default_rng(0)
    w_low = np.asarray(ycfg.system.disturbance["w_low"])
    w_high = np.asarray(ycfg.system.disturbance["w_high"])
    w_seqs = rng.uniform(w_low, w_high, size=(B, H, len(w_low)))

    s = family_setup_from_numpy(family, setup_as_numpy(built, cfg, ycfg), device="cpu",
                                dtype=torch.float64)
    port = run_paper_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp,
        x0=s.x0, target=s.target, w_seqs=torch.as_tensor(w_seqs), eps=s.eps, device="cpu",
    )
    ref = j_run_paper_closed_loop_lanes(
        built.system, built.aug, j_sys_c, cfg, w_nominal=built.w_nominal,
        aux_init=built.aux_init, bp=built.bp, x0=built.x0, target=built.target,
        w_seqs=jnp.asarray(w_seqs), eps=EPS, block_b=128, interpret=True,
    )
    return port, ref


@pytest.mark.parametrize("field", ClosedLoopLog._fields)
def test_closed_loop_log_matches_jax(logs, field):
    port, ref = logs
    p, r = getattr(port, field), np.asarray(getattr(ref, field))
    assert tuple(p.shape) == r.shape and p.dtype == torch.float64
    rtol, atol = TOL[field]
    np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol)


def test_closed_loop_adapts_and_stays_finite(logs):
    """Every logged value is finite and the ancillary weights move."""
    port, _ = logs
    for field in ClosedLoopLog._fields:
        assert bool(torch.isfinite(getattr(port, field)).all()), field
    assert not bool(torch.equal(port.Q_hist[:, -1], port.Q_hist[:, 0])) or not bool(
        torch.equal(port.R_hist[:, -1], port.R_hist[:, 0]))
