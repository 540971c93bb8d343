"""The JAX package's lane engine ignores ``adaptation.adapt_ancillary: false``: its lane
loops adapt the ancillary θ anyway. The port's runner refuses the key
(tests/test_torch_runner.py); this pins the JAX package's behaviour, which ROADMAP.md
records (queue C).

The JAX runner (engine="lanes", interpret mode) on the Dubins config with
adapt_ancillary: false, shrunk to N=6, H=3 in f32, writes the run that the port's runner
writes with adapt_ancillary: true on the same disturbances, within tests/test_torch_runner.py's
f32 tolerance; and its ancillary weights move.
"""
import jax.numpy as jnp
import numpy as np

from tube_mpc_tpu.runners import run_experiment as j_run_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config
from tube_mpc_tpu.utils.io import load_run as j_load_run

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.utils.config import parse_config
from tube_mpc_tpu_torch.utils.io import load_run

from test_torch_runner import ARTIFACTS, SCALE_TOL, disturbances, raw_of


def test_jax_lane_engine_adapts_the_ancillary_weights_with_adapt_ancillary_false(tmp_path):
    off = raw_of("dubins", **{"adaptation.adapt_ancillary": False})
    on = raw_of("dubins")
    w = disturbances(on)
    cfg = j_parse_config(off)
    assert not cfg.adaptation.adapt_ancillary
    j_run_experiment(cfg, str(tmp_path / "jax"), w_seq=jnp.asarray(w, dtype=jnp.float32),
                     engine="lanes")
    runners.run_experiment(parse_config(on), str(tmp_path / "port"), w_seq=w, device="cpu")
    theirs, ours = j_load_run(str(tmp_path / "jax")), load_run(str(tmp_path / "port"))
    for name in ARTIFACTS:
        np.testing.assert_allclose(theirs[name], ours[name], rtol=0,
                                   atol=SCALE_TOL * max(np.abs(theirs[name]).max(), 1e-30),
                                   err_msg=name)
    Q = theirs["Qa_history"]
    assert not np.array_equal(Q[-1], Q[0]), "the JAX run's ancillary Q did not move"
