"""With no w_seq, the port's runner draws what the JAX package's runner draws from the
config's seed, on both engines, and tube_verification what the JAX one draws from its keys
(tube_mpc_tpu_torch/utils/prng.py), on the CPU at N=4, H=2:

- the lane engine (f32), B = 1 and B = 3: [B, H, nx] from PRNGKey(seed), one draw;
- the XLA engine, B = 1: [H, nx] from PRNGKey(seed), in paper mode (f64) and on the
  generic path (adapt_nominal, f64); B = 3: one [H, nx] from each of
  split(PRNGKey(seed), 3) (paper, f64);
- tube_verification(keys=split(PRNGKey(5), 4)) on the XLA engine (tests/
  torch_scenario_cases.py's setup).

Each case is shown twice. The port's run with no w_seq is bitwise its run on the JAX
package's draw passed as w_seq, drawn eagerly as bench.py draws (each operation rounded on
its own). And it agrees with the JAX runner's own run from the seed at the runner tests'
tolerances: every artifact within 1e-3 of its largest magnitude on the lane engine
(tests/test_torch_runner.py), rtol 1e-6 on states and controls, 1e-5 on the loss and weight
histories, atol 1e-8 on the XLA engine (tests/test_torch_xla_runner.py), and the scenario
tests' on tube_verification (tests/test_torch_scenarios.py). The JAX runners draw inside
jax.jit, where XLA's CPU compiler fuses low + (high - low) * u into one multiply-add on some
elements; that draw is one rounding from the eager one (held: within an ulp of high - low),
far inside those tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.costs import CostWeights as JCostWeights
from tube_mpc_tpu.parallel.scenarios import tube_verification as j_tube_verification
from tube_mpc_tpu.runners import run_experiment as j_run_experiment
from tube_mpc_tpu.utils.config import build_experiment as j_build_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config

from tube_mpc_tpu_torch import runners
from tube_mpc_tpu_torch.ops.costs import CostWeights
from tube_mpc_tpu_torch.parallel import TubeStats, tube_verification
from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog
from tube_mpc_tpu_torch.utils.config import parse_config
from tube_mpc_tpu_torch.utils.prng import PRNGKey, split

from torch_scenario_cases import W_AUX, draws, jax_setup, port_setup
from torch_xla_cases import close, raw_of, t64

N, H, SEED = 4, 2, 3
HISTORIES = ("loss", "Q_hist", "R_hist", "qb_hist")
# (engine, batch, config changes)
CASES = {
    "lanes_B1": ("lanes", None, {"use_float64": False}),
    "lanes_B3": ("lanes", 3, {"use_float64": False}),
    "xla_B1": ("xla", None, {}),
    "xla_B1_generic": ("xla", None, {"adaptation.adapt_nominal": True}),
    "xla_B3": ("xla", 3, {}),
}


def jax_draw(jsys, engine, B, dtype):
    """The JAX runner's draw from PRNGKey(SEED), made eagerly -> [B, H, nx] numpy."""
    key = jax.random.PRNGKey(SEED)
    if engine == "lanes":
        return np.asarray(jsys.sample_disturbance(key, (B, H), dtype=dtype))
    if B == 1:
        return np.asarray(jsys.sample_disturbance(key, (H,), dtype=dtype))[None]
    return np.asarray(jax.vmap(lambda k: jsys.sample_disturbance(k, (H,), dtype=dtype))(
        jax.random.split(key, B)))


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tmp_path_factory):
    engine, batch, changes = CASES[request.param]
    raw = raw_of("dubins", N, H, seed=SEED, **changes)
    tmp = tmp_path_factory.mktemp(request.param)
    jcfg = j_parse_config(raw)
    B = batch or 1
    dtype = jnp.float64 if engine == "xla" else jnp.float32
    w = jax_draw(j_build_experiment(jcfg).system, engine, B, dtype)
    drawn = runners.run_experiment(parse_config(raw), str(tmp / "drawn"), batch=batch,
                                   engine=engine, device="cpu")
    given = runners.run_experiment(parse_config(raw), str(tmp / "given"),
                                   w_seq=w if B > 1 else w[0], engine=engine, device="cpu")
    ref = j_run_experiment(jcfg, str(tmp / "jax"), batch=batch, engine=engine)
    return request.param, engine, B, w, drawn, given, ref


def test_the_drawn_run_is_the_run_on_the_jax_draw(runs):
    case, _, B, w, drawn, given, _ = runs
    for name in ClosedLoopLog._fields:
        a, b = getattr(drawn["log"], name), getattr(given["log"], name)
        assert a.shape[:2] == (B, H), (case, name)
        assert torch.equal(a, b), f"{case} {name}"


def test_the_drawn_run_matches_the_jax_runners(runs):
    case, engine, B, _, drawn, _, ref = runs
    for name in ClosedLoopLog._fields:
        a = getattr(drawn["log"], name).double().numpy()
        b = np.asarray(getattr(ref["log"], name), dtype=np.float64)
        b = b.reshape(a.shape)     # the JAX XLA runner's single trajectory has no lane dim
        if engine == "lanes":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * max(np.abs(b).max(), 1e-30),
                                       err_msg=f"{case} {name}")
        else:
            rtol = 1e-5 if name in HISTORIES else 1e-6
            np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-8, err_msg=f"{case} {name}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
def test_the_jitted_jax_draw_is_one_rounding_from_the_eager_one(dtype):
    """The fused multiply-add skips the rounding of (high - low) * u, which is at most half
    an ulp of high - low, and the sum's rounding then moves by at most another half."""
    jsys = j_build_experiment(j_parse_config(raw_of("dubins", N, H))).system
    key = jax.random.PRNGKey(SEED)
    eager = np.asarray(jsys.sample_disturbance(key, (64, 30), dtype=dtype))
    jitted = np.asarray(jax.jit(lambda k: jsys.sample_disturbance(k, (64, 30), dtype=dtype))(key))
    width = np.asarray(jsys.w_high, dtype=dtype) - np.asarray(jsys.w_low, dtype=dtype)
    assert np.all(np.abs(jitted - eager) <= np.spacing(width))


def test_tube_verification_draws_from_its_keys_as_jax():
    system, aug, cfg, kw, x0, _, _ = jax_setup()
    s = port_setup()
    B = 4
    keys, w = draws(system, 5, B, cfg.H)
    j_w_aux = JCostWeights.create(W_AUX["Q"], W_AUX["R"], W_AUX["Qf"], W_AUX["qb"],
                                  dtype=jnp.float64)
    ref_logs, ref = j_tube_verification(system, aug, cfg, w_aux=j_w_aux, x0=x0, keys=keys, **kw)
    w_aux = CostWeights(*(t64(W_AUX[f]) for f in CostWeights._fields))
    kw_port = dict(w_nominal=s.w_nominal, w_aux=w_aux, bp=s.bp, x0=s.x0, target=s.target,
                   device="cpu")
    port_keys = split(PRNGKey(5), B)
    np.testing.assert_array_equal(port_keys.numpy(), np.asarray(keys).astype(np.int64))
    logs, stats = tube_verification(s.system, s.aug, s.cfg, keys=port_keys, **kw_port)
    given_logs, given = tube_verification(s.system, s.aug, s.cfg, w_seqs=t64(w), **kw_port)
    for name in TubeStats._fields:
        assert torch.equal(getattr(stats, name), getattr(given, name)), name
        close(getattr(stats, name), getattr(ref, name), 1e-6, 1e-8, name)
    for name in ClosedLoopLog._fields:
        assert torch.equal(getattr(logs, name), getattr(given_logs, name)), name
        tol = (1e-5, 1e-8) if name in HISTORIES else (1e-6, 1e-8)
        close(getattr(logs, name), getattr(ref_logs, name), *tol, name)
