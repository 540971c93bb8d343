"""The port's feature-major generic closed loop (tube/closed_loop.run_generic_closed_loop)
against the JAX package's vmapped one, in f64 on the CPU, B=3, N=8, H=3: the tests of
tests/test_torch_xla_generic_<coupling>.py, each of which names its coupling with the
fixture ``coupling`` and its cases in its module's ``CASES`` ({name: (config,
{"section.key": value}, inner adaptation steps, least steps held)}), one parametrised
test per case.

Both packages build the same YAML and start from the runner's raw θ̄, θ (the config's
numbers taken as raw values); the coupled cases adapt θ̄ through the ancillary problem's
reference. Tolerances: rtol 1e-6 on states and controls, 1e-5 on the loss, the weight
histories and the final raw parameters, atol 1e-8 (tests/test_closed_loop.py:139-143).

The comparison holds the steps on which the port agrees with itself under a 1e-15
relative perturbation of its raw θ̄, θ start, as chip_smoke.py's rule for a chaotic loop
does: at least the case's least steps held, and the final raw parameters when all three
hold. On dubins.yaml's coupled cases from the shipped start the third step's nominal
solve is that sensitive: the start runs along the bisector of the first two obstacles,
the plan's ω, ~1.3e-3, moves by 7.6e-7 under the perturbation (tol 1e-3 or 1e-12
alike), as far as it parts from the JAX package's, where the line search's candidates
tie to rounding. Those cases hold their first two steps; the same cases from a start
half a unit off the bisector (x0 = (0, 0.5, π/4), where the perturbation moves u_real by
~1e-14) hold all three steps and the final raw θ̄, θ, and so does every other case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tube_mpc_tpu.tube.closed_loop import run_generic_closed_loop as j_run_generic_closed_loop

from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog, run_generic_closed_loop

from torch_xla_cases import built_pair, close, disturbances, raw_of, raws_pair, t64

B, N, H = 3, 8, 3
STATE_TOL = (1e-6, 1e-8)
HIST_TOL = (1e-5, 1e-8)


def _cfg(built, coupling, steps):
    c = built.tube_cfg
    return dataclasses.replace(c, coupling=coupling,
                               adapt=dataclasses.replace(c.adapt, steps=steps))


def _tol(field):
    return HIST_TOL if field in ("loss", "Q_hist", "R_hist", "qb_hist") else STATE_TOL


def held_steps(log, other):
    """The number of leading steps on which two logs agree within the tolerances."""
    for t in range(log.x_real.shape[1]):
        for field in ClosedLoopLog._fields:
            a, b = getattr(log, field)[:, t], getattr(other, field)[:, t]
            rtol, atol = _tol(field)
            if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                return t
    return log.x_real.shape[1]


def run_case(name, changes, steps, coupling):
    """(port (log, raws), JAX (log, raws), adapt_nominal, the steps the port holds under
    its perturbed start)."""
    raw = raw_of(name, N, H, **changes)
    w = disturbances(raw, B, H, seed=8)
    jb, pb = built_pair(raw)
    (jn, ja), (pn, pa) = raws_pair(raw)

    def mine(scale):
        return run_generic_closed_loop(
            pb.system, pb.aug, _cfg(pb, coupling, steps),
            raw_nom_init=type(pn)(*(v * scale for v in pn)),
            raw_aux_init=type(pa)(*(v * scale for v in pa)), x0=pb.x0, target=pb.target,
            w_seq=t64(w), device="cpu")

    jcfg = _cfg(jb, coupling, steps)
    ref = jax.jit(jax.vmap(lambda ws: j_run_generic_closed_loop(
        jb.system, jb.aug, jcfg, raw_nom_init=jn, raw_aux_init=ja, x0=jb.x0,
        target=jb.target, w_seq=ws)))(jnp.asarray(w))
    out = mine(1.0)
    return out, ref, pb.tube_cfg.adapt_nominal, held_steps(out[0], mine(1.0 + 1e-15)[0])


def pytest_generate_tests(metafunc):
    if "key" in metafunc.fixturenames:
        metafunc.parametrize("key", list(metafunc.module.CASES), scope="module")


@pytest.fixture(scope="module")
def loop(request, key, coupling):
    return run_case(*request.module.CASES[key][:3], coupling)


def test_generic_loop_matches_the_jax_loop(request, key, loop):
    (log, (rn, ra)), (jlog, (jrn, jra)), _, held = loop
    least = request.module.CASES[key][3]
    assert held >= least, f"{key}: the port agrees with itself on {held} steps only"
    for field in ClosedLoopLog._fields:
        close(getattr(log, field)[:, :held], np.asarray(getattr(jlog, field))[:, :held],
              *_tol(field), f"{key} {field}")
    if held == H:
        for mine, ref, tree in ((rn, jrn, "raw_nom"), (ra, jra, "raw_aux")):
            for f in mine._fields:
                close(getattr(mine, f), getattr(ref, f), *HIST_TOL, f"{key} {tree}.{f}")


def test_the_coupled_chain_moves_the_nominal_parameters(request, key, loop):
    """With adapt_nominal the nominal raw θ̄ moved; without, it stayed as it started."""
    (_, (rn, _)), _, adapt_nominal, _ = loop
    name, changes = request.module.CASES[key][:2]
    start = raws_pair(raw_of(name, N, H, **changes))[1][0]
    changed = [bool((v != v0).any()) for v, v0 in zip(rn, start)]
    assert any(changed) == adapt_nominal, changed
