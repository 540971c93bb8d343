"""The port's generic lane closed loop against the JAX package's: the uncoupled generic loop with two inner adaptation steps per time step.

One JAX reference run, in interpret mode; the case and the tolerances are in
tests/torch_generic_loop.py.
"""
import pytest
import torch

from torch_generic_loop import FIELDS, check_field, field_values, moved, run_case


@pytest.fixture(scope="module")
def run():
    return run_case("generic_steps2")


@pytest.mark.parametrize("field", FIELDS)
def test_generic_steps2_loop_matches_jax(run, field):
    check_field(run, field)


def test_generic_steps2_loop_adapts_and_stays_finite(run):
    """Every logged value and final raw leaf is finite, and the re-gradient at fixed trajectories moves the barrier parameters."""
    for field in FIELDS:
        assert bool(torch.isfinite(field_values(run, field)[0]).all()), field
    for field in ['raw_aux.alpha_raw', 'raw_aux.gamma_raw']:
        assert moved(run, field), field
