"""The port's generic lane closed loop against the JAX package's: the coupled loop (adapt_nominal=True, coupling="reference").

One JAX reference run, in interpret mode; the case and the tolerances are in
tests/torch_generic_loop.py.
"""
import pytest
import torch

from torch_generic_loop import FIELDS, check_field, field_values, moved, run_case


@pytest.fixture(scope="module")
def run():
    return run_case("coupled")


@pytest.mark.parametrize("field", FIELDS)
def test_coupled_loop_matches_jax(run, field):
    check_field(run, field)


def test_coupled_loop_adapts_and_stays_finite(run):
    """Every logged value and final raw leaf is finite, and the coupled chain moves the nominal weights and tightening."""
    for field in FIELDS:
        assert bool(torch.isfinite(field_values(run, field)[0]).all()), field
    for field in ['raw_nom.Q_raw', 'raw_nom.tight_raw', 'raw_aux.alpha_raw']:
        assert moved(run, field), field
