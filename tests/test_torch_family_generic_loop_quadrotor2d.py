"""The coupled lane closed loop on the planar quadrotor against the JAX package's, at
B=3, N=6, H=3 in f64 on the CPU (tests/torch_family_generic_checks.py). Most of its time is
the JAX package compiling its coupled loop's n̂=7 kernels in interpret mode."""
import pytest

from torch_family_generic_checks import (  # noqa: F401  the tests and their fixtures
    loops, test_coupled_loop_adapts_the_nominal_and_stays_finite,
    test_coupled_loop_final_raws_match_jax, test_coupled_loop_matches_jax,
    test_coupled_setup_matches_build_experiment,
)


@pytest.fixture(scope="module")
def family():
    return "quadrotor2d"
