"""K5 and K6 (their plain versions) on the planar quadrotor against the JAX package's
Pallas kernels in interpret mode, in f64 on the CPU (tests/torch_family_generic_checks.py;
its coupled loop is in tests/test_torch_family_generic_loop_quadrotor2d.py, a file of its
own so that the test workers spread the two JAX compilations of its n̂=7 kernels)."""
import pytest

from torch_family_generic_checks import (  # noqa: F401  the tests and their fixtures
    case, k5, k6, test_k5_matches_pallas_kernel, test_k5_zeroes_gains_of_controls_at_a_bound,
    test_k6_dynamics_terms_are_not_zero, test_k6_matches_pallas_kernel,
)


@pytest.fixture(scope="module")
def family():
    return "quadrotor2d"
