"""K3 and K4 (their plain versions) on the double integrator against the JAX package's Pallas
kernels in interpret mode, and its whole lane sensitivity, in f64 on the CPU
(tests/torch_family_kernel_checks.py)."""
import pytest

from torch_family_kernel_checks import (  # noqa: F401  the tests and their fixtures
    case, grads, k3, k4, test_sbwd_matches_pallas_kernel,
    test_sbwd_zeroes_gains_of_controls_at_a_bound, test_sensitivity_matches_jax,
    test_sfwd_matches_pallas_kernel,
)


@pytest.fixture(scope="module")
def family():
    return "double_integrator"
