"""K1 and K2 (their plain versions) on the double integrator against the JAX package's Pallas
kernels in interpret mode, and its whole lane solve, in f64 on the CPU
(tests/torch_family_kernel_checks.py)."""
import pytest

from torch_family_kernel_checks import (  # noqa: F401  the tests and their fixtures
    case, k1, k2, solved, test_fwd_matches_pallas_kernel, test_ric_matches_pallas_kernel,
    test_solve_matches_jax,
)


@pytest.fixture(scope="module")
def family():
    return "double_integrator"
