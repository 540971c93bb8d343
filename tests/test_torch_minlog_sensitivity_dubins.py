"""K3-K6 (their plain versions) on Dubins with the exact-min aggregation and the log barrier against the JAX
package's Pallas kernels in interpret mode, and its whole lane sensitivity, in f64 on
the CPU (tests/torch_minlog_checks.py)."""
import pytest

from torch_minlog_checks import (  # noqa: F401  the tests and their fixtures
    case, grads, k3, k4, k5, k6, test_k5_matches_pallas_kernel, test_k6_dynamics_terms,
    test_k6_matches_pallas_kernel, test_sbwd_matches_pallas_kernel,
    test_sensitivity_matches_jax, test_sfwd_matches_pallas_kernel,
)


@pytest.fixture(scope="module")
def minlog():
    return "dubins_min_log"
