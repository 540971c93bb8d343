"""K1 and K2 (their plain versions) on Dubins with the exact-min aggregation and the log barrier against the JAX
package's Pallas kernels in interpret mode, and its whole lane solve, in f64 on the CPU
(tests/torch_minlog_checks.py)."""
import pytest

from torch_minlog_checks import (  # noqa: F401  the tests and their fixtures
    case, k1, k2, solved, test_fwd_matches_pallas_kernel, test_inputs_take_the_branches,
    test_ric_matches_pallas_kernel, test_solve_matches_jax,
)


@pytest.fixture(scope="module")
def minlog():
    return "dubins_min_log"
