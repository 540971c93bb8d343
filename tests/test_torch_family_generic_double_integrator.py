"""K5 and K6 (their plain versions) and the coupled lane closed loop on the double integrator,
against the JAX package in f64 on the CPU (tests/torch_family_generic_checks.py)."""
import pytest

from torch_family_generic_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def family():
    return "double_integrator"
