"""The port's paper lane closed loop on the planar quadrotor against the JAX package's, at
B=3, N=6, H=3 in f64 (tests/torch_family_loop_checks.py)."""
import pytest

from torch_family_loop_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def family():
    return "quadrotor2d"
