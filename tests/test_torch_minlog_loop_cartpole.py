"""The port's coupled lane closed loop on the cart-pole configuration with the log
barrier, against the JAX package's, at B=3, N=6, H=3 in f64
(tests/torch_minlog_loop_checks.py)."""
import pytest

from torch_minlog_loop_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def minlog():
    return "cartpole_log"


@pytest.fixture(scope="module")
def kind():
    return "coupled"


@pytest.fixture(scope="module")
def changes():
    return {}
