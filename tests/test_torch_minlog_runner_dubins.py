"""The port's runner against the JAX lane-engine runner on the Dubins config with
obstacle_aggregation: min and barrier_type: log, in paper mode, at N=6, H=3 in f32
(tests/torch_minlog_runner_checks.py)."""
import pytest

from torch_minlog_runner_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def minlog():
    return "dubins_min_log"


@pytest.fixture(scope="module")
def changes():
    return {}
