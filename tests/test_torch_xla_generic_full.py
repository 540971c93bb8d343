"""The feature-major generic loop with coupling="full" (the exact bilevel gradient, the
explicit ∂L/∂x̄ term too) against the JAX package's, on Dubins (adapt.steps 1 and 2) and
on the cart-pole (m = 1, its Jacobians by autodiff); the Dubins cases also from a start
off the obstacles' bisector, where every step holds. The tests:
tests/torch_xla_generic_checks.py."""
import pytest

from torch_xla_generic_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def coupling():
    return "full"


OFF_BISECTOR = {"adaptation.adapt_nominal": True, "system.x0": [0.0, 0.5, 0.7853981633974483]}
CASES = {"coupled": ("dubins", {"adaptation.adapt_nominal": True}, 1, 2),
         "coupled_steps2": ("dubins", {"adaptation.adapt_nominal": True}, 2, 2),
         "coupled_off_bisector": ("dubins", OFF_BISECTOR, 1, H),
         "coupled_steps2_off_bisector": ("dubins", OFF_BISECTOR, 2, H),
         "cartpole": ("cartpole", {"adaptation.adapt_nominal": True}, 1, H)}
