"""The feature-major generic loop with coupling="reference" (the reference's coupled
chain: the nominal plan is constant in L) against the JAX package's; the uncoupled
generic path (paper_dubins_mode: false) too; the coupled cases also from a start off the
obstacles' bisector, where every step holds. The tests: tests/torch_xla_generic_checks.py."""
import pytest

from torch_xla_generic_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def coupling():
    return "reference"


OFF_BISECTOR = {"adaptation.adapt_nominal": True, "system.x0": [0.0, 0.5, 0.7853981633974483]}
CASES = {"coupled": ("dubins", {"adaptation.adapt_nominal": True}, 1, 2),
         "coupled_steps2": ("dubins", {"adaptation.adapt_nominal": True}, 2, 2),
         "coupled_off_bisector": ("dubins", OFF_BISECTOR, 1, H),
         "coupled_steps2_off_bisector": ("dubins", OFF_BISECTOR, 2, H),
         "generic": ("dubins", {"paper_dubins_mode": False}, 1, H)}
