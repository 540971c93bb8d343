"""The port's paper lane closed loop on the Dubins configuration with the exact-min
aggregation and the log barrier, against the JAX package's, at B=3, N=6, H=3 in f64
(tests/torch_minlog_loop_checks.py), from a start half a unit off the bisector of the
first two obstacles.

At the shipped start (0, 0, π/4) the nominal plan runs along the bisector y = x of the
obstacles (4, 2) and (2, 4), where their h_i are equal to the last bit or nearly so at
every step, and the exact min's derivative jumps between the tie (1/2 to each side) and
one side on a one-ulp difference of h_i. There the JAX reference's own rounding decides:
XLA under jit rounds h_i = (px - cx)² + (py - cy)² - r² otherwise than the same
operations in order, which PyTorch, the CUDA kernels (-fmad=false) and JAX without jit
run. After the first iteration of the first nominal solve, at (px, py) =
(0.07071067811865477, 0.07071067811865475), the operations in order give h_0 = h_1 =
18.161471862576143 and XLA under jit 18.161471862576143 and 18.161471862576146, and the
first nominal ω parts by 5.6e-4. test_the_bisector_ties_as_the_operations_in_order pins
the port's side of that.
"""
import jax.numpy as jnp
import pytest
import torch

from tube_mpc_tpu_torch.utils.config import lane_components, parse_config

from torch_minlog_cases import raw_of
from torch_minlog_loop_checks import *  # noqa: F401,F403  the tests and their fixtures


@pytest.fixture(scope="module")
def minlog():
    return "dubins_min_log"


@pytest.fixture(scope="module")
def kind():
    return "paper"


@pytest.fixture(scope="module")
def changes():
    return {"system.x0": [0.0, 0.5, 0.7853981633974483]}


def test_the_bisector_ties_as_the_operations_in_order():
    """At that point of the shipped start's nominal plan, the port's h_i of the obstacles
    (4, 2) and (2, 4) tie, as JAX's operations run one by one give them, and the min's
    tangent takes half of each side: ∂h/∂px = 1/2 2 (px - 4) + 1/2 2 (px - 2)."""
    px, py = 0.07071067811865477, 0.07071067811865475
    sys_c = lane_components(parse_config(raw_of("dubins_min_log")))
    assert sys_c.spec.centers[:2] == ((4.0, 2.0), (2.0, 4.0))
    xs = tuple(torch.tensor([v], dtype=torch.float64) for v in (px, py, 0.7853981633974483))
    value, tangent = sys_c.h_lin(xs)
    jhs = [(jnp.float64(px) - cx) ** 2 + (jnp.float64(py) - cy) ** 2 - 1.0
           for cx, cy in ((4.0, 2.0), (2.0, 4.0))]
    assert float(value) == float(jhs[0]) == float(jhs[1]) == 18.161471862576143
    one, zero = torch.ones(1, dtype=torch.float64), torch.zeros(1, dtype=torch.float64)
    assert float(tangent((one, zero, zero))) == 0.5 * (2 * (px - 4.0)) + 0.5 * (2 * (px - 2.0))
