"""The XLA engine's sequential Riccati sweep (tube_mpc_tpu_torch/solvers/ilqr.py::
_backward_pass) keeps V_xx symmetric, ½(V_xx + V_xxᵀ) after every step, a guard the JAX
package's sweep lacks (ROADMAP.md, "differences kept on purpose"), on the CPU:

- at N = 256 and 1024 on tests/test_pscan.py's random LQ recipe (reg 1e-9, f64) its gains
  stay with the exact-elimination recursion's, at the tolerance
  tests/test_torch_pscan.py holds the horizon-parallel sweep to there (rtol 1e-7, atol
  1e-8). Without the guard the split value update grows the antisymmetric part that
  rounding leaves in V_xx, and the gains part from the recursion's far past that tolerance
  (tools/riccati_asymmetry_probe.py prints by how much); in f32 the same sweep stays within
  1e-3 of the f64 recursion;
- V_xx is symmetric to the bit after every step (each value update recorded);
- at N <= 64 the sweep agrees with the JAX package's _backward_pass (lane by lane, jitted
  once a shape) at tests/test_torch_xla_ilqr.py's tolerance, rtol 1e-7, atol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.solvers import ilqr as J

from tube_mpc_tpu_torch.solvers import ilqr

from test_torch_pscan import LANES, exact_recursion, random_lq
from torch_xla_cases import close, t64

REG = 1e-9


@pytest.mark.parametrize("N", [256, 1024])
def test_sequential_gains_match_the_exact_recursion_at_long_horizons(N):
    data = [t64(a) for a in random_lq(3, LANES, N, 4, 2)]
    K, _ = ilqr._backward_pass(*data, REG)
    _, _, K_e = exact_recursion(*data, reg=REG)
    close(K, K_e.numpy(), 1e-7, 1e-8, "K")


@pytest.mark.parametrize("N", [256, 1024])
def test_sequential_gains_in_f32_stay_with_the_exact_recursion(N):
    data = [t64(a) for a in random_lq(3, LANES, N, 4, 2)]
    K, _ = ilqr._backward_pass(*(a.float() for a in data), REG)
    _, _, K_e = exact_recursion(*data, reg=REG)
    assert torch.isfinite(K).all()
    assert float((K.double() - K_e).abs().max()) < 1e-3


def test_v_xx_is_symmetric_after_every_step(monkeypatch):
    seen = []
    update = ilqr._value_update

    def recorded(*args):
        V_x, V_xx = update(*args)
        seen.append(V_xx)
        return V_x, V_xx

    monkeypatch.setattr(ilqr, "_value_update", recorded)
    N = 64
    ilqr._backward_pass(*(t64(a) for a in random_lq(3, LANES, N, 4, 2)), REG)
    assert len(seen) == N
    for k, V_xx in enumerate(seen):
        assert torch.equal(V_xx, V_xx.transpose(-1, -2)), f"step {k}"


@pytest.mark.parametrize("n,m,N", [(4, 2, 17), (4, 1, 32), (6, 2, 50), (7, 2, 64)])
def test_sequential_sweep_matches_jax_at_short_horizons(n, m, N):
    data = random_lq(20 + N, LANES, N, n, m)
    K, kff = ilqr._backward_pass(*(t64(a) for a in data), REG)
    ref = jax.jit(J._backward_pass, static_argnums=9)
    lanes = [ref(*(jnp.asarray(a[i]) for a in data), REG) for i in range(LANES)]
    close(K, np.stack([np.asarray(r[0]) for r in lanes]), 1e-7, 1e-9, "K")
    close(kff, np.stack([np.asarray(r[1]) for r in lanes]), 1e-7, 1e-9, "kff")
