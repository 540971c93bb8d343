"""The port's generic and coupled sensitivity interface against the JAX
package's, in f64 on the CPU: tube_sensitivity_grads_lanes_generic (with and
without the reference cotangents) and tube_sensitivity_grads_lanes_nominal_coupled
fed those cotangents as its upper gradients, through the JAX functions with their
Pallas kernels in interpret mode. The case and the tolerances are those of
tests/test_torch_lane_sensitivity_generic.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from tube_mpc_tpu.tube import lane_interface as jli

from tube_mpc_tpu_torch.tube.lane_interface import (
    tube_sensitivity_grads_lanes_generic,
    tube_sensitivity_grads_lanes_nominal_coupled,
)

from test_torch_lane_sensitivity import ACTIVE_TOL, ATOL, BT, REG, RTOL, _t
from test_torch_lane_sensitivity_generic import B, F64, N, case  # noqa: F401 (fixture)

TARGET = np.array([10.0, 10.0, np.pi / 4])


@pytest.fixture(scope="module")
def interface(case):
    """The port's and JAX's generic (with and without the cotangents) and coupled
    nominal gradients; the nominal sweep takes the cotangents as upper rows."""
    kw = dict(X_hat=case["X"], U=case["U"], X_ref=_t(case["X_ref"]), U_ref=_t(case["U_ref"]),
              reg=REG, active_tol=ACTIVE_TOL)
    j = lambda a: jnp.asarray(np.asarray(a), dtype=F64)
    jkw = {k: (j(v) if k not in ("reg", "active_tol") else v) for k, v in kw.items()}
    port = tube_sensitivity_grads_lanes_generic(case["pb"], w=case["w"], bp=case["bp"],
                                                device="cpu", **kw)
    port_e = tube_sensitivity_grads_lanes_generic(case["pb"], w=case["w"], bp=case["bp"],
                                                  emit_ref_grads=True, device="cpu", **kw)
    ref = jli.tube_sensitivity_grads_lanes_generic(case["j_pb"], w=case["j_w"], bp=case["j_bp"],
                                                   block_b=BT, interpret=True, **jkw)
    ref_e = jli.tube_sensitivity_grads_lanes_generic(case["j_pb"], w=case["j_w"],
                                                     bp=case["j_bp"], block_b=BT, interpret=True,
                                                     emit_ref_grads=True, **jkw)
    _, g_Xref, g_Uref = port_e
    nom = tube_sensitivity_grads_lanes_nominal_coupled(
        case["pb"], w=case["w"], bp=case["bp"], X_hat=case["X"], U=case["U"],
        target=_t(TARGET), upper_gX=g_Xref, upper_gU=g_Uref, reg=REG, active_tol=ACTIVE_TOL,
        device="cpu")
    ref_nom = jli.tube_sensitivity_grads_lanes_nominal_coupled(
        case["j_pb"], w=case["j_w"], bp=case["j_bp"], X_hat=j(case["X"]), U=j(case["U"]),
        target=j(TARGET), upper_gX=j(g_Xref), upper_gU=j(g_Uref), reg=REG,
        active_tol=ACTIVE_TOL, block_b=BT, interpret=True)
    return dict(generic=(port, ref), emit=(port_e, ref_e), nominal=(nom, ref_nom))


@pytest.mark.parametrize("which", ["generic", "emit", "nominal"])
def test_interface_gradients_match_jax(interface, which):
    port, ref = interface[which]
    if which == "emit":
        (port, pX, pU), (ref, rX, rU) = port, ref
        assert tuple(pX.shape) == (B, N + 1, 4) and tuple(pU.shape) == (B, N, 2)
        np.testing.assert_allclose(pX.numpy(), np.asarray(rX), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pU.numpy(), np.asarray(rU), rtol=RTOL, atol=ATOL)
        assert not bool(pX[..., 3].any())   # the barrier row is masked
    assert type(port).__name__ == type(ref).__name__ and port._fields == ref._fields
    for f in port._fields:
        p, r = getattr(port, f), np.asarray(getattr(ref, f))
        assert tuple(p.shape) == r.shape, f
        np.testing.assert_allclose(p.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=f)
    if which == "nominal":
        assert float(port.tight.abs().max()) > 0.0
