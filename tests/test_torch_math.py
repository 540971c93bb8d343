"""The port's math layer against the JAX package, in f64 on the CPU.

Same numpy inputs through both: barriers and their derivatives, the Dubins step,
both forms of the smooth-min h, both forms of f̂, init_b0, the hand-written
tangent map (against torch.func.jvp and against JAX's jac_rows) and the
projected momentum update with and without gradient clipping.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops import barrier as jbar
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import augmented_step_fn as j_augmented_step_fn
from tube_mpc_tpu.ops.lanes import dubins_components as j_dubins_components
from tube_mpc_tpu.ops.lanes import init_b0_fn as j_init_b0_fn
from tube_mpc_tpu.ops.lanes import jac_rows as j_jac_rows
from tube_mpc_tpu.presets import PAPER_OBSTACLES
from tube_mpc_tpu.presets import dubins_paper_setup as j_dubins_paper_setup
from tube_mpc_tpu.systems.dubins import dubins_step as j_dubins_step
from tube_mpc_tpu.systems.obstacles import CircleField as JCircleField
from tube_mpc_tpu.systems.obstacles import h_smoothmin as j_h_smoothmin
from tube_mpc_tpu.tube.params import AdaptConfig as JAdaptConfig
from tube_mpc_tpu.tube.params import AuxAdapt as JAuxAdapt
from tube_mpc_tpu.tube.params import momentum_update as j_momentum_update
from tube_mpc_tpu.tube.params import project_aux_adapt as j_project_aux_adapt

from tube_mpc_tpu_torch.ops import barrier as tbar
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import (
    augmented_lin_fn,
    augmented_step_fn,
    dubins_components,
    init_b0_fn,
    jac_rows,
)
from tube_mpc_tpu_torch.presets import dubins_paper_setup
from tube_mpc_tpu_torch.systems.dubins import dubins_step
from tube_mpc_tpu_torch.systems.obstacles import CircleField, h_smoothmin
from tube_mpc_tpu_torch.tube.params import AdaptConfig, AuxAdapt, momentum_update, project_aux_adapt

RTOL = 1e-12
EPS = 1e-4
BETA = 20.0
B = 64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(np.asarray(a), dtype=jnp.float64)


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def inputs():
    """Lanes spread over the obstacle field (some inside an obstacle, so both
    barrier branches run), headings all round, controls within bounds."""
    rng = np.random.default_rng(20)
    x = np.stack([rng.uniform(0.0, 10.0, B), rng.uniform(0.0, 10.0, B),
                  rng.uniform(-np.pi, np.pi, B), rng.uniform(0.0, 3.0, B)])
    x[:2, :4] = np.array([[4.3, 2.1, 6.0, 8.5], [2.2, 4.1, 6.4, 4.0]])  # inside obstacles
    u = np.stack([rng.uniform(-10.0, 10.0, B), rng.uniform(-np.pi, np.pi, B)])
    bp = np.stack([rng.uniform(0.0, 0.2, B), rng.uniform(-0.5, 0.5, B), rng.uniform(0.0, 0.1, B)])
    dx = rng.normal(size=(4, B))
    du = rng.normal(size=(2, B))
    return dict(x=x, u=u, bp=bp, dx=dx, du=du)


def _components():
    kw = dict(dt=0.01, v_min=-10.0, v_max=10.0, omega_max=float(np.pi),
              centers=PAPER_OBSTACLES, radii=[1.0] * 5, aggregation="smoothmin", beta=BETA)
    return dubins_components(**kw), j_dubins_components(**kw)


@pytest.mark.parametrize("name", ["relaxed_inverse_barrier", "d_relaxed_inverse_barrier",
                                  "log_barrier", "d_log_barrier"])
def test_barrier_functions_match(name):
    rng = np.random.default_rng(1)
    zeta = np.concatenate([rng.uniform(-2.0, 2.0, 200), [0.0, EPS, 0.05, 1e-6]])
    alpha = rng.uniform(0.0, 0.3, zeta.shape)
    port_fn, ref_fn = getattr(tbar, name), getattr(jbar, name)
    if "log" in name:
        port, ref = port_fn(_t(zeta), eps=EPS), ref_fn(_j(zeta), eps=EPS)
    else:
        port, ref = port_fn(_t(zeta), _t(alpha), eps=EPS), ref_fn(_j(zeta), _j(alpha), eps=EPS)
    _close(port, ref)


@pytest.mark.parametrize("barrier_type", ["inverse", "log"])
def test_barrier_value_deriv_and_tangent_match(barrier_type):
    rng = np.random.default_rng(2)
    zeta = rng.uniform(-1.0, 2.0, 300)
    alpha = rng.uniform(0.0, 0.3, 300)
    dz = rng.normal(size=300)
    kw = dict(barrier_type=barrier_type, eps=EPS)
    _close(tbar.barrier_value(_t(zeta), _t(alpha), **kw), jbar.barrier_value(_j(zeta), _j(alpha), **kw))
    _close(tbar.barrier_deriv(_t(zeta), _t(alpha), **kw), jbar.barrier_deriv(_j(zeta), _j(alpha), **kw))
    value, tangent = tbar.barrier_lin(_t(zeta), _t(alpha), **kw)
    ref_val, ref_tan = jax.jvp(lambda z: jbar.barrier_value(z, _j(alpha), **kw), (_j(zeta),), (_j(dz),))
    _close(value, ref_val)
    _close(tangent(_t(dz)), ref_tan)


def test_dubins_step_matches(inputs):
    x, u = inputs["x"][:3].T, inputs["u"].T
    _close(dubins_step(_t(x), _t(u), dt=0.01), j_dubins_step(_j(x), _j(u), dt=0.01))


def test_h_component_form_matches(inputs):
    sys_c, j_sys_c = _components()
    xs = [inputs["x"][i] for i in range(3)]
    _close(sys_c.h(tuple(map(_t, xs))), j_sys_c.h(tuple(map(_j, xs))))
    value, tangent = sys_c.h_lin(tuple(map(_t, xs)))
    ref_val, ref_tan = jax.jvp(j_sys_c.h, (tuple(map(_j, xs)),),
                               (tuple(_j(inputs["dx"][i]) for i in range(3)),))
    _close(value, ref_val)
    _close(tangent(tuple(_t(inputs["dx"][i]) for i in range(3))), ref_tan)


def test_h_logsumexp_form_matches(inputs):
    x = inputs["x"][:3].T
    centers = np.asarray(PAPER_OBSTACLES, dtype=np.float64)
    field = CircleField(centers=_t(centers), radii=_t(np.ones(5)))
    j_field = JCircleField(centers=_j(centers), radii=_j(np.ones(5)))
    _close(h_smoothmin(_t(x), field, beta=BETA), j_h_smoothmin(_j(x), j_field, beta=BETA))


def test_f_hat_component_form_matches(inputs):
    sys_c, j_sys_c = _components()
    xs, us, bp = inputs["x"], inputs["u"], inputs["bp"]
    port = augmented_step_fn(sys_c, eps=EPS)(
        tuple(_t(r) for r in xs), tuple(_t(r) for r in us), BarrierParams(*map(_t, bp)))
    ref = j_augmented_step_fn(j_sys_c, eps=EPS)(
        tuple(_j(r) for r in xs), tuple(_j(r) for r in us), JBarrierParams(*map(_j, bp)))
    for p, r in zip(port, ref):
        _close(p, r)
    lin_value, _ = augmented_lin_fn(sys_c, eps=EPS)(
        tuple(_t(r) for r in xs), tuple(_t(r) for r in us), BarrierParams(*map(_t, bp)))
    for p, r in zip(lin_value, port):
        np.testing.assert_array_equal(p.numpy(), r.numpy())


def test_f_hat_feature_last_form_and_init_b0_match(inputs):
    s = dubins_paper_setup(N=4, H=2, device="cpu", dtype=torch.float64)
    js = j_dubins_paper_setup(N=4, H=2, dtype=jnp.float64)
    x_hat, u = inputs["x"].T, inputs["u"].T
    bp = [inputs["bp"][i] for i in range(3)]
    _close(s.aug.f_hat(_t(x_hat), _t(u), BarrierParams(*map(_t, bp))),
           js.aug.f_hat(_j(x_hat), _j(u), JBarrierParams(*map(_j, bp))))
    _close(s.aug.init_b0(_t(x_hat[:, :3]), BarrierParams(*map(_t, bp))),
           js.aug.init_b0(_j(x_hat[:, :3]), JBarrierParams(*map(_j, bp))))


def test_init_b0_component_form_matches(inputs):
    sys_c, j_sys_c = _components()
    xs, bp = inputs["x"][:3], inputs["bp"]
    _close(init_b0_fn(sys_c, eps=EPS)(tuple(map(_t, xs)), BarrierParams(*map(_t, bp))),
           j_init_b0_fn(j_sys_c, eps=EPS)(tuple(map(_j, xs)), JBarrierParams(*map(_j, bp))))


def test_tangent_map_matches_torch_jvp(inputs):
    sys_c, _ = _components()
    xs = tuple(_t(r) for r in inputs["x"])
    us = tuple(_t(r) for r in inputs["u"])
    dxs = tuple(_t(r) for r in inputs["dx"])
    dus = tuple(_t(r) for r in inputs["du"])
    bp = BarrierParams(*map(_t, inputs["bp"]))
    f_hat = augmented_step_fn(sys_c, eps=EPS)
    _, ref = torch.func.jvp(lambda x, u: f_hat(x, u, bp), (xs, us), (dxs, dus))
    _, tangent = augmented_lin_fn(sys_c, eps=EPS)(xs, us, bp)
    for p, r in zip(tangent(dxs, dus), ref):
        _close(p, r, rtol=1e-9, atol=1e-12)


def test_jacobian_rows_match_jax_jac_rows(inputs):
    sys_c, j_sys_c = _components()
    bp = BarrierParams(*map(_t, inputs["bp"]))
    _, tangent = augmented_lin_fn(sys_c, eps=EPS)(
        tuple(_t(r) for r in inputs["x"]), tuple(_t(r) for r in inputs["u"]), bp)
    A, Bm = jac_rows(tangent, 4, 2, _t(inputs["x"][0]))
    j_f_hat = j_augmented_step_fn(j_sys_c, eps=EPS)
    j_bp = JBarrierParams(*map(_j, inputs["bp"]))
    A_ref, B_ref = j_jac_rows(lambda x, u: j_f_hat(x, u, j_bp),
                              tuple(_j(r) for r in inputs["x"]), tuple(_j(r) for r in inputs["u"]))
    for i in range(4):
        for j in range(4):
            _close(A[i][j], A_ref[i][j], rtol=1e-9, atol=1e-12)
        for a in range(2):
            _close(Bm[i][a], B_ref[i][a], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("clip", [0.0, 0.7])
def test_momentum_update_and_projection_match(clip):
    rng = np.random.default_rng(3)
    p = [np.abs(rng.normal(size=(B, 3))), 0.01 + np.abs(rng.normal(size=(B, 2))), rng.uniform(size=B)]
    g = [rng.normal(size=(B, 3)), rng.normal(size=(B, 2)), rng.normal(size=B)]
    v = [rng.normal(size=(B, 3)), rng.normal(size=(B, 2)), rng.normal(size=B)]
    cfg, j_cfg = AdaptConfig(lr=0.3, momentum=0.9, grad_clip_norm=clip), \
        JAdaptConfig(lr=0.3, momentum=0.9, grad_clip_norm=clip)
    port_p, port_v = momentum_update(AuxAdapt(*map(_t, p)), AuxAdapt(*map(_t, g)),
                                     AuxAdapt(*map(_t, v)), cfg, project_aux_adapt)
    ref_p, ref_v = j_momentum_update(JAuxAdapt(*map(_j, p)), JAuxAdapt(*map(_j, g)),
                                     JAuxAdapt(*map(_j, v)), j_cfg, j_project_aux_adapt)
    for a, b in zip(port_p + port_v, tuple(ref_p) + tuple(ref_v)):
        _close(a, b)
    # the projection is active somewhere (clamps at Q >= 0, R >= 1e-4, qb in [0, 1])
    assert float(port_p.Q.min()) == 0.0 and float(port_p.qb.max()) == 1.0
