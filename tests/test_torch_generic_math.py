"""The generic path's math in the port against the JAX package, in f64 on the CPU.

The derivatives of f̂ in the barrier parameters (α, γ, tight), which the JAX
generic sensitivity kernel takes by three jax.jvp calls and the port writes by
hand (ops/barrier.py::barrier_dalpha, the ``params`` of ops/lanes.py's tangent
map), against jax.jvp and torch.func.jvp; and the raw softplus/tanh parameters,
their projection and the momentum update over them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops import barrier as jbar
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import augmented_step_fn as j_augmented_step_fn
from tube_mpc_tpu.tube import params as jparams

from tube_mpc_tpu_torch.ops import barrier as tbar
from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import augmented_lin_fn, augmented_step_fn
from tube_mpc_tpu_torch.tube import params as tparams

from test_torch_math import _components, _j, _t

EPS = 1e-4
B = 64
RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(scope="module")
def point():
    """Lanes over the obstacle field: some inside an obstacle or within α of one
    (the quadratic branch), the rest on the 1/h branch; α = ε exactly on two lanes
    (the balanced-equality tie) and α < ε on two (α has no effect there)."""
    rng = np.random.default_rng(30)
    x = np.stack([rng.uniform(0.0, 10.0, B), rng.uniform(0.0, 10.0, B),
                  rng.uniform(-np.pi, np.pi, B), rng.uniform(0.0, 3.0, B)])
    x[:2, :6] = np.array([[4.3, 2.1, 6.0, 8.5, 4.9, 3.2], [2.2, 4.1, 6.4, 4.0, 2.3, 1.0]])
    u = np.stack([rng.uniform(-10.0, 10.0, B), rng.uniform(-np.pi, np.pi, B)])
    bp = np.stack([rng.uniform(0.0, 1.5, B), rng.uniform(-0.9, 0.9, B), rng.uniform(0.0, 0.3, B)])
    bp[0, 6:8] = EPS
    bp[0, 8:10] = 0.0
    return dict(x=x, u=u, bp=bp, tie=np.isin(np.arange(B), [6, 7]))


def _jax_param_tangents(p):
    """jax.jvp of the JAX f̂ in each of α, γ, tight (tangent 1), as
    tube_mpc_tpu/ops/pallas/lane_sensitivity.py:248-258 takes them."""
    _, j_sys_c = _components()
    f_hat = j_augmented_step_fn(j_sys_c, eps=EPS)
    xs, us = tuple(map(_j, p["x"])), tuple(map(_j, p["u"]))
    a, g, t = map(_j, p["bp"])
    one = jnp.ones_like(a)
    f = lambda a_, g_, t_: f_hat(xs, us, JBarrierParams(alpha=a_, gamma=g_, tight=t_))
    return [jax.jvp(lambda a_: f(a_, g, t), (a,), (one,))[1],
            jax.jvp(lambda g_: f(a, g_, t), (g,), (one,))[1],
            jax.jvp(lambda t_: f(a, g, t_), (t,), (one,))[1]]


def _port_param_tangents(p):
    sys_c, _ = _components()
    _, tangent = augmented_lin_fn(sys_c, eps=EPS)(
        tuple(map(_t, p["x"])), tuple(map(_t, p["u"])), BarrierParams(*map(_t, p["bp"])))
    return tangent.params()


def test_point_runs_both_barrier_branches(point):
    sys_c, _ = _components()
    h = sys_c.h(tuple(map(_t, point["x"][:3]))).numpy()
    alpha_eff = np.maximum(point["bp"][0], EPS)
    relaxed = h - point["bp"][2] < alpha_eff
    assert relaxed.any() and not relaxed.all()
    assert relaxed[6:8].any()   # the tie α == ε on the quadratic branch


@pytest.mark.parametrize("param", ["alpha", "gamma", "tight"])
def test_param_tangent_matches_jax_jvp(point, param):
    i = ["alpha", "gamma", "tight"].index(param)
    port, ref = _port_param_tangents(point)[i], _jax_param_tangents(point)[i]
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    if param == "alpha":
        assert float(np.abs(np.asarray(ref[3])).max()) > 0.0
        assert float(np.abs(port[3].numpy()[point["tie"]]).max()) > 0.0


@pytest.mark.parametrize("param", ["alpha", "gamma", "tight"])
def test_param_tangent_matches_torch_jvp(point, param):
    """Against torch's own autodiff of the port's f̂, away from the tie α == ε,
    where torch's clamp passes the whole tangent and JAX's max half of it."""
    i = ["alpha", "gamma", "tight"].index(param)
    sys_c, _ = _components()
    f_hat = augmented_step_fn(sys_c, eps=EPS)
    xs, us = tuple(map(_t, point["x"])), tuple(map(_t, point["u"]))
    bp = list(map(_t, point["bp"]))

    def f(v):
        args = list(bp)
        args[i] = v
        return f_hat(xs, us, BarrierParams(*args))

    _, ref = torch.func.jvp(f, (bp[i],), (torch.ones_like(bp[i]),))
    port = _port_param_tangents(point)[i]
    keep = ~point["tie"]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy()[keep], r.numpy()[keep], rtol=RTOL, atol=ATOL)


def test_barrier_dalpha_matches_jax_jvp():
    rng = np.random.default_rng(31)
    zeta = np.concatenate([rng.uniform(-2.0, 2.0, 200), [0.0, EPS, 0.05, -0.3, 0.2]])
    alpha = np.concatenate([rng.uniform(0.0, 1.0, 200), [EPS, EPS, 0.0, 0.0, 0.3]])
    port = tbar.barrier_dalpha(_t(zeta), _t(alpha), eps=EPS)
    ref = jax.jvp(lambda a: jbar.relaxed_inverse_barrier(_j(zeta), a, eps=EPS),
                  (_j(alpha),), (jnp.ones_like(_j(alpha)),))[1]
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert not bool(tbar.barrier_dalpha(_t(zeta), _t(alpha), barrier_type="log", eps=EPS).any())


def test_softplus_and_its_inverse_match():
    x = np.concatenate([np.linspace(-30.0, 30.0, 121), [1000.0, 100.0, 20.5, -1000.0]])
    np.testing.assert_allclose(tparams.softplus(_t(x)).numpy(), np.asarray(jparams.softplus(_j(x))),
                               rtol=1e-12, atol=0.0)
    assert float(tparams.softplus(_t([1000.0]))) == 1000.0
    y = np.concatenate([np.geomspace(1e-6, 50.0, 60), [1000.0]])
    np.testing.assert_allclose(tparams.inv_softplus(_t(y)).numpy(),
                               np.asarray(jparams.inv_softplus(_j(y))), rtol=1e-12, atol=0.0)


def _raws(rng, shape=(B,)):
    aux = dict(Q_raw=rng.normal(size=shape + (3,)), R_raw=rng.normal(size=shape + (2,)),
               Qf_raw=rng.normal(size=shape + (3,)), qb_raw=rng.normal(size=shape),
               alpha_raw=rng.normal(size=shape), gamma_raw=rng.normal(size=shape))
    return aux, dict(aux, tight_raw=rng.normal(size=shape))


@pytest.mark.parametrize("cls", ["RawAuxTheta", "RawNominalTheta"])
def test_raw_parameters_map_and_project_as_jax(cls):
    aux, nom = _raws(np.random.default_rng(32))
    leaves = aux if cls == "RawAuxTheta" else nom
    port = getattr(tparams, cls)(**{k: _t(v) for k, v in leaves.items()})
    ref = getattr(jparams, cls)(**{k: _j(v) for k, v in leaves.items()})
    methods = ["Q", "R", "Qf", "qb", "alpha", "gamma"] + (["tight"] if cls == "RawNominalTheta" else [])
    for m in methods:
        np.testing.assert_allclose(getattr(port, m)().numpy(), np.asarray(getattr(ref, m)()),
                                   rtol=1e-12, atol=0.0)
    pp, rp = tparams.project_raw(port), jparams.project_raw(ref)
    assert type(pp) is type(port)
    for f in port._fields:
        np.testing.assert_array_equal(getattr(pp, f).numpy(), np.asarray(getattr(rp, f)))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_momentum_update_of_raw_parameters_matches(clip):
    rng = np.random.default_rng(33)
    p, _ = _raws(rng)
    g, _ = _raws(rng)
    v, _ = _raws(rng)
    cfg = tparams.AdaptConfig(lr=5e-2, momentum=0.9, grad_clip_norm=clip)
    j_cfg = jparams.AdaptConfig(lr=5e-2, momentum=0.9, grad_clip_norm=clip)
    mk = lambda d, cls, f: cls(**{k: f(x) for k, x in d.items()})
    port = tparams.momentum_update(mk(p, tparams.RawAuxTheta, _t), mk(g, tparams.RawAuxTheta, _t),
                                   mk(v, tparams.RawAuxTheta, _t), cfg, tparams.project_raw)
    ref = jparams.momentum_update(mk(p, jparams.RawAuxTheta, _j), mk(g, jparams.RawAuxTheta, _j),
                                  mk(v, jparams.RawAuxTheta, _j), j_cfg, jparams.project_raw)
    for a, b in zip(port[0] + port[1], tuple(ref[0]) + tuple(ref[1])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)
