"""The three families' component forms, feature-last systems and registry against
the JAX package's, in f64 on the CPU.

- The hand-written tangent maps of f and h (ops/lanes.py) against torch.func.jvp of
  the same values, and their Jacobian rows against JAX's jac_rows (jax.jvp), which
  they follow term by term: equal to rounding.
- The feature-last step and h (systems/*.py) against the JAX systems'.
- registry.build_components and default_x0 against the JAX registry's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams
from tube_mpc_tpu.ops.lanes import augmented_step_fn as j_augmented_step_fn
from tube_mpc_tpu.ops.lanes import grad_rows as j_grad_rows
from tube_mpc_tpu.ops.lanes import jac_rows as j_jac_rows
from tube_mpc_tpu.systems import registry as j_registry

from tube_mpc_tpu_torch.ops.dbas import BarrierParams
from tube_mpc_tpu_torch.ops.lanes import augmented_lin_fn, jac_rows
from tube_mpc_tpu_torch.systems import registry

from torch_family_cases import FAMILIES, jax_family, problems, t64

F64 = jnp.float64
B = 7


def _point(name, seed):
    """Component rows (xs, us) of B random states and controls of family ``name``,
    some controls past their bounds, some cart positions past the track limit."""
    pb, _, s = problems(name)
    rng = np.random.default_rng(seed)
    x = np.asarray(s.x0)[None] + rng.normal(size=(B, pb.n)) * np.r_[3.0, 3.0, np.ones(pb.n - 2)]
    lo, hi = np.asarray(pb.u_min), np.asarray(pb.u_max)
    u = rng.uniform(lo - 0.5 * (hi - lo), hi + 0.5 * (hi - lo), size=(B, pb.m))
    return x, u


def _rows(a):
    return tuple(t64(a[:, i]) for i in range(a.shape[1]))


def _jrows(a):
    return tuple(jnp.asarray(a[:, i], dtype=F64) for i in range(a.shape[1]))


@pytest.mark.parametrize("name", FAMILIES)
def test_step_tangent_matches_torch_jvp(name):
    """f_lin's tangent along a random direction against torch.func.jvp of its value."""
    pb, _, s = problems(name)
    x, u = _point(name, 1)
    rng = np.random.default_rng(2)
    dx, du = rng.normal(size=x.shape), rng.normal(size=u.shape)
    f_lin = s.sys_c.f_lin
    _, tangent = f_lin(_rows(x), _rows(u))
    mine = torch.stack(tangent(_rows(dx), _rows(du)))
    _, ref = torch.func.jvp(lambda xs, us: f_lin(xs, us)[0], (_rows(x), _rows(u)),
                            (_rows(dx), _rows(du)))
    ref = torch.stack(ref)
    np.testing.assert_allclose(mine.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-14 * float(ref.abs().max()))


@pytest.mark.parametrize("name", FAMILIES)
def test_h_tangent_matches_torch_jvp(name):
    pb, _, s = problems(name)
    x, _ = _point(name, 3)
    dx = np.random.default_rng(4).normal(size=x.shape)
    h_lin = s.sys_c.h_lin
    value, tangent = h_lin(_rows(x))
    _, ref = torch.func.jvp(lambda xs: h_lin(xs)[0], (_rows(x),), (_rows(dx),))
    np.testing.assert_allclose(tangent(_rows(dx)).numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-14 * float(ref.abs().max()))


@pytest.mark.parametrize("name", FAMILIES)
def test_step_and_h_rows_match_jax(name):
    """The values of f and h, f's Jacobian rows (basis tangents) and h's gradient rows
    against the JAX component form's jax.jvp."""
    pb, _, s = problems(name)
    _, _, j_sys_c, _ = jax_family(name, N=6, H=3)
    x, u = _point(name, 5)
    value, tangent = s.sys_c.f_lin(_rows(x), _rows(u))
    np.testing.assert_allclose(torch.stack(value).numpy(),
                               np.stack(j_sys_c.f(_jrows(x), _jrows(u))), rtol=1e-15, atol=0)
    A, Bm = jac_rows(tangent, pb.n, pb.m, t64(x[:, 0]))
    jA, jB = j_jac_rows(j_sys_c.f, _jrows(x), _jrows(u))
    np.testing.assert_allclose(np.array([[a.numpy() for a in r] for r in A]), np.array(jA),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(np.array([[b.numpy() for b in r] for r in Bm]), np.array(jB),
                               rtol=1e-14, atol=1e-15)
    h, h_tan = s.sys_c.h_lin(_rows(x))
    np.testing.assert_allclose(h.numpy(), np.asarray(j_sys_c.h(_jrows(x))), rtol=1e-15, atol=0)
    grads = [h_tan(tuple(t64(np.full(B, float(i == j))) for i in range(pb.n))).numpy()
             for j in range(pb.n)]
    np.testing.assert_allclose(np.array(grads), np.array(j_grad_rows(j_sys_c.h, _jrows(x))),
                               rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("name", FAMILIES)
def test_augmented_jacobian_rows_match_jax(name):
    """f̂'s Jacobian rows (the port's augmented tangent map) against jac_rows of the JAX
    augmented step, with per-lane barrier parameters."""
    pb, _, s = problems(name)
    x, u = _point(name, 6)
    b = np.random.default_rng(7).uniform(0.1, 2.0, size=(B, 1))
    xh = np.concatenate([x, b], axis=1)
    alpha, gamma, tight = (np.linspace(0.0, v, B) for v in (0.2, 0.5, 0.05))
    bp = BarrierParams(t64(alpha), t64(gamma), t64(tight))
    jbp = JBarrierParams(*(jnp.asarray(v, dtype=F64) for v in (alpha, gamma, tight)))
    _, tangent = augmented_lin_fn(s.sys_c, eps=1e-4)(_rows(xh), _rows(u), bp)
    A, Bm = jac_rows(tangent, pb.n_hat, pb.m, t64(x[:, 0]))
    jf = j_augmented_step_fn(jax_family(name, N=6, H=3)[2], eps=1e-4)
    jA, jB = j_jac_rows(lambda xx, uu: jf(xx, uu, jbp), _jrows(xh), _jrows(u))
    for mine, ref in ((A, jA), (Bm, jB)):
        mine = np.array([[c.numpy() for c in r] for r in mine])
        ref = np.array(ref)
        np.testing.assert_allclose(mine, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())


@pytest.mark.parametrize("name", FAMILIES)
def test_feature_last_system_matches_jax(name):
    """registry.build's step, h, bounds, target and disturbance bounds against the JAX
    registry's, from the same YAML numbers."""
    built = jax_family(name, N=6, H=3)[0]
    _, _, s = problems(name)
    js, ps = built.system, s.system
    assert (ps.name, ps.nx, ps.nu, ps.angle_dims) == (js.name, js.nx, js.nu, tuple(js.angle_dims))
    for f in ("u_min", "u_max", "x_target", "w_low", "w_high"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)), f)
    x, u = _point(name, 8)
    np.testing.assert_allclose(ps.f(t64(x), t64(u)).numpy(),
                               np.asarray(js.f(jnp.asarray(x), jnp.asarray(u))),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(ps.h(t64(x)).numpy(), np.asarray(js.h(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", FAMILIES + ("dubins",))
def test_registry_components_and_default_x0(name):
    kw = dict(dt=0.02, control_bounds={"a_max": 3.0, "t_max": 6.0, "f_max": 15.0, "v_max": 4.0},
              obstacles=None if name == "cartpole" else [dict(center=[1.0, 2.0], radius=0.5)],
              aggregation="smoothmin", beta=10.0, extra={"x_lim": 1.5})
    mine, ref = registry.build_components(name, **kw), j_registry.build_components(name, **kw)
    assert (mine.n, mine.m, mine.u_min, mine.u_max) == (ref.n, ref.m, ref.u_min, ref.u_max)
    assert mine.spec.family == name and mine.spec.dt == 0.02
    if name == "cartpole":
        assert mine.spec.x_lim == 1.5 and mine.spec.centers == ()
    else:
        assert mine.spec.centers == ((1.0, 2.0),) and mine.spec.beta == 10.0
    np.testing.assert_array_equal(
        registry.default_x0(name, ref.n, device="cpu", dtype=torch.float64).numpy(),
        np.asarray(j_registry.default_x0(name, ref.n, F64)))
    with pytest.raises(ValueError, match="No component form"):
        registry.build_components("unicycle", **kw)
