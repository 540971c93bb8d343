"""The lane engine's other branches in component form, against jax.jvp of the JAX
package's forms, in f64 on the CPU: the exact-min obstacle aggregation
(ops/lanes.py::min_h_lin) and the log barrier (ops/barrier.py::barrier_lin,
barrier_dalpha, and the rows of f̂ in ops/lanes.py::augmented_lin_fn).

The port writes every tangent by hand, term by term as JAX's differentiation rules
form it, so the two agree bitwise where no exp or log enters (and to a last bit where
one does): lax.min's balanced-equality weights on a tie (1/2 to each side, not the
gradient of an argmin), max's weight 0 below the barrier's eps (where the analytic
derivative d_log_barrier is -1/eps) and 1/2 on zeta == eps, and the symbolic zero of
jax.jvp in alpha, which the port's row of ∂f̂/∂α keeps as an exact 0 also where gamma
is not finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.ops import lanes as jl
from tube_mpc_tpu.ops.barrier import barrier_value as j_barrier_value
from tube_mpc_tpu.ops.barrier import d_log_barrier as j_d_log_barrier
from tube_mpc_tpu.ops.dbas import BarrierParams as JBarrierParams

from tube_mpc_tpu_torch.ops import lanes
from tube_mpc_tpu_torch.ops.barrier import barrier_dalpha, barrier_lin
from tube_mpc_tpu_torch.ops.dbas import BarrierParams

F64 = jnp.float64
EPS = 1e-4
# two equal obstacles whose bisector is px = 5, and a third, smaller one
CENTERS, RADII = [(4.0, 5.0), (6.0, 5.0), (5.0, 8.0)], [1.0, 1.0, 0.5]


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def same(port, ref):
    """Bitwise equal, NaN where NaN."""
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def close(port, ref):
    """Equal to rtol 1e-14, NaN where NaN, the same infinities: XLA's exp and log round a
    last bit apart from PyTorch's, and the smooth-min and the barrier take them."""
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=1e-14, atol=0)


def forms(family, aggregation="min"):
    """(the port's component system, the JAX one) of `family` with CENTERS."""
    obs = dict(centers=CENTERS, radii=RADII, aggregation=aggregation, beta=20.0)
    if family == "dubins":
        args = dict(dt=0.1, v_min=-2.0, v_max=2.0, omega_max=1.0, **obs)
        return lanes.dubins_components(**args), jl.dubins_components(**args)
    if family == "double_integrator":
        args = dict(dt=0.1, a_max=3.0, **obs)
        return (lanes.double_integrator_components(**args),
                jl.double_integrator_components(**args))
    args = dict(dt=0.02, **obs)
    return lanes.quadrotor2d_components(**args), jl.quadrotor2d_components(**args)


def points(n, seed=0):
    """[n, B] state rows: random points, points on the bisector px = 5 (a tie of the two
    equal obstacles, at (5, 5) with h = 0, and on the third's edge), and NaN and inf
    positions."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(2.0, 8.0, size=(n, 12))
    x[0, :5] = 5.0
    x[1, :5] = [5.0, 4.0, 6.5, 7.5, 2.0]   # (5, 7.5): h = 0 of the third obstacle
    x[0, 5], x[1, 6], x[0, 7] = np.nan, np.nan, np.inf
    return x


@pytest.mark.parametrize("family", ["dubins", "double_integrator", "quadrotor2d"])
def test_min_h_value_and_tangent_rows_match_jax_jvp(family):
    """min_h_lin's value and its tangent along each basis direction (the rows of ∇h)
    against jax.jvp of the JAX form's h with aggregation 'min', bitwise: on the ties the
    chain's balanced-equality weights, 1/2 to each side."""
    sc, jc = forms(family)
    x = points(sc.n)
    xs, jxs = tuple(t64(r) for r in x), tuple(jnp.asarray(r, dtype=F64) for r in x)
    value, tangent = sc.h_lin(xs)
    same(value, jc.h(jxs))
    for j in range(sc.n):
        basis = [np.ones(x.shape[1]) if i == j else np.zeros(x.shape[1]) for i in range(sc.n)]
        _, ref = jax.jvp(jc.h, (jxs,), (tuple(jnp.asarray(b, dtype=F64) for b in basis),))
        same(tangent(tuple(t64(b) for b in basis)), ref)
    # the ties take half of each side: on the bisector, with both obstacles ahead of the
    # third, d h / d px = (1/2) 2 (5 - 4) + (1/2) 2 (5 - 6) = 0
    dpx = tangent(tuple(t64(np.ones(x.shape[1]) if i == 0 else np.zeros(x.shape[1]))
                        for i in range(sc.n)))
    assert float(dpx[0]) == 0.0 and float(dpx[1]) == 0.0


def test_min_aggregation_is_refused_only_for_single():
    """'single' raises the JAX form's reason; the two ported aggregations build."""
    for agg in ("smoothmin", "min"):
        assert forms("dubins", agg)[0].spec.aggregation == agg
    with pytest.raises(ValueError, match="unsupported aggregation for component form: single"):
        forms("dubins", "single")


# zeta below eps, equal to it, above it, at 0, negative, and not finite
ZETA = np.array([-1.0, 0.0, EPS / 2, EPS, 2 * EPS, 0.3, 5.0, np.nan, np.inf, -np.inf])


def test_log_barrier_tangent_matches_jax_jvp():
    """barrier_lin's value and tangent of the log barrier against jax.jvp of JAX's
    barrier_value: 0 below eps (d_log_barrier gives -1/eps there), half of -1/eps on
    zeta == eps."""
    dz = np.random.default_rng(1).normal(size=ZETA.shape)
    value, tangent = barrier_lin(t64(ZETA), 0.1, barrier_type="log", eps=EPS)
    ref_v, ref_t = jax.jvp(lambda z: j_barrier_value(z, 0.1, barrier_type="log", eps=EPS),
                           (jnp.asarray(ZETA, dtype=F64),), (jnp.asarray(dz, dtype=F64),))
    same(value, ref_v)
    same(tangent(t64(dz)), ref_t)
    one = tangent(torch.ones(len(ZETA), dtype=torch.float64)).numpy()
    assert (one[:3] == 0.0).all() and one[3] == -0.5 / EPS
    assert float(j_d_log_barrier(jnp.asarray(EPS / 2, dtype=F64), eps=EPS)) == -1.0 / EPS


def test_log_barrier_alpha_derivative_matches_jax_jvp():
    """∂B/∂α of the log barrier, jax.jvp in alpha: a symbolic zero, instantiated as 0."""
    alpha = np.full(ZETA.shape, 0.1)
    _, ref = jax.jvp(lambda a: j_barrier_value(jnp.asarray(ZETA, dtype=F64), a,
                                               barrier_type="log", eps=EPS),
                     (jnp.asarray(alpha, dtype=F64),), (jnp.ones(ZETA.shape, dtype=F64),))
    same(barrier_dalpha(t64(ZETA), t64(alpha), barrier_type="log", eps=EPS), ref)


def _fhat_case():
    """Dubins rows x̂ [4, B], u [2, B] and per-lane (alpha, gamma, tight): lanes on the
    bisector px = 5 (at (5, 5), h = 0: with tight = -eps, zeta == eps; with tight 0,
    zeta = 0 < eps), inside an obstacle, far from every obstacle, and with gamma inf and
    NaN."""
    rng = np.random.default_rng(3)
    B = 10
    x = np.stack([rng.uniform(2.0, 8.0, B), rng.uniform(2.0, 8.0, B), rng.uniform(-3, 3, B),
                  rng.uniform(0.0, 2.0, B)])
    x[0, :4], x[1, :4] = 5.0, [5.0, 5.0, 6.0, 3.0]
    x[:2, 4] = [4.0, 5.2]
    u = rng.uniform(-1.0, 1.0, size=(2, B))
    alpha, gamma = rng.uniform(0.0, 0.2, B), rng.uniform(-0.5, 0.5, B)
    tight = np.zeros(B)
    tight[0] = -EPS
    gamma[6], gamma[7] = np.inf, np.nan
    return x, u, (alpha, gamma, tight)


@pytest.mark.parametrize("aggregation,barrier", [("min", "log"), ("smoothmin", "log"),
                                                 ("min", "inverse")])
def test_fhat_rows_match_jac_rows_and_the_sensitivity_jvps(aggregation, barrier):
    """f̂'s Jacobian rows (jac_rows) and params(), ∂f̂/∂(α, γ, tight), against the JAX
    package's jac_rows and the three jax.jvp calls of the generic _sfwd_kernel
    (tube_mpc_tpu/ops/pallas/lane_sensitivity.py:232, 250), to a last bit, on lanes with
    zeta < eps, zeta == eps, ties and non-finite gamma. With the log barrier the α row
    is an exact 0 in both, also where gamma is inf or NaN."""
    sc, jc = forms("dubins", aggregation)
    x, u, bps = _fhat_case()
    xs, us = tuple(t64(r) for r in x), tuple(t64(r) for r in u)
    jxs, jus = (tuple(jnp.asarray(r, dtype=F64) for r in a) for a in (x, u))
    bp = BarrierParams(*(t64(v) for v in bps))
    jbp = JBarrierParams(*(jnp.asarray(v, dtype=F64) for v in bps))
    f_hat_lin = lanes.augmented_lin_fn(sc, barrier_type=barrier, eps=EPS)
    j_f_hat = jl.augmented_step_fn(jc, barrier_type=barrier, eps=EPS)

    value, tangent = f_hat_lin(xs, us, bp)
    for p, r in zip(value, j_f_hat(jxs, jus, jbp)):
        close(p, r)
    A, Bm = lanes.jac_rows(tangent, 4, 2, xs[0])
    jA, jB = jl.jac_rows(lambda xx, uu: j_f_hat(xx, uu, jbp), jxs, jus)
    for i in range(4):
        for j in range(4):
            close(A[i][j], jA[i][j])
        for a in range(2):
            close(Bm[i][a], jB[i][a])

    one = jnp.ones_like(jbp.alpha)
    f_of = lambda a, g, t: j_f_hat(jxs, jus, JBarrierParams(alpha=a, gamma=g, tight=t))
    refs = (jax.jvp(lambda a: f_of(a, jbp.gamma, jbp.tight), (jbp.alpha,), (one,))[1],
            jax.jvp(lambda g: f_of(jbp.alpha, g, jbp.tight), (jbp.gamma,), (one,))[1],
            jax.jvp(lambda t: f_of(jbp.alpha, jbp.gamma, t), (jbp.tight,), (one,))[1])
    for rows, ref in zip(tangent.params(), refs):
        for p, r in zip(rows, ref):
            close(p, r)
    if barrier == "log":
        d_alpha = tangent.params()[0][3]
        assert bool((d_alpha == 0.0).all())
