"""The port's associative-scan Riccati (tube_mpc_tpu_torch/solvers/pscan.py) against the
JAX package's (tube_mpc_tpu/solvers/pscan.py), in f64 on the CPU.

- Against JAX: inv_small at n = 1-5 and 7; riccati_value_sweep (elem_reg 0 and 1e-9),
  parallel_backward_pass and parallel_affine_rollout at tests/test_pscan.py's shapes plus
  (5, 1, 30) and (7, 2, 50), at rtol 1e-10, atol 1e-12. Each shape's JAX reference is
  computed once (a module fixture): the four JAX calls jitted as one function, traced once
  and applied to each of the lanes (a vmap over them would compute the same, but triples
  the tracing of the 4x4 cofactor inverse's thousands of operations).
- The scan helper against a sequential fold, at lengths that take both parities at every
  level of its recursion, and bitwise against jax.lax.associative_scan on elementwise
  elements (the same grouping of the same products).
- The port's scan against the port's own sequential sweep and against the exact-elimination
  recursion, at tests/test_pscan.py's tolerances (the content of its three slow tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tube_mpc_tpu.solvers import pscan as J

from tube_mpc_tpu_torch.solvers import pscan as P
from tube_mpc_tpu_torch.solvers.ilqr import _backward_pass

from torch_xla_cases import close, t64

RTOL, ATOL = 1e-10, 1e-12
LANES = 3
SHAPES = [(4, 2, 17), (4, 1, 32), (6, 2, 50), (3, 3, 8), (5, 1, 30), (7, 2, 50)]
SCAN_LENGTHS = [1, 2, 3, 4, 5, 7, 8, 17, 32, 50]
GROUPING_LENGTHS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 17]   # eager JAX: ~2 s at N=50


def random_lq(seed, lanes, N, n, m):
    """tests/test_pscan.py's random LQ problem, drawn with numpy over `lanes` lanes."""
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.1 * rng.standard_normal((lanes, N, n, n))
    B = 0.5 * rng.standard_normal((lanes, N, n, m))
    lx = rng.standard_normal((lanes, N, n))
    lu = rng.standard_normal((lanes, N, m))

    def spd(sz, scale):
        W = rng.standard_normal((lanes, N, sz, sz))
        return scale * (W @ np.swapaxes(W, -1, -2)) + np.eye(sz)

    lxx = spd(n, 0.1)
    luu = spd(m, 0.1)
    lux = 0.1 * rng.standard_normal((lanes, N, m, n))
    phi_x = rng.standard_normal((lanes, n))
    W = rng.standard_normal((lanes, n, n))
    phi_xx = 0.5 * (W @ np.swapaxes(W, -1, -2)) + np.eye(n)
    return A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx


def random_affine(seed, lanes, N, n):
    rng = np.random.default_rng(seed)
    F = np.eye(n) + 0.05 * rng.standard_normal((lanes, N, n, n))
    return F, rng.standard_normal((lanes, N, n)), rng.standard_normal((lanes, n))


ELEM_REGS = (0.0, 1e-9)


def _jax_refs(data, F, c, x0):
    """The JAX functions on one lane."""
    return (*(J.riccati_value_sweep(*data, elem_reg=reg) for reg in ELEM_REGS),
            J.parallel_backward_pass(*data, 1e-9),
            J.parallel_affine_rollout(F, c, x0))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "n%d_m%d_N%d" % s)
def case(request):
    n, m, N = request.param
    data = random_lq(10 + N + n, LANES, N, n, m)
    F, c, x0 = random_affine(20 + N + n, LANES, N, n)
    refs = jax.jit(_jax_refs)
    per_lane = [refs([jnp.asarray(a[i]) for a in data], F[i], c[i], x0[i]) for i in range(LANES)]
    ref = jax.tree.map(lambda *lanes: np.stack([np.asarray(v) for v in lanes]), *per_lane)
    return dict(data=[t64(a) for a in data], affine=(t64(F), t64(c), t64(x0)), ref=ref)


@pytest.mark.parametrize("elem_reg", ELEM_REGS)
def test_value_sweep_matches_jax(case, elem_reg):
    V_x, V_xx = P.riccati_value_sweep(*case["data"], elem_reg=elem_reg)
    jV_x, jV_xx = case["ref"][ELEM_REGS.index(elem_reg)]
    assert V_x.shape == jV_x.shape and V_xx.shape == jV_xx.shape
    close(V_x, jV_x, RTOL, ATOL, "V_x")
    close(V_xx, jV_xx, RTOL, ATOL, "V_xx")


def test_parallel_backward_pass_matches_jax(case):
    K, kff = P.parallel_backward_pass(*case["data"], 1e-9)
    jK, jkff = case["ref"][2]
    assert K.shape == jK.shape and kff.shape == jkff.shape
    close(K, jK, RTOL, ATOL, "K")
    close(kff, jkff, RTOL, ATOL, "kff")


def test_parallel_affine_rollout_matches_jax(case):
    X = P.parallel_affine_rollout(*case["affine"])
    assert X.shape == case["ref"][3].shape
    close(X, case["ref"][3], RTOL, ATOL)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_inv_small_matches_jax(n):
    rng = np.random.default_rng(n)
    W = rng.standard_normal((LANES, 6, n, n))
    A = np.eye(n) + 0.3 * W                       # batched over two leading dims
    got = P.inv_small(t64(A))
    close(got, jax.jit(J.inv_small)(jnp.asarray(A)), RTOL, ATOL)
    close(got @ t64(A), np.broadcast_to(np.eye(n), A.shape), 1e-12, 1e-12, "A^-1 A")


def test_inv_small_of_a_singular_matrix_is_not_finite_as_in_jax():
    """n > 4 is a solve without a host check: a singular A gives non-finite values, as
    jnp.linalg.solve's do, and no error."""
    A = np.ones((2, 5, 5))
    assert not np.all(np.isfinite(np.asarray(J.inv_small(jnp.asarray(A)))))
    assert not torch.isfinite(P.inv_small(t64(A))).all()


def _affine_fold(F, c):
    """Inclusive prefix compositions by a sequential fold, along dim 1."""
    outF, outc = [F[:, 0]], [c[:, 0]]
    for k in range(1, F.shape[1]):
        outF.append(F[:, k] @ outF[-1])
        outc.append((F[:, k] @ outc[-1][..., None])[..., 0] + c[:, k])
    return torch.stack(outF, dim=1), torch.stack(outc, dim=1)


@pytest.mark.parametrize("N", SCAN_LENGTHS)
def test_scan_matches_a_sequential_fold(N):
    F, c, _ = random_affine(N, LANES, N, 3)
    got = P._associative_scan(P._affine_combine, P.AffineElement(t64(F), t64(c)), dim=1)
    refF, refc = _affine_fold(t64(F), t64(c))
    close(got.F, refF.numpy(), 1e-12, 1e-13, "F")
    close(got.c, refc.numpy(), 1e-12, 1e-13, "c")


@pytest.mark.parametrize("N", GROUPING_LENGTHS)
def test_scan_groups_as_jax_does(N):
    """Scalar affine maps (elementwise products and sums, each rounded once in either
    package): the same grouping gives the same bits as jax.lax.associative_scan's."""
    rng = np.random.default_rng(100 + N)
    f, c = 1.0 + 0.3 * rng.standard_normal((LANES, N)), rng.standard_normal((LANES, N))
    combine = lambda e1, e2: type(e1)(e2[0] * e1[0], e2[0] * e1[1] + e2[1])
    got = P._associative_scan(combine, P.AffineElement(t64(f), t64(c)), dim=1)
    # eagerly, one operation at a time: a jitted scan may fuse a product and a sum
    ref = jax.lax.associative_scan(combine, P.AffineElement(jnp.asarray(f), jnp.asarray(c)),
                                   axis=1)
    assert np.array_equal(got.F.numpy(), np.asarray(ref.F))
    assert np.array_equal(got.c.numpy(), np.asarray(ref.c))


# ---- the port's scan against the port's own sequential forms (tests/test_pscan.py) -----

@pytest.mark.parametrize("n,m,N", [(4, 2, 17), (4, 1, 32), (6, 2, 50), (3, 3, 8)])
def test_parallel_gains_match_the_sequential_sweep(n, m, N):
    data = [t64(a) for a in random_lq(0, LANES, N, n, m)]
    reg = 1e-9  # split and exact updates coincide to O(reg)
    K_s, k_s = _backward_pass(*data, reg)
    K_p, k_p = P.parallel_backward_pass(*data, reg)
    close(K_p, K_s.numpy(), 1e-7, 1e-8, "K")
    close(k_p, k_s.numpy(), 1e-7, 1e-8, "kff")


def exact_recursion(A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx, reg=0.0):
    """tests/test_pscan.py's exact-elimination value recursion, over the lanes at once, its
    Q_uu solve regularised by reg: (V_x [B, N+1, n], V_xx [B, N+1, n, n], K [B, N, m, n])."""
    mT = lambda M: M.transpose(-1, -2)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    V_x, V_xx = phi_x, phi_xx
    seq_x, seq_xx, gains = [V_x], [V_xx], []
    for k in reversed(range(A.shape[1])):
        Q_x = lx[:, k] + mv(mT(A[:, k]), V_x)
        Q_u = lu[:, k] + mv(mT(B[:, k]), V_x)
        Q_xx = lxx[:, k] + mT(A[:, k]) @ V_xx @ A[:, k]
        Q_ux = lux[:, k] + mT(B[:, k]) @ V_xx @ A[:, k]
        Q_uu = luu[:, k] + mT(B[:, k]) @ V_xx @ B[:, k]
        Kk = -torch.linalg.solve(Q_uu + reg * torch.eye(Q_uu.shape[-1], dtype=Q_uu.dtype), Q_ux)
        V_x = Q_x + mv(mT(Kk), Q_u)
        V_xx = Q_xx + mT(Kk) @ Q_ux
        seq_x.insert(0, V_x)
        seq_xx.insert(0, V_xx)
        gains.insert(0, Kk)
    return torch.stack(seq_x, dim=1), torch.stack(seq_xx, dim=1), torch.stack(gains, dim=1)


def test_value_sweep_matches_the_exact_recursion():
    data = [t64(a) for a in random_lq(1, LANES, 21, 4, 2)]
    V_x_p, V_xx_p = P.riccati_value_sweep(*data, elem_reg=0.0)
    V_x, V_xx, _ = exact_recursion(*data)
    close(V_x_p, V_x.numpy(), 1e-7, 1e-9, "V_x")
    close(V_xx_p, V_xx.numpy(), 1e-7, 1e-9, "V_xx")


@pytest.mark.parametrize("N", [256, 1024])
def test_parallel_gains_match_the_exact_recursion_at_long_horizons(N):
    """Past a few hundred steps of these problems the JAX package's sequential sweep (the
    split value update) parts from the exact elimination, by far more than O(reg); the
    port's keeps V_xx symmetric and does not (tests/test_torch_riccati_symmetry.py). The
    scan's gains stay with the exact recursion's, at tests/test_pscan.py's tolerance of
    the gains."""
    data = [t64(a) for a in random_lq(3, LANES, N, 4, 2)]
    K_p, _ = P.parallel_backward_pass(*data, 1e-9)
    _, _, K_e = exact_recursion(*data, reg=1e-9)
    close(K_p, K_e.numpy(), 1e-7, 1e-8, "K")


def test_parallel_affine_rollout_matches_the_loop():
    n, N = 5, 33
    F, c, _ = random_affine(2, LANES, N, n)
    F, c = t64(F), t64(c)
    x0 = torch.arange(n, dtype=torch.float64).expand(LANES, n)
    X = P.parallel_affine_rollout(F, c, x0)
    x = x0
    for k in range(N):
        x = (F[:, k] @ x[..., None])[..., 0] + c[:, k]
        close(X[:, k + 1], x.numpy(), 1e-9, 1e-10, f"step {k + 1}")


def test_reduced_precision_products_are_refused():
    data = [t64(a) for a in random_lq(0, 1, 4, 3, 1)]
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for call in (lambda: P.parallel_backward_pass(*data, 1e-9),
                     lambda: P.riccati_value_sweep(*data),
                     lambda: P.parallel_affine_rollout(data[0], data[2], data[7])):
            with pytest.raises(RuntimeError, match="matmul_precision"):
                call()
    finally:
        torch.set_float32_matmul_precision(before)
