"""Parallel-scan (associative) Riccati: the O(log N)-depth backward pass and δ-rollout
(port of tube_mpc_tpu/solvers/pscan.py, lanes first: every tensor is [B, N, ...]).

The sequential Riccati sweep (solvers/ilqr.py::_backward_pass) is O(N) deep: one small
step after another. This module writes the LQ backward pass as an associative
composition of span elements, so that a scan evaluates it in O(log N) levels of
batched operations over the whole horizon. It is an opt-in
(``ILQRConfig.horizon_parallel``), for long horizons and small batches.

Formulation (parallel LQT algebra, cf. Sarkka & Garcia-Fernandez, "Temporal
parallelization of dynamic programming", from the Pontryagin two-point boundary-value
form with general cross terms). A span [i, j] of the LQ problem, with all controls
inside eliminated by exact minimisation, gives the linear relations

    x_j      = A x_i + b - C lam_j
    lam_i    = J x_i - eta + A^T lam_j

where lam is the costate. One step k (dynamics dx+ = A_k dx + B_k du, stage cost
lx.dx + lu.du + 1/2 dx.lxx.dx + 1/2 du.luu.du + du.lux.dx) gives, with H = luu^{-1}:

    A_e = A_k - B_k H lux          C_e = B_k H B_k^T
    J_e = lxx - lux^T H lux        b_e = -B_k H lu
    eta_e = lux^T H lu - lx

The terminal condition lam_N = phi_xx x_N + phi_x is the last element (A=0, b=0, C=0,
J=phi_xx, eta=-phi_x). Composing span1=[i,m] with span2=[m,j] (eliminating x_m, lam_m;
M = (I + C1 J2)^{-1}):

    A = A2 M A1
    b = A2 M (b1 + C1 eta2) + b2
    C = A2 M C1 A2^T + C2
    J = J1 + A1^T J2 M A1                      (J2 M = M^T J2, push-through)
    eta = eta1 + A1^T M^T (eta2 - J2 b1)

This is associative. The suffix compositions E_k = e_k o ... o e_N give the value
function at every k at once: V_xx_k = J(E_k), V_x_k = -eta(E_k). The gains are then
horizon-parallel functions of (step data, V_{k+1}), with the sequential pass's
regularised solve.

Semantics note: the sequential pass propagates the value with the SPLIT update (K from
the regularised Q_uu solve, the quadratic forms with the unregularised Q_uu); the exact
elimination here differs from it by O(reg). The gains returned use the same regularised
solve, so for reg -> 0 the two backward passes coincide. Like the JAX module, the scan
keeps V unscaled: it has no counterpart of the sequential pass's rescaled carry.

The affine closed-loop δ-rollout x_{k+1} = F_k x_k + c_k is likewise an associative
composition of affine maps; ``parallel_affine_rollout`` evaluates it in O(log N) levels.

The scan (``_associative_scan``) follows jax.lax.associative_scan's recursion step for
step, so the products are formed in the same grouping as the JAX package's. Every level
is a few batched tensor operations over the lanes and the horizon; nothing here loops
over k, and no operation reads a value back to the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch
from torch import Tensor

from ..ops.linalg import solve_spd
from .ilqr import check_precision


class SpanElement(NamedTuple):
    """Conditional-value-function span: x_j = A x_i + b - C lam_j;
    lam_i = J x_i - eta + A^T lam_j."""

    A: Tensor    # [..., n, n]
    b: Tensor    # [..., n]
    C: Tensor    # [..., n, n]
    J: Tensor    # [..., n, n]
    eta: Tensor  # [..., n]


class AffineElement(NamedTuple):
    """x_{k+1} = F x_k + c, composed associatively."""

    F: Tensor  # [..., n, n]
    c: Tensor  # [..., n]


def _mT(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """M @ v over leading dims: M [..., a, b], v [..., b] -> [..., a]."""
    return (M @ v[..., None])[..., 0]


def _eye_like(A: Tensor) -> Tensor:
    """A contiguous identity of A's shape [..., n, n] (a batched solve's right-hand side)."""
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).contiguous()


def inv_small(A: Tensor) -> Tensor:
    """The inverse of A [..., n, n]: the adjugate (cofactor) form for n <= 4, term for
    term as the JAX module's; for n > 4 ``torch.linalg.solve_ex(A, I)``, whose result on
    a singular A is not finite (as jnp.linalg.solve's) and which checks nothing on the
    host."""
    n = A.shape[-1]
    if n > 4:
        return torch.linalg.solve_ex(A, _eye_like(A))[0]
    a = lambda i, j: A[..., i, j]
    if n == 1:
        return 1.0 / A
    if n == 2:
        det = a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)
        adj = torch.stack([
            torch.stack([a(1, 1), -a(0, 1)], dim=-1),
            torch.stack([-a(1, 0), a(0, 0)], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    if n == 3:
        c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
        c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
        c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
        det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
        adj = torch.stack([
            torch.stack([c00,
                         a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2),
                         a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)], dim=-1),
            torch.stack([c01,
                         a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0),
                         a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)], dim=-1),
            torch.stack([c02,
                         a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1),
                         a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    # n == 4: Laplace expansion by 2x2 complementary minors
    s0 = a(0, 0) * a(1, 1) - a(1, 0) * a(0, 1)
    s1 = a(0, 0) * a(1, 2) - a(1, 0) * a(0, 2)
    s2 = a(0, 0) * a(1, 3) - a(1, 0) * a(0, 3)
    s3 = a(0, 1) * a(1, 2) - a(1, 1) * a(0, 2)
    s4 = a(0, 1) * a(1, 3) - a(1, 1) * a(0, 3)
    s5 = a(0, 2) * a(1, 3) - a(1, 2) * a(0, 3)
    c5 = a(2, 2) * a(3, 3) - a(3, 2) * a(2, 3)
    c4 = a(2, 1) * a(3, 3) - a(3, 1) * a(2, 3)
    c3 = a(2, 1) * a(3, 2) - a(3, 1) * a(2, 2)
    c2 = a(2, 0) * a(3, 3) - a(3, 0) * a(2, 3)
    c1 = a(2, 0) * a(3, 2) - a(3, 0) * a(2, 2)
    c0 = a(2, 0) * a(3, 1) - a(3, 0) * a(2, 1)
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    rows = [
        [a(1, 1) * c5 - a(1, 2) * c4 + a(1, 3) * c3,
         -a(0, 1) * c5 + a(0, 2) * c4 - a(0, 3) * c3,
         a(3, 1) * s5 - a(3, 2) * s4 + a(3, 3) * s3,
         -a(2, 1) * s5 + a(2, 2) * s4 - a(2, 3) * s3],
        [-a(1, 0) * c5 + a(1, 2) * c2 - a(1, 3) * c1,
         a(0, 0) * c5 - a(0, 2) * c2 + a(0, 3) * c1,
         -a(3, 0) * s5 + a(3, 2) * s2 - a(3, 3) * s1,
         a(2, 0) * s5 - a(2, 2) * s2 + a(2, 3) * s1],
        [a(1, 0) * c4 - a(1, 1) * c2 + a(1, 3) * c0,
         -a(0, 0) * c4 + a(0, 1) * c2 - a(0, 3) * c0,
         a(3, 0) * s4 - a(3, 1) * s2 + a(3, 3) * s0,
         -a(2, 0) * s4 + a(2, 1) * s2 - a(2, 3) * s0],
        [-a(1, 0) * c3 + a(1, 1) * c1 - a(1, 2) * c0,
         a(0, 0) * c3 - a(0, 1) * c1 + a(0, 2) * c0,
         -a(3, 0) * s3 + a(3, 1) * s1 - a(3, 2) * s0,
         a(2, 0) * s3 - a(2, 1) * s1 + a(2, 2) * s0],
    ]
    adj = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)
    return adj / det[..., None, None]


def _slices(elems: Sequence[Tensor], dim: int, start, stop, step=None):
    at = (slice(None),) * dim + (slice(start, stop, step),)
    return [e[at] for e in elems]


def _interleave(a: Tensor, b: Tensor, dim: int) -> Tensor:
    """a at the even and b at the odd positions along dim (a as long as b, or one longer)."""
    shape = list(a.shape)
    shape[dim] = a.shape[dim] + b.shape[dim]
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def _associative_scan(combine: Callable, elems: NamedTuple, dim: int) -> NamedTuple:
    """The inclusive scan of `elems` (a NamedTuple of tensors of one length along dim)
    under the associative `combine`, by jax.lax.associative_scan's recursion: combine the
    adjacent pairs, scan those, combine the odd results with the even elements, prepend
    the first element and interleave."""
    kind = type(elems)
    comb = lambda a, b: list(combine(kind(*a), kind(*b)))

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        reduced = comb(_slices(xs, dim, 0, -1, 2), _slices(xs, dim, 1, None, 2))
        odd = scan(reduced)
        if n % 2 == 0:
            even = comb(_slices(odd, dim, 0, -1), _slices(xs, dim, 2, None, 2))
        else:
            even = comb(odd, _slices(xs, dim, 2, None, 2))
        even = [torch.cat([x, e], dim=dim) for x, e in zip(_slices(xs, dim, 0, 1), even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    return kind(*scan(list(elems)))


def _combine_chrono(e1: SpanElement, e2: SpanElement) -> SpanElement:
    """Compose span e1=[i,m] with the LATER span e2=[m,j]."""
    n = e1.A.shape[-1]
    eye = torch.eye(n, dtype=e1.A.dtype, device=e1.A.device)
    M = inv_small(eye + e1.C @ e2.J)  # (I + C1 J2)^{-1}
    A2M = e2.A @ M
    A = A2M @ e1.A
    C1_eta2 = _mv(e1.C, e2.eta)
    b = _mv(A2M, e1.b + C1_eta2) + e2.b
    C = A2M @ e1.C @ _mT(e2.A) + e2.C
    J2M = e2.J @ M  # equals M^T J2
    J = e1.J + _mT(e1.A) @ J2M @ e1.A
    eta = e1.eta + _mv(_mT(M @ e1.A), e2.eta - _mv(e2.J, e1.b))
    return SpanElement(A=A, b=b, C=C, J=J, eta=eta)


def _combine_rev(later: SpanElement, earlier: SpanElement) -> SpanElement:
    """Combiner for a time-REVERSED element sequence (suffix products)."""
    return _combine_chrono(earlier, later)


def _eliminate(B, lu, luu, lux, elem_reg: float):
    """(luu_r^{-1} lu, luu_r^{-1} lux, B luu_r^{-1}) with luu_r = luu + elem_reg·I: one
    solve for the three right-hand sides, since every column's operations are its own."""
    nu, n = B.shape[-1], B.shape[-2]
    luu_r = luu + elem_reg * torch.eye(nu, dtype=B.dtype, device=B.device)
    X = solve_spd(luu_r, torch.cat([lu[..., None], lux, _eye_like(luu_r)], dim=-1))
    H_lu, H_lux, inv_luu = X[..., 0], X[..., 1:1 + n], X[..., 1 + n:]
    BH = B @ inv_luu                      # [B, N, n, nu]
    return H_lu, H_lux, BH


def riccati_value_sweep(
    A: Tensor, B: Tensor,
    lx: Tensor, lu: Tensor, lxx: Tensor, luu: Tensor, lux: Tensor,
    phi_x: Tensor, phi_xx: Tensor,
    *, elem_reg: float = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Every value-function pair, V_x [B, N+1, n] and V_xx [B, N+1, n, n], in O(log N)
    levels (A [B, N, n, n], B [B, N, n, nu], ..., phi_x [B, n], phi_xx [B, n, n]).

    elem_reg is added to luu for the exact-elimination elements (an invertibility guard);
    it plays the role of the sequential pass's Q_uu regulariser up to O(reg)."""
    check_precision()
    H_lu, H_lux, BH = _eliminate(B, lu, luu, lux, elem_reg)
    A_e = A - B @ H_lux                   # [B, N, n, n]
    C_e = BH @ _mT(B)                     # [B, N, n, n]
    J_e = lxx - _mT(lux) @ H_lux          # [B, N, n, n]
    b_e = -_mv(BH, lu)                    # [B, N, n]
    eta_e = _mv(_mT(lux), H_lu) - lx

    lanes, n = A.shape[0], A.shape[-1]
    zero_m = torch.zeros((lanes, 1, n, n), dtype=A.dtype, device=A.device)
    zero_v = torch.zeros((lanes, 1, n), dtype=A.dtype, device=A.device)
    elems = SpanElement(
        A=torch.cat([A_e, zero_m], dim=1),
        b=torch.cat([b_e, zero_v], dim=1),
        C=torch.cat([C_e, zero_m], dim=1),
        J=torch.cat([J_e, phi_xx[:, None]], dim=1),
        eta=torch.cat([eta_e, -phi_x[:, None]], dim=1),
    )
    # The suffix products E_k = e_k o ... o e_N by a prefix scan over the reversed sequence.
    rev = SpanElement(*(torch.flip(t, dims=(1,)) for t in elems))
    suf_rev = _associative_scan(_combine_rev, rev, dim=1)
    suf = SpanElement(*(torch.flip(t, dims=(1,)) for t in suf_rev))
    return -suf.eta, suf.J  # V_x [B, N+1, n], V_xx [B, N+1, n, n]


def parallel_backward_pass(
    A: Tensor, B: Tensor,
    lx: Tensor, lu: Tensor, lxx: Tensor, luu: Tensor, lux: Tensor,
    phi_x: Tensor, phi_xx: Tensor, reg: float,
) -> Tuple[Tensor, Tensor]:
    """A drop-in for the sequential ``_backward_pass``: the gains (K [B, N, nu, n],
    kff [B, N, nu]) with its regularised solve, in O(log N) levels."""
    V_x, V_xx = riccati_value_sweep(
        A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx, elem_reg=reg
    )
    Vp_x, Vp_xx = V_x[:, 1:], V_xx[:, 1:]  # V_{k+1} for each k, horizon-parallel
    nu = B.shape[-1]
    eye = torch.eye(nu, dtype=B.dtype, device=B.device)
    Bt = _mT(B)
    Q_u = lu + _mv(Bt, Vp_x)
    Q_ux = lux + Bt @ Vp_xx @ A
    Q_uu = luu + Bt @ Vp_xx @ B
    Q_uu_reg = Q_uu + reg * eye
    # one solve for both right-hand sides: every column's operations are its own
    Kk = -solve_spd(Q_uu_reg, torch.cat([Q_ux, Q_u[..., None]], dim=-1))
    return Kk[..., :-1], Kk[..., -1]


def _affine_combine(e1: AffineElement, e2: AffineElement) -> AffineElement:
    """e2 AFTER e1 (chronological prefix products)."""
    return AffineElement(F=e2.F @ e1.F, c=_mv(e2.F, e1.c) + e2.c)


def parallel_affine_rollout(F: Tensor, c: Tensor, x0: Tensor) -> Tensor:
    """X [B, N+1, n] with x_{k+1} = F_k x_k + c_k (F [B, N, n, n], c [B, N, n],
    x0 [B, n]), in O(log N) levels.

    The closed-loop δ-rollout of the sensitivity sweep has exactly this form, with
    F_k = A_k + B_k K_k and c_k = B_k kff_k (masked)."""
    check_precision()
    pre = _associative_scan(_affine_combine, AffineElement(F=F, c=c), dim=1)
    X_tail = _mv(pre.F, x0[:, None]) + pre.c
    return torch.cat([x0[:, None], X_tail], dim=1)
