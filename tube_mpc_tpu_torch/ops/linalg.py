"""Small-matrix linear algebra of the feature-major solvers (port of
tube_mpc_tpu/ops/linalg.py:22-153).

- ``solve_spd``: closed forms for n = 1 and n = 2 (the plain LU of LAPACK's dgesv on
  real f64, the scale-invariant resolve-or-zero adjugate on f32), ``torch.linalg.solve_ex``
  for larger n (no error check: a singular system gives non-finite values, as
  jnp.linalg.solve does, and the line search rejects them).
- ``masked_reduced_solve``: the active-set elimination with static shapes: active rows and
  columns become identity rows and the right-hand side is zeroed there, so X[active] = 0
  and X[free] solves the free-free block.

Every function broadcasts over leading batch dims.
"""
from __future__ import annotations

import torch
from torch import Tensor


def range_guard_default(dtype: torch.dtype) -> bool:
    """Whether intermediates must stay inside the f32 exponent range (~3.4e38).

    True for every dtype narrower than float64, False for float64. The JAX package also
    guards float64 on a TPU, where x64 is emulated with the f32 exponent range; f64 is
    real on the CPU and on the card, so the port has no such branch."""
    return dtype != torch.float64


def _lu_solve_2x2(A: Tensor, B: Tensor) -> Tensor:
    """2x2 LU solve with partial pivoting, LAPACK dgesv's operation sequence: the larger
    first-column entry is the pivot (strict >, the first on a tie), eliminate,
    back-substitute. An exact zero pivot or a non-finite entry gives X = 0."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    swap = torch.abs(c) > torch.abs(a)
    p00 = torch.where(swap, c, a)
    p01 = torch.where(swap, d, b)
    p10 = torch.where(swap, a, c)
    p11 = torch.where(swap, b, d)
    b0 = torch.where(swap[..., None], B[..., 1, :], B[..., 0, :])
    b1 = torch.where(swap[..., None], B[..., 0, :], B[..., 1, :])
    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c) & torch.isfinite(d)
    one = torch.ones_like(p00)
    l = p10 / torch.where(p00 == 0.0, one, p00)
    u11 = p11 - l * p01
    ok = finite & (p00 != 0.0) & (u11 != 0.0)
    u11 = torch.where(u11 == 0.0, one, u11)
    p00 = torch.where(p00 == 0.0, one, p00)
    x1 = (b1 - l[..., None] * b0) / u11[..., None]
    x0 = (b0 - p01[..., None] * x1) / p00[..., None]
    X = torch.stack([x0, x1], dim=-2)
    return torch.where(ok[..., None, None], X, torch.zeros_like(X))


def solve_spd(A: Tensor, B: Tensor) -> Tensor:
    """Solve A X = B for (regularised) SPD A [..., n, n]; B [..., n] or [..., n, m]."""
    n = A.shape[-1]
    vec = B.ndim == A.ndim - 1
    if vec:
        B = B[..., None]
    if n == 1:
        X = B / A[..., :1, :]
    elif n == 2 and not range_guard_default(A.dtype):
        X = _lu_solve_2x2(A, B)
    elif n == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        # Normalised by the largest entry: barrier-inflated Hessians reach ~1e22, whose
        # raw determinant overflows the f32 range.
        s = torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                          torch.maximum(torch.abs(c), torch.abs(d)))
        s = torch.clamp(s, min=1e-30)
        a, b, c, d = a / s, b / s, c / s, d / s
        det = a * d - b * c
        # Resolve-or-zero: a normalised |det| within ~100 ulps of 0 is rounding noise (a
        # barrier-dominated, numerically rank-1 Q_uu); X = 0 keeps the incumbent plan.
        ok = torch.abs(det) > 100.0 * torch.finfo(A.dtype).eps
        safe_det = torch.where(ok, det, torch.ones_like(det))
        inv_det = torch.where(ok, torch.ones_like(det), torch.zeros_like(det)) / (safe_det * s)
        x0 = (d[..., None] * B[..., 0, :] - b[..., None] * B[..., 1, :]) * inv_det[..., None]
        x1 = (-c[..., None] * B[..., 0, :] + a[..., None] * B[..., 1, :]) * inv_det[..., None]
        X = torch.stack([x0, x1], dim=-2)
        X = torch.where(ok[..., None, None], X, torch.zeros_like(X))
    else:
        X = torch.linalg.solve_ex(A, B)[0]
    return X[..., 0] if vec else X


def masked_reduced_solve(A: Tensor, B: Tensor, active: Tensor) -> Tensor:
    """Active-set reduced solve: A [..., n, n], B [..., n] or [..., n, m], active [..., n]
    (True: the dimension sits at a bound, δ = 0). Returns X with X[active] = 0 and X[free]
    solving the free-free subsystem."""
    free = (~active).to(A.dtype)
    A_masked = A * free[..., :, None] * free[..., None, :] + _diag_embed(active.to(A.dtype))
    vec = B.ndim == A.ndim - 1
    Bm = B * free if vec else B * free[..., :, None]
    return solve_spd(A_masked, Bm)


def _diag_embed(v: Tensor) -> Tensor:
    """[..., n] -> [..., n, n] with v on the diagonal."""
    n = v.shape[-1]
    return v[..., :, None] * torch.eye(n, dtype=v.dtype, device=v.device)


def regularize(H: Tensor, reg: float) -> Tensor:
    """H + reg * I."""
    return H + reg * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
