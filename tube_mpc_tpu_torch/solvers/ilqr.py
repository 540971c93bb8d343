"""Box-constrained iLQR over B lanes, feature-major (port of
tube_mpc_tpu/solvers/ilqr.py:1-201).

The semantics are the JAX solver's: the decision variable is u itself, forward passes
clamp to the box, the backward pass uses full regularised gains, the line search picks
the best candidate of a fixed step-size ladder (first minimum, NaN as +inf, optional
feasibility filter), and a lane stops when its accepted cost changes by less than tol.

The JAX package vmaps a per-scenario ``lax.while_loop``, which runs each lane until its
own ``done`` or ``max_iter``; a finished lane keeps its carry. Here the lanes are a
batch dim and the loop is Python's: every iteration updates X, U and the cost only where
a lane is still live, so each lane's result is the one it gives alone. A live lane's
iteration count is the loop index, so it is not carried. The horizon-parallel parts
(linearisation, stage derivatives, costs) are single batched operations over (B, k);
the Riccati sweep and the rollouts loop over k, but with ILQRConfig.horizon_parallel the
sweep is solvers/pscan.py's associative scan.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import Tensor

from ..ops.linalg import range_guard_default, solve_spd
from .ocp import OCP, rollout, total_cost

# Renormalisation threshold of the scaled Riccati carry (see _backward_pass): thresh·|A|²
# stays inside the f32 range with barrier-inflated |A| up to ~1e12. Real f64 has the
# range 1e308 and never rescales in practice, so its recursion is the unscaled one.
_V_SCALE_THRESH = 1e12
_V_SCALE_THRESH_F64 = 1e250


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver hyperparameters. horizon_parallel switches the Riccati sweep to the
    O(log N)-level associative-scan form (solvers/pscan.py), for long horizons or small
    batches; its value propagation differs from the sequential split update by O(reg)."""

    max_iter: int = 30
    tol: float = 1e-6
    reg: float = 1e-6
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    horizon_parallel: bool = False


def check_precision() -> None:
    """Refuse reduced-precision (TF32) products: on the 4x4 Riccati algebra they cost
    ~1e-2 of absolute error a sweep, which is why the JAX solver traces under matmul
    precision "highest"."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the feature-major solvers need torch.set_float32_matmul_precision('highest') "
            f"(it is {torch.get_float32_matmul_precision()!r}): TF32 products cost ~1e-2 of "
            "absolute error on the Riccati algebra")


def _mT(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """M @ v over leading dims: M [..., a, b], v [..., b] -> [..., a]."""
    return (M @ v[..., None])[..., 0]


def _linearize(ocp: OCP, theta, X: Tensor, U: Tensor):
    """Every stage's Jacobians and cost derivatives in one batched call each."""
    A, B = ocp.jac_fn()(X[:, :-1], U, theta)
    lx, lu, lxx, luu, lux = ocp.stage_derivs_fn()(X[:, :-1], U, theta)
    phi_x, phi_xx = ocp.terminal_derivs_fn()(X[:, -1], theta)
    return A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx


def _value_update(Q_x, Q_u, Q_xx, Q_ux, Q_uu, K, kff):
    """One step's (V_x, V_xx) by the split update, V_xx then made symmetric: the update
    carries an antisymmetric part of V_xx forward and can grow it, from the products'
    rounding, until the gains are lost; ½(V_xx + V_xxᵀ) is symmetric to the bit."""
    Kt, Q_xu = _mT(K), _mT(Q_ux)
    V_x = Q_x + _mv(Kt @ Q_uu, kff) + _mv(Kt, Q_u) + _mv(Q_xu, kff)
    V_xx = Q_xx + Kt @ Q_uu @ K + Kt @ Q_ux + Q_xu @ K
    return V_x, 0.5 * (V_xx + _mT(V_xx))


def _backward_pass(A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx, reg: float):
    """The Riccati recursion over k = N-1..0 -> (K [B, N, nu, n̂], kff [B, N, nu]).

    The carry holds V scaled: the true V is exp(log_s)·(V_x, V_xx), renormalised
    whenever a lane's largest entry passes the threshold. Gains are scale-invariant;
    below the threshold log_s stays exactly 0.0 and every inv_s multiply is an exact
    identity, so the recursion is the unscaled one.

    V_xx is made symmetric after every step, ½(V_xx + V_xxᵀ), which the JAX package's
    sweep does not do: without it the split value update grows the antisymmetric part that
    rounding leaves in V_xx at long horizons, and its gains part from the exact recursion's
    (at N=1024 in f64 on random LQ problems, and from the first iteration of the quadrotor's
    N=200 OCP in f32 on the card; tools/riccati_asymmetry_probe.py)."""
    N, nu = B.shape[1], B.shape[-1]
    eye = torch.eye(nu, dtype=B.dtype, device=B.device)
    thresh = _V_SCALE_THRESH if range_guard_default(B.dtype) else _V_SCALE_THRESH_F64
    V_x, V_xx = phi_x, phi_xx
    log_s = torch.zeros(B.shape[:1], dtype=B.dtype, device=B.device)
    Ks, kffs = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], B[:, k]
        At, Bt = _mT(A_k), _mT(B_k)
        inv_s = torch.exp(-log_s)
        s1, s2 = inv_s[:, None], inv_s[:, None, None]
        Q_x = lx[:, k] * s1 + _mv(At, V_x)
        Q_u = lu[:, k] * s1 + _mv(Bt, V_x)
        Q_xx = lxx[:, k] * s2 + At @ V_xx @ A_k
        Q_ux = lux[:, k] * s2 + Bt @ V_xx @ A_k
        Q_uu = luu[:, k] * s2 + Bt @ V_xx @ B_k
        Q_uu_reg = Q_uu + (reg * inv_s)[:, None, None] * eye

        # one solve for both right-hand sides: every column's operations are its own
        Kk = -solve_spd(Q_uu_reg, torch.cat([Q_ux, Q_u[..., None]], dim=-1))
        K, kff = Kk[..., :-1], Kk[..., -1]

        V_x_new, V_xx_new = _value_update(Q_x, Q_u, Q_xx, Q_ux, Q_uu, K, kff)
        m = torch.maximum(torch.amax(torch.abs(V_xx_new), dim=(-2, -1)),
                          torch.amax(torch.abs(V_x_new), dim=-1))
        scale = torch.where(m > thresh, m / thresh, torch.ones_like(m))
        V_x, V_xx = V_x_new / scale[:, None], V_xx_new / scale[:, None, None]
        log_s = log_s + torch.log(scale)
        Ks[k], kffs[k] = K, kff
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1)


def _forward_pass(ocp: OCP, theta, x0, X_old, U_old, K, kff, alphas: Tensor):
    """The closed-loop rollouts of every step size at once, clamped to the box:
    -> X [B, nα, N+1, n̂], U [B, nα, N, nu], cost [B, nα] (+inf where infeasible)."""
    lanes, N = U_old.shape[:2]
    x = x0[:, None].expand(lanes, alphas.shape[0], x0.shape[-1])
    a = alphas[:, None]
    xs, us = [x], []
    for k in range(N):
        du = kff[:, k, None] + _mv(K[:, k, None], x - X_old[:, k, None])
        u = ocp.clamp(U_old[:, k, None] + a * du)
        x = ocp.f(x, u, theta)
        xs.append(x)
        us.append(u)
    X_new, U_new = torch.stack(xs, dim=2), torch.stack(us, dim=2)
    cost = total_cost(ocp, theta, X_new, U_new)
    if ocp.feasible is not None:
        feas = torch.all(ocp.feasible(X_new, theta), dim=-1)
        cost = torch.where(feas, cost, torch.full_like(cost, float("inf")))
    return X_new, U_new, cost


def ilqr_solve(ocp: OCP, cfg: ILQRConfig, theta, x0: Tensor, U_init: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Solve the box-constrained OCP of every lane: x0 [B, n̂], U_init [B, N, nu],
    theta's leaves [B, ...] -> (X [B, N+1, n̂], U [B, N, nu]).

    Each lane stops at its own convergence or max_iter, as a vmapped while_loop's lane
    does: a finished lane's iteration changes nothing. The host reads, each iteration,
    whether any lane is still live, and the solve stops when none is (a warm-started
    closed-loop solve stops well before max_iter).

    Not differentiable: solvers/diff_ilqr.make_diff_ilqr is its implicit-function form."""
    check_precision()
    with torch.no_grad():
        return _ilqr_solve_impl(ocp, cfg, theta, x0, U_init)


def _ilqr_solve_impl(ocp, cfg, theta, x0, U_init):
    U = ocp.clamp(U_init)
    X = rollout(ocp, theta, x0, U)
    alphas = torch.as_tensor(cfg.alphas, dtype=x0.dtype, device=x0.device)
    lanes = x0.shape[0]
    prev_cost = torch.full((lanes,), float("inf"), dtype=x0.dtype, device=x0.device)
    done = torch.zeros((lanes,), dtype=torch.bool, device=x0.device)
    for _ in range(cfg.max_iter):
        if bool(done.all()):
            break
        live = ~done
        lin = _linearize(ocp, theta, X, U)
        if cfg.horizon_parallel:
            from .pscan import parallel_backward_pass  # here: pscan imports this module
            K, kff = parallel_backward_pass(*lin, cfg.reg)
        else:
            K, kff = _backward_pass(*lin, cfg.reg)
        X_c, U_c, costs = _forward_pass(ocp, theta, x0, X, U, K, kff, alphas)
        # NaN candidates never win (+inf); the first minimum wins a tie.
        costs = torch.where(torch.isnan(costs), torch.full_like(costs, float("inf")), costs)
        best = torch.argmin(costs, dim=-1)
        best_cost = torch.gather(costs, 1, best[:, None])[:, 0]
        X_b = torch.gather(X_c, 1, best[:, None, None, None].expand(
            (lanes, 1) + X_c.shape[2:]))[:, 0]
        U_b = torch.gather(U_c, 1, best[:, None, None, None].expand(
            (lanes, 1) + U_c.shape[2:]))[:, 0]
        # No finite candidate: keep the incumbent and stop the lane.
        any_finite = torch.isfinite(best_cost)
        take = (live & any_finite)[:, None, None]
        X = torch.where(take, X_b, X)
        U = torch.where(take, U_b, U)
        best_cost = torch.where(any_finite, best_cost, prev_cost)
        now_done = (torch.abs(prev_cost - best_cost) < cfg.tol) | ~any_finite
        prev_cost = torch.where(live, best_cost, prev_cost)
        done = torch.where(live, now_done, done)
    return X, U

