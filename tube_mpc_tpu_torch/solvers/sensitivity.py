"""The DDP-structured O(T) sensitivity solve of the implicit function theorem, over B
lanes (port of tube_mpc_tpu/solvers/sensitivity.py:24-140).

Solves L_zz δz = -∇_z L_upper over the KKT system of a solved OCP by the backward and
forward recursions, with the active control dims eliminated (δu_i = 0 at a bound) by
``masked_reduced_solve``. The linearisation is one batched call over (B, k); the two
sweeps loop over k. Differentiable by autograd: the closed loop's hypergradient
(tube/closed_loop.make_paper_closed_loop_diff) runs through it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..ops.linalg import masked_reduced_solve
from .ilqr import check_precision
from .ocp import OCP, sample_jacobian


class SensitivityResult(NamedTuple):
    delta_X: Tensor       # [B, N+1, n̂]
    delta_U: Tensor       # [B, N, nu]
    delta_lambda: Tensor  # [B, N+1, n̂]


def _mT(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _lagrangian_hessians(ocp: OCP, theta, X: Tensor, U: Tensor, lam_next: Tensor):
    """∂²[λ_{k+1}ᵀ f(x_k, u_k)]/∂(x, u)² of every stage: (H_xx, H_uu, H_ux)."""
    nxh = X.shape[-1]

    def grad_xu(xu: Tensor) -> Tensor:
        return torch.func.grad(
            lambda z: torch.sum(lam_next * ocp.f(z[..., :nxh], z[..., nxh:], theta)))(xu)

    H = sample_jacobian(grad_xu, torch.cat([X, U], dim=-1))
    return H[..., :nxh, :nxh], H[..., nxh:, nxh:], H[..., nxh:, :nxh]


def ddp_sensitivity(
    ocp: OCP,
    theta,
    X: Tensor,
    U: Tensor,
    g_X: Tensor,
    g_U: Tensor,
    *,
    reg: float = 1e-9,
    active_tol: float = 1e-8,
    exact_hessians: bool = False,
) -> SensitivityResult:
    """δz = (δX, δU, δλ) for the upper-loss gradients g_X [B, N+1, n̂], g_U [B, N, nu].

    exact_hessians: False is the reference's Gauss-Newton recursion (cost Hessians with
    first-order dynamics); True adds the Lagrangian's curvature λ_{k+1}ᵀ∇²f, with the
    adjoints λ_N = φ_x, λ_k = ℓ_x + A_kᵀ λ_{k+1} of the solved OCP, which makes δz the
    exact derivative of the solution map."""
    check_precision()
    N, nu = U.shape[1], U.shape[-1]
    A, B = ocp.jac_fn()(X[:, :-1], U, theta)
    lx, _, lxx, luu, lux = ocp.stage_derivs_fn()(X[:, :-1], U, theta)
    phi_x, phi_xx = ocp.terminal_derivs_fn()(X[:, -1], theta)
    active = ocp.active_mask(U, tol=active_tol)

    if exact_hessians:
        lam, lam_next = phi_x, [None] * N
        for k in reversed(range(N)):
            lam_next[k] = lam
            lam = lx[:, k] + _mv(_mT(A[:, k]), lam)
        Hxx, Huu, Hux = _lagrangian_hessians(ocp, theta, X[:, :-1], U,
                                             torch.stack(lam_next, dim=1))
        lxx, luu, lux = lxx + Hxx, luu + Huu, lux + Hux

    eye = torch.eye(nu, dtype=U.dtype, device=U.device)
    V_xx, tV_x = phi_xx, g_X[:, N]
    Ks, kffs, V_xx_seq, tV_x_seq = [None] * N, [None] * N, [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k = A[:, k], B[:, k]
        At, Bt = _mT(A_k), _mT(B_k)
        Q_xx = lxx[:, k] + At @ V_xx @ A_k
        Q_xu = _mT(lux[:, k]) + At @ V_xx @ B_k
        Q_ux = lux[:, k] + Bt @ V_xx @ A_k
        Q_uu = luu[:, k] + Bt @ V_xx @ B_k
        tQ_u = g_U[:, k] + _mv(Bt, tV_x)
        tQ_x = g_X[:, k] + _mv(At, tV_x)
        Q_uu_reg = Q_uu + reg * eye

        # one solve for both right-hand sides: every column's operations are its own
        Kk = -masked_reduced_solve(Q_uu_reg, torch.cat([Q_ux, tQ_u[..., None]], dim=-1),
                                   active[:, k])
        K, kff = Kk[..., :-1], Kk[..., -1]

        tV_x = tQ_x + _mv(Q_xu, kff)
        V_xx = Q_xx + Q_xu @ K
        Ks[k], kffs[k], V_xx_seq[k], tV_x_seq[k] = K, kff, V_xx, tV_x

    dx = torch.zeros_like(X[:, 0])
    dxs, dvs, dlams = [dx], [], []
    for k in range(N):
        dv = kffs[k] + _mv(Ks[k], dx)
        dv = torch.where(active[:, k], torch.zeros_like(dv), dv)
        dlams.append(tV_x_seq[k] + _mv(V_xx_seq[k], dx))
        dx = _mv(A[:, k], dx) + _mv(B[:, k], dv)
        dxs.append(dx)
        dvs.append(dv)
    dlams.append(g_X[:, N] + _mv(phi_xx, dx))
    return SensitivityResult(delta_X=torch.stack(dxs, dim=1), delta_U=torch.stack(dvs, dim=1),
                             delta_lambda=torch.stack(dlams, dim=1))
