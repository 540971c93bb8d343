"""The optimal-control problem of the feature-major solvers (port of
tube_mpc_tpu/solvers/ocp.py:29-109).

The JAX package writes its callables per scenario and per stage and vmaps them. The port
writes them over a batch of scenarios in front, B lanes, and over every stage at once:

    f(x, u, theta)               x [B, *S, n̂], u [B, *S, nu]          -> [B, *S, n̂]
    f_jac(x, u, theta)           -> (A [B, *S, n̂, n̂], B [B, *S, n̂, nu])
    stage_cost(X, U, theta)      X [B, *S, N, n̂], U [B, *S, N, nu]    -> [B, *S, N]
    terminal_cost(x_N, theta)    x_N [B, *S, n̂]                       -> [B, *S]
    stage_derivs(X, U, theta)    -> (l_x, l_u, l_xx, l_uu, l_ux), each [B, *S, N, ...]
    terminal_derivs(x_N, theta)  -> (phi_x [B, *S, n̂], phi_xx [B, *S, n̂, n̂])
    feasible(X, theta)           X [B, *S, N+1, n̂]                    -> bool [B, *S, N+1]

theta is a tree of named tuples whose leaves are [B, ...] (one value per lane); *S are
extra dims between the lane and the state (the line search's step sizes). Stage k of
X is X[..., k, :], so a stage cost reads per-stage parameters by position
(tube/problem.py).

Each sample's outputs depend on its own inputs only, so the derivative fallbacks take
per-sample derivatives of the batched callables: torch.func.grad of the sum, and the
rows of a Jacobian by torch.func.vjp under torch.func.vmap over the output's basis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import Tensor


def lane_view(leaf: Tensor, ndim: int) -> Tensor:
    """A lane's leaf [B, *F] as [B, 1, .., 1, *F] with ``ndim`` dims, to broadcast
    against a state of the lane whose dims between B and F are extra ones."""
    return leaf.reshape(leaf.shape[:1] + (1,) * (ndim - leaf.ndim) + leaf.shape[1:])


def sample_jacobian(fn: Callable[[Tensor], Tensor], z: Tensor) -> Tensor:
    """d fn(z) / dz per sample: fn maps z [..., d] to [..., m], each sample from its own
    z; returns [..., m, d]."""
    out, vjp = torch.func.vjp(fn, z)
    m = out.shape[-1]
    eye = torch.eye(m, dtype=out.dtype, device=out.device)
    basis = eye.reshape((m,) + (1,) * (out.ndim - 1) + (m,)).expand((m,) + out.shape)
    (rows,) = torch.func.vmap(vjp)(basis)
    return rows.movedim(0, -2)


@dataclasses.dataclass(frozen=True)
class OCP:
    """The problem's callables (see the module's docstring for their shapes)."""

    f: Callable[[Tensor, Tensor, Any], Tensor]
    stage_cost: Callable[[Tensor, Tensor, Any], Tensor]
    terminal_cost: Callable[[Tensor, Any], Tensor]
    f_jac: Optional[Callable[[Tensor, Tensor, Any], Tuple[Tensor, Tensor]]] = None
    stage_derivs: Optional[Callable] = None
    terminal_derivs: Optional[Callable] = None
    u_min: Optional[Tensor] = None
    u_max: Optional[Tensor] = None
    feasible: Optional[Callable[[Tensor, Any], Tensor]] = None

    # ---- derivative fallbacks (autodiff of the batched callables) ----

    def jac_fn(self):
        if self.f_jac is not None:
            return self.f_jac

        def jac(x, u, theta):
            lead = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
            x, u = x.expand(lead + x.shape[-1:]), u.expand(lead + u.shape[-1:])
            A = sample_jacobian(lambda x_: self.f(x_, u, theta), x)
            B = sample_jacobian(lambda u_: self.f(x, u_, theta), u)
            return A, B

        return jac

    def stage_derivs_fn(self):
        if self.stage_derivs is not None:
            return self.stage_derivs
        c = self.stage_cost

        def sd(X, U, theta):
            grad = torch.func.grad(lambda X_, U_: torch.sum(c(X_, U_, theta)), argnums=(0, 1))
            lx, lu = grad(X, U)
            lxx = sample_jacobian(lambda X_: grad(X_, U)[0], X)
            luu = sample_jacobian(lambda U_: grad(X, U_)[1], U)
            lux = sample_jacobian(lambda X_: grad(X_, U)[1], X)
            return lx, lu, lxx, luu, lux

        return sd

    def terminal_derivs_fn(self):
        if self.terminal_derivs is not None:
            return self.terminal_derivs
        c = self.terminal_cost

        def td(xN, theta):
            grad = torch.func.grad(lambda x_: torch.sum(c(x_, theta)))
            return grad(xN), sample_jacobian(grad, xN)

        return td

    # ---- control bounds ----

    def clamp(self, u: Tensor) -> Tensor:
        if self.u_min is None:
            return u
        return torch.minimum(self.u_max, torch.maximum(self.u_min, u))

    def active_mask(self, u: Tensor, tol: float = 1e-8) -> Tensor:
        """The dims at (within tol of) their bounds; all False without bounds."""
        if self.u_min is None:
            return torch.zeros(u.shape, dtype=torch.bool, device=u.device)
        return (u <= self.u_min + tol) | (u >= self.u_max - tol)


def rollout(ocp: OCP, theta, x0: Tensor, U: Tensor) -> Tensor:
    """Open-loop rollout: x0 [B, n̂], U [B, N, nu] -> X [B, N+1, n̂]."""
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(ocp.f(xs[-1], U[:, k], theta))
    return torch.stack(xs, dim=1)


def total_cost(ocp: OCP, theta, X: Tensor, U: Tensor) -> Tensor:
    """The stage costs' sum plus the terminal cost: X [B, *S, N+1, n̂] -> [B, *S]."""
    return (torch.sum(ocp.stage_cost(X[..., :-1, :], U, theta), dim=-1)
            + ocp.terminal_cost(X[..., -1, :], theta))
