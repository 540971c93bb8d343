"""The differentiable iLQR: the solve as an implicit function, through
torch.autograd.Function (port of tube_mpc_tpu/solvers/diff_ilqr.py:38-118).

The forward pass is the iLQR of solvers/ilqr.py; the backward pass is the
O(T) DDP sensitivity sweep and the IFT accumulation at the solution:

    X, U = solve(theta, x0, U_init)     # forward: ilqr_solve
    L(X, U).backward()                  # backward: ddp_sensitivity + one autograd.grad

so Algorithm-2 adaptation is torch.autograd.grad of the upper loss in θ, and the coupled
bilevel chain needs no special code: cotangents reach the ancillary references through
the ancillary solve's backward and go on through the nominal solve's into θ̄.

θ is a tree of named tuples; a Function takes tensors, so its leaves go in flat and the
tree is rebuilt inside. Every leaf is [B, ...] and the lanes are independent: a lane's
cotangent reaches its own leaves only. U_init (and regrad's X, U) get zero cotangents.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import Tensor

from .ift import ift_accumulate, tree_flatten, tree_unflatten
from .ilqr import ILQRConfig, ilqr_solve
from .ocp import OCP
from .sensitivity import ddp_sensitivity


def _implicit_bwd(ocp: OCP, opts, spec, leaves, needs, X, U, g_X, g_U):
    """The backward pass at the KKT point (X, U): (cotangents of the leaves, or None where
    not needed; g_x0 = δλ_0)."""
    sens_reg, active_tol, exact_hessians = opts
    theta = tree_unflatten(spec, leaves)
    sens = ddp_sensitivity(ocp, theta, X, U, g_X, g_U, reg=sens_reg, active_tol=active_tol,
                           exact_hessians=exact_hessians)
    grads: List = [None] * len(leaves)
    wanted = [i for i, need in enumerate(needs) if need]
    if wanted:
        with torch.enable_grad():
            live = [leaf.detach().requires_grad_(need) for leaf, need in zip(leaves, needs)]
            total = torch.sum(ift_accumulate(ocp, tree_unflatten(spec, live), X, U, sens))
            got = torch.autograd.grad(total, [live[i] for i in wanted], allow_unused=True)
        for i, g in zip(wanted, got):
            grads[i] = torch.zeros_like(leaves[i]) if g is None else g
    return grads, sens.delta_lambda[:, 0]


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ocp, cfg, opts, spec, x0, U_init, *leaves):
        X, U = ilqr_solve(ocp, cfg, tree_unflatten(spec, leaves), x0, U_init)
        ctx.ocp, ctx.opts, ctx.spec = ocp, opts, spec
        ctx.save_for_backward(X, U, *leaves)
        return X, U

    @staticmethod
    def backward(ctx, g_X, g_U):
        X, U, *leaves = ctx.saved_tensors
        grads, g_x0 = _implicit_bwd(ctx.ocp, ctx.opts, ctx.spec, leaves,
                                    ctx.needs_input_grad[6:], X, U, g_X, g_U)
        g_U_init = torch.zeros_like(U) if ctx.needs_input_grad[5] else None
        return (None, None, None, None, g_x0 if ctx.needs_input_grad[4] else None, g_U_init,
                *grads)


class _Regrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ocp, opts, spec, x0, X, U, *leaves):
        ctx.ocp, ctx.opts, ctx.spec = ocp, opts, spec
        ctx.save_for_backward(X, U, *leaves)
        return X.clone(), U.clone()

    @staticmethod
    def backward(ctx, g_X, g_U):
        X, U, *leaves = ctx.saved_tensors
        grads, g_x0 = _implicit_bwd(ctx.ocp, ctx.opts, ctx.spec, leaves,
                                    ctx.needs_input_grad[6:], X, U, g_X, g_U)
        zero = lambda i, t: torch.zeros_like(t) if ctx.needs_input_grad[i] else None
        return (None, None, None, g_x0 if ctx.needs_input_grad[3] else None, zero(4, X),
                zero(5, U), *grads)


def make_diff_ilqr(ocp: OCP, cfg: ILQRConfig, *, sens_reg: float = 1e-9,
                   active_tol: float = 1e-8, exact_hessians: bool = False):
    """solve(theta, x0, U_init) -> (X, U), differentiable in theta and x0. U_init is a
    warm start only. exact_hessians: the backward pass's curvature (ddp_sensitivity)."""
    opts = (sens_reg, active_tol, exact_hessians)

    def solve(theta, x0: Tensor, U_init: Tensor) -> Tuple[Tensor, Tensor]:
        leaves, spec = tree_flatten(theta)
        return _Solve.apply(ocp, cfg, opts, spec, x0, U_init, *leaves)

    return solve


def make_ift_regrad(ocp: OCP, *, sens_reg: float = 1e-9, active_tol: float = 1e-8,
                    exact_hessians: bool = False):
    """regrad(theta, x0, X, U) -> (X, U): the identity forward, whose backward runs the
    sensitivity and IFT at the GIVEN (X, U) with the GIVEN theta's Hessians: the
    reference's inner adaptation iterations, which re-derive the gradient on the
    trajectories of the step's solves while θ moves."""
    opts = (sens_reg, active_tol, exact_hessians)

    def regrad(theta, x0: Tensor, X: Tensor, U: Tensor) -> Tuple[Tensor, Tensor]:
        leaves, spec = tree_flatten(theta)
        return _Regrad.apply(ocp, opts, spec, x0, X, U, *leaves)

    return regrad
