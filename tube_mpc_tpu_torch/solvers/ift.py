"""The implicit-function-theorem gradient accumulation, over B lanes (port of
tube_mpc_tpu/solvers/ift.py:26-60).

Turns the sensitivity directions δz = (δX, δU, δλ) into ∇_θ L through

    ∇_θ L = ξ_θᵀ δλ_0 + Σ_k ( ℒ_{θx}^{(k)} δx_k + ℒ_{θu}^{(k)} δu_k + f_θᵀ δλ_{k+1} )
          + φ_{θx} δx_N

written as one scalar per lane, a function of θ; one torch.autograd.grad of its sum over
the lanes gives every lane's gradient (the lanes are independent). The cost gradients
ℓ_x, ℓ_u, φ_x are the OCP's stage and terminal derivatives, which are functions of θ.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import Tensor

from .ocp import OCP
from .sensitivity import SensitivityResult


def tree_flatten(tree) -> Tuple[List[Tensor], Any]:
    """(leaves, spec) of a tree of named tuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        leaves, specs = [], []
        for child in tree:
            sub, spec = tree_flatten(child)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree), tuple(specs))
    return [tree], None


def tree_unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in tree_flatten's order."""
    it = iter(leaves)

    def build(s):
        return next(it) if s is None else s[0](*(build(c) for c in s[1]))

    return build(spec)


def ift_accumulate(ocp: OCP, theta, X: Tensor, U: Tensor, sens: SensitivityResult,
                   x0_fn: Optional[Callable] = None) -> Tensor:
    """The IFT accumulation of each lane [B], differentiable in theta. x0_fn(theta) is
    ξ(θ) where the initial state depends on the parameters; without it the δλ_0ᵀξ term
    is a constant."""
    dX, dU, dlam = sens.delta_X, sens.delta_U, sens.delta_lambda
    xi = x0_fn(theta) if x0_fn is not None else X[:, 0].detach()
    total = torch.sum(dlam[:, 0] * xi, dim=-1)
    lx, lu = ocp.stage_derivs_fn()(X[:, :-1], U, theta)[:2]
    steps = (torch.sum(lx * dX[:, :-1], dim=-1) + torch.sum(lu * dU, dim=-1)
             + torch.sum(dlam[:, 1:] * ocp.f(X[:, :-1], U, theta), dim=-1))
    total = total + torch.sum(steps, dim=-1)
    phi_x = ocp.terminal_derivs_fn()(X[:, -1], theta)[0]
    return total + torch.sum(phi_x * dX[:, -1], dim=-1)


def ift_gradient(ocp: OCP, theta, X: Tensor, U: Tensor, sens: SensitivityResult,
                 x0_fn: Optional[Callable] = None):
    """∇_θ L of every lane, a tree like theta (zeros where a leaf does not enter)."""
    leaves, spec = tree_flatten(theta)
    with torch.enable_grad():
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        total = torch.sum(ift_accumulate(ocp, tree_unflatten(spec, live), X, U, sens, x0_fn))
        grads = torch.autograd.grad(total, live, allow_unused=True)
    return tree_unflatten(spec, [torch.zeros_like(v) if g is None else g
                                 for v, g in zip(leaves, grads)])
