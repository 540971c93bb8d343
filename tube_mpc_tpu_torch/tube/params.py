"""Adapted parameters and the projected momentum update of Algorithm 2 (port of
tube_mpc_tpu/tube/params.py:27-160).

Two parameterisations:
- the paper path adapts (Q, R, q_b) directly, with projection clamps;
- the generic path adapts unconstrained raw parameters mapped through
  softplus/tanh, projected by field name.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor


class AuxAdapt(NamedTuple):
    """Ancillary weights adapted online (Qf is tied to Q): Q [.., nx], R [.., nu], qb [..]."""

    Q: Tensor
    R: Tensor
    qb: Tensor


def project_aux_adapt(p: AuxAdapt) -> AuxAdapt:
    """Q >= 0, R >= 1e-4, qb in [0, 1]."""
    return AuxAdapt(
        Q=torch.clamp(p.Q, min=0.0),
        R=torch.clamp(p.R, min=1e-4),
        qb=torch.clamp(p.qb, 0.0, 1.0),
    )


# ---------------------------------------------------------------------------
# Generic-path raw parameters: softplus/tanh reparameterisation.
# ---------------------------------------------------------------------------

def softplus(x: Tensor) -> Tensor:
    """log(1 + e^x) as jax.nn.softplus computes it, logaddexp(x, 0).

    Not torch.nn.functional.softplus, which returns x unchanged above its
    threshold of 20: the raw terminal weights start at 1000."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: Tensor) -> Tensor:
    """Inverse of softplus, for raw parameters that map to given values."""
    return y + torch.log(-torch.expm1(-y))


class RawNominalTheta(NamedTuple):
    """Unconstrained raw nominal parameters; leaves [..] or [.., d]."""

    Q_raw: Tensor
    R_raw: Tensor
    Qf_raw: Tensor
    qb_raw: Tensor
    alpha_raw: Tensor
    gamma_raw: Tensor
    tight_raw: Tensor

    def Q(self): return softplus(self.Q_raw)
    def R(self): return softplus(self.R_raw)
    def Qf(self): return softplus(self.Qf_raw)
    def qb(self): return softplus(self.qb_raw)
    def alpha(self): return softplus(self.alpha_raw) + 1e-6
    def gamma(self): return torch.tanh(self.gamma_raw)
    def tight(self): return softplus(self.tight_raw)


class RawAuxTheta(NamedTuple):
    """Unconstrained raw ancillary parameters; leaves [..] or [.., d]."""

    Q_raw: Tensor
    R_raw: Tensor
    Qf_raw: Tensor
    qb_raw: Tensor
    alpha_raw: Tensor
    gamma_raw: Tensor

    def Q(self): return softplus(self.Q_raw)
    def R(self): return softplus(self.R_raw)
    def Qf(self): return softplus(self.Qf_raw)
    def qb(self): return softplus(self.qb_raw)
    def alpha(self): return softplus(self.alpha_raw) + 1e-6
    def gamma(self): return torch.tanh(self.gamma_raw)


# Projection bounds on the RAW parameters, by field name: (min, max), None for
# no bound on that side.
_RAW_PROJECTION: dict = {
    "Q_raw": (0.0, None),
    "Qf_raw": (0.0, None),
    "R_raw": (1e-4, 1e4),
    "qb_raw": (0.0, 1.0),
    "gamma_raw": (-1.0, 1.0),
    "alpha_raw": (0.0, 1.0),
    "tight_raw": (0.0, 2.0),
}


def project_raw(p):
    """Project a Raw*Theta by field name."""
    vals = {}
    for name in p._fields:
        lo, hi = _RAW_PROJECTION.get(name, (None, None))
        v = getattr(p, name)
        if lo is not None or hi is not None:
            v = torch.clamp(v, min=lo, max=hi)
        vals[name] = v
    return type(p)(**vals)


# ---------------------------------------------------------------------------
# Projected momentum SGD (Algorithm 2 update rule).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    lr: float = 1e-2
    momentum: float = 0.9
    steps: int = 1
    grad_clip_norm: float = 0.0  # 0 disables
    project: bool = True


def _map(fn, *trees):
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def momentum_update(params, grads, vel, cfg: AdaptConfig, project_fn=None):
    """v <- momentum v + g ;  p <- proj(p - lr v), over matching NamedTuples.

    With grad_clip_norm > 0 the gradient is first scaled by
    min(1, clip / (||g|| + 1e-12)), the norm taken over every leaf in full: on
    the lane engine the leaves are [B, ..], so each lane's step then depends on
    the whole batch, as in the reference."""
    if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.as_tensor(cfg.grad_clip_norm, dtype=gnorm.dtype, device=gnorm.device)
        scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0)
        grads = _map(lambda g: g * scale, grads)

    if cfg.momentum and cfg.momentum > 0:
        vel = _map(lambda v, g: cfg.momentum * v + g, vel, grads)
        step = vel
    else:
        step = grads

    params = _map(lambda p, s: p - cfg.lr * s, params, step)
    if cfg.project and project_fn is not None:
        params = project_fn(params)
    return params, vel
