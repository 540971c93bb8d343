"""Adapted ancillary weights and the projected momentum update of Algorithm 2
(port of tube_mpc_tpu/tube/params.py:27-42, 126-160, paper path)."""
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
