"""The shipped Dubins paper configuration (port of tube_mpc_tpu/presets.py:22-86)."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import Tensor

from .device import DeviceLike, resolve_device, resolve_dtype
from .ops.costs import CostWeights
from .ops.dbas import AugmentedDynamics, BarrierParams, make_augmented
from .ops.lanes import ComponentSystem, dubins_components
from .systems.base import System
from .systems.dubins import DubinsConfig, make_dubins
from .systems.obstacles import CircleField
from .tube.closed_loop import TubeMPCConfig
from .tube.params import AdaptConfig, AuxAdapt

PAPER_OBSTACLES: Tuple[Tuple[float, float], ...] = (
    (4.0, 2.0), (2.0, 4.0), (4.0, 8.0), (8.0, 4.0), (6.0, 6.0),
)
PAPER_ALPHAS: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01, 0.0)


@dataclasses.dataclass(frozen=True)
class DubinsPaperSetup:
    """The paper experiment. ``sys_c`` is the component form the lane kernels run
    (the same obstacles, beta and bounds as ``system``); ``eps`` is the barrier floor."""

    system: System
    aug: AugmentedDynamics
    sys_c: ComponentSystem
    cfg: TubeMPCConfig
    w_nominal: CostWeights
    aux_init: AuxAdapt
    bp: BarrierParams
    x0: Tensor
    target: Tensor
    field: CircleField
    eps: float


def build_dubins_setup(
    *,
    cfg: TubeMPCConfig,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,
    target: Tensor,
    centers: Tensor,
    radii: Tensor,
    beta: float,
    eps: float,
    dubins: DubinsConfig = DubinsConfig(dt=0.01),
) -> DubinsPaperSetup:
    """Assemble a setup from its parts (tensors on one device and dtype)."""
    field = CircleField(centers=centers, radii=radii)
    system = make_dubins(dubins, obstacles=field, aggregation="smoothmin", beta=beta,
                         device=centers.device, dtype=centers.dtype)
    sys_c = dubins_components(
        dt=dubins.dt, v_min=dubins.v_min, v_max=dubins.v_max, omega_max=dubins.omega_max,
        centers=[tuple(float(v) for v in c) for c in centers.tolist()],
        radii=[float(r) for r in radii.tolist()], aggregation="smoothmin", beta=beta,
    )
    return DubinsPaperSetup(
        system=system, aug=make_augmented(system, barrier_type="inverse", eps=eps), sys_c=sys_c,
        cfg=cfg, w_nominal=w_nominal, aux_init=aux_init, bp=bp, x0=x0, target=target,
        field=field, eps=eps,
    )


def dubins_paper_setup(
    *,
    N: int = 50,
    H: int = 300,
    device: DeviceLike = None,
    dtype=torch.float32,
    beta: float = 20.0,
    eps: float = 1e-4,
    nominal_max_iter: int = 10,
    aux_max_iter: int = 20,
    lr: float = 5e-2,
    momentum: float = 0.9,
    alphas: Tuple[float, ...] = PAPER_ALPHAS,
) -> DubinsPaperSetup:
    """The dubins.yaml paper experiment, parameterised by size and dtype."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    cfg = TubeMPCConfig(
        N=N, H=H, nominal_max_iter=nominal_max_iter, aux_max_iter=aux_max_iter,
        tol=1e-3, reg=1e-6, alphas=tuple(alphas), adapt=AdaptConfig(lr=lr, momentum=momentum),
    )
    return build_dubins_setup(
        cfg=cfg,
        w_nominal=CostWeights.create([1.0, 1.0, 0.0], [1.0, 1.0], [1000.0] * 3, 1.0,
                                     device=dev, dtype=dtype),
        aux_init=AuxAdapt(Q=t([1.0] * 3), R=t([1.0] * 2), qb=t(1.0)),
        bp=BarrierParams.create(0.0, 0.0, 0.0, device=dev, dtype=dtype),
        x0=t([0.0, 0.0, math.pi / 4]),
        target=t([10.0, 10.0, math.pi / 4]),
        centers=t([list(c) for c in PAPER_OBSTACLES]),
        radii=t([1.0] * len(PAPER_OBSTACLES)),
        beta=beta, eps=eps,
    )
