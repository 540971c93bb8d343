"""The shipped paper configurations: Dubins (port of tube_mpc_tpu/presets.py:22-86) and
the double integrator, the planar quadrotor and the cart-pole as bench.py runs them
(BENCH_SYSTEM, bench.py:143-181: ``build_experiment(load_config(configs/<name>.yaml),
paper_mode=True)`` with N and H replaced, through the port's utils.config)."""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from .device import DeviceLike, resolve_device, resolve_dtype
from .ops.costs import CostWeights
from .ops.dbas import AugmentedDynamics, BarrierParams, make_augmented
from .ops.lanes import FAMILIES, ComponentSystem, dubins_components
from .systems import registry
from .systems.base import System
from .systems.dubins import DubinsConfig, make_dubins
from .systems.obstacles import CircleField
from .tube.closed_loop import TubeMPCConfig
from .tube.params import AdaptConfig, AuxAdapt, RawAuxTheta, RawNominalTheta
from .utils.config import (
    ExperimentConfig,
    build_experiment,
    lane_components,
    load_config,
    validate_for_engine,
)

PAPER_OBSTACLES: Tuple[Tuple[float, float], ...] = (
    (4.0, 2.0), (2.0, 4.0), (4.0, 8.0), (8.0, 4.0), (6.0, 6.0),
)
PAPER_ALPHAS: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.05, 0.01, 0.0)


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    """A paper experiment. ``sys_c`` is the component form the lane kernels run
    (the same obstacles, aggregation, beta and bounds as ``system``); ``field`` holds the
    circle obstacles (None for the cart-pole); ``eps`` is the barrier floor and
    ``barrier_type`` the barrier ("inverse" or "log") of ``aug`` and of the loops."""

    system: System
    aug: AugmentedDynamics
    sys_c: ComponentSystem
    cfg: TubeMPCConfig
    w_nominal: CostWeights
    aux_init: AuxAdapt
    bp: BarrierParams
    x0: Tensor
    target: Tensor
    field: Optional[CircleField]
    eps: float
    barrier_type: str = "inverse"


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
) -> PaperSetup:
    """Assemble a setup from its parts (tensors on one device and dtype)."""
    field = CircleField(centers=centers, radii=radii)
    system = make_dubins(dubins, obstacles=field, aggregation="smoothmin", beta=beta,
                         device=centers.device, dtype=centers.dtype)
    sys_c = dubins_components(
        dt=dubins.dt, v_min=dubins.v_min, v_max=dubins.v_max, omega_max=dubins.omega_max,
        centers=[tuple(float(v) for v in c) for c in centers.tolist()],
        radii=[float(r) for r in radii.tolist()], aggregation="smoothmin", beta=beta,
    )
    return PaperSetup(
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
) -> PaperSetup:
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


# bench.py's BENCH_SYSTEM families: each runs its shipped configs/<name>.yaml
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FAMILY_NAMES: Tuple[str, ...] = tuple(f for f in FAMILIES if f != "dubins")


def build_family_setup(
    name: str,
    *,
    cfg: TubeMPCConfig,
    w_nominal: CostWeights,
    aux_init: AuxAdapt,
    bp: BarrierParams,
    x0: Tensor,
    target: Tensor,
    dt: float,
    control_bounds: Dict[str, Any],
    w_low,
    w_high,
    obstacles,          # sequence of ((cx, cy), r)
    beta: float,
    eps: float,
    extra: Optional[Dict[str, Any]] = None,
) -> PaperSetup:
    """Assemble a setup of family ``name`` from its parts (tensors on one device and
    dtype), through the registry as build_experiment does."""
    dev, dtype = target.device, target.dtype
    obs = [dict(center=[float(c) for c in center], radius=float(r)) for center, r in obstacles]
    field = None
    if obs:
        field = CircleField(
            centers=torch.as_tensor([o["center"] for o in obs], dtype=dtype, device=dev),
            radii=torch.as_tensor([o["radius"] for o in obs], dtype=dtype, device=dev))
    system = registry.build(
        name, dt=dt, control_bounds=control_bounds,
        disturbance=dict(w_low=tuple(w_low), w_high=tuple(w_high)), target=target.tolist(),
        obstacles=field, aggregation="smoothmin", beta=beta, device=dev, dtype=dtype,
        extra=extra)
    sys_c = registry.build_components(
        name, dt=dt, control_bounds=control_bounds, obstacles=obs or None,
        aggregation="smoothmin", beta=beta, extra=extra)
    return PaperSetup(
        system=system, aug=make_augmented(system, barrier_type="inverse", eps=eps), sys_c=sys_c,
        cfg=cfg, w_nominal=w_nominal, aux_init=aux_init, bp=bp, x0=x0, target=target,
        field=field, eps=eps,
    )


def config_setup(cfg: ExperimentConfig, *, N: int, H: int, device: DeviceLike = None,
                 dtype=torch.float32) -> PaperSetup:
    """The setup of ``cfg`` (any config the lane engine takes: its aggregation and its
    barrier too) in ``dtype`` on ``device``, built in paper mode unless the nominal θ̄
    adapts (adaptation.adapt_nominal), with N and H replaced."""
    cfg = dataclasses.replace(cfg, use_float64=resolve_dtype(dtype) == torch.float64)
    built = build_experiment(cfg, paper_mode=not cfg.adaptation.adapt_nominal, device=device)
    validate_for_engine(built, "lanes")
    return PaperSetup(
        system=built.system, aug=built.aug, sys_c=lane_components(cfg),
        cfg=dataclasses.replace(built.tube_cfg, N=N, H=H), w_nominal=built.w_nominal,
        aux_init=built.aux_init, bp=built.bp, x0=built.x0, target=built.target,
        field=built.field, eps=cfg.dbas.eps, barrier_type=cfg.dbas.barrier_type,
    )


def config_coupled_setup(cfg: ExperimentConfig, *, N: int, H: int, device: DeviceLike = None,
                         dtype=torch.float32) -> Tuple[PaperSetup, RawNominalTheta, RawAuxTheta]:
    """config_setup of ``cfg`` with adaptation.adapt_nominal: true, as the CLI runs it:
    the generic loop's coupled chain (setup.cfg.adapt_nominal, reg the file's ilqr_reg)
    from the file's numbers taken as raw θ̄ and θ (runners.raw_thetas): (setup, raw θ̄,
    raw θ)."""
    from .runners import raw_thetas

    cfg = dataclasses.replace(
        cfg, use_float64=resolve_dtype(dtype) == torch.float64,
        adaptation=dataclasses.replace(cfg.adaptation, adapt_nominal=True))
    setup = config_setup(cfg, N=N, H=H, device=device, dtype=dtype)
    return (setup, *raw_thetas(cfg, setup.x0.device))


def _family_config(name: str, adapt_nominal: bool = False) -> ExperimentConfig:
    """configs/<name>.yaml with adaptation.adapt_nominal set to ``adapt_nominal``."""
    if name not in FAMILY_NAMES:
        raise ValueError(f"no paper setup for {name!r}; have {sorted(FAMILY_NAMES)}")
    cfg = load_config(str(CONFIGS / f"{name}.yaml"))
    return dataclasses.replace(
        cfg, adaptation=dataclasses.replace(cfg.adaptation, adapt_nominal=adapt_nominal))


def family_paper_setup(
    name: str,
    *,
    N: int = 50,
    H: int = 300,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> PaperSetup:
    """bench.py's BENCH_SYSTEM=<name> setup: configs/<name>.yaml, read by
    utils.config.load_config and built in paper mode (reg 1e-6, and the file's tol,
    alphas, iteration caps, weights, eps and adaptation; x0 from the file or the
    registry's default_x0), with N and H replaced."""
    return config_setup(_family_config(name), N=N, H=H, device=device, dtype=dtype)


def family_coupled_setup(
    name: str,
    *,
    N: int = 50,
    H: int = 300,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> Tuple[PaperSetup, RawNominalTheta, RawAuxTheta]:
    """config_coupled_setup of configs/<name>.yaml."""
    return config_coupled_setup(_family_config(name), N=N, H=H, device=device, dtype=dtype)
