"""The shipped paper configurations: Dubins (port of tube_mpc_tpu/presets.py:22-86) and
the double integrator, the planar quadrotor and the cart-pole as bench.py runs them
(BENCH_SYSTEM, bench.py:143-181: ``build_experiment(load_config(configs/<name>.yaml),
paper_mode=True)`` with N and H replaced)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from .device import DeviceLike, resolve_device, resolve_dtype
from .ops.costs import CostWeights
from .ops.dbas import AugmentedDynamics, BarrierParams, make_augmented
from .ops.lanes import ComponentSystem, dubins_components
from .systems import registry
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
class PaperSetup:
    """A paper experiment. ``sys_c`` is the component form the lane kernels run
    (the same obstacles, beta and bounds as ``system``); ``field`` holds the circle
    obstacles (None for the cart-pole); ``eps`` is the barrier floor."""

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


# The shipped configs/<name>.yaml of each family, as bench.py runs them (BENCH_SYSTEM):
# the numbers the JAX package reads from each file, held here as Python constants
# (tests/test_torch_family_setup.py pins each against the JAX package's reading of the
# file). Every family runs the inverse barrier with alpha, gamma and the tightening 0,
# eps 1e-4, the smooth-min with beta 20 where it has obstacles, and tol 1e-3.
FAMILY_CONFIGS: Dict[str, Dict[str, Any]] = {
    "double_integrator": dict(
        dt=0.05, nominal_max_iter=10, aux_max_iter=15, alphas=(1.0, 0.5, 0.25, 0.1, 0.0),
        control_bounds={"a_max": 5.0}, extra={},
        w_low=(-0.02,) * 4, w_high=(0.02,) * 4, target=(10.0, 10.0, 0.0, 0.0), x0=None,
        obstacles=(((4.0, 4.0), 1.2), ((7.0, 6.5), 1.0)),
        Q=(1.0, 1.0, 0.1, 0.1), R=(0.1, 0.1), qb=1.0, Qf=(100.0, 100.0, 10.0, 10.0),
        aux_Q=(1.0, 1.0, 1.0, 1.0), aux_R=(1.0, 1.0), aux_qb=1.0, lr=1e-2,
    ),
    "quadrotor2d": dict(
        dt=0.02, nominal_max_iter=10, aux_max_iter=15,
        alphas=(1.0, 0.5, 0.25, 0.1, 0.05, 0.0),
        control_bounds={"t_min": 0.0, "t_max": 8.0}, extra={},
        w_low=(-0.02,) * 6, w_high=(0.02,) * 6, target=(8.0, 8.0, 0.0, 0.0, 0.0, 0.0), x0=None,
        obstacles=(((3.0, 3.0), 1.0), ((5.5, 5.0), 1.0), ((3.5, 6.5), 0.8), ((6.5, 2.5), 0.8)),
        Q=(1.0, 1.0, 0.5, 0.1, 0.1, 0.1), R=(0.05, 0.05), qb=1.0,
        Qf=(200.0, 200.0, 50.0, 10.0, 10.0, 10.0),
        aux_Q=(1.0,) * 6, aux_R=(1.0, 1.0), aux_qb=1.0, lr=1e-3,
    ),
    "cartpole": dict(
        dt=0.02, nominal_max_iter=15, aux_max_iter=15,
        alphas=(1.0, 0.5, 0.25, 0.1, 0.05, 0.0),
        control_bounds={"f_max": 20.0}, extra={"x_lim": 2.4},
        w_low=(-0.01,) * 4, w_high=(0.01,) * 4, target=(0.0, 0.0, 0.0, 0.0),
        x0=(0.0, 0.0, 3.0, 0.0), obstacles=(),
        Q=(1.0, 0.1, 5.0, 0.1), R=(0.01,), qb=0.1, Qf=(10.0, 1.0, 50.0, 1.0),
        aux_Q=(1.0,) * 4, aux_R=(1.0,), aux_qb=0.1, lr=1e-4,
    ),
}
FAMILY_ADAPT = dict(momentum=0.9, steps=1, grad_clip_norm=1.0, project=True)
FAMILY_EPS, FAMILY_BETA = 1e-4, 20.0


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


def family_paper_setup(
    name: str,
    *,
    N: int = 50,
    H: int = 300,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> PaperSetup:
    """bench.py's BENCH_SYSTEM=<name> setup: configs/<name>.yaml in paper mode (reg
    1e-6, tol 1e-3, the file's alphas, iteration caps, weights and adaptation) with N and
    H replaced; x0 from the file (cart-pole) or the registry's default_x0."""
    if name not in FAMILY_CONFIGS:
        raise ValueError(f"no paper setup for {name!r}; have {sorted(FAMILY_CONFIGS)}")
    c = FAMILY_CONFIGS[name]
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    cfg = TubeMPCConfig(
        N=N, H=H, nominal_max_iter=c["nominal_max_iter"], aux_max_iter=c["aux_max_iter"],
        tol=1e-3, reg=1e-6, alphas=tuple(c["alphas"]),
        adapt=AdaptConfig(lr=c["lr"], **FAMILY_ADAPT),
    )
    nx = len(c["target"])
    x0 = t(c["x0"]) if c["x0"] is not None else registry.default_x0(
        name, nx, device=dev, dtype=dtype)
    return build_family_setup(
        name, cfg=cfg,
        w_nominal=CostWeights.create(c["Q"], c["R"], c["Qf"], c["qb"], device=dev, dtype=dtype),
        aux_init=AuxAdapt(Q=t(c["aux_Q"]), R=t(c["aux_R"]), qb=t(c["aux_qb"])),
        bp=BarrierParams.create(0.0, 0.0, 0.0, device=dev, dtype=dtype),
        x0=x0, target=t(c["target"]), dt=c["dt"], control_bounds=c["control_bounds"],
        w_low=c["w_low"], w_high=c["w_high"], obstacles=c["obstacles"], beta=FAMILY_BETA,
        eps=FAMILY_EPS, extra=c["extra"],
    )
