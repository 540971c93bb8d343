"""Typed experiment configuration with the reference's YAML surface (port of
tube_mpc_tpu/utils/config.py).

The same YAML schema (``configs/dubins.yaml``) parses into the same validated dataclasses,
and ``build_experiment`` turns them into the port's objects (System, AugmentedDynamics,
TubeMPCConfig, weights) on one device: the card unless the caller asks for the CPU.
``validate_for_engine`` refuses, before any kernel is built, what the lane kernels do
not take; the feature-major (XLA) engine takes every config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from ..device import DeviceLike, resolve_device
from ..ops.costs import CostWeights
from ..ops.dbas import AugmentedDynamics, BarrierParams, make_augmented
from ..systems import registry
from ..systems.base import System
from ..systems.obstacles import CircleField
from ..tube.closed_loop import TubeMPCConfig
from ..tube.params import AdaptConfig, AuxAdapt


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str = "dubins"
    dt: float = 0.01
    horizon_N: int = 50
    task_horizon_H: int = 300
    nominal_max_iter: int = 10
    aux_max_iter: int = 20
    ilqr_reg: float = 1e-6
    ilqr_tol: float = 1e-3
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    control_bounds: Dict[str, Any] = dataclasses.field(default_factory=dict)
    disturbance: Dict[str, Any] = dataclasses.field(default_factory=dict)
    target: Tuple[float, ...] = (10.0, 10.0, math.pi / 4)
    x0: Optional[Tuple[float, ...]] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class DBaSConfigYaml:
    barrier_type: str = "inverse"
    alpha: float = 0.0
    gamma: float = 0.0
    nominal_tightening: float = 0.0
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class EnvironmentConfig:
    obstacles: Tuple[Dict[str, Any], ...] = ()
    obstacle_smoothmin_beta: float = 20.0
    obstacle_aggregation: str = "min"


@dataclasses.dataclass(frozen=True)
class CostConfig:
    Q: Tuple[float, ...] = (1.0, 1.0, 0.0)
    R: Tuple[float, ...] = (1.0, 1.0)
    q_b: float = 1.0
    Qf: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class AdaptationConfig:
    lr_eta: float = 1e-2
    steps: int = 1
    momentum: float = 0.0
    grad_clip_norm: float = 0.0
    adapt_nominal: bool = True
    adapt_ancillary: bool = True
    project_params: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    system: SystemConfig
    dbas: DBaSConfigYaml
    environment: EnvironmentConfig
    cost_nominal: CostConfig
    cost_auxiliary: CostConfig
    adaptation: AdaptationConfig
    seed: int = 0
    run_name: str = "run"
    out_dir: str = "outputs"
    plot: bool = False
    debug_numerics: bool = False
    use_float64: bool = False
    paper_dubins_mode: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.use_float64 else torch.float32


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _take(d: Dict[str, Any], cls, **overrides):
    """Build dataclass ``cls`` from dict ``d``; unknown keys collect into an ``extra``
    field when the dataclass has one (so system-specific knobs pass through), lists
    become tuples."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs: Dict[str, Any] = {}
    extra: Dict[str, Any] = {}
    for k, v in (d or {}).items():
        if k in fields and k != "extra":
            kwargs[k] = _tuplify(v) if isinstance(v, list) else v
        else:
            extra[k] = v
    if "extra" in fields and extra:
        kwargs["extra"] = extra
    kwargs.update(overrides)
    return cls(**kwargs)


def parse_config(raw: Dict[str, Any]) -> ExperimentConfig:
    """Parse a reference-schema YAML dict into an ExperimentConfig."""
    env = dict(raw.get("environment", {}) or {})
    # a singular `environment.obstacle` is the single-obstacle h, whatever the aggregation
    if "obstacle" in env and not env.get("obstacles"):
        env["obstacles"] = [env.pop("obstacle")]
        env["obstacle_aggregation"] = "single"
    return ExperimentConfig(
        system=_take(raw.get("system", {}), SystemConfig),
        dbas=_take(raw.get("dbas", {}), DBaSConfigYaml),
        environment=_take(env, EnvironmentConfig),
        cost_nominal=_take(raw.get("cost_nominal", {}), CostConfig),
        cost_auxiliary=_take(raw.get("cost_auxiliary", {}), CostConfig),
        adaptation=_take(raw.get("adaptation", {}), AdaptationConfig),
        seed=int(raw.get("seed", 0)),
        run_name=str(raw.get("run_name", "run")),
        out_dir=str(raw.get("out_dir", "outputs")),
        plot=bool(raw.get("plot", False)),
        debug_numerics=bool(raw.get("debug_numerics", False)),
        use_float64=bool(raw.get("use_float64", False)),
        paper_dubins_mode=bool(raw.get("paper_dubins_mode", True)),
    )


def read_yaml(path: str) -> Dict[str, Any]:
    """The YAML file at ``path`` as plain Python values (yaml.safe_load)."""
    import yaml

    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def load_config(path: str) -> ExperimentConfig:
    return parse_config(read_yaml(path))


@dataclasses.dataclass(frozen=True)
class BuiltExperiment:
    """Everything the runners need, built from an ExperimentConfig on ``device``."""

    cfg: ExperimentConfig
    system: System
    aug: AugmentedDynamics
    tube_cfg: TubeMPCConfig
    w_nominal: CostWeights
    aux_init: AuxAdapt
    w_aux_full: CostWeights
    bp: BarrierParams
    x0: Tensor
    target: Tensor
    field: Optional[CircleField]
    device: torch.device


#: The lane kernels solve Q_uu in closed form for nu in {1, 2}.
LANE_ENGINE_MAX_NU = 2


def validate_for_engine(built: BuiltExperiment, engine: str) -> None:
    """Refuse, at build time and before any kernel is built, a configuration that the
    engine does not take: with the ROADMAP.md item that would bring it, or, for the
    'single' aggregation, which neither package's lane engine runs, the JAX package's
    reason."""
    if engine != "lanes":
        return
    nu = built.system.nu
    if nu > LANE_ENGINE_MAX_NU:
        raise ValueError(
            f"engine='lanes' supports nu <= {LANE_ENGINE_MAX_NU} control dims (closed-form "
            f"Q_uu inverses in the lane kernels); system {built.cfg.system.name!r} has nu={nu}. "
            "Use --engine xla for this system: it runs the same solver semantics on the "
            "feature-major path."
        )
    env = built.cfg.environment
    if env.obstacles and env.obstacle_aggregation not in ("smoothmin", "min"):
        raise ValueError(
            f"engine='lanes' takes the 'smoothmin' and 'min' obstacle aggregations, not "
            f"{env.obstacle_aggregation!r} (a singular environment.obstacle is 'single'): "
            f"unsupported aggregation for component form: {env.obstacle_aggregation} (the "
            "JAX package's lane engine raises the same when it traces h)."
        )


def lane_components(cfg: ExperimentConfig):
    """The component form (ops/lanes.py) that the lane kernels run for ``cfg``'s system."""
    env = cfg.environment
    return registry.build_components(
        cfg.system.name, dt=cfg.system.dt, control_bounds=dict(cfg.system.control_bounds),
        obstacles=[dict(o) for o in env.obstacles] or None,
        aggregation=env.obstacle_aggregation, beta=env.obstacle_smoothmin_beta,
        extra=dict(cfg.system.extra))


def build_experiment(cfg: ExperimentConfig, *, paper_mode: Optional[bool] = None,
                     device: DeviceLike = None) -> BuiltExperiment:
    """The port's objects of ``cfg`` in ``cfg.dtype`` on ``device`` (the card unless
    device='cpu'). Paper mode, by default, is paper_dubins_mode and not adapt_nominal."""
    dev = resolve_device(device)
    dtype = cfg.dtype
    sc = cfg.system
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)

    field = None
    if cfg.environment.obstacles:
        obs = [dict(o) for o in cfg.environment.obstacles]
        for i, o in enumerate(obs):
            if "center" not in o or "radius" not in o:
                raise ValueError(
                    f"environment obstacle #{i} needs 'center' and 'radius', got {sorted(o)}")
        field = CircleField(centers=t([list(o["center"]) for o in obs]),
                            radii=t([float(o["radius"]) for o in obs]))

    system = registry.build(
        sc.name,
        dt=sc.dt,
        control_bounds=dict(sc.control_bounds),
        disturbance=dict(sc.disturbance),
        target=sc.target,
        obstacles=field,
        aggregation=cfg.environment.obstacle_aggregation,
        beta=cfg.environment.obstacle_smoothmin_beta,
        device=dev,
        dtype=dtype,
        extra=dict(sc.extra),
    )
    aug = make_augmented(system, barrier_type=cfg.dbas.barrier_type, eps=cfg.dbas.eps)

    if paper_mode is None:
        paper_mode = cfg.paper_dubins_mode and not cfg.adaptation.adapt_nominal
    # the reference's paper path pins the solver's reg to 1e-6 and ignores ilqr_reg; its
    # generic path takes ilqr_reg
    reg = 1e-6 if paper_mode else sc.ilqr_reg

    tube_cfg = TubeMPCConfig(
        N=sc.horizon_N,
        H=sc.task_horizon_H,
        nominal_max_iter=sc.nominal_max_iter,
        aux_max_iter=sc.aux_max_iter,
        tol=sc.ilqr_tol,
        reg=reg,
        alphas=tuple(sc.line_search_alphas),
        adapt=AdaptConfig(
            lr=cfg.adaptation.lr_eta,
            momentum=cfg.adaptation.momentum,
            steps=cfg.adaptation.steps,
            grad_clip_norm=cfg.adaptation.grad_clip_norm,
            project=cfg.adaptation.project_params,
        ),
        adapt_nominal=cfg.adaptation.adapt_nominal,
        adapt_ancillary=cfg.adaptation.adapt_ancillary,
    )

    nx, nu = system.nx, system.nu
    cn, ca = cfg.cost_nominal, cfg.cost_auxiliary
    Qf_n = cn.Qf if cn.Qf is not None else tuple(1.0 for _ in range(nx))
    w_nominal = CostWeights.create(list(cn.Q), list(cn.R), list(Qf_n), cn.q_b, device=dev,
                                   dtype=dtype)
    aux_Q = list(ca.Q) if ca.Q else [1.0] * nx
    aux_R = list(ca.R) if ca.R else [1.0] * nu
    aux_init = AuxAdapt(Q=t(aux_Q), R=t(aux_R), qb=t(float(ca.q_b)))
    Qf_a = ca.Qf if ca.Qf is not None else aux_Q
    w_aux_full = CostWeights.create(aux_Q, aux_R, list(Qf_a), ca.q_b, device=dev, dtype=dtype)

    bp = BarrierParams.create(alpha=cfg.dbas.alpha, gamma=cfg.dbas.gamma,
                              tight=cfg.dbas.nominal_tightening, device=dev, dtype=dtype)
    x0 = (t(list(sc.x0)) if sc.x0 is not None
          else registry.default_x0(sc.name, nx, device=dev, dtype=dtype))
    return BuiltExperiment(
        cfg=cfg, system=system, aug=aug, tube_cfg=tube_cfg, w_nominal=w_nominal,
        aux_init=aux_init, w_aux_full=w_aux_full, bp=bp, x0=x0, target=t(list(sc.target)),
        field=field, device=dev,
    )
