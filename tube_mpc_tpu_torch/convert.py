"""Carry a setup, parameters and a closed-loop state across from numpy.

The JAX package's objects reach the port as numpy arrays and Python numbers (for
example ``np.asarray`` of each leaf of a paper setup, Dubins' or a family's), so both
packages can run on the same numbers. Containers may be mappings or objects with the same
attribute names (a JAX named tuple of numpy leaves is one). The JAX feature-major (XLA)
states are per scenario; stack them along a new first axis (B lanes) before.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from .device import DeviceLike, resolve_device, resolve_dtype
from .ops.costs import CostWeights
from .ops.dbas import BarrierParams
from .parallel.scenarios import PopulationState
from .presets import PaperSetup, build_dubins_setup, build_family_setup
from .systems.dubins import DubinsConfig
from .tube.closed_loop import (
    GenericLoopState,
    NominalRecedingState,
    PaperLoopState,
    TubeMPCConfig,
)
from .tube.lane_closed_loop import GenericLaneState, LaneLoopState
from .tube.params import AdaptConfig, AuxAdapt, RawAuxTheta, RawNominalTheta
from .tube.problem import AuxTheta, NominalTheta


def _get(obj: Any, key: str) -> Any:
    return obj[key] if isinstance(obj, Mapping) else getattr(obj, key)


def _has(obj: Any, key: str) -> bool:
    return key in obj if isinstance(obj, Mapping) else hasattr(obj, key)


def _cfg_from(c: Any) -> TubeMPCConfig:
    a = _get(c, "adapt")
    return TubeMPCConfig(
        N=int(_get(c, "N")), H=int(_get(c, "H")),
        nominal_max_iter=int(_get(c, "nominal_max_iter")),
        aux_max_iter=int(_get(c, "aux_max_iter")),
        tol=float(_get(c, "tol")), reg=float(_get(c, "reg")),
        alphas=tuple(float(x) for x in _get(c, "alphas")),
        adapt=AdaptConfig(
            lr=float(_get(a, "lr")), momentum=float(_get(a, "momentum")),
            steps=int(_get(a, "steps")), grad_clip_norm=float(_get(a, "grad_clip_norm")),
            project=bool(_get(a, "project")),
        ),
        **{f: (str if f == "coupling" else bool)(_get(c, f))
           for f in ("adapt_nominal", "adapt_ancillary", "coupling") if _has(c, f)},
    )


def _weights_from(d: Any, t):
    """(w_nominal, aux_init, bp) of ``d``."""
    wn, ai, bp = _get(d, "w_nominal"), _get(d, "aux_init"), _get(d, "bp")
    return (CostWeights(Q=t(_get(wn, "Q")), R=t(_get(wn, "R")), Qf=t(_get(wn, "Qf")),
                        qb=t(_get(wn, "qb"))),
            AuxAdapt(Q=t(_get(ai, "Q")), R=t(_get(ai, "R")), qb=t(_get(ai, "qb"))),
            BarrierParams(alpha=t(_get(bp, "alpha")), gamma=t(_get(bp, "gamma")),
                          tight=t(_get(bp, "tight"))))


def setup_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> PaperSetup:
    """A Dubins PaperSetup from ``d`` with: cfg (N, H, nominal_max_iter, aux_max_iter,
    tol, reg, alphas, adapt{lr, momentum, steps, grad_clip_norm, project}, and
    optionally adapt_nominal, adapt_ancillary, coupling),
    w_nominal{Q, R, Qf, qb}, aux_init{Q, R, qb}, bp{alpha, gamma, tight}, x0,
    target, centers [M, 2], radii [M], beta, eps, and optionally dubins (the
    DubinsConfig fields; default dt=0.01)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def t(v):
        return torch.tensor(np.array(v), dtype=dtype, device=dev)

    dubins = DubinsConfig(dt=0.01)
    if _has(d, "dubins"):
        dc = _get(d, "dubins")
        dubins = DubinsConfig(**{f: (tuple(float(x) for x in _get(dc, f))
                                     if f in ("w_low", "w_high", "x_target") else float(_get(dc, f)))
                                 for f in DubinsConfig.__dataclass_fields__ if _has(dc, f)})
    w_nominal, aux_init, bp = _weights_from(d, t)
    return build_dubins_setup(
        cfg=_cfg_from(_get(d, "cfg")), w_nominal=w_nominal, aux_init=aux_init, bp=bp,
        x0=t(_get(d, "x0")),
        target=t(_get(d, "target")),
        centers=t(_get(d, "centers")),
        radii=t(_get(d, "radii")),
        beta=float(_get(d, "beta")),
        eps=float(_get(d, "eps")),
        dubins=dubins,
    )


def family_setup_from_numpy(name: str, d: Any, device: DeviceLike = None,
                            dtype=torch.float32) -> PaperSetup:
    """A PaperSetup of family ``name`` from ``d`` with: cfg, w_nominal, aux_init, bp, x0
    and target as setup_from_numpy takes them, and the system's dt, control_bounds
    {name: bound}, w_low, w_high, centers [M, 2] and radii [M] (M may be 0), beta, eps
    and optionally extra (e.g. {"x_lim": ..} of the cart-pole)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def t(v):
        return torch.tensor(np.array(v), dtype=dtype, device=dev)

    w_nominal, aux_init, bp = _weights_from(d, t)
    centers = np.asarray(_get(d, "centers"), dtype=np.float64).reshape(-1, 2)
    radii = np.asarray(_get(d, "radii"), dtype=np.float64).reshape(-1)
    return build_family_setup(
        name, cfg=_cfg_from(_get(d, "cfg")), w_nominal=w_nominal, aux_init=aux_init, bp=bp,
        x0=t(_get(d, "x0")), target=t(_get(d, "target")), dt=float(_get(d, "dt")),
        control_bounds={k: float(v) for k, v in dict(_get(d, "control_bounds")).items()},
        w_low=[float(v) for v in _get(d, "w_low")], w_high=[float(v) for v in _get(d, "w_high")],
        obstacles=[(tuple(c), float(r)) for c, r in zip(centers.tolist(), radii.tolist())],
        beta=float(_get(d, "beta")), eps=float(_get(d, "eps")),
        extra=dict(_get(d, "extra")) if _has(d, "extra") else None,
    )


def lane_state_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> LaneLoopState:
    """A LaneLoopState from ``d`` with x, b, x_bar, b_bar, U_nom_ws, U_aux_ws and
    adapt{Q, R, qb}, vel{Q, R, qb}: per lane ([B, nx], [B, nu], [B]), or shared in
    population mode ([nx], [nu], [])."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def t(v):
        return torch.tensor(np.array(v), dtype=dtype, device=dev)

    def aux(o):
        return AuxAdapt(Q=t(_get(o, "Q")), R=t(_get(o, "R")), qb=t(_get(o, "qb")))

    return LaneLoopState(
        x=t(_get(d, "x")), b=t(_get(d, "b")), x_bar=t(_get(d, "x_bar")), b_bar=t(_get(d, "b_bar")),
        U_nom_ws=t(_get(d, "U_nom_ws")), U_aux_ws=t(_get(d, "U_aux_ws")),
        adapt=aux(_get(d, "adapt")), vel=aux(_get(d, "vel")),
    )


def raw_aux_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> RawAuxTheta:
    """A RawAuxTheta from ``d`` with Q_raw, R_raw, Qf_raw, qb_raw, alpha_raw, gamma_raw."""
    return _raw_from_numpy(RawAuxTheta, d, device, dtype)


def raw_nom_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> RawNominalTheta:
    """A RawNominalTheta from ``d`` with the RawAuxTheta fields and tight_raw."""
    return _raw_from_numpy(RawNominalTheta, d, device, dtype)


def _raw_from_numpy(cls, d: Any, device: DeviceLike, dtype):
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    return cls(*(torch.tensor(np.array(_get(d, f)), dtype=dtype, device=dev) for f in cls._fields))


def generic_lane_state_from_numpy(d: Any, device: DeviceLike = None,
                                  dtype=torch.float32) -> GenericLaneState:
    """A GenericLaneState from ``d`` with x, b, x_bar, b_bar, U_nom_ws, U_aux_ws,
    raw_aux and vel_aux (RawAuxTheta fields), raw_nom and vel_nom (RawNominalTheta
    fields)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def t(v):
        return torch.tensor(np.array(v), dtype=dtype, device=dev)

    return GenericLaneState(
        x=t(_get(d, "x")), b=t(_get(d, "b")), x_bar=t(_get(d, "x_bar")), b_bar=t(_get(d, "b_bar")),
        U_nom_ws=t(_get(d, "U_nom_ws")), U_aux_ws=t(_get(d, "U_aux_ws")),
        raw_aux=raw_aux_from_numpy(_get(d, "raw_aux"), dev, dtype),
        vel_aux=raw_aux_from_numpy(_get(d, "vel_aux"), dev, dtype),
        raw_nom=raw_nom_from_numpy(_get(d, "raw_nom"), dev, dtype),
        vel_nom=raw_nom_from_numpy(_get(d, "vel_nom"), dev, dtype),
    )


def _tensor_fn(device: DeviceLike, dtype):
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)
    return lambda v: torch.tensor(np.array(v), dtype=dtype, device=dev)


def cost_weights_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> CostWeights:
    """CostWeights from ``d`` with Q, R, Qf, qb."""
    t = _tensor_fn(device, dtype)
    return CostWeights(*(t(_get(d, f)) for f in CostWeights._fields))


def barrier_params_from_numpy(d: Any, device: DeviceLike = None,
                              dtype=torch.float32) -> BarrierParams:
    """BarrierParams from ``d`` with alpha, gamma, tight."""
    t = _tensor_fn(device, dtype)
    return BarrierParams(*(t(_get(d, f)) for f in BarrierParams._fields))


def aux_adapt_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> AuxAdapt:
    """AuxAdapt from ``d`` with Q, R, qb."""
    t = _tensor_fn(device, dtype)
    return AuxAdapt(*(t(_get(d, f)) for f in AuxAdapt._fields))


def nominal_theta_from_numpy(d: Any, device: DeviceLike = None,
                             dtype=torch.float32) -> NominalTheta:
    """NominalTheta from ``d`` with w{Q, R, Qf, qb} and bp{alpha, gamma, tight}."""
    return NominalTheta(w=cost_weights_from_numpy(_get(d, "w"), device, dtype),
                        bp=barrier_params_from_numpy(_get(d, "bp"), device, dtype))


def aux_theta_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> AuxTheta:
    """AuxTheta from ``d`` with w, bp (as nominal_theta_from_numpy), X_ref and U_ref."""
    t = _tensor_fn(device, dtype)
    return AuxTheta(w=cost_weights_from_numpy(_get(d, "w"), device, dtype),
                    bp=barrier_params_from_numpy(_get(d, "bp"), device, dtype),
                    X_ref=t(_get(d, "X_ref")), U_ref=t(_get(d, "U_ref")))


_STATE_ARRAYS = ("x", "b", "x_bar", "b_bar", "U_nom_ws", "U_aux_ws")


def paper_state_from_numpy(d: Any, device: DeviceLike = None,
                           dtype=torch.float32) -> PaperLoopState:
    """PaperLoopState from ``d`` with x, b, x_bar, b_bar, U_nom_ws, U_aux_ws, adapt{Q, R,
    qb} and vel{Q, R, qb}, each with the lanes in front."""
    t = _tensor_fn(device, dtype)
    return PaperLoopState(*(t(_get(d, f)) for f in _STATE_ARRAYS),
                          adapt=aux_adapt_from_numpy(_get(d, "adapt"), device, dtype),
                          vel=aux_adapt_from_numpy(_get(d, "vel"), device, dtype))


def population_state_from_numpy(d: Any, device: DeviceLike = None,
                                dtype=torch.float32) -> PopulationState:
    """PopulationState (parallel/scenarios.py) from ``d`` with the arrays of
    paper_state_from_numpy, each with the scenarios in front, and the shared adapt{Q, R,
    qb} and vel{Q, R, qb} ([nx], [nu], [])."""
    t = _tensor_fn(device, dtype)
    return PopulationState(*(t(_get(d, f)) for f in _STATE_ARRAYS),
                           adapt=aux_adapt_from_numpy(_get(d, "adapt"), device, dtype),
                           vel=aux_adapt_from_numpy(_get(d, "vel"), device, dtype))


def generic_state_from_numpy(d: Any, device: DeviceLike = None,
                             dtype=torch.float32) -> GenericLoopState:
    """GenericLoopState from ``d`` with the arrays of paper_state_from_numpy and raw_nom,
    raw_aux, vel_nom, vel_aux (the raw θ̄ and θ fields)."""
    t = _tensor_fn(device, dtype)
    return GenericLoopState(
        *(t(_get(d, f)) for f in _STATE_ARRAYS),
        raw_nom=raw_nom_from_numpy(_get(d, "raw_nom"), device, dtype),
        raw_aux=raw_aux_from_numpy(_get(d, "raw_aux"), device, dtype),
        vel_nom=raw_nom_from_numpy(_get(d, "vel_nom"), device, dtype),
        vel_aux=raw_aux_from_numpy(_get(d, "vel_aux"), device, dtype))


def nominal_receding_state_from_numpy(d: Any, device: DeviceLike = None,
                                      dtype=torch.float32) -> NominalRecedingState:
    """NominalRecedingState from ``d`` with t, x, b, U_ws (in dtype), done, success,
    collided (bool) and success_t (int64): the JAX receding scan's carry (t, x, b, U_ws,
    done, success, success_t, collided), each with the lanes in front but t."""
    dev = resolve_device(device)
    t = _tensor_fn(dev, dtype)
    as_ = lambda f, kind: torch.tensor(np.array(_get(d, f)), dtype=kind, device=dev)
    return NominalRecedingState(
        t=as_("t", torch.int64), x=t(_get(d, "x")), b=t(_get(d, "b")), U_ws=t(_get(d, "U_ws")),
        done=as_("done", torch.bool), success=as_("success", torch.bool),
        success_t=as_("success_t", torch.int64), collided=as_("collided", torch.bool))
