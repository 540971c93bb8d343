"""Carry a setup and a closed-loop state across from numpy.

The JAX package's objects reach the port as numpy arrays and Python numbers (for
example ``np.asarray`` of each leaf of a ``DubinsPaperSetup``), so both packages
can run on the same numbers. Containers may be mappings or objects with the same
attribute names.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from .device import DeviceLike, resolve_device, resolve_dtype
from .ops.costs import CostWeights
from .ops.dbas import BarrierParams
from .presets import DubinsPaperSetup, build_dubins_setup
from .systems.dubins import DubinsConfig
from .tube.closed_loop import TubeMPCConfig
from .tube.lane_closed_loop import GenericLaneState, LaneLoopState
from .tube.params import AdaptConfig, AuxAdapt, RawAuxTheta, RawNominalTheta


def _get(obj: Any, key: str) -> Any:
    return obj[key] if isinstance(obj, Mapping) else getattr(obj, key)


def _has(obj: Any, key: str) -> bool:
    return key in obj if isinstance(obj, Mapping) else hasattr(obj, key)


def setup_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> DubinsPaperSetup:
    """A DubinsPaperSetup from ``d`` with: cfg (N, H, nominal_max_iter, aux_max_iter,
    tol, reg, alphas, adapt{lr, momentum, steps, grad_clip_norm, project}, and
    optionally adapt_nominal, adapt_ancillary, coupling),
    w_nominal{Q, R, Qf, qb}, aux_init{Q, R, qb}, bp{alpha, gamma, tight}, x0,
    target, centers [M, 2], radii [M], beta, eps, and optionally dubins (the
    DubinsConfig fields; default dt=0.01)."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype)

    def t(v):
        return torch.tensor(np.array(v), dtype=dtype, device=dev)

    c, a = _get(d, "cfg"), _get(_get(d, "cfg"), "adapt")
    cfg = TubeMPCConfig(
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
    wn, ai, bp = _get(d, "w_nominal"), _get(d, "aux_init"), _get(d, "bp")
    dubins = DubinsConfig(dt=0.01)
    if _has(d, "dubins"):
        dc = _get(d, "dubins")
        dubins = DubinsConfig(**{f: (tuple(float(x) for x in _get(dc, f))
                                     if f in ("w_low", "w_high", "x_target") else float(_get(dc, f)))
                                 for f in DubinsConfig.__dataclass_fields__ if _has(dc, f)})
    return build_dubins_setup(
        cfg=cfg,
        w_nominal=CostWeights(Q=t(_get(wn, "Q")), R=t(_get(wn, "R")), Qf=t(_get(wn, "Qf")),
                              qb=t(_get(wn, "qb"))),
        aux_init=AuxAdapt(Q=t(_get(ai, "Q")), R=t(_get(ai, "R")), qb=t(_get(ai, "qb"))),
        bp=BarrierParams(alpha=t(_get(bp, "alpha")), gamma=t(_get(bp, "gamma")),
                         tight=t(_get(bp, "tight"))),
        x0=t(_get(d, "x0")),
        target=t(_get(d, "target")),
        centers=t(_get(d, "centers")),
        radii=t(_get(d, "radii")),
        beta=float(_get(d, "beta")),
        eps=float(_get(d, "eps")),
        dubins=dubins,
    )


def lane_state_from_numpy(d: Any, device: DeviceLike = None, dtype=torch.float32) -> LaneLoopState:
    """A LaneLoopState from ``d`` with x, b, x_bar, b_bar, U_nom_ws, U_aux_ws and
    adapt{Q, R, qb}, vel{Q, R, qb}."""
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
