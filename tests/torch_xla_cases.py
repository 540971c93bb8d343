"""Shared setups of the feature-major (XLA) engine's port tests: one YAML, built by both
packages' utils.config.build_experiment in f64 on the CPU, so both run on the same numbers;
the disturbances are drawn once with numpy within the config's bounds."""
import copy
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
import yaml

from tube_mpc_tpu.tube.params import RawAuxTheta as JRawAuxTheta
from tube_mpc_tpu.tube.params import RawNominalTheta as JRawNominalTheta
from tube_mpc_tpu.utils.config import build_experiment as j_build_experiment
from tube_mpc_tpu.utils.config import parse_config as j_parse_config

from tube_mpc_tpu_torch.runners import raw_thetas
from tube_mpc_tpu_torch.utils.config import build_experiment, parse_config

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


def raw_of(name, N, H, **changes):
    """configs/<name>.yaml in f64 with N and H replaced and "section.key" (or top-level
    "key") changes; None deletes the key."""
    with open(REPO / "configs" / f"{name}.yaml", "r", encoding="utf-8") as f:
        raw = copy.deepcopy(yaml.safe_load(f))
    raw["use_float64"] = True
    raw["system"]["horizon_N"], raw["system"]["task_horizon_H"] = N, H
    for key, value in changes.items():
        section, leaf = key.split(".") if "." in key else (None, key)
        section = raw if section is None else raw[section]
        if value is None:
            section.pop(leaf)
        else:
            section[leaf] = value
    return raw


def built_pair(raw, paper_mode=None):
    """(the JAX package's BuiltExperiment, the port's on the CPU) of one YAML."""
    return (j_build_experiment(j_parse_config(raw), paper_mode=paper_mode),
            build_experiment(parse_config(raw), paper_mode=paper_mode, device="cpu"))


def disturbances(raw, B, H, seed):
    """[B, H, nx] uniform within the config's disturbance bounds."""
    lo = np.asarray(raw["system"]["disturbance"]["w_low"])
    hi = np.asarray(raw["system"]["disturbance"]["w_high"])
    return np.random.default_rng(seed).uniform(lo, hi, size=(B, H, len(lo)))


def raws_pair(raw):
    """(JAX raw θ̄, θ; the port's) of the runners' initial raw parameters."""
    nom, aux = raw_thetas(parse_config(raw), torch.device("cpu"))
    j = lambda tree, cls: cls(*(jnp.asarray(v.numpy()) for v in tree))
    return (j(nom, JRawNominalTheta), j(aux, JRawAuxTheta)), (nom, aux)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(port, ref, rtol, atol, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=what)
