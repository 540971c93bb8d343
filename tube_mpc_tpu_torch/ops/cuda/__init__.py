"""Hand-written CUDA kernels of the lane engine and their launch counts.

KERNELS maps each kernel's name to its wrapper; a wrapper's ``launches`` counts
the times it launched its CUDA kernel (plain-version calls on CPU tensors do not
count).
"""
from __future__ import annotations

from typing import Dict

from .lane_sensitivity import sbwd, sfwd
from .lane_solver import fwd, ric

KERNELS = {"ric": ric, "fwd": fwd, "sbwd": sbwd, "sfwd": sfwd}


def launch_counts() -> Dict[str, int]:
    return {name: w.launches for name, w in KERNELS.items()}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0
