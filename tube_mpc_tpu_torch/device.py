"""Device and dtype resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no card and
no ``device="cpu"`` they raise, so a run never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Iterable, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def resolve_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}: use torch.float32 or torch.float64")
    return dtype


def check_on(device: torch.device, tensors: Iterable[torch.Tensor], what: str) -> None:
    """Raise unless every tensor lies on ``device`` (cuda:0 and cuda match)."""
    for t in tensors:
        if t.device.type != device.type or (
            device.index is not None and t.device.index not in (None, device.index)
        ):
            raise ValueError(f"{what}: a tensor lies on {t.device}, expected {device}")
