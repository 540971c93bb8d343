"""Numerics debugging (port of tube_mpc_tpu/utils/debug.py:23-89): the reference's
``_ensure_finite`` per phase and for a run's outputs, and its anomaly mode.

- ``located_check``: the finite check of one phase. The JAX package threads it through its
  jitted scan as a checkify check that ``run_checked`` surfaces; in eager PyTorch the
  check runs where it stands and raises FloatingPointError naming the phase, so
  ``run_checked`` is a plain call.
- ``check_finite_log``: the post-hoc check of a run's outputs, leaf by leaf.
- ``debug_nans``: the anomaly-mode switch (torch.autograd's anomaly detection, which
  names the operation whose backward made a NaN).
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) of every tensor or array of a tree of named tuples, tuples, lists and
    dicts, each path as jax.tree_util.keystr writes it (``.field``, ``[i]``, ``['key']``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif tree is not None:
        yield path, tree


def check_finite_log(tree: Any, *, name: str = "log") -> None:
    """Raise FloatingPointError with a located diagnostic if any leaf is non-finite."""
    for loc, leaf in _leaves(tree):
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.all(np.isfinite(a)):
            bad = int((~np.isfinite(a)).sum())
            finite = a[np.isfinite(a)]
            lo = float(finite.min()) if finite.size else float("nan")
            hi = float(finite.max()) if finite.size else float("nan")
            raise FloatingPointError(
                f"[NUMERIC-FAIL] {name}{loc}: {bad} non-finite entries "
                f"(finite range [{lo}, {hi}])"
            )


def located_check(x, phase: str, enabled: bool = True):
    """x, after raising FloatingPointError if it has a non-finite entry and the check is
    enabled (a host read of the check's result)."""
    if enabled and not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError(
            f"[NUMERIC-FAIL] non-finite value in {phase} (reference _ensure_finite "
            "semantics; rerun with debug_nans for op-level location)")
    return x


def run_checked(fn: Callable, *args, **kwargs):
    """Run ``fn`` with its located checks armed: they raise where they stand, so this is
    the call itself (the JAX package's checkify transform has no eager counterpart)."""
    return fn(*args, **kwargs)


def debug_nans(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
