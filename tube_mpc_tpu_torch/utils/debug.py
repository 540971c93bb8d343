"""Located finite check of a whole run (port of tube_mpc_tpu/utils/debug.py::check_finite_log,
the reference's ``_ensure_finite`` for a run's outputs)."""
from __future__ import annotations

from typing import Any

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
