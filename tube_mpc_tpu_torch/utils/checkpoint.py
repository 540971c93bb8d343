"""Checkpoint and resume for long closed-loop runs (port of
tube_mpc_tpu/utils/checkpoint.py:1-292, 420-513).

``run_steps`` is the step loop of the closed loops (tube/closed_loop.py's paper loop,
tube/lane_closed_loop.py's paper and generic loops). Given a ``ckpt_dir`` it runs in
segments of ``segment_len`` steps: after each segment the whole carry (states, warm
starts, θ and momentum) and the logs so far are written there, so that a killed run,
started again with the same ``ckpt_dir``, resumes after the last segment written. The
loops draw the disturbances of the whole run up front, so a resumed run consumes the same
stream. The steps are the same with or without a ``ckpt_dir``, so a segmented run's
results are bitwise those of the monolithic run, resumed or not.

The files are the JAX package's: ``state_<t>.npz`` (a flat .npz of leaf path -> array,
with ``__step__``), its run fingerprint in ``state_<t>.npz.meta.json``, and
``logs_<t>.npz`` (each ClosedLoopLog field, time-major [t, B, ...]). Leaf paths are those
that ``jax.tree_util.keystr`` gives the same named tuples: ".x", ".adapt.Q", "[0].x".
Each file is written whole under a temporary name and then renamed, logs first, so that a
state file is never read without its logs or half written.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch
from torch import Tensor


def _leaves(tree, path: str = ""):
    """(path, leaf) of every leaf: a named tuple's fields as ".name", a tuple's items as
    "[i]"."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f".{names[i]}" if names else f"[{i}]"))
    else:
        yield path, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: torch.as_tensor(v).detach().cpu().numpy() for k, v in _leaves(tree)}


def _unflatten(template, flat: Dict[str, np.ndarray], path: str = ""):
    """The tree of ``template`` with each leaf from ``flat``, in the dtype and on the
    device of the template's leaf."""
    if isinstance(template, tuple):
        names = getattr(template, "_fields", None)
        items = [_unflatten(v, flat, path + (f".{names[i]}" if names else f"[{i}]"))
                 for i, v in enumerate(template)]
        return type(template)(*items) if names else tuple(items)
    if path not in flat:
        raise KeyError(f"checkpoint missing leaf {path}")
    return torch.as_tensor(flat[path], dtype=template.dtype, device=template.device)


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_state(path: str, state, *, step: int, extra: Optional[dict] = None) -> None:
    """Write ``state`` (a tree of tensors) and its step to ``path`` (.npz), and ``extra``
    to ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if extra is not None:
        with open(path + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(extra, f)
    _write_npz(path, dict(_flatten(state), __step__=np.asarray(step)))


def load_state(path: str, template) -> Tuple[Any, int]:
    """(the state of ``path`` in the tree, dtypes and devices of ``template``, its step)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__step__"}
        step = int(z["__step__"])
    return _unflatten(template, flat), step


def _logs_path(state_path: str) -> str:
    """The logs file of a state file: the base name's "state_" becomes "logs_" (not a
    directory's)."""
    d, base = os.path.split(state_path)
    return os.path.join(d, base.replace("state_", "logs_", 1))


def _sha1(*chunks: bytes) -> str:
    h = hashlib.sha1()
    for c in chunks:
        h.update(c)
    return h.hexdigest()[:16]


def _run_fingerprint(w, H: int, *, cfg=None, inputs=None) -> dict:
    """The identity of a checkpointed run: the disturbances' shape and hash, and the
    hashes of the run's config (its repr) and of its inputs (the initial carry with θ,
    the fixed references), so that a run resumed in another run's directory is refused
    instead of joining inconsistent logs."""
    arr = torch.as_tensor(w).detach().cpu().numpy()
    fp = {"H": int(H), "w_shape": list(arr.shape), "w_sha1": _sha1(arr.tobytes())}
    if cfg is not None:
        fp["cfg_sha1"] = _sha1(repr(cfg).encode())
    if inputs is not None:
        flat = _flatten(inputs)
        fp["inputs_sha1"] = _sha1(*(b for k in sorted(flat) for b in (
            k.encode(), str(flat[k].dtype).encode(), str(flat[k].shape).encode(),
            np.ascontiguousarray(flat[k]).tobytes())))
    return fp


def _check_fingerprint(ck: str, fp: dict) -> None:
    meta_path = ck + ".meta.json"
    if not os.path.exists(meta_path):
        return  # a checkpoint written without a fingerprint: the caller's to vouch for
    with open(meta_path, "r", encoding="utf-8") as f:
        saved = json.load(f)
    if saved != fp:
        raise ValueError(
            f"checkpoint {ck} was written by a different run: saved {saved} vs "
            f"current {fp}. Point ckpt_dir elsewhere or delete the stale checkpoints.")


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The state file of the latest step in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"state_(\d+)\.npz", f)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), os.path.join(ckpt_dir, f)
    return best


def run_steps(step: Callable, state, w: Tensor, log_type: Type, *,
              ckpt_dir: Optional[str] = None, segment_len: Optional[int] = None,
              cfg=None, inputs=None) -> Tuple[Any, Any]:
    """Run ``step`` (state, w_t) -> (state, log tuple) over the H steps of w [B, H, nx];
    returns (the final state, a ``log_type`` of [B, H, ...]).

    With ``ckpt_dir``, in segments of ``segment_len`` steps, writing the state and the
    logs so far after each, and from the latest checkpoint in ``ckpt_dir`` if there is
    one. The run's fingerprint (w, ``repr(cfg)``, the tree ``inputs``) is written with
    each state and must match the checkpoint's to resume from it."""
    H = w.shape[1]
    t, logs, fp = 0, None, None   # logs: [B, t, ...] per field
    if ckpt_dir is not None:
        if segment_len is None or segment_len < 1:
            raise ValueError(f"segment_len must be >= 1, got {segment_len}")
        fp = _run_fingerprint(w, H, cfg=cfg, inputs=inputs)
        ck = latest_checkpoint(ckpt_dir)
        if ck is not None:
            _check_fingerprint(ck, fp)
            state, t = load_state(ck, state)
            with np.load(_logs_path(ck)) as z:
                logs = [torch.as_tensor(z[f], device=w.device).transpose(0, 1)
                        for f in log_type._fields]
    while t < H:
        seg = []
        for k in range(t, H if fp is None else min(t + segment_len, H)):
            state, log = step(state, w[:, k])
            seg.append(log)
        t += len(seg)
        new = [torch.stack(field, dim=1) for field in zip(*seg)]
        logs = new if logs is None else [torch.cat([a, b], dim=1) for a, b in zip(logs, new)]
        if fp is not None:
            os.makedirs(ckpt_dir, exist_ok=True)
            _write_npz(os.path.join(ckpt_dir, f"logs_{t}.npz"),   # time-major, as JAX's
                       {f: np.ascontiguousarray(v.detach().cpu().numpy().swapaxes(0, 1))
                        for f, v in zip(log_type._fields, logs)})
            save_state(os.path.join(ckpt_dir, f"state_{t}.npz"), state, step=t, extra=fp)
    return state, log_type(*(v.contiguous() for v in logs))
