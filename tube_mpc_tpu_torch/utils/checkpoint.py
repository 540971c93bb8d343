"""Checkpoint and resume for long closed-loop runs (port of
tube_mpc_tpu/utils/checkpoint.py).

``run_steps`` is the step loop of the closed loops (tube/closed_loop.py's paper loop,
tube/lane_closed_loop.py's paper and generic loops, and the sharded paper loop, whose
ranks each step their own lanes: ``LaneShards``). Given a ``ckpt_dir`` it runs in
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
state file is never read without its logs or half written. A sharded run's checkpoint holds
the whole run's carry and logs, gathered from every rank and written by rank 0, so it is
resumed on the same number of ranks, each of which takes its own lanes of it.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Type

import numpy as np
import torch
import torch.distributed as dist
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


def _map_leaves(fn, tree, path: str = ""):
    """The tree with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        items = [_map_leaves(fn, v, path + (f".{names[i]}" if names else f"[{i}]"))
                 for i, v in enumerate(tree)]
        return type(tree)(*items) if names else tuple(items)
    return fn(path, tree)


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


class LaneShards(NamedTuple):
    """A sharded run's split of its B lanes over the ranks of ``group``: rank r steps the
    lanes [r·lanes, (r + 1)·lanes). The carry's fields named in ``shared`` (the population
    θ and its velocity) are the same on every rank; every other leaf has the lanes in front."""

    group: Any   # a torch.distributed ProcessGroup
    rank: int
    world: int
    lanes: int   # per rank
    shared: Tuple[str, ...] = ()

    def _per_lane(self, path: str) -> bool:
        return path.split(".")[1] not in self.shared if path.startswith(".") else True

    def local(self, tree):
        """This rank's lanes of a whole-run tree (views)."""
        lo = self.rank * self.lanes
        return _map_leaves(lambda p, v: v[lo:lo + self.lanes] if self._per_lane(p) else v, tree)

    def gather(self, tree):
        """The whole run's tree from every rank's: the lanes of each leaf with lanes in front,
        in rank order, by one all_gather for each dtype; a shared leaf as this rank has it."""
        paths = [p for p, _ in _leaves(tree) if self._per_lane(p)]
        leaves = dict(_leaves(tree))
        whole = {}
        for dtype in dict.fromkeys(leaves[p].dtype for p in paths):
            same = [p for p in paths if leaves[p].dtype == dtype]
            flat = torch.cat([leaves[p].reshape(self.lanes, -1) for p in same], dim=1)
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            dist.all_gather(parts, flat.contiguous(), group=self.group)
            cols = torch.cat(parts, dim=0).split([leaves[p][:1].numel() for p in same], dim=1)
            whole.update({p: c.reshape((-1,) + tuple(leaves[p].shape[1:]))
                          for p, c in zip(same, cols)})
        return _map_leaves(lambda p, v: whole.get(p, v), tree)


def run_steps(step: Callable, state, w: Tensor, log_type: Type, *,
              ckpt_dir: Optional[str] = None, segment_len: Optional[int] = None,
              cfg=None, inputs=None, shards: Optional[LaneShards] = None,
              fingerprint: Optional[dict] = None) -> Tuple[Any, Any]:
    """Run ``step`` (state, w_t) -> (state, log tuple) over the H steps of w [B, H, nx];
    returns (the final state, a ``log_type`` of [B, H, ...]).

    With ``ckpt_dir``, in segments of ``segment_len`` steps, writing the state and the
    logs so far after each, and from the latest checkpoint in ``ckpt_dir`` if there is
    one. The run's fingerprint (w, ``repr(cfg)``, the tree ``inputs``, and the keys of
    ``fingerprint``) is written with each state and must match the checkpoint's to resume
    from it.

    With ``shards``, ``state`` and ``w`` are the whole run's and this rank steps its own
    lanes of them (``step`` built for that many). Each segment's logs are gathered from
    every rank (the whole loop is one segment without ``ckpt_dir``); a checkpoint holds the
    whole carry, gathered too, which rank 0 writes while the others wait at a barrier.
    Every rank returns the whole run's final state and logs."""
    H = w.shape[1]
    t, logs, fp = 0, None, None   # logs: [B, t, ...] per field
    if ckpt_dir is not None:
        if segment_len is None or segment_len < 1:
            raise ValueError(f"segment_len must be >= 1, got {segment_len}")
        fp = dict(_run_fingerprint(w, H, cfg=cfg, inputs=inputs), **(fingerprint or {}))
        ck = latest_checkpoint(ckpt_dir)
        if ck is not None:
            _check_fingerprint(ck, fp)
            state, t = load_state(ck, state)
            with np.load(_logs_path(ck)) as z:
                logs = [torch.as_tensor(z[f], device=w.device).transpose(0, 1)
                        for f in log_type._fields]
    if shards is not None:
        state, w = shards.local(state), shards.local(w)
    while t < H:
        seg = []
        for k in range(t, H if fp is None else min(t + segment_len, H)):
            state, log = step(state, w[:, k])
            seg.append(log)
        t += len(seg)
        new = [torch.stack(field, dim=1) for field in zip(*seg)]
        if shards is not None:
            new = list(shards.gather(tuple(new)))
        logs = new if logs is None else [torch.cat([a, b], dim=1) for a, b in zip(logs, new)]
        if fp is not None:
            whole = state if shards is None else shards.gather(state)
            if shards is None or shards.rank == 0:
                os.makedirs(ckpt_dir, exist_ok=True)
                _write_npz(os.path.join(ckpt_dir, f"logs_{t}.npz"),   # time-major, as JAX's
                           {f: np.ascontiguousarray(v.detach().cpu().numpy().swapaxes(0, 1))
                            for f, v in zip(log_type._fields, logs)})
                save_state(os.path.join(ckpt_dir, f"state_{t}.npz"), whole, step=t, extra=fp)
            if shards is not None:
                dist.barrier(group=shards.group)
    if shards is not None:
        state = shards.gather(state)
    return state, log_type(*(v.contiguous() for v in logs))
