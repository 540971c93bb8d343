"""Profiling and tracing helpers (port of tube_mpc_tpu/utils/profiling.py).

- ``trace(log_dir)``: a context manager around ``torch.profiler.profile`` that writes a
  Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``, which TensorBoard's profiler plugin
  and chrome://tracing read) of everything run inside into ``log_dir``: host activity,
  and the card's kernels when the run is on the card.
- ``annotate(name)``: a named host range that shows in the trace, on the clock of the
  card's kernel rows, and costs well under a microsecond with no profiler on. The program's
  spans at its layer boundaries (``tube.*``, ``lane.*``, ``kernel.*``) are these. The JAX
  package's ``annotate`` is a ``jax.profiler.TraceAnnotation``, a user range; this one is
  a function-scope range on purpose (see its docstring).
- ``Timer``: named wall-clock phases, synchronised with the card where asked.
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Dict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from ..device import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None):
    """Profile the body and write its trace into ``log_dir``. On the card (the default;
    ``device="cpu"`` for a run on the CPU) the trace holds the device's kernels too: the
    card's work is synchronised at the end, and a profile with no device activity (the
    profiler could not record it) raises RuntimeError instead of writing a trace of the
    host alone."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(e.device_type == torch.autograd.DeviceType.CUDA
                                      for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity on the card; no trace "
                           "written")
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named range of the trace, as a context manager: recorded when a profiler is on, a
    near no-op (~0.5 µs) when none is. It is a function-scope range, with the timestamps of
    the trace's host rows, and it is recorded on the host only. A user-scope range
    (``torch.profiler.record_function``) costs ~20 times as much with the profiler off, and
    under CUPTI it also gets a device-side annotation row, which a reading of the card's busy
    time would count as work."""
    return _RecordFunctionFast(name)


def _cuda_devices(tree) -> set:
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(v) for v in tree)) if tree else set()
    if isinstance(tree, dict):
        return _cuda_devices(list(tree.values()))
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return {tree.device}
    return set()


class Timer:
    """Named wall-clock phases, synchronised with the card:

        timer = Timer()
        with timer.phase("first"):
            out = fn(x)
        with timer.phase("steady", sync=out):
            out = fn(x)
        print(timer.report())
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None):
        """Time the body; where ``sync`` is a CUDA tensor or a tree of tensors that holds
        one, wait for the card before reading the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(sync):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} total={total * 1e3:9.2f}ms  n={n}  mean={total / n * 1e3:9.2f}ms")
        return "\n".join(lines)
