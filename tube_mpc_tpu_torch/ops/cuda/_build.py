"""Build and load the lane kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a plain
C interface, ``tube_mpc_tpu_torch/_build/lib<name>_<digest>.so``, at first use,
and loaded with ``ctypes``. The digest covers the source, the shared header and
the flags, so an edited source is rebuilt. Several sources build in parallel, one
``nvcc`` each. Nothing here runs when the package is imported, and a failed build
raises with nvcc's output.

``-fmad=false`` keeps nvcc from contracting a*b+c into one rounding, so a kernel
rounds exactly as its plain PyTorch version does on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lane_solver", "lane_sbwd", "lane_sfwd")
HEADERS = ("lane_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the lane kernels build only where the CUDA toolkit is installed")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + [CSRC / hdr for hdr in HEADERS]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every stale library of ``names`` in parallel; returns seconds per build."""
    pending = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not pending:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name, out in pending.items():
        fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)

    def wait(name):   # the build's log and its own seconds, whichever finishes first
        log, _ = procs[name][0].communicate()
        return log, time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        waited = dict(zip(procs, pool.map(wait, procs)))
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, seconds[name] = waited[name]
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
