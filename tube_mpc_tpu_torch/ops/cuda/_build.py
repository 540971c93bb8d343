"""Build and load the lane kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` once for each component system the
kernels take (``FAMILIES``), with ``-DLANE_SYSTEM=<its index>``, into a shared library
with a plain C interface, ``tube_mpc_tpu_torch/_build/lib<library>_<digest>.so``:
``<source>`` for Dubins (the default without the define), ``<source>_<family>`` for
the others. A library is built at first use, so a run builds only its own system's,
and loaded with ``ctypes``. The digest covers the source, the shared header and the
flags, so an edited source is rebuilt. Several libraries build in parallel, one
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
from typing import Dict, Iterable, Tuple

from ..lanes import FAMILIES

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



def library_name(source: str, family: str = "dubins") -> str:
    return source if family == "dubins" else f"{source}_{family}"


# library name: (source, family)
LIBRARIES: Dict[str, Tuple[str, str]] = {
    library_name(src, fam): (src, fam) for fam in FAMILIES for src in SOURCES}

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


def flags(name: str) -> Tuple[str, ...]:
    """nvcc's flags for library ``name``."""
    family = LIBRARIES[name][1]
    return NVCC_FLAGS if family == "dubins" else NVCC_FLAGS + (
        f"-DLANE_SYSTEM={FAMILIES.index(family)}",)


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{LIBRARIES[name][0]}.cu"] + [CSRC / hdr for hdr in HEADERS]:
        h.update(path.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, float]:
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
        cmd = [nvcc, *flags(name), "-o", tmp, str(CSRC / f"{LIBRARIES[name][0]}.cu")]
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
    """The loaded library ``name`` (see LIBRARIES), built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
