"""Build and load the lane kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` once for each variant of the
kernels: a component system (``FAMILIES``, ``-DLANE_SYSTEM=<its index>``), its
obstacle aggregation (``AGGREGATIONS``, ``-DLANE_AGG``; the circle systems only) and
its barrier (``BARRIERS``, ``-DLANE_BARRIER``), into a shared library with a plain C
interface, ``tube_mpc_tpu_torch/_build/lib<library>_<digest>.so``. The variant
``<family>[_min][_log]`` names the non-default policies (the smooth-min and the
inverse barrier are the defaults, without a define); its library is ``<source>`` for
Dubins with the defaults, ``<source>_min_log`` and the like for Dubins with others,
and ``<source>_<variant>`` for the other systems. A library is built at first use, so
a run builds only its own variant's, and loaded with ``ctypes``. The digest covers the
source, the shared header and the flags, so an edited source is rebuilt. Several
libraries build in parallel, one ``nvcc`` each, as many at once as there are cores.
Nothing here runs when the package is imported, and a failed build raises with nvcc's
output.

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
AGGREGATIONS = ("smoothmin", "min")   # ids of LANE_AGG (lane_common.cuh)
BARRIERS = ("inverse", "log")         # ids of LANE_BARRIER


def variant_name(family: str, aggregation: str = "smoothmin", barrier: str = "inverse") -> str:
    """The kernels' variant: ``<family>[_min][_log]``."""
    return family + ("_min" if aggregation == "min" else "") + ("_log" if barrier == "log" else "")


def library_name(source: str, variant: str = "dubins") -> str:
    """The library of ``source`` for ``variant``: the source's own name for Dubins with
    the defaults."""
    if variant.startswith("dubins"):
        return source + variant[len("dubins"):]
    return f"{source}_{variant}"


# variant: (family, aggregation, barrier); the cart-pole's h is its track limit, which
# no aggregation changes
VARIANTS: Dict[str, Tuple[str, str, str]] = {
    variant_name(fam, agg, bar): (fam, agg, bar)
    for fam in FAMILIES for agg in AGGREGATIONS for bar in BARRIERS
    if fam != "cartpole" or agg == "smoothmin"}
DEFAULT_VARIANTS = tuple(FAMILIES)   # the smooth-min and the inverse barrier

# library name: (source, variant)
LIBRARIES: Dict[str, Tuple[str, str]] = {
    library_name(src, var): (src, var) for var in VARIANTS for src in SOURCES}


def libraries(variants: Iterable[str]) -> Tuple[str, ...]:
    """The libraries of every source for each of ``variants``."""
    return tuple(library_name(src, var) for var in variants for src in SOURCES)

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
    """nvcc's flags for library ``name``: a define for each policy that is not the
    default."""
    family, aggregation, barrier = VARIANTS[LIBRARIES[name][1]]
    out = NVCC_FLAGS
    if family != "dubins":
        out += (f"-DLANE_SYSTEM={FAMILIES.index(family)}",)
    if aggregation != "smoothmin":
        out += (f"-DLANE_AGG={AGGREGATIONS.index(aggregation)}",)
    if barrier != "inverse":
        out += (f"-DLANE_BARRIER={BARRIERS.index(barrier)}",)
    return out


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{LIBRARIES[name][0]}.cu"] + [CSRC / hdr for hdr in HEADERS]:
        h.update(path.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest(name)}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every stale library of ``names``, as many at once as there are cores, the
    quadrotor's and the backward sweeps' (the longest) first; returns each build's
    seconds from the start of the first."""
    pending = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not pending:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()

    def one(name):
        out = pending[name]
        fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *flags(name), "-o", tmp, str(CSRC / f"{LIBRARIES[name][0]}.cu")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc.returncode, proc.stdout, tmp, time.perf_counter() - start

    order = sorted(pending, key=lambda n: ("quadrotor2d" not in n, "sbwd" not in n, n))
    with ThreadPoolExecutor(max_workers=min(len(order), os.cpu_count() or 1)) as pool:
        done = dict(zip(order, pool.map(one, order)))
    seconds, failed = {}, []
    for name, (rc, log, tmp, secs) in done.items():
        seconds[name] = secs
        BUILD_LOG[name] = log
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc {name}.cu failed ({rc}):\n{log}")
        else:
            os.replace(tmp, pending[name])
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
