#!/usr/bin/env python3
"""Compare the port's kernels of this tree with those of another checkout, on one NVIDIA
card, in one process.

    python3 tools/port_kernel_ab.py BASE_DIR     # from the repository root

BASE_DIR holds another commit's tree (e.g. `git archive <commit>` unpacked into a
gitignored directory). Every `tube_mpc_tpu_torch/csrc/*.cu` of both trees (the two may
split the kernels over different sources) is built with this tree's nvcc flags, all at
once; the script prints each build's ptxas registers, shared memory and spills and, where
`cuobjdump` is found, the SASS instruction count of each kernel. Then it times the f32
kernels of both builds on the same inputs: K1 `ric`, K2 `fwd` (at nα=7 and at the
rollout's nα=1), K3 `sbwd` and K4 `sfwd` on one closed-loop step of the paper setup, and
K5 `sbwd_generic`, `sbwd_upper`, K6 `sfwd_generic`, `sfwd_ref` on one step of the coupled
setup, at B=16384, N=50 (chip_smoke.paper_step, coupled_step). Each is called through
this tree's wrapper with the wrapper's library lookup pointed at one build or the other,
in the order base, this, this, base, each the device time per launch of RUNS launches back
to back (chip_smoke.device_time_ms), and the two builds' outputs must be bitwise equal.
The last line is one JSON object with the times.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

RUNS = 50


def build_all(nvcc: str, jobs):
    """Run nvcc on every (flags, source, output) of `jobs`, as many at once as there are
    cores; returns each job's (return code, log) in order."""
    def one(job):
        flags, src, out = job
        proc = subprocess.run([nvcc, *flags, "-o", str(out), str(src)], capture_output=True,
                              text=True)
        return proc.returncode, proc.stdout + proc.stderr
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        return list(pool.map(one, jobs))


def sass_counts(so: Path):
    """{kernel symbol: SASS instructions} of a built library, or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, timeout=300)
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[fn] += 1
    return counts


class TreeLib:
    """The C entry points of one build's libraries, whichever source holds each."""

    def __init__(self, libs):
        self.libs = libs

    def __getattr__(self, fn):
        for lib in self.libs:
            if hasattr(lib, fn):
                return getattr(lib, fn)
        raise AttributeError(fn)


def on_build(lib: TreeLib, fn):
    """fn with the wrappers' library lookup (ops.cuda._build.load) pointed at `lib`."""
    from tube_mpc_tpu_torch.ops.cuda import _build

    def run():
        _build.load = lambda name: lib
        return fn()
    return run


def step_cases(torch, dev):
    """{label: (f32 call of a kernel's wrapper, its inputs)}: the paper step's K1-K4 and
    the coupled step's K5/K6 variants at B, N of chip_smoke."""
    import chip_smoke

    cases = {}
    for step_of in (chip_smoke.paper_step, chip_smoke.coupled_step):
        pb, _, make, inputs, _ = step_of(torch, dev, torch.float32)
        fns = make(pb)
        for name, ins in inputs.items():
            cases[name] = (fns[name][0], ins)
        if "fwd" in inputs:
            cases["fwd nα=1"] = (fns["fwd nα=1"][0], inputs["fwd"])
    return cases


def bitwise_equal(torch, xs, ys) -> bool:
    return len(xs) == len(ys) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(xs, ys))  # NaNs too


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    base = Path(sys.argv[1]).resolve()

    import chip_smoke
    from tube_mpc_tpu_torch.ops.cuda import _build

    card = chip_smoke.nvidia_smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {(tree, src.stem): src for tree, root in (("base", base), ("this", REPO))
            for src in sorted((root / "tube_mpc_tpu_torch/csrc").glob("*.cu"))}
    sos = {key: out_dir / f"lib{key[0]}_{key[1]}.so" for key in srcs}
    logs = build_all(_build.nvcc_path(), [(_build.NVCC_FLAGS, srcs[k], sos[k]) for k in srcs])
    libs = {"base": [], "this": []}
    for (tree, name), (rc, log) in zip(srcs, logs):
        if rc != 0:
            raise SystemExit(f"nvcc failed on {srcs[tree, name]}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {tree}: {chip_smoke.kernel_label(line.strip())}", flush=True)
        for sym, n in sass_counts(sos[tree, name]).items():
            print(f"[sass] {tree}: {chip_smoke.kernel_label(sym)}: {n} instructions", flush=True)
        libs[tree].append(ctypes.CDLL(str(sos[tree, name])))
    builds = {tree: TreeLib(found) for tree, found in libs.items()}

    dev = torch.device("cuda", 0)
    cases = on_build(builds["this"], lambda: step_cases(torch, dev))()
    torch.cuda.synchronize()
    result = {"card": card, "B": chip_smoke.B, "N": chip_smoke.N, "runs": RUNS, "ms": {}}
    for label, (call, ins) in cases.items():
        runs = {tree: on_build(lib, lambda: call(*ins)) for tree, lib in builds.items()}
        outs = {tree: run() for tree, run in runs.items()}
        torch.cuda.synchronize()
        same = bitwise_equal(torch, outs["base"], outs["this"])
        times = [(tree, chip_smoke.device_time_ms(torch, runs[tree], RUNS))
                 for tree in ("base", "this", "this", "base")]
        result["ms"][label] = times
        print(f"[time] {label}: " + ", ".join(f"{k} {ms!r} ms" for k, ms in times)
              + f" (mean of {RUNS} back to back); outputs bitwise equal: {same}", flush=True)
        if not same:
            raise SystemExit(f"port_kernel_ab: {label} differs between the two builds")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
