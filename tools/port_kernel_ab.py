#!/usr/bin/env python3
"""Compare the port's kernels of this tree with those of another checkout, on one NVIDIA
card, in one process.

    python3 tools/port_kernel_ab.py BASE_DIR [--variants dubins quadrotor2d ...] [--sass all]
                                             # from the repository root

BASE_DIR holds another commit's tree (e.g. `git archive <commit>` unpacked into a
gitignored directory). Every `tube_mpc_tpu_torch/csrc/*.cu` of both trees (the two may
split the kernels over different sources) is built for each library variant of
`--variants` (default VARIANTS: Dubins, the double integrator, the quadrotor, the
cart-pole and the quadrotor with the exact min and the log barrier; with `--sass all`
also every other variant of `_build.VARIANTS`, for the SASS comparison alone) with this
tree's nvcc flags for that variant (`_build.flags`: `-DLANE_SYSTEM`, `-DLANE_AGG`,
`-DLANE_BARRIER`), all at once. The script prints each build's ptxas registers, shared memory and spills,
where `cuobjdump` is found each kernel's SASS instruction count, and, for every kernel
that both trees build, whether its SASS is the same instruction for instruction (a kernel
whose source did not change compiles to what it was). Then it times the f32 kernels of
both builds on the same inputs (CASES): for Dubins K1 `ric`, K2 `fwd` (at nα=7 and at the
rollout's nα=1), K3 `sbwd` and K4 `sfwd` on one closed-loop step of the paper setup, and
K5 `sbwd_generic`, `sbwd_upper`, K6 `sfwd_generic`, `sfwd_ref` on one step of the coupled
setup, at B=16384, N=50 (chip_smoke.paper_step, coupled_step); for another family its K1
and K3 on its paper step (N=50); for the cart-pole K1 and K3 also in f64, the two K5 on
the coupled step of configs/cartpole.yaml at its N=40 and, with the variant `cartpole_log`,
K1 on the coupled step and K3 on the paper step of chip_smoke.MINLOG's cartpole_log at the
file's N=40; for the quadrotor also K2 (at the config's nα and at nα=1) and K4 (also in
f64) on its paper step, and K1, K2, the K5 and the K6 variants on the coupled step of
configs/quadrotor2d.yaml at its N=200, and K1, K2 and the K5 variants on that step of
chip_smoke.MINLOG's quadrotor2d_min_log and K4 on its paper step, at the file's N=200; and
K4 of the double integrator (each of its four libraries) and of the cart-pole (both) on
their paper steps in f32 and f64, at N=50 and at their config's N (30, 40). Each is called
through this
tree's wrapper with the wrapper's library lookup pointed at one build or the other, in the
order base, this, this, base, each the device time per launch of RUNS launches back to back
(chip_smoke.device_time_ms), beside its bound as chip_smoke.py computes it (the larger of
bytes over the card's memory rate and the plain version's operations over its peak rate),
and the two builds' outputs must be bitwise equal. The last line is one JSON object with
the times.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
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
VARIANTS = ("dubins", "double_integrator", "double_integrator_min", "double_integrator_log",
            "double_integrator_min_log", "quadrotor2d", "cartpole", "cartpole_log",
            "quadrotor2d_min_log")
FWD = ("fwd", "fwd nα=1")


def sfwd_at(family, n, label=None, **kw):
    """K4 alone on the paper step of `family` at N=n, in f32 and f64 (the cases at another N
    than the variant's others)."""
    label = label or family
    return [(f" {label} N={n}{sfx}", "paper_step", {"family": family, "N_": n, **kw, **dt},
             ("sfwd",)) for sfx, dt in (("", {}), (" f64", {"dtype": "float64"}))]


# variant: [(label suffix, chip_smoke's step function by name, its keyword arguments (with
#            "dtype", a torch dtype's name, for another than f32), the kernels timed on it,
#            None for all)]
CASES = {
    "dubins": [("", "paper_step", {}, None), ("", "coupled_step", {}, None)],
    "double_integrator": [
        (" double_integrator", "paper_step", {"family": "double_integrator"},
         ("ric", "sbwd", *FWD, "sfwd")),
        (" double_integrator f64", "paper_step",
         {"family": "double_integrator", "dtype": "float64"}, ("ric", "sbwd", "sfwd")),
        *sfwd_at("double_integrator", 30),
        (" double_integrator N=30", "coupled_step",
         {"family": "double_integrator", "N_": 30, "solver": True},
         ("ric", "sbwd_generic", "sbwd_upper"))],
    "double_integrator_min": [
        (" double_integrator_min N=30", "paper_step",
         {"family": "double_integrator_min", "N_": 30}, ("ric", "sbwd", "sfwd")),
        (" double_integrator_min N=30 f64", "paper_step",
         {"family": "double_integrator_min", "N_": 30, "dtype": "float64"}, ("sfwd",)),
        *sfwd_at("double_integrator_min", 50),
        (" double_integrator_min N=30", "coupled_step",
         {"family": "double_integrator_min", "N_": 30, "solver": True},
         ("sbwd_generic", "sbwd_upper"))],
    # the double integrator's log-barrier libraries, which no configuration of chip_smoke.py
    # runs: its kernels on the inputs of its paper and coupled steps, with the problem of
    # those policies (with_policies)
    **{v: [(f" {v}", "paper_step", {"family": "double_integrator", "policies": (agg, "log")},
            ("ric", "sbwd", *FWD, "sfwd")),
           (f" {v} f64", "paper_step", {"family": "double_integrator", "policies": (agg, "log"),
                                        "dtype": "float64"}, ("sfwd",)),
           *sfwd_at("double_integrator", 30, v, policies=(agg, "log")),
           (f" {v}", "coupled_step", {"family": "double_integrator", "policies": (agg, "log")},
            ("sbwd_generic", "sbwd_upper"))]
       for v, agg in (("double_integrator_log", "smoothmin"),
                      ("double_integrator_min_log", "min"))},
    "cartpole": [(" cartpole", "paper_step", {"family": "cartpole"}, ("ric", "sbwd", "sfwd")),
                 (" cartpole f64", "paper_step", {"family": "cartpole", "dtype": "float64"},
                  ("ric", "sbwd", "sfwd")),
                 *sfwd_at("cartpole", 40),
                 (" cartpole N=40", "coupled_step", {"family": "cartpole", "N_": 40},
                  ("sbwd_generic", "sbwd_upper"))],
    "cartpole_log": [(" cartpole_log N=40", "coupled_step",
                      {"family": "cartpole_log", "N_": 40, "solver": True}, ("ric",)),
                     (" cartpole_log N=40", "paper_step", {"family": "cartpole_log", "N_": 40},
                      ("sbwd", "sfwd")),
                     (" cartpole_log N=40 f64", "paper_step",
                      {"family": "cartpole_log", "N_": 40, "dtype": "float64"}, ("sfwd",)),
                     *sfwd_at("cartpole_log", 50)],
    "quadrotor2d": [
        (" quadrotor2d", "paper_step", {"family": "quadrotor2d"},
         ("ric", "sbwd", *FWD, "sfwd")),
        (" quadrotor2d f64", "paper_step", {"family": "quadrotor2d", "dtype": "float64"},
         ("sfwd",)),
        (" quadrotor2d N=200", "coupled_step",
         {"family": "quadrotor2d", "N_": 200, "solver": True},
         ("ric", *FWD, "sbwd_generic", "sbwd_upper", "sfwd_generic", "sfwd_ref"))],
    "quadrotor2d_min_log": [
        (" quadrotor2d_min_log N=200", "coupled_step",
         {"family": "quadrotor2d_min_log", "N_": 200, "solver": True},
         ("ric", *FWD, "sbwd_generic", "sbwd_upper")),
        (" quadrotor2d_min_log N=200", "paper_step",
         {"family": "quadrotor2d_min_log", "N_": 200}, ("sfwd",))],
}


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


def sass_of(so: Path):
    """{kernel symbol: (SASS instructions, digest of their text)} of a built library, or {}
    without cuobjdump. The digest leaves out the instructions' addresses."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, timeout=300)
    texts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            texts[fn] = []
        elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            texts[fn].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return {fn: (len(t), hashlib.sha256("\n".join(t).encode()).hexdigest()[:16])
            for fn, t in texts.items()}


class TreeLib:
    """The C entry points of one build's libraries, whichever source holds each."""

    def __init__(self, libs):
        self.libs = libs

    def __getattr__(self, fn):
        for lib in self.libs:
            if hasattr(lib, fn):
                return getattr(lib, fn)
        raise AttributeError(fn)


def on_build(libs, fn):
    """fn with the wrappers' library lookup (ops.cuda._build.load) pointed at `libs`: a
    TreeLib for every library, or {variant: TreeLib} (_build.VARIANTS)."""
    from tube_mpc_tpu_torch.ops.cuda import _build

    def run():
        if isinstance(libs, dict):
            _build.load = lambda name: libs[_build.LIBRARIES[name][1]]
        else:
            _build.load = lambda name: libs
        return fn()
    return run


def with_policies(pb, aggregation, barrier):
    """The double integrator's lane problem pb with another obstacle aggregation and
    barrier (the same obstacles, bounds and eps)."""
    from tube_mpc_tpu_torch.ops import lanes
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

    sp = pb.spec
    sys_c = lanes.double_integrator_components(dt=sp.dt, a_max=pb.u_max[0], centers=sp.centers,
                                               radii=sp.radii, aggregation=aggregation,
                                               beta=sp.beta)
    return make_lane_problem(sys_c, barrier_type=barrier, eps=pb.eps)


def step_cases(torch, dev, cases=CASES["dubins"]):
    """{label: (call of a kernel's wrapper, its plain version, its inputs, the kernel's
    name, the problem's count of const rows)} of `cases` (CASES' entries): by default the
    paper step's K1-K4 and the coupled step's K5/K6 variants at B, N of chip_smoke, in f32.
    A case with "policies" (aggregation, barrier) runs the step's kernels with those."""
    import chip_smoke

    out = {}
    for suffix, step, kwargs, kernels in cases:
        kwargs = dict(kwargs)
        dtype = getattr(torch, kwargs.pop("dtype", "float32"))
        policies = kwargs.pop("policies", None)
        pb, _, make, inputs, _ = getattr(chip_smoke, step)(torch, dev, dtype, **kwargs)
        fns = make(pb if policies is None else with_policies(pb, *policies))
        if "fwd" in inputs:
            inputs = {**inputs, "fwd nα=1": inputs["fwd"]}
        for name, ins in inputs.items():
            if kernels is None or name in kernels:
                out[name + suffix] = (*fns[name], ins, name, 2 * pb.n_hat + pb.m + 3)
    return out


def changed_kernels(base, this):
    """(how many kernels both builds have, the labels of those whose SASS differs) of two
    builds' {(library variant, kernel symbol): (instructions, digest)}. A kernel is a
    symbol in one variant: the variants of a system (its aggregations and barriers) build
    the same symbols from different code."""
    import chip_smoke

    both = sorted(set(base) & set(this))
    changed = [f"{variant}: {chip_smoke.kernel_label(sym)}" for variant, sym in both
               if base[variant, sym][1] != this[variant, sym][1]]
    return len(both), changed


def bitwise_equal(torch, xs, ys) -> bool:
    return len(xs) == len(ys) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(xs, ys))  # NaNs too


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=sorted(CASES))
    ap.add_argument("--sass", choices=("timed", "all"), default="timed",
                    help="the library variants whose SASS is compared: those of --variants, "
                         "or every variant of _build.VARIANTS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    base = args.base.resolve()

    import chip_smoke
    from tube_mpc_tpu_torch.ops.cuda import _build

    card = chip_smoke.nvidia_smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    built = list(args.variants)
    if args.sass == "all":
        built += [v for v in _build.VARIANTS if v not in built]
    srcs = {(tree, variant, src.stem): src
            for variant in built for tree, root in (("base", base), ("this", REPO))
            for src in sorted((root / "tube_mpc_tpu_torch/csrc").glob("*.cu"))}
    sos = {key: out_dir / f"lib{key[0]}_{key[2]}_{key[1]}.so" for key in srcs}
    jobs = [(_build.flags(_build.library_name("lane_solver", k[1])), srcs[k], sos[k])
            for k in srcs]
    logs = build_all(_build.nvcc_path(), jobs)
    libs = {}
    sass = {"base": {}, "this": {}}
    for (tree, variant, name), (rc, log) in zip(srcs, logs):
        if rc != 0:
            raise SystemExit(f"nvcc failed on {srcs[tree, variant, name]} ({variant}):\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {tree} {variant}: {chip_smoke.kernel_label(line.strip())}",
                      flush=True)
        for sym, (n, digest) in sass_of(sos[tree, variant, name]).items():
            sass[tree][variant, sym] = (n, digest)
            print(f"[sass] {tree} {variant}: {chip_smoke.kernel_label(sym)}: {n} instructions",
                  flush=True)
        if variant in args.variants:
            libs.setdefault(tree, {}).setdefault(variant, []).append(
                ctypes.CDLL(str(sos[tree, variant, name])))
    both, changed = changed_kernels(sass["base"], sass["this"])
    print(f"[sass] kernels built by both trees in {len(built)} library variants: {both}, the "
          f"same SASS: {both - len(changed)}; changed: {json.dumps(changed)}", flush=True)
    builds = {tree: {v: TreeLib(found) for v, found in by.items()} for tree, by in libs.items()}

    dev = torch.device("cuda", 0)
    cases = {}
    for variant in args.variants:
        cases.update(on_build(builds["this"], lambda: step_cases(torch, dev, CASES[variant]))())
    torch.cuda.synchronize()
    result = {"card": card, "B": chip_smoke.B, "runs": RUNS, "sass_changed": changed, "ms": {},
              "bound_ms": {}}
    for label, (call, plain, ins, name, nc) in cases.items():
        runs = {tree: on_build(lib, lambda: call(*ins)) for tree, lib in builds.items()}
        outs = {tree: run() for tree, run in runs.items()}
        torch.cuda.synchronize()
        same = bitwise_equal(torch, outs["base"], outs["this"])
        times = [(tree, chip_smoke.device_time_ms(torch, runs[tree], RUNS))
                 for tree in ("base", "this", "this", "base")]
        *_, t_bytes, t_ops = chip_smoke.work_bound(torch, name, plain, ins, outs["this"], nc)
        bound, by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        result["ms"][label] = times
        result["bound_ms"][label] = [bound, by]
        print(f"[time] {label}: " + ", ".join(f"{k} {ms!r} ms" for k, ms in times)
              + f" (mean of {RUNS} back to back); bound {bound!r} ms ({by}); outputs "
              f"bitwise equal: {same}", flush=True)
        if not same:
            raise SystemExit(f"port_kernel_ab: {label} differs between the two builds")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
