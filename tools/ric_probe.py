#!/usr/bin/env python3
"""Where the chunked sweeps' time and register spills go (K1 `ric_kernel`, K3/K5
`sbwd_kernel`, K4/K6 `sfwd_kernel`, all on lane_common.cuh's sweeps), on one NVIDIA
card, in one process.

    python3 tools/ric_probe.py                           # Dubins, from the repository root
    python3 tools/ric_probe.py --family quadrotor2d      # the quadrotor's n̂ = 7 kernels
    python3 tools/ric_probe.py --family quadrotor2d --tree chip_tree/base   # another tree's
    python3 tools/ric_probe.py --family quadrotor2d --variants "A only" parts2   # some (and kept)

1. Builds variants of a tree's kernel sources (`tube_mpc_tpu_torch/csrc/`, of this tree or
   of `--tree`), each a copy of the sources with textual edits (VARIANTS[family]), all at
   once with the package's nvcc flags for the family's library, and prints each variant's
   ptxas registers and spills of the family's f32 and f64 instantiations (PROBED).
   Dubins (`--family dubins`):
   - kept:   the sources as they are;
   - A only: the recursion's warps skip phase B (the recursion), so phase A and the
             barriers remain;
   - B only: phase A is skipped, so phase B (over whatever shared memory holds) and the
             barriers remain;
   - kc2, kc4, kc6: SWEEP_KC steps per chunk, not 3 (f32 only; above 48 KB of
             buffers the launchers set the dynamic shared memory attribute);
   - cap3, cap2: 3 or 2 f32 blocks per SM in __launch_bounds__ (at most 168 or 255
             registers a thread), not 4 (128), for the systems with n̂ <= 5.
   The quadrotor (`--family quadrotor2d`; K1 and K3/K5 are timed):
   kept, A only and B only as above, cap2, cap3, cap4: 2, 3 or 4 f32 blocks per SM
   for n̂ > 5 (SweepBlocksPerSM), whatever the tree's value, and "parts<P> aw<W>": K3/K5's
   split sweep (sweep_split) with P threads a lane in phase B and W phase-A warps
   (SPLIT_PARTS, SPLIT_AW; a tree without the split sweep fails these).
   The edits are to the shared sweeps, so each variant changes every kernel on them alike.
2. Times every f32 kernel of the family's cases (Dubins: tools/port_kernel_ab.py's paper
   step's K1-K4 and coupled step's K5/K6 at B=16384, N=50; the quadrotor: K1 and K3 on its
   paper step at N=50, K1 and the two K5 on the coupled step of configs/quadrotor2d.yaml
   at its N=200) through its wrapper on every variant's build, in turns (every variant,
   then every variant in reverse order), each the device time per launch of RUNS
   launches back to back, and says whether each variant's outputs are bitwise those of
   `kept`.
3. Compiles `kept` once more to cubins with -lineinfo (which leaves the code as it
   is), disassembles them with nvdisasm -gi, and counts each instantiation's
   local-memory stores and loads (STL, LDL: the register spills) by the source line
   of the innermost frame of their line info. The register allocator's spills in a
   kernel on a shared sweep carry the line of the kernel's sweep call, whichever
   phase they serve: the phase shows in the `A only` and `B only` variants' ptxas
   lines instead. The stack frame of the math library's out-of-line paths, which every
   f64 instantiation has, shows at the kernel's last line.

A variant's edit that matches no line of the tree's sources fails the run (an edit with a
count must match exactly that often): update VARIANTS with the kernels.
The last line is one JSON object with the times and the counts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))
sys.path.insert(0, str(TOOLS.parent))

import port_kernel_ab as ab  # noqa: E402

RUNS = 50
SWEEP = "lane_common.cuh"
A_ONLY = (SWEEP, r"rec_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", None)
B_ONLY = (SWEEP, r"lin_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", None)
VARIANTS = {  # family: {name: [(file, regex, replacement, matches, None for at least one)]}
    "dubins": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        **{f"kc{kc}": [(SWEEP, r"constexpr int SWEEP_KC = 3;",
                        f"constexpr int SWEEP_KC = {kc};", 1)] for kc in (2, 4, 6)},
        **{f"cap{n}": [(SWEEP, r"\) : \(sizeof\(T\) == 4 \? 4 : 1\);",
                        f") : (sizeof(T) == 4 ? {n} : 1);", 1)] for n in (3, 2)},
    },
    "quadrotor2d": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        **{f"cap{n}": [(SWEEP, r"NH > 5 \? \(sizeof\(T\) == 4 \? \d+ : 1\)",
                        f"NH > 5 ? (sizeof(T) == 4 ? {n} : 1)", 1)] for n in (2, 3, 4)},
        **{name: [(SWEEP, r"constexpr int SPLIT_PARTS = \d+;", f"constexpr int SPLIT_PARTS = {n};",
                   1),
                  (SWEEP, r"constexpr int SPLIT_AW = \d+;", f"constexpr int SPLIT_AW = {aw};", 1)]
           for name, n, aw in (("parts4 aw2", 4, 2), ("parts4 aw1", 4, 1), ("parts2 aw1", 2, 1))},
    },
}
SOURCES = ("lane_solver", "lane_sbwd", "lane_sfwd")   # the steps' inputs run every kernel
PROBED = {  # the instantiations whose ptxas lines are printed
    "dubins": ("ric_kernel<float, dubins, 5>", "sbwd_kernel<float, false, false, dubins, 5>",
               "sfwd_kernel<float, false, false, dubins, 5>"),   # the paper's
    "quadrotor2d": tuple(f"{k}<{t}{flags}, quadrotor2d, 4>" for t in ("float", "double")
                         for k, flags in (("ric_kernel", ""), ("sbwd_kernel", ", false, false"),
                                          ("sbwd_kernel", ", true, false"),
                                          ("sbwd_kernel", ", true, true"))),
}
CASES = {"dubins": ab.CASES["dubins"],
         "quadrotor2d": ab.CASES["quadrotor2d"]}


def variant_sources(csrc: Path, edits, out: Path):
    """Copy csrc's sources into out with the edits applied; fail unless each edit matches
    as often as it says (at least once where it says None)."""
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        for name, pattern, repl, count in edits:
            if name == src.name:
                text, n = re.subn(pattern, repl, text)
                if n != count and not (count is None and n > 0):
                    raise SystemExit(f"ric_probe: {pattern!r} matched {n} times in {name}")
        (out / src.name).write_text(text)


def ptxas_lines(log: str, label, kernel: str):
    """The ptxas lines of `kernel` (a label as chip_smoke.kernel_label writes it)."""
    lines = [label(x.strip()) for x in log.splitlines()]
    for i, x in enumerate(lines):
        if "Compiling entry" in x and f"'{kernel}'" in x:
            return [y for y in lines[i + 1:i + 4] if "spill" in y or "registers" in y]
    return []


def spill_sites(sass: str, sources):
    """{kernel symbol: Counter((STL or LDL, "<source> line N"))}: each local-memory
    instruction at the innermost frame of its line-info chain that lies in one of
    `sources` (file names)."""
    counts, fn, chain = {}, None, []
    for line in sass.splitlines():
        if "/*" not in line:
            m = re.search(r"\.text\.(_Z\w+)", line)
            if m:
                fn = m.group(1)
                continue
        if "//##" in line:
            chain = [(Path(f).name, int(n)) for f, n in re.findall(r'"([^"]+)", line (\d+)', line)]
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?(STL|LDL)\b", line)
        if not (m and fn):
            continue
        ours = [(f, ln) for f, ln in chain if f in sources]
        site = f"{ours[0][0]} line {ours[0][1]}" if ours else "unplaced"
        counts.setdefault(fn, Counter())[(m.group(1), site)] += 1
    return counts


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(VARIANTS), default="dubins")
    ap.add_argument("--tree", type=Path, default=TOOLS.parent,
                    help="the checkout whose kernel sources are probed (default: this one)")
    ap.add_argument("--variants", nargs="+",
                    help="the variants to build and time (default: all of the family's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ric_probe: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke
    from tube_mpc_tpu_torch.ops.cuda import _build

    label = chip_smoke.kernel_label
    card = chip_smoke.nvidia_smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    family, csrc = args.family, args.tree.resolve() / "tube_mpc_tpu_torch" / "csrc"
    variants = {v: e for v, e in VARIANTS[family].items()
                if v == "kept" or not args.variants or v in args.variants}
    out_dir = _build.BUILD_DIR / "probe" / family
    names = SOURCES
    flags = list(_build.flags(_build.library_name("lane_solver", family)))
    jobs, keys = [], []
    for variant, edits in variants.items():
        vdir = out_dir / variant.replace(" ", "_")
        variant_sources(csrc, edits, vdir)
        for name in names:
            keys.append((variant, name))
            jobs.append((flags, vdir / f"{name}.cu", vdir / f"lib{name}.so"))
    cubin_flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for name in names:
        keys.append(("kept, -lineinfo cubin", name))
        jobs.append((["-cubin", "-lineinfo", *cubin_flags], csrc / f"{name}.cu",
                     out_dir / f"{name}_lineinfo.cubin"))
    libs = {}
    for (variant, name), job, (rc, log) in zip(keys, jobs, ab.build_all(_build.nvcc_path(), jobs)):
        if rc != 0:
            raise SystemExit(f"ric_probe: nvcc failed on {variant} {name}:\n{log}")
        for kernel in PROBED[family]:
            found = ptxas_lines(log, label, kernel)
            if found:
                print(f"[build] {variant}: {kernel}: {' | '.join(found)}", flush=True)
        if variant in variants:
            libs.setdefault(variant, []).append(ctypes.CDLL(str(job[2])))
    builds = {variant: ab.TreeLib(found) for variant, found in libs.items()}

    result = {"card": card, "family": family, "tree": str(args.tree), "B": chip_smoke.B,
              "runs": RUNS, "ms": {}, "bitwise": {}, "spills": {}}
    dev = torch.device("cuda", 0)
    cases = ab.on_build(builds["kept"], lambda: ab.step_cases(torch, dev, CASES[family]))()
    for case, (call, ins) in cases.items():
        runs = {v: ab.on_build(lib, lambda: call(*ins)) for v, lib in builds.items()}
        outs = {v: run() for v, run in runs.items()}
        torch.cuda.synchronize()
        times = {v: [] for v in builds}
        for order in (list(builds), list(builds)[::-1]):
            for v in order:
                times[v].append(chip_smoke.device_time_ms(torch, runs[v], RUNS))
        result["ms"][case] = times
        result["bitwise"][case] = {v: ab.bitwise_equal(torch, outs[v], outs["kept"]) for v in builds}
        for v in builds:
            print(f"[time] {case} {v}: {', '.join(f'{t!r}' for t in times[v])} ms (mean of "
                  f"{RUNS} back to back, twice); outputs bitwise those of kept: "
                  f"{result['bitwise'][case][v]}", flush=True)

    tool = shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm"
    sources = [f"{name}.cu" for name in names] + list(_build.HEADERS)
    for name in names:
        sass = subprocess.run([tool, "-gi", "-c", str(out_dir / f"{name}_lineinfo.cubin")],
                              capture_output=True, text=True, timeout=600, check=True).stdout
        for sym, c in sorted(spill_sites(sass, sources).items(), key=lambda kv: label(kv[0])):
            by = {f"{op} {part}": n for (op, part), n in sorted(c.items())}
            result["spills"][label(sym)] = by
            print(f"[sass] {label(sym)}: local-memory instructions {json.dumps(by)}", flush=True)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
