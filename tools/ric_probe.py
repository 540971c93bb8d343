#!/usr/bin/env python3
"""Where the chunked sweeps' time and register spills go (K1 `ric_kernel`, K3/K5
`sbwd_kernel`, K4/K6 `sfwd_kernel`, all on lane_common.cuh's `sweep`), on one NVIDIA
card, in one process.

    python3 tools/ric_probe.py     # from the repository root

1. Builds variants of this tree's kernel sources (`tube_mpc_tpu_torch/csrc/`), each a
   copy of the sources with textual edits (VARIANTS), all at once with the package's
   nvcc flags, and prints each variant's ptxas registers and spills of the paper's
   f32 instantiations (PROBED):
   - kept:   the sources as they are;
   - A only: warp 0 skips phase B (the recursion), so phase A and the barriers remain;
   - B only: the phase-A warps skip phase A, so phase B (over whatever shared memory
             holds) and the barriers remain;
   - kc2, kc4, kc6: SWEEP_KC steps per chunk, not 3 (f32 only; above 48 KB of
             buffers the launchers set the dynamic shared memory attribute);
   - cap3, cap2: 3 or 2 f32 blocks per SM in __launch_bounds__ (at most 168 or 255
             registers a thread), not 4 (128), for the systems with n̂ <= 5.
   The edits are to the shared sweep, so each variant changes K1, K3-K6 alike.
2. Times every f32 kernel of tools/port_kernel_ab.py's cases (the paper step's K1-K4,
   the coupled step's K5/K6 at B=16384, N=50) through its wrapper on every variant's
   build, in turns (every variant, then every variant in reverse order), each the
   device time per launch of RUNS launches back to back, and says whether each
   variant's outputs are bitwise those of `kept`.
3. Compiles `kept` once more to cubins with -lineinfo (which leaves the code as it
   is), disassembles them with nvdisasm -gi, and counts each instantiation's
   local-memory stores and loads (STL, LDL: the register spills) by the source line
   of the innermost frame of their line info. The register allocator's spills in a
   kernel on the shared sweep carry the line of the kernel's `sweep(` call, whichever
   phase they serve: the phase shows in the `A only` and `B only` variants' ptxas
   lines instead. The stack frame of the math library's out-of-line paths, which every
   f64 instantiation has, shows at the kernel's last line.

The last line is one JSON object with the times and the counts.
"""
from __future__ import annotations

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
VARIANTS = {  # name: [(file, regex, replacement, matches)]
    "kept": [],
    "A only": [(SWEEP, r"rec_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", 2)],
    "B only": [(SWEEP, r"lin_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", 1)],
    **{f"kc{kc}": [(SWEEP, r"constexpr int SWEEP_KC = 3;", f"constexpr int SWEEP_KC = {kc};", 1)]
       for kc in (2, 4, 6)},
    **{f"cap{n}": [(SWEEP, r"sizeof\(T\) == 4 \? 4 : 1", f"sizeof(T) == 4 ? {n} : 1", 1)]
       for n in (3, 2)},
}
PROBED = ("ric_kernel<float, dubins, 5>", "sbwd_kernel<float, false, false, dubins, 5>",
          "sfwd_kernel<float, false, false, dubins, 5>")   # the paper's instantiations


def variant_sources(csrc: Path, edits, out: Path):
    """Copy csrc's sources into out with the edits applied; fail unless each edit matches
    as often as it says."""
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        for name, pattern, repl, count in edits:
            if name == src.name:
                text, n = re.subn(pattern, repl, text)
                if n != count:
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

    if len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ric_probe: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke
    from tube_mpc_tpu_torch.ops.cuda import _build

    label = chip_smoke.kernel_label
    card = chip_smoke.nvidia_smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    out_dir = _build.BUILD_DIR / "probe"
    names = list(_build.SOURCES)
    jobs, keys = [], []
    for variant, edits in VARIANTS.items():
        vdir = out_dir / variant.replace(" ", "_")
        variant_sources(_build.CSRC, edits, vdir)
        for name in names:
            keys.append((variant, name))
            jobs.append((_build.NVCC_FLAGS, vdir / f"{name}.cu", vdir / f"lib{name}.so"))
    cubin_flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for name in names:
        keys.append(("kept, -lineinfo cubin", name))
        jobs.append((["-cubin", "-lineinfo", *cubin_flags], _build.CSRC / f"{name}.cu",
                     out_dir / f"{name}_lineinfo.cubin"))
    libs = {}
    for (variant, name), job, (rc, log) in zip(keys, jobs, ab.build_all(_build.nvcc_path(), jobs)):
        if rc != 0:
            raise SystemExit(f"ric_probe: nvcc failed on {variant} {name}:\n{log}")
        for kernel in PROBED:
            found = ptxas_lines(log, label, kernel)
            if found:
                print(f"[build] {variant}: {kernel}: {' | '.join(found)}", flush=True)
        if variant in VARIANTS:
            libs.setdefault(variant, []).append(ctypes.CDLL(str(job[2])))
    builds = {variant: ab.TreeLib(found) for variant, found in libs.items()}

    result = {"card": card, "B": chip_smoke.B, "N": chip_smoke.N, "runs": RUNS, "ms": {},
              "bitwise": {}, "spills": {}}
    dev = torch.device("cuda", 0)
    cases = ab.on_build(builds["kept"], lambda: ab.step_cases(torch, dev))()
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
