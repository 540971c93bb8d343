#!/usr/bin/env python3
"""Where K1's (`ric_kernel`, csrc/lane_solver.cu) time and register spills go, on one
NVIDIA card, in one process.

    python3 tools/ric_probe.py     # from the repository root

1. Builds variants of this tree's `tube_mpc_tpu_torch/csrc/lane_solver.cu`, each one
   textual edit of the source (VARIANTS), all in parallel with the package's nvcc flags,
   and prints each variant's ptxas registers and spills of ric_kernel<float, 5>:
   - kept:   the source as it is;
   - A only: warp 0 skips the recursion, so phase A and the barriers remain;
   - B only: the linearising warps skip phase A, so the recursion (over whatever
             shared memory holds) and the barriers remain;
   - kc2, kc4, kc6: RIC_KC steps per chunk, not 3 (f32 only: the f64 buffers pass
             48 KB from 4 steps up, so these drop the launcher's static_assert);
   - cap3, cap2: 3 or 2 f32 blocks per SM in __launch_bounds__ (at most 168 or 255
             registers a thread), not 4 (128).
2. Times lane_ric_f32 of every variant on the paper step's inputs of
   tools/port_kernel_ab.py (B=16384, N=50), in turns (every variant, then every
   variant in reverse order), each the device time per launch of RUNS launches back
   to back, and says whether each variant's K and kff are bitwise those of `kept`.
3. Compiles `kept` once more to a cubin with -lineinfo (which leaves the code as it
   is; the script prints that cubin's ptxas spills beside the library's), disassembles
   it with nvdisasm -gi, and counts each instantiation's local-memory stores and loads
   (STL, LDL: the register spills) by where their source line lies: phase A
   (`lin_step`, the `linearise` lambda and its first call, in every warp, for the
   first chunk; the linearising warps' loop), phase B (`ric_step`, warp 0's loop),
   or else by that line. The stack frame of the math library's out-of-line paths,
   which every f64 instantiation has, shows at the kernel's last line.

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
KC_ASSERT = (r"static_assert\(smem[^;]*;", "")
VARIANTS = {  # name: [(regex, replacement)], each regex matching exactly once
    "kept": [],
    "A only": [(r"ric_step\(buf[^;]*;", "(void)buf;")],
    "B only": [(r"lin_step<NOBS>\([^;]*;", "(void)buf;")],
    **{f"kc{kc}": [(r"constexpr int RIC_KC = 3;", f"constexpr int RIC_KC = {kc};"), KC_ASSERT]
       for kc in (2, 4, 6)},
    **{f"cap{n}": [(r"sizeof\(T\) == 4 \? 4 : 1", f"sizeof(T) == 4 ? {n} : 1")] for n in (3, 2)},
}
PROBED = "ric_kernel<float, 5>"   # the paper's instantiation, whose ptxas lines are printed


def variant_source(text: str, edits) -> str:
    for pattern, repl in edits:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise SystemExit(f"ric_probe: {pattern!r} matched {n} times in lane_solver.cu")
    return text


def ptxas_lines(log: str, label, kernel: str):
    """The ptxas lines of `kernel` (a label as chip_smoke.kernel_label writes it)."""
    lines = [label(x.strip()) for x in log.splitlines()]
    for i, x in enumerate(lines):
        if "Compiling entry" in x and f"'{kernel}'" in x:
            return [y for y in lines[i + 1:i + 4] if "spill" in y or "registers" in y]
    return []


def line_ranges(src_lines):
    """{part: (first, last) source line, 1-based} of K1's parts in lane_solver.cu."""
    def span(start, end):
        lo = next(i for i, x in enumerate(src_lines) if start(x))
        hi = next(i for i in range(lo + 1, len(src_lines)) if end(src_lines[i]))
        return lo + 1, hi + 1
    return {
        "A": [span(lambda x: "void lin_step(" in x, lambda x: x == "}"),
              span(lambda x: "auto linearise" in x, lambda x: "linearise(0, " in x),
              span(lambda x: x.strip() == "} else {", lambda x: x == "  }")],
        "B": [span(lambda x: "void ric_step(" in x, lambda x: x == "}"),
              span(lambda x: "if (warp == 0) {" in x, lambda x: x.strip() == "} else {")],
    }


def spill_sites(sass: str, src_name: str, ranges):
    """{kernel symbol: Counter((STL or LDL, part))}: each local-memory instruction is
    placed by the innermost frame of its line-info chain that lies in `src_name`, in
    phase A or B by `ranges`, or else as "line N"."""
    counts, fn, chain = {}, None, []
    for line in sass.splitlines():
        if "/*" not in line:
            m = re.search(r"\.text\.(_Z\w+)", line)
            if m:
                fn = m.group(1)
                continue
        if "//##" in line:
            chain = re.findall(r'"([^"]+)", line (\d+)', line)
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?(STL|LDL)\b", line)
        if not (m and fn):
            continue
        part = "unplaced"
        for f, ln in chain:
            if Path(f).name == src_name:
                ln = int(ln)
                part = next((p for p, spans in ranges.items()
                             if any(lo <= ln <= hi for lo, hi in spans)), f"line {ln}")
                break
        counts.setdefault(fn, Counter())[(m.group(1), part)] += 1
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
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "lane_solver.cu"
    text = src.read_text()
    nvcc = _build.nvcc_path()
    include = ["-I", str(_build.CSRC)]
    procs = {}
    for name, edits in VARIANTS.items():
        path = out_dir / f"{name.replace(' ', '_')}.cu"
        path.write_text(variant_source(text, edits))
        procs[name] = ab.build(nvcc, [*_build.NVCC_FLAGS, *include], path,
                               path.with_suffix(".so"))
    cubin_flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = out_dir / "kept_lineinfo.cubin"
    procs["kept, -lineinfo cubin"] = ab.build(nvcc, ["-cubin", "-lineinfo", *cubin_flags], src,
                                              cubin)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ric_probe: nvcc failed on {name}:\n{log}")
        print(f"[build] {name}: {PROBED}: {' | '.join(ptxas_lines(log, label, PROBED))}",
              flush=True)
        if name in VARIANTS:
            libs[name] = ctypes.CDLL(str(out_dir / f"{name.replace(' ', '_')}.so"))

    result = {"card": card, "B": ab.B, "N": ab.N, "runs": RUNS, "ms": {}, "bitwise": {},
              "spills": {}}
    dev = torch.device("cuda", 0)
    _, fn, ins, outs_of, consts = ab.paper_step_cases(torch, dev)["lane_ric_f32"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {name: outs_of() for name in libs}
    runs = {name: ab.entry_call(lib, fn, ins, outs[name], consts, stream)
            for name, lib in libs.items()}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    for name in libs:
        result["bitwise"][name] = ab.bitwise_equal(torch, outs[name], outs["kept"])
        result["ms"][name] = []
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            result["ms"][name].append(chip_smoke.device_time_ms(torch, runs[name], RUNS))
    for name in libs:
        print(f"[time] {name}: {', '.join(f'{t!r}' for t in result['ms'][name])} ms (mean of "
              f"{RUNS} back to back, twice); K, kff bitwise those of kept: "
              f"{result['bitwise'][name]}", flush=True)

    tool = shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm"
    sass = subprocess.run([tool, "-gi", "-c", str(cubin)], capture_output=True, text=True,
                          timeout=600, check=True).stdout
    ranges = line_ranges(text.splitlines())
    print(f"[sass] lane_solver.cu lines of phase A {ranges['A']}, of phase B {ranges['B']}",
          flush=True)
    for sym, c in sorted(spill_sites(sass, src.name, ranges).items(), key=lambda kv: label(kv[0])):
        if "ric_kernel" not in sym and "fwd_kernel" not in sym:
            continue
        by = {f"{op} {part}": n for (op, part), n in sorted(c.items())}
        result["spills"][label(sym)] = by
        print(f"[sass] {label(sym)}: local-memory instructions {json.dumps(by)}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
