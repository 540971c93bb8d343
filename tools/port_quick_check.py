#!/usr/bin/env python3
"""The quickest check of the port's kernels on one NVIDIA card (~4 min with the build).

    python3 tools/port_quick_check.py     # from the repository root

Builds every kernel library (each source for each variant: each system with each obstacle
aggregation and each barrier, _build.VARIANTS, 42 libraries, of which chip_smoke.py runs 24)
and prints ptxas' registers and spills; then, for Dubins, each `bench.py` BENCH_SYSTEM family
and each of chip_smoke.MINLOG's configurations (the exact min, the log barrier), holds K1-K4
against their plain versions on one closed-loop step's inputs (chip_smoke.paper_step) and
K5/K6 on one coupled step's (chip_smoke.coupled_step: Dubins' bench.py coupled setup, a
config with adaptation.adapt_nominal: true) in f64 and f32, at the main shape (B=16384,
N=50, each kernel timed over 10 launches) and at B=1000, N=37 (there with 1 and 8
obstacles for the systems that have obstacles), at chip_smoke's tolerances, saying whether
each agrees bitwise; last, five steps of each family's paper and coupled loops at full
width, with the launch counts. It checks the kernels and nothing else of chip_smoke.py's contract: use it
after a kernel edit, before the whole script. Exits 1 if any check fails.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_quick_check: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from tube_mpc_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.presets import family_coupled_setup, family_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_generic_closed_loop_lanes

    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    secs = _build.build(_build.LIBRARIES)
    print("[build]", round(time.perf_counter() - t0, 1),
          json.dumps({k: round(v, 1) for k, v in secs.items()}), flush=True)
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {cs.kernel_label(line.strip())}", flush=True)

    dev = torch.device("cuda", 0)
    fails = []

    def ragged(t):
        return (t[:cs.RAGGED_N, :, :cs.RAGGED_B] if t.ndim == 3 else t[:, :cs.RAGGED_B]).contiguous()

    steps = [(family, step_of) for family in ("dubins",) + cs.FAMILIES + tuple(cs.MINLOG)
             for step_of in (cs.paper_step, cs.coupled_step)]
    for family, step_of in steps:
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).replace("torch.", "")
            pb, eps, make, inputs, _ = step_of(torch, dev, dtype, family)
            variants = [("main", pb, lambda t: t)]
            if pb.spec.centers:
                for c in (pb.spec.centers[:1],
                          pb.spec.centers + cs.EXTRA_CENTERS[:8 - len(pb.spec.centers)]):
                    variants.append((f"{len(c)} obs ragged", cs.with_obstacles(pb, c, eps), ragged))
            else:
                variants.append(("ragged", pb, ragged))
            for label, q, cut in variants:
                fns = make(q)
                for k, t in inputs.items():
                    ins = tuple(map(cut, t))
                    got, ref = fns[k][0](*ins), fns[k][1](*ins)
                    torch.cuda.synchronize()
                    err, ok = cs.max_err(torch, got, ref, *cs.TOL[dname][k])
                    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
                    ms = (cs.device_time_ms(torch, lambda: fns[k][0](*ins), 10)
                          if label == "main" else float("nan"))
                    print(f"[check] {family} {dname} {label} {k}: err {err!r} ok {ok} "
                          f"bitwise {bitwise} ms {ms:.4f}", flush=True)
                    if not ok:
                        fails.append((family, dname, label, k))
            del inputs
            torch.cuda.empty_cache()

    for family in cs.FAMILIES:
        for mode in ("paper", "coupled"):
            if mode == "paper":
                s = family_paper_setup(family, N=cs.N, H=5, device=dev, dtype=torch.float32)
                run = lambda w: cs.run_paper_loop(s, w, dev)
            else:
                s, raw_nom, raw_aux = family_coupled_setup(family, N=cs.N, H=5, device=dev,
                                                           dtype=torch.float32)
                run = lambda w: run_generic_closed_loop_lanes(
                    s.system, s.aug, s.sys_c, s.cfg, raw_nom=raw_nom, raw_aux_init=raw_aux,
                    x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device=dev)[0]
            w = cs.torch_draw(s.system, torch.Generator(device=dev).manual_seed(1), (cs.B, 5),
                              torch.float32)
            reset_launch_counts()
            t1 = time.perf_counter()
            out = run(w)
            torch.cuda.synchronize()
            print(f"[loop] {family} {mode} H=5: {time.perf_counter() - t1:.2f} s, finite "
                  f"{float(torch.isfinite(out.loss[:, -1]).float().mean())!r}, launches "
                  f"{launch_counts()}", flush=True)
    print("[done]", round(time.perf_counter() - t0, 1), "s; fails:", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
