#!/usr/bin/env python3
"""Compare the port's paper-path kernels (K1 `ric`, K2 `fwd`, K3 `sbwd`, K4 `sfwd`) of this
tree with those of another checkout, on one NVIDIA card, in one process.

    python3 tools/port_kernel_ab.py BASE_DIR     # from the repository root

BASE_DIR holds another commit's tree (e.g. `git archive <commit>` unpacked into a
gitignored directory). Both trees' `tube_mpc_tpu_torch/csrc/lane_solver.cu` and
`lane_sensitivity.cu` are built with this tree's nvcc flags, all four in parallel; the
script prints each build's ptxas registers, shared memory and spills and, where
`cuobjdump` is found, the SASS instruction count of each kernel. Then it times the f32
entry points `lane_ric_f32`, `lane_fwd_f32` (at nα=7 and at the rollout's nα=1),
`lane_sbwd_f32` and `lane_sfwd_f32` of both builds on the same inputs (one closed-loop
step of the paper setup at B=16384, N=50, after three disturbed steps: the first
iteration of the ancillary solve for K1/K2, the sensitivity of its solution for K3/K4),
in the order base, this, this, base, each the device time per launch of RUNS launches
back to back (chip_smoke.device_time_ms), and requires the two builds' outputs to be
bitwise equal. The last line is one JSON object with the times.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

B, N = 16384, 50
RUNS = 50
SEED = 1
SOURCES = ("lane_solver", "lane_sensitivity")


def build(nvcc: str, flags, src: Path, out: Path):
    cmd = [nvcc, *flags, "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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


def paper_step_cases(torch, dev):
    """The f32 entry points' inputs on one closed-loop step of the paper setup at B, N:
    {label: (source, entry point, inputs, a factory of fresh outputs, constants)}."""
    from tube_mpc_tpu_torch.ops.costs import CostWeights
    from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import kernel_consts, ric, rollout
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import make_paper_lane_step, paper_lane_init_state
    from tube_mpc_tpu_torch.tube.lane_interface import (
        _build_C, _rows, _with_barrier_row, make_lane_problem, tube_ilqr_solve_lanes)

    dtype = torch.float32
    s = dubins_paper_setup(N=N, H=4, device=dev, dtype=dtype)
    pb = make_lane_problem(s.sys_c, eps=s.eps)
    step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                target=s.target, B=B, dtype=dtype, device=dev)
    state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                  x0=s.x0, B=B, dtype=dtype)
    w = s.system.sample_disturbance(torch.Generator(device=dev).manual_seed(SEED), (B, 3),
                                    dtype=dtype)
    for t in range(3):
        state, _ = step(state, w[:, t])
    X_nom, U_nom = tube_ilqr_solve_lanes(
        pb, s.cfg.nominal_ilqr(), w=s.w_nominal, bp=s.bp,
        x_hat0=torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1), U_init=state.U_nom_ws,
        X_ref=s.target[None, None].expand(B, N + 1, 3),
        U_ref=torch.zeros((B, N, 2), dtype=dtype, device=dev), device=dev)
    a = state.adapt
    w_aux = CostWeights(Q=a.Q, R=a.R, Qf=a.Q, qb=a.qb)
    x_hat = torch.cat([state.x, state.b[:, None]], -1)
    X_aux, U_aux = tube_ilqr_solve_lanes(
        pb, s.cfg.aux_ilqr(), w=w_aux, bp=s.bp, x_hat0=x_hat,
        U_init=state.U_aux_ws, X_ref=X_nom[..., :3], U_ref=U_nom, device=dev)
    C = _build_C(pb, w_aux, s.bp, B, dtype, dev)
    Xa, Ua = _rows(X_aux), _rows(U_aux)
    Xr, Ur = _rows(_with_barrier_row(X_nom[..., :3])), _rows(U_nom)
    x0, U0 = _rows(x_hat), _rows(s.system.clamp(state.U_aux_ws))
    X0 = rollout(pb, x0, U0, Xr, Ur, C)
    phix = C[6:10] * (X0[-1] - Xr[-1])            # the terminal rows of C
    k1 = (X0[:-1].contiguous(), U0, Xr[:-1].contiguous(), Ur, C, phix)
    Kg, kffg = ric(pb, s.cfg.reg, *k1)
    k2 = (x0, X0[:-1].contiguous(), U0, Kg, kffg, Xr[:-1].contiguous(), Xr[-1], Ur, C)
    reg, active_tol = 1e-9, 1e-8
    k3 = (Ua, Xa[:-1].contiguous(), Xr[:-1].contiguous(), C, Xa[-1], Xr[-1])
    K, kff = sbwd(pb, reg, active_tol, *k3)
    k4 = (K, kff, Xa[:-1].contiguous(), Xr[:-1].contiguous(), Ua, Ur, C, Xa[-1], Xr[-1])
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=dev)
    na = len(s.cfg.alphas)
    return {
        "lane_ric_f32": ("lane_solver", "lane_ric_f32", k1, lambda: (new(N, 8, B), new(N, 2, B)),
                         kernel_consts(pb, reg=s.cfg.reg)),
        f"lane_fwd_f32 (nα={na})": (
            "lane_solver", "lane_fwd_f32", k2,
            lambda: (new(N, 4 * na, B), new(N, 2 * na, B), new(na, B)),
            kernel_consts(pb, alphas=s.cfg.alphas)),
        "lane_fwd_f32 (nα=1)": ("lane_solver", "lane_fwd_f32", k2,
                                lambda: (new(N, 4, B), new(N, 2, B), new(1, B)),
                                kernel_consts(pb, alphas=(1.0,))),
        "lane_sbwd_f32": ("lane_sensitivity", "lane_sbwd_f32", k3,
                          lambda: (new(N, 8, B), new(N, 2, B)),
                          kernel_consts(pb, reg=reg, active_tol=active_tol)),
        "lane_sfwd_f32": ("lane_sensitivity", "lane_sfwd_f32", k4, lambda: (new(4, B), new(2, B)),
                          kernel_consts(pb)),
    }


def entry_call(lib, fn, ins, outs, consts, stream):
    """A no-argument call of the C entry point `fn` of `lib` on these tensors."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * (len(ins) + len(outs)) + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 2
    f.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in list(ins) + list(outs)]

    def run():
        err = f(*ptrs, N, B, ctypes.addressof(consts), stream)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err}")
    return run


def bitwise_equal(torch, xs, ys) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))   # NaNs too
               for a, b in zip(xs, ys))


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
    nvcc = _build.nvcc_path()
    srcs = {(tree, name): root / "tube_mpc_tpu_torch/csrc" / f"{name}.cu"
            for tree, root in (("base", base), ("this", REPO)) for name in SOURCES}
    procs = {key: build(nvcc, _build.NVCC_FLAGS, src, out_dir / f"lib{key[0]}_{key[1]}.so")
             for key, src in srcs.items()}
    libs = {}
    for key, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {srcs[key]}:\n{log}")
        tree = key[0]
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {tree}: {chip_smoke.kernel_label(line.strip())}", flush=True)
        so = out_dir / f"lib{tree}_{key[1]}.so"
        for sym, n in sass_counts(so).items():
            print(f"[sass] {tree}: {chip_smoke.kernel_label(sym)}: {n} instructions", flush=True)
        libs[key] = ctypes.CDLL(str(so))

    dev = torch.device("cuda", 0)
    cases = paper_step_cases(torch, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card, "B": B, "N": N, "runs": RUNS, "ms": {}}
    for label, (src, fn, ins, outs_of, consts) in cases.items():
        outs = {tree: outs_of() for tree in ("base", "this")}
        runs = {tree: entry_call(libs[tree, src], fn, ins, outs[tree], consts, stream)
                for tree in outs}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        same = bitwise_equal(torch, outs["base"], outs["this"])
        times = []
        for tree in ("base", "this", "this", "base"):
            times.append((tree, chip_smoke.device_time_ms(torch, runs[tree], RUNS)))
        result["ms"][label] = times
        print(f"[time] {label}: " + ", ".join(f"{k} {ms!r} ms" for k, ms in times)
              + f" (mean of {RUNS} back to back); outputs bitwise equal: {same}", flush=True)
        if not same:
            raise SystemExit(f"port_kernel_ab: {label} differs between the two builds")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
