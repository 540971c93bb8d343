#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. device:  the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build:   nvcc builds the two kernel sources (four kernels) from csrc/, in parallel;
3. kernels: each kernel against its plain PyTorch version on the same inputs, at the
            main path's shapes (B=16384, N=50, n̂=4, m=2, nα=7) in f64 and in f32.
            The inputs are those of a real closed-loop step of the paper setup
            (after three disturbed steps, so that the lanes differ); some of its
            ancillary controls must lie at a bound, so that K3's active set runs.
            Each kernel is timed with CUDA events (median of 20 runs) beside its
            plain version;
4. loop64:  a short f64 closed loop (B=256, N=50, H=5) through the kernels on the
            card and through the plain versions on the CPU, held at the
            tolerances of tests/test_lane_closed_loop.py:45-50;
5. main:    the full-width slice, B=16384, N=50, H=300 in f32, disturbances from a
            seeded torch.Generator on the card; every kernel must have launched in
            this run (the launch counts are set to 0 just before it), K3 and K4
            exactly H times, and at least 99% of the lanes must end with a finite loss;
6. profile: torch.profiler over five full-width steps: the device's busy share and
            the device time of the four kernels and of PyTorch's own kernels.

Then it prints the `kernels` JSON line, the card's name and power limit, and, as
the last line, {"ok": true, "device": {...}}. With no card it exits non-zero at once.
It takes no arguments: every size is fixed below, so a result line always stands
for the whole run at full width.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and float32 / float64 outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

SEED = 0  # every random number here comes from torch.Generator seeded from it

B, N, H = 16384, 50, 300  # the main path: bench.py's paper workload, full width and depth
RUNS = 20                 # timed runs per kernel
LOOP64_B, LOOP64_H = 256, 5
PROFILE_H = 5

KERNELS = {
    # name: (source, the Pallas kernel it replaces)
    "ric": ("tube_mpc_tpu_torch/csrc/lane_solver.cu", "tube_mpc_tpu/ops/pallas/lane_solver.py:78"),
    "fwd": ("tube_mpc_tpu_torch/csrc/lane_solver.cu", "tube_mpc_tpu/ops/pallas/lane_solver.py:196"),
    "sbwd": ("tube_mpc_tpu_torch/csrc/lane_sensitivity.cu",
             "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48"),
    "sfwd": ("tube_mpc_tpu_torch/csrc/lane_sensitivity.cu",
             "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:172"),
}

# Kernel against plain version: (rtol, atol as a fraction of the largest finite |value| of
# the same output row, i.e. the same component index across steps and lanes, so that the
# barrier rows, which reach 1/eps and more, set no tolerance for the position rows).
# f64: the CPU tests' tolerances (tests/test_torch_lane_solver.py, test_torch_lane_sensitivity.py).
# f32: the two run the same operations in the same order (-fmad=false), so they differ only
# where the card's math library rounds sin/cos/exp/log differently inside a kernel than in
# PyTorch's; the Riccati recursions carry such a last-bit difference over 50 steps, so 1e-4
# of the row's scale holds what f32 can promise. Where the plain output is not finite, the
# kernel's must be the same (NaN where NaN, the same infinity) in either type.
TOL = {
    "float64": {"ric": (1e-12, 1e-12), "fwd": (1e-12, 1e-12), "sbwd": (1e-9, 1e-11),
                "sfwd": (1e-9, 1e-11)},
    "float32": {k: (1e-4, 1e-4) for k in KERNELS},
}
LOOP_TOL = {  # tests/test_lane_closed_loop.py:45-50
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-8), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-8, 1e-11), "R_hist": (1e-8, 1e-11), "qb_hist": (1e-8, 1e-11),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_time_ms(torch, fn, runs: int, warmup: int = 2) -> float:
    """Median over `runs` of one call's device time, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def count_ops(torch, fn, args, lanes: int) -> int:
    """Arithmetic operations of a plain version on the first `lanes` lanes of its
    inputs: every elementwise arithmetic or comparison op counts one per element."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = {"add", "sub", "rsub", "mul", "div", "neg", "exp", "log", "sin", "cos", "abs",
               "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne",
               "ge", "gt", "le", "lt", "isfinite", "isnan", "bitwise_or", "bitwise_and",
               "logical_or", "logical_and", "bitwise_not", "logical_not", "reciprocal",
               "_to_copy"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func.overloadpacket.__name__ in counted and isinstance(out, torch.Tensor):
                Counter.ops += out.numel()
            return out

    small = [t[..., :lanes].contiguous() if isinstance(t, torch.Tensor) else t for t in args]
    with Counter():
        fn(*small)
    return Counter.ops


def max_err(torch, got, ref, rtol, atol_frac):
    """(max |got - ref| where ref is finite, inf if got is not finite there; whether the
    outputs agree): where ref is finite, |got - ref| <= rtol |ref| + atol_frac * (largest
    finite |ref| of the element's row, dim -2); elsewhere got equals ref, or both are NaN."""
    worst, ok = 0.0, True
    for g, r in zip(got, ref):
        fin = torch.isfinite(r)
        ra = torch.where(fin, r.abs(), torch.zeros_like(r))
        scale = ra.amax(dim=[d for d in range(r.ndim) if d != r.ndim - 2], keepdim=True)
        d = torch.where(fin, (g - r).abs().nan_to_num(nan=float("inf")), torch.zeros_like(r))
        within = d <= rtol * ra + atol_frac * scale
        same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        ok = ok and bool(torch.where(fin, within, same).all())
        worst = max(worst, float(d.max()))
    return worst, ok


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from tube_mpc_tpu_torch.ops.costs import CostWeights
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sfwd_plain
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric_plain, rollout
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import (
        make_paper_lane_step,
        paper_lane_init_state,
        run_paper_closed_loop_lanes,
    )
    from tube_mpc_tpu_torch.tube.lane_interface import (
        _build_C,
        _rows,
        _with_barrier_row,
        make_lane_problem,
        tube_ilqr_solve_lanes,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()

    # ---- 1. device ------------------------------------------------------------
    log(f"[device] {card}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"[build] {len(seconds)} sources built in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in seconds.items()})})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. kernels against their plain versions --------------------------------
    reg_sens, active_tol = 1e-9, 1e-8

    def step_inputs(dtype):
        """The four kernels' inputs in one real closed-loop step of the paper setup at
        full width: three disturbed steps first, then this step's nominal solve, the
        first iteration of its ancillary solve, and the sensitivity of its solution."""
        s = dubins_paper_setup(N=N, H=4, device=dev, dtype=dtype)
        pb = make_lane_problem(s.sys_c, eps=s.eps)
        step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                    target=s.target, B=B, dtype=dtype, device=dev)
        state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                      x0=s.x0, B=B, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        w = s.system.sample_disturbance(gen, (B, 3), dtype=dtype)
        for t in range(3):
            state, _ = step(state, w[:, t])
        x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
        X_ref_nom = s.target[None, None].expand(B, N + 1, 3)
        U_ref_nom = torch.zeros((B, N, 2), dtype=dtype, device=dev)
        X_nom, U_nom = tube_ilqr_solve_lanes(
            pb, s.cfg.nominal_ilqr(), w=s.w_nominal, bp=s.bp, x_hat0=x_hat_bar,
            U_init=state.U_nom_ws, X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev)
        x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
        a = state.adapt
        w_aux = CostWeights(Q=a.Q, R=a.R, Qf=a.Q, qb=a.qb)
        C = _build_C(pb, w_aux, s.bp, B, dtype, dev)
        x0 = _rows(x_hat)
        U0 = _rows(s.system.clamp(state.U_aux_ws))
        Xr = _rows(_with_barrier_row(X_nom[..., :3]))
        Ur = _rows(U_nom)
        X0 = rollout(pb, x0, U0, Xr, Ur, C)
        nh, m = pb.n_hat, pb.m
        phix = C[nh + m:2 * nh + m] * (X0[-1] - Xr[-1])   # terminal rows of C
        k1 = (X0[:-1], U0, Xr[:-1], Ur, C, phix)
        K, kff = WRAPPERS["ric"](pb, s.cfg.reg, *k1)
        k2 = (x0, X0[:-1], U0, K, kff, Xr[:-1], Xr[-1], Ur, C)
        X_aux, U_aux = tube_ilqr_solve_lanes(
            pb, s.cfg.aux_ilqr(), w=w_aux, bp=s.bp, x_hat0=x_hat, U_init=state.U_aux_ws,
            X_ref=X_nom[..., :3], U_ref=U_nom, device=dev)
        Xa, Ua = _rows(X_aux), _rows(U_aux)
        k3 = (Ua, Xa[:-1], Xr[:-1], C, Xa[-1], Xr[-1])
        Ks, kffs = WRAPPERS["sbwd"](pb, reg_sens, active_tol, *k3)
        k4 = (Ks, kffs, Xa[:-1], Xr[:-1], Ua, Ur, C, Xa[-1], Xr[-1])
        torch.cuda.synchronize()
        at_bound = int(((Ua <= -10.0 + active_tol) | (Ua >= 10.0 - active_tol)).sum())
        calls = {
            "ric": (lambda *t: WRAPPERS["ric"](pb, s.cfg.reg, *t),
                    lambda *t: ric_plain(pb, s.cfg.reg, *t), k1),
            "fwd": (lambda *t: WRAPPERS["fwd"](pb, s.cfg.alphas, *t),
                    lambda *t: fwd_plain(pb, s.cfg.alphas, *t), k2),
            "sbwd": (lambda *t: WRAPPERS["sbwd"](pb, reg_sens, active_tol, *t),
                     lambda *t: sbwd_plain(pb, reg_sens, active_tol, *t), k3),
            "sfwd": (lambda *t: WRAPPERS["sfwd"](pb, *t), lambda *t: sfwd_plain(pb, *t), k4),
        }
        return calls, at_bound, len(s.cfg.alphas)

    results = {}
    failed = []
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        calls, at_bound, n_alphas = step_inputs(dtype)
        log(f"[kernels] {dname}: inputs from a closed-loop step at B={B}, N={N}, "
            f"{n_alphas} alphas; {at_bound} ancillary controls at a bound")
        if at_bound == 0:
            failed.append(f"{dname} inputs: no ancillary control at a bound, K3's active set unchecked")
        for name, (kernel, plain, inputs) in calls.items():
            got = kernel(*inputs)
            ref = plain(*inputs)
            torch.cuda.synchronize()
            rtol, atol_frac = TOL[dname][name]
            err, ok = max_err(torch, got, ref, rtol, atol_frac)
            nonfinite = sum(int((~torch.isfinite(r)).sum()) for r in ref)
            log(f"[kernels] {dname} {name}: max |kernel - plain| = {err!r} "
                f"(rtol {rtol}, atol {atol_frac} of the row's max|plain|) -> "
                f"{'ok' if ok else 'FAIL'}; {nonfinite} non-finite values in the plain output")
            if not ok:
                failed.append(f"{dname} {name}")
            if dtype != torch.float32:
                continue
            ms = device_time_ms(torch, lambda: kernel(*inputs), RUNS)
            plain_ms = device_time_ms(torch, lambda: plain(*inputs), RUNS, warmup=1)
            out_bytes = sum(t.numel() * t.element_size() for t in got)
            in_bytes = sum(t.numel() * t.element_size() for t in inputs)
            lanes = 8
            ops = count_ops(torch, plain, inputs, lanes) * (B // lanes)
            t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
            results[name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=in_bytes + out_bytes, ops=ops)
            log(f"[kernels] {dname} {name}: {ms:.4f} ms (median of {RUNS}), plain "
                f"{plain_ms:.2f} ms; {in_bytes + out_bytes} bytes -> {t_bytes:.4f} ms, "
                f"{ops} ops -> {t_ops:.4f} ms at peak")
        del calls
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")

    # ---- 4. short f64 closed loop: kernels on the card vs plain versions on the CPU ----
    logs = {}
    for where in ("cpu", dev):
        s = dubins_paper_setup(N=N, H=LOOP64_H, device=where, dtype=torch.float64)
        w = s.system.sample_disturbance(torch.Generator().manual_seed(SEED + 2),
                                        (LOOP64_B, LOOP64_H), dtype=torch.float64).to(where)
        t0 = time.perf_counter()
        out = run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device=where)
        if where != "cpu":
            torch.cuda.synchronize()
        log(f"[loop64] B={LOOP64_B}, N={N}, H={LOOP64_H} f64 on {where}: "
            f"{time.perf_counter() - t0:.1f} s")
        logs[where] = out
    bad = []
    for field, (rtol, atol) in LOOP_TOL.items():
        a, b = getattr(logs[dev], field).cpu(), getattr(logs["cpu"], field)
        d = (a - b).abs()
        ok = bool((d <= atol + rtol * b.abs()).all())
        log(f"[loop64] {field}: max |card - cpu| = {float(d.max())!r} "
            f"(rtol {rtol}, atol {atol}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(field)
    if bad:
        raise SystemExit(f"chip_smoke: the f64 loop on the card disagrees with the plain loop: {bad}")

    # ---- 5. the full-width main path ---------------------------------------------
    s = dubins_paper_setup(N=N, H=H, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = s.system.sample_disturbance(gen, (B, H), dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_paper_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
        bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device=dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
    shapes_ok = (tuple(out.x_real.shape) == (B, H, 3) and tuple(out.u_real.shape) == (B, H, 2)
                 and tuple(out.loss.shape) == (B, H) and tuple(out.Q_hist.shape) == (B, H, 3))
    log(f"[main] B={B}, N={N}, H={H} f32: {elapsed:.3f} s, {2 * H * B / elapsed:.1f} solves/s "
        f"(2*H*B / elapsed), finite_lane_frac {finite!r}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"[main] launches: {json.dumps(counts)}; final loss median "
        f"{float(out.loss[:, -1].nanmedian())!r}")
    problems = [k for k, v in counts.items() if v == 0]
    if problems:
        raise SystemExit(f"chip_smoke: kernels not launched on the main path: {problems}")
    if counts["sbwd"] != H or counts["sfwd"] != H:
        raise SystemExit(f"chip_smoke: K3/K4 launched {counts['sbwd']}/{counts['sfwd']} times, not H={H}")
    if finite < 0.99:
        raise SystemExit(f"chip_smoke: finite_lane_frac {finite} < 0.99")
    if not shapes_ok:
        raise SystemExit("chip_smoke: the closed-loop log has the wrong shapes")

    # ---- 6. where the time goes: torch.profiler over a few full-width steps ---------
    from torch.profiler import ProfilerActivity, profile

    s = dubins_paper_setup(N=N, H=PROFILE_H, device=dev, dtype=torch.float32)
    w = s.system.sample_disturbance(torch.Generator(device=dev).manual_seed(SEED + 3),
                                    (B, PROFILE_H), dtype=torch.float32)

    def run():
        run_paper_closed_loop_lanes(
            s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
            bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, device=dev)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op on the host also reports the
        # device time of the kernels it launched, which would count them twice
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    ours = sum(r[0] for r in rows if any(f"{k}_kernel" in r[2] for k in KERNELS)) / 1e6
    log(f"[profile] {PROFILE_H} steps at B={B}, N={N}, f32: {plain_wall:.3f} s unprofiled, "
        f"{wall:.3f} s profiled; device busy {busy:.3f} s ({busy / wall:.1%} of the profiled "
        f"wall, {busy / plain_wall:.1%} of the unprofiled), of which the four kernels "
        f"{ours:.3f} s and PyTorch's own kernels {busy - ours:.3f} s")
    for us, count, key in rows[:12]:
        log(f"[profile]   {us / 1e3:10.3f} ms  x{count:<6d} {key[:110]}")

    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=counts[name], max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": line}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
