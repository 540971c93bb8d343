#!/usr/bin/env python3
"""Trace the cart-pole paper loop's non-finite lanes of bench.py's draw: on the CPU the lanes
alone through the port's lane loop (its plain versions) and the JAX package's (Pallas in
interpret mode); on the card the whole batch through the kernels and their plain versions.

    python3 tools/cartpole_nonfinite_trace.py --lanes 2278 4463 --steps 12 11
    python3 tools/cartpole_nonfinite_trace.py --device cuda --lanes 2278 4463 --steps 12 11

--lanes are lanes of bench.py's BENCH_SYSTEM=cartpole run (B=16384, N=50, H=300, f32) whose
last loss is not finite, --steps each one's first step with a logged value not finite, as
chip_smoke.py's phase prng (b) prints them from the card. The disturbances are
sample_disturbance(PRNGKey(0), (16384, 300)) of the cart-pole's setup, drawn again here by
the port's threefry copy (bitwise the JAX package's draw), cut to H = the last step given + 1
(the loop is causal) and, on the CPU, to those lanes.

On the CPU each lane runs four ways: the port and the JAX package in f32 (as bench.py runs),
then both in f64 (configs/cartpole.yaml with use_float64). On the card (no JAX): the whole
batch (B=16384, H cut) through the kernels and through the plain versions on the card
(chip_smoke.plain_on_card: the same operations with the card's math library; ~6 min), held
bitwise against each other field by field, then the lanes alone through the kernels in f32
and f64: the configuration clips the adaptation's gradient by its norm over every lane
(params.momentum_update, as the JAX package and the reference do), so a lane's run depends
on the whole batch and a replay of the lanes alone is another run. For each it prints each
lane's first step with a logged value not finite (or "finite") and the fields not finite
there, the last loss, and on the CPU the largest |port - JAX| of x_real and u_real over the
steps both keep finite, and how far the port's f64 loop moves when the disturbances are
scaled by 1 + 1e-15. It checks nothing: it prints, and exits 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

B_BENCH, N, H_BENCH = 16384, 50, 300
FIELDS = ("x_real", "u_real", "x_bar", "u_bar", "b_real", "loss")


def first_nonfinite(np, log):
    """Each lane's (first step with a logged value not finite or -1, the fields not finite
    there): log is {field: [L, H, ...]}."""
    ok = {f: np.isfinite(np.asarray(v)).reshape(v.shape[0], v.shape[1], -1).all(-1)
          for f, v in log.items()}
    every = np.stack(list(ok.values())).all(0)
    out = []
    for i, row in enumerate(every):
        t = int(np.argmin(row)) if not row.all() else -1
        out.append((t, [f for f in ok if t >= 0 and not ok[f][i, t]]))
    return out


def port_loop(torch, w, Hc, dtype, device):
    """The port's cart-pole paper lane loop on `device` under w [L, Hc, 4] -> {field: numpy}."""
    from tube_mpc_tpu_torch.presets import family_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

    s = family_paper_setup("cartpole", N=N, H=Hc, device=device, dtype=dtype)
    log = run_paper_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp,
        x0=s.x0, target=s.target, w_seqs=w.to(device=device, dtype=dtype), eps=s.eps,
        barrier_type=s.barrier_type, device=device)
    return {f: getattr(log, f).double().cpu().numpy() for f in FIELDS}


def show(np, what, lanes, log, seconds):
    print(f"[{what}] {seconds:.1f} s", flush=True)
    for lane, (t, fields), loss in zip(lanes, first_nonfinite(np, log), log["loss"][:, -1]):
        at = "finite" if t < 0 else f"step {t} ({', '.join(fields)})"
        print(f"[{what}] lane {lane}: {at}, last loss {float(loss)!r}", flush=True)


def bitwise(np, a, b) -> bool:
    return a.shape == b.shape and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def on_card(torch, np, lanes, Hc, w):
    """w: the whole draw [B_BENCH, Hc, 4] on the card."""
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    full = {}
    for what, ctx in (("kernels", None), ("plain versions on the card", cs.plain_on_card)):
        t0 = time.perf_counter()
        if ctx is None:
            log = port_loop(torch, w, Hc, torch.float32, dev)
        else:
            with ctx():
                log = port_loop(torch, w, Hc, torch.float32, dev)
        torch.cuda.synchronize()
        full[what] = log
        bad = np.flatnonzero(~np.isfinite(log["loss"][:, -1]))
        show(np, f"{what}, f32, B={B_BENCH}", lanes, {f: v[lanes] for f, v in log.items()},
             time.perf_counter() - t0)
        print(f"[{what}, f32, B={B_BENCH}] {bad.size} lanes with the loss at step {Hc - 1} not "
              f"finite: {bad[:20].tolist()}", flush=True)
    same = {f: bitwise(np, full["kernels"][f], full["plain versions on the card"][f])
            for f in FIELDS}
    print(f"kernels against plain versions on the card, B={B_BENCH}, H={Hc}, bitwise per "
          f"field: {same}", flush=True)
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        log = port_loop(torch, w[lanes], Hc, dtype, dev)
        torch.cuda.synchronize()
        show(np, f"kernels, {str(dtype)[6:]}, the lanes alone (B={len(lanes)})", lanes, log,
             time.perf_counter() - t0)


def on_cpu(torch, np, lanes, Hc, w):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tube_mpc_tpu.systems.registry import build_components
    from tube_mpc_tpu.tube.lane_closed_loop import (
        run_paper_closed_loop_lanes as j_run_paper_closed_loop_lanes)
    from tube_mpc_tpu.utils.config import build_experiment, load_config

    ycfg0 = load_config(str(REPO / "configs" / "cartpole.yaml"))
    env = ycfg0.environment
    j_sys_c = build_components(
        "cartpole", dt=ycfg0.system.dt, control_bounds=dict(ycfg0.system.control_bounds),
        obstacles=[dict(o) for o in env.obstacles] or None,
        aggregation=env.obstacle_aggregation, beta=env.obstacle_smoothmin_beta,
        extra=dict(ycfg0.system.extra))
    for dname, tdt, jdt in (("f32", torch.float32, jnp.float32),
                            ("f64", torch.float64, jnp.float64)):
        t0 = time.perf_counter()
        p_log = port_loop(torch, w, Hc, tdt, "cpu")
        show(np, f"port, {dname}", lanes, p_log, time.perf_counter() - t0)
        t0 = time.perf_counter()
        ycfg = dataclasses.replace(ycfg0, use_float64=(dname == "f64"))
        built = build_experiment(ycfg, paper_mode=True)
        cfg = dataclasses.replace(built.tube_cfg, N=N, H=Hc)
        ref = j_run_paper_closed_loop_lanes(
            built.system, built.aug, j_sys_c, cfg, w_nominal=built.w_nominal,
            aux_init=built.aux_init, bp=built.bp, x0=built.x0, target=built.target,
            w_seqs=jnp.asarray(w.numpy(), dtype=jdt), eps=ycfg.dbas.eps,
            barrier_type=ycfg.dbas.barrier_type, block_b=128, interpret=True)
        j_log = {f: np.asarray(getattr(ref, f), dtype=np.float64) for f in FIELDS}
        show(np, f"JAX (interpret), {dname}", lanes, j_log, time.perf_counter() - t0)
        p_first, j_first = first_nonfinite(np, p_log), first_nonfinite(np, j_log)
        for i, lane in enumerate(lanes):
            T = [t for t in (p_first[i][0], j_first[i][0]) if t >= 0]
            upto = min(T) if T else Hc
            dx = np.abs(p_log["x_real"][i, :upto] - j_log["x_real"][i, :upto]).max(initial=0.0)
            du = np.abs(p_log["u_real"][i, :upto] - j_log["u_real"][i, :upto]).max(initial=0.0)
            print(f"[{dname}] lane {lane}: max |port - JAX| over the first {upto} steps: x_real "
                  f"{float(dx)!r}, u_real {float(du)!r}", flush=True)
    # the port against itself with the disturbances times 1 + 1e-15, in f64: how far a
    # last-bit difference grows on these lanes
    p_log = port_loop(torch, w, Hc, torch.float64, "cpu")
    q_log = port_loop(torch, w.double() * (1.0 + 1e-15), Hc, torch.float64, "cpu")
    for i, lane in enumerate(lanes):
        du = np.abs(p_log["u_real"][i] - q_log["u_real"][i]).max(axis=-1)
        grown = np.flatnonzero(du > 1e-6)
        print(f"[f64, w x (1 + 1e-15)] lane {lane}: max |du| {float(du.max())!r}, first step "
              f"with |du| > 1e-6: {int(grown[0]) if grown.size else None}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, nargs="*", default=None,
                    help="each lane's first non-finite step on the card (H is cut after the last)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tube_mpc_tpu_torch.presets import family_paper_setup
    from tube_mpc_tpu_torch.utils.prng import PRNGKey

    lanes = args.lanes
    Hc = max(args.steps) + 1 if args.steps else H_BENCH
    s32 = family_paper_setup("cartpole", N=N, H=H_BENCH, device=args.device,
                             dtype=torch.float32)
    w = s32.system.sample_disturbance(PRNGKey(0, args.device), (B_BENCH, H_BENCH),
                                      dtype=torch.float32)
    w = w[:, :Hc].contiguous() if args.device == "cuda" else w[lanes, :Hc].contiguous()
    print(f"cart-pole paper loop, lanes {lanes} of bench.py's draw (PRNGKey(0), B={B_BENCH}, "
          f"H={H_BENCH}), replayed at B={len(lanes)}, N={N}, H={Hc} on {args.device}; the "
          f"card's first non-finite steps {args.steps}", flush=True)
    torch.set_float32_matmul_precision("highest")
    (on_card if args.device == "cuda" else on_cpu)(torch, np, lanes, Hc, w)
    return 0


if __name__ == "__main__":
    sys.exit(main())
