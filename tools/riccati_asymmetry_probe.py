#!/usr/bin/env python3
"""Why the XLA engine's sequential Riccati sweep parted from its exact value at long horizons,
and whether the package's other two sweeps share the mode.

    python3 tools/riccati_asymmetry_probe.py                 # on the card (B=16384 lanes built)
    python3 tools/riccati_asymmetry_probe.py --device cpu --lanes 64

It linearises the quadrotor's nominal OCP (chip_smoke.pscan_quadrotor: its config's N=200,
zero controls, the lanes' starts moved by a seeded draw) in f32 on the device, keeps LANES
of its lanes, and prints each sweep's largest gain error against the exact-elimination
recursion in f64 on the CPU (chip_smoke.exact_recursion, the same regulariser):

- the split value update as solvers/ilqr.py::_backward_pass computed it before V_xx was made
  symmetric (split_sweep below), in f32 on the device, in f32 and f64 on the CPU, and in f32
  on the device with V_xx made symmetric after every step;
- solvers/ilqr.py::_backward_pass as the package runs it (V_xx made symmetric), in f32 on the
  device;
- solvers/pscan.py::parallel_backward_pass (the exact elimination) in f32 on the device;
- on the CPU, the split update with a perturbation of NOISE x max |V_xx| added to V_xx after
  every step, antisymmetric (P - P^T) or symmetric (P + P^T), P a seeded normal draw.

Then the sequential sweep with and without the guard on random LQ problems at N=256 and 1024
in f64 (chip_smoke.pscan_lq), and the two other sweeps, each on LANES lanes of the quadrotor's
OCP, in f32 on the device and on the CPU against f64 on the CPU:

- solvers/sensitivity.py::ddp_sensitivity (its value update V_xx = Q_xx + Q_xu K), on the
  rollout of the controls at the middle of their box, with seeded upper gradients: the
  largest |δU| and |δX| error relative to the f64 sweep's largest value;
- the quadrotor's lane K1 (ops/cuda/lane_solver.py::ric, csrc/lane_solver.cu::ric_kernel;
  on the CPU its plain version): its gains on the nominal lane solve's first iteration (on
  the device it needs the quadrotor's lane_solver library, built at first use).

The split update V_xx' = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K carries an antisymmetric
part of V_xx forward and, on this problem, grows it; the exact form and the scan do not.
Products whose rounding leaves V_xx slightly asymmetric seed that growth. It checks
nothing: it prints, and exits 0.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NOISE = (1e-9, 1e-8)


def split_sweep(torch, A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx, reg, symmetric=False,
                noise=0.0, sign=-1.0):
    """solvers/ilqr.py::_backward_pass below its rescaling threshold (the carry stays
    unscaled on this problem), optionally with V_xx made symmetric or perturbed after every
    step -> K [B, N, nu, n̂] in f64 on the CPU."""
    from tube_mpc_tpu_torch.ops.linalg import solve_spd

    mT = lambda M: M.transpose(-1, -2)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    gen = torch.Generator().manual_seed(0)
    V_x, V_xx = phi_x, phi_xx
    Ks = [None] * A.shape[1]
    for k in reversed(range(A.shape[1])):
        A_k, B_k = A[:, k], B[:, k]
        Q_x, Q_u = lx[:, k] + mv(mT(A_k), V_x), lu[:, k] + mv(mT(B_k), V_x)
        Q_xx = lxx[:, k] + mT(A_k) @ V_xx @ A_k
        Q_ux = lux[:, k] + mT(B_k) @ V_xx @ A_k
        Q_uu = luu[:, k] + mT(B_k) @ V_xx @ B_k
        Kk = -solve_spd(Q_uu + reg * eye, torch.cat([Q_ux, Q_u[..., None]], dim=-1))
        K, kff = Kk[..., :-1], Kk[..., -1]
        V_x = Q_x + mv(mT(K) @ Q_uu, kff) + mv(mT(K), Q_u) + mv(mT(Q_ux), kff)
        V_xx = Q_xx + mT(K) @ Q_uu @ K + mT(K) @ Q_ux + mT(Q_ux) @ K
        if symmetric:
            V_xx = 0.5 * (V_xx + mT(V_xx))
        if noise:
            P = torch.randn(V_xx.shape, generator=gen, dtype=V_xx.dtype).to(V_xx.device)
            V_xx = V_xx + noise * V_xx.abs().amax() * (P + sign * mT(P))
        Ks[k] = K
    return torch.stack(Ks, dim=1).cpu().double()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=64, help="lanes swept (of the 16384 built)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from tube_mpc_tpu_torch.solvers import ilqr
    from tube_mpc_tpu_torch.solvers.pscan import parallel_backward_pass

    torch.set_float32_matmul_precision("highest")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cs.nvidia_smi(), flush=True)
    built = cs.B if dev.type == "cuda" else args.lanes
    ocp, theta, x0, U0, cfg, Nq = cs.pscan_quadrotor(
        torch, dev, built, torch.float32, torch.Generator(device=dev).manual_seed(cs.SEED + 122))
    U = ocp.clamp(U0)
    lin = [t[:args.lanes] for t in ilqr._linearize(ocp, theta, ilqr.rollout(ocp, theta, x0, U), U)]
    c32 = [t.cpu() for t in lin]
    c64 = [t.double() for t in c32]
    exact = cs.exact_recursion(torch, *c64, reg=cfg.reg)[2]

    def show(what, K):
        print(f"{what}: max |K - exact f64| = {float((K - exact).abs().max())!r}", flush=True)

    print(f"quadrotor2d, first iteration, N={Nq}, {args.lanes} lanes, reg {cfg.reg}; max |K| of "
          f"the exact recursion {float(exact.abs().max())!r}", flush=True)
    show(f"split sweep, f32 on {dev}", split_sweep(torch, *lin, cfg.reg))
    show(f"split sweep, f32 on {dev}, V_xx made symmetric every step",
         split_sweep(torch, *lin, cfg.reg, symmetric=True))
    show(f"ilqr._backward_pass (V_xx made symmetric), f32 on {dev}",
         ilqr._backward_pass(*lin, cfg.reg)[0].cpu().double())
    show(f"parallel_backward_pass, f32 on {dev}", parallel_backward_pass(*lin, cfg.reg)[0].cpu().double())
    show("split sweep, f32 on the CPU", split_sweep(torch, *c32, cfg.reg))
    show("split sweep, f64 on the CPU", split_sweep(torch, *c64, cfg.reg))
    for noise in NOISE:
        for sign, kind in ((-1.0, "antisymmetric"), (1.0, "symmetric")):
            for data, dtype in ((c32, "f32"), (c64, "f64")):
                show(f"split sweep, {dtype} on the CPU, {kind} {noise:g} x max|V_xx| a step",
                     split_sweep(torch, *data, cfg.reg, noise=noise, sign=sign))
    long_horizon_probe(torch, cs, dev, ilqr)
    sensitivity_probe(torch, cs, dev, args.lanes)
    lane_k1_probe(torch, cs, dev, args.lanes)
    return 0


def long_horizon_probe(torch, cs, dev, ilqr):
    """tests/test_pscan.py's random LQ recipe (chip_smoke.pscan_lq, n̂=4, nu=2, PSCAN_B
    lanes, reg 1e-9) in f64 on the device at N=256 and 1024: the split update without and
    with the symmetry guard against the exact recursion, as max |K - K_exact| and the worst
    |K - K_exact| / (1e-8 + 1e-7 |K_exact|) (the gains' tolerance of tests/test_pscan.py)."""
    for Nl in (256, 1024):
        data = [t.to(dev) for t in cs.pscan_lq(torch, cs.SEED + 103, cs.PSCAN_B, Nl, 4, 2,
                                                torch.float64)]
        exact = cs.exact_recursion(torch, *data, reg=1e-9)[2].cpu()
        for what, K in (("split sweep", split_sweep(torch, *data, 1e-9)),
                        ("ilqr._backward_pass (V_xx made symmetric)",
                         ilqr._backward_pass(*data, 1e-9)[0].cpu())):
            d = (K - exact).abs()
            print(f"random LQ, N={Nl}, {cs.PSCAN_B} lanes, f64 on {dev}, reg 1e-9: {what}: max "
                  f"|K - exact| = {float(d.max())!r}, worst share of the tolerance "
                  f"{float((d / (1e-8 + 1e-7 * exact.abs())).max())!r}", flush=True)


def relative(got, ref) -> float:
    """max |got - ref| / max |ref|, both taken to f64 on the CPU."""
    got, ref = got.cpu().double(), ref.cpu().double()
    return float((got - ref).abs().max() / ref.abs().max())


def sensitivity_probe(torch, cs, dev, lanes):
    """ddp_sensitivity on the quadrotor's OCP over `lanes` lanes, on the rollout of the
    controls at the middle of their box (none active) from the same starts (drawn on the
    CPU in f32), on the device in f32 and on the CPU in f32 and f64, with seeded upper
    gradients g_X, g_U: the δU and δX errors against f64."""
    from tube_mpc_tpu_torch.solvers import ilqr
    from tube_mpc_tpu_torch.solvers.sensitivity import ddp_sensitivity

    f32, f64 = torch.float32, torch.float64
    runs = {}
    for where, dtype in ((dev, f32), (torch.device("cpu"), f32), (torch.device("cpu"), f64)):
        ocp, theta, _, U0, cfg, Nq = cs.pscan_quadrotor(
            torch, where, lanes, dtype, torch.Generator(device=where).manual_seed(cs.SEED + 122))
        x_hat0 = cs.pscan_quadrotor(torch, "cpu", lanes, f32,
                                    torch.Generator().manual_seed(cs.SEED + 123))[2]
        gen = torch.Generator().manual_seed(cs.SEED + 124)
        g_X = torch.randn(lanes, Nq + 1, x_hat0.shape[-1], generator=gen, dtype=f32)
        g_U = torch.randn(lanes, Nq, U0.shape[-1], generator=gen, dtype=f32)
        to = lambda t: t.to(device=where, dtype=dtype)
        U = (0.5 * (ocp.u_min + ocp.u_max)).expand_as(U0)   # no control at a bound
        X = ilqr.rollout(ocp, theta, to(x_hat0), U)
        res = ddp_sensitivity(ocp, theta, X, U, to(g_X), to(g_U))
        runs[where.type, dtype] = res
    ref = runs["cpu", f64]
    print(f"ddp_sensitivity, quadrotor2d, controls mid-box, N={Nq}, {lanes} lanes, reg 1e-9 "
          f"(V_xx = Q_xx + Q_xu K): max |dU| of f64 {float(ref.delta_U.abs().max())!r}",
          flush=True)
    for (kind, dtype), res in runs.items():
        if dtype is f32:
            print(f"ddp_sensitivity, f32 on {kind}: max |δU - f64| / max |δU| = "
                  f"{relative(res.delta_U, ref.delta_U)!r}, max |δX - f64| / max |δX| = "
                  f"{relative(res.delta_X, ref.delta_X)!r}", flush=True)


def lane_k1_probe(torch, cs, dev, lanes):
    """The quadrotor's K1 on the nominal lane solve's first iteration at its config's N over
    `lanes` lanes (chip_smoke.solver_inputs: the clamped zero controls' rollout toward the
    target): the gains on the device in f32, and its plain version's on the same inputs on
    the CPU in f32, against the plain version's in f64."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import ric_plain
    from tube_mpc_tpu_torch.presets import family_paper_setup
    from tube_mpc_tpu_torch.tube.lane_interface import _build_C, make_lane_problem

    f32 = torch.float32
    _, _, x_hat0, U0, cfg, Nq = cs.pscan_quadrotor(torch, dev, lanes, f32,
                                                   torch.Generator().manual_seed(cs.SEED + 123))
    ps = family_paper_setup("quadrotor2d", N=Nq, H=1, device=dev, dtype=f32)
    pb = make_lane_problem(ps.sys_c, barrier_type=ps.barrier_type, eps=ps.eps)
    nx = ps.system.nx
    C = _build_C(pb, ps.w_nominal, ps.bp, lanes, f32, dev)
    X_ref = ps.target[None, None].expand(lanes, Nq + 1, nx)
    k1 = cs.solver_inputs(pb, cfg.reg, ps.system, C, x_hat0.to(dev), U0,
                          X_ref, torch.zeros_like(U0))[0]
    K = WRAPPERS["ric"](pb, cfg.reg, *k1)[0]
    c32 = [t.cpu() for t in k1]
    K32 = ric_plain(pb, cfg.reg, *c32)[0]
    K64 = ric_plain(pb, cfg.reg, *(t.double() for t in c32))[0]
    print(f"lane K1 (ric), quadrotor2d nominal first iteration, N={Nq}, {lanes} lanes, reg "
          f"{cfg.reg}: max |K| of f64 {float(K64.abs().max())!r}; f32 on {dev}: max |K - f64| "
          f"= {float((K.cpu().double() - K64).abs().max())!r}; plain f32 on the CPU: "
          f"{float((K32.double() - K64).abs().max())!r}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
