#!/usr/bin/env python3
"""Why the XLA engine's sequential Riccati sweep parts from its exact value at long horizons.

    python3 tools/riccati_asymmetry_probe.py                 # on the card (B=16384 lanes built)
    python3 tools/riccati_asymmetry_probe.py --device cpu --lanes 64

It linearises the quadrotor's nominal OCP (chip_smoke.pscan_quadrotor: its config's N=200,
zero controls, the lanes' starts moved by a seeded draw) in f32 on the device, keeps LANES
of its lanes, and prints each sweep's largest gain error against the exact-elimination
recursion in f64 on the CPU (chip_smoke.exact_recursion, the same regulariser):

- solvers/ilqr.py::_backward_pass, the split value update, in f32 on the device, in f32 and
  f64 on the CPU, and in f32 on the device with V_xx made symmetric after every step;
- solvers/pscan.py::parallel_backward_pass (the exact elimination) in f32 on the device;
- on the CPU, the split update with a perturbation of NOISE x max |V_xx| added to V_xx after
  every step, antisymmetric (P - P^T) or symmetric (P + P^T), P a seeded normal draw.

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
    show(f"parallel_backward_pass, f32 on {dev}", parallel_backward_pass(*lin, cfg.reg)[0].cpu().double())
    show("split sweep, f32 on the CPU", split_sweep(torch, *c32, cfg.reg))
    show("split sweep, f64 on the CPU", split_sweep(torch, *c64, cfg.reg))
    for noise in NOISE:
        for sign, kind in ((-1.0, "antisymmetric"), (1.0, "symmetric")):
            for data, dtype in ((c32, "f32"), (c64, "f64")):
                show(f"split sweep, {dtype} on the CPU, {kind} {noise:g} x max|V_xx| a step",
                     split_sweep(torch, *data, cfg.reg, noise=noise, sign=sign))
    return 0


if __name__ == "__main__":
    sys.exit(main())
