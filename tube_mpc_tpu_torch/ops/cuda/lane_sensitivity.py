"""Lane sensitivity, paper variants: K3 (backward δz sweep) and K4 (forward δ
rollout fused with the closed-form Algorithm-2 weight gradients), their plain
PyTorch versions and the glue (port of tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48-459
with generic=False, custom_upper=False, emit_ref_grads=False).

Each wrapper (``sbwd``, ``sfwd``) runs the plain version for CPU tensors and the
CUDA kernel (csrc/lane_sensitivity.cu) for CUDA tensors, and counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from ..lanes import jac_rows
from .lane_solver import (
    LaneProblem,
    _bp_from_C,
    _inv2,
    _rescale,
    check_kernel_inputs,
    kernel_consts,
    launch,
    on_cpu,
)


def sbwd_plain(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor, Xr: Tensor,
               C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """Backward δz sweep: U [N, m, B], X, Xr [N, n̂, B], C, terminal XN, XrN [n̂, B]
    -> K [N, m n̂, B], kff [N, m, B]. Upper gradient g_x = 2 (x - x_ref), g_u = 0;
    a control within active_tol of a bound gets an identity row and column in
    Q_uu and zero gains."""
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    bp = _bp_from_C(pb, C)
    K_out = X.new_empty((N, m * nh, B))
    kff_out = X.new_empty((N, m, B))
    zero = torch.zeros_like(XN[0])
    tv = [2.0 * (XN[i] - XrN[i]) for i in range(nh)]
    vxx = [[C[nh + m + i] if i == j else zero for j in range(nh)] for i in range(nh)]
    LogS = torch.zeros_like(zero)

    for k in reversed(range(N)):
        inv_s = torch.exp(-LogS)
        xs = tuple(X[k, i] for i in range(nh))
        us = [U[k, a] for a in range(m)]
        _, tangent = pb.f_hat_lin(xs, tuple(us), bp)
        A, Bm = jac_rows(tangent, nh, m, xs[0])
        gx = [2.0 * (xs[i] - Xr[k, i]) * inv_s for i in range(nh)]

        VA = [[sum(vxx[i][l] * A[l][j] for l in range(nh)) for j in range(nh)] for i in range(nh)]
        VB = [[sum(vxx[i][l] * Bm[l][a] for l in range(nh)) for a in range(m)] for i in range(nh)]
        Qxx = [[(C[i] * inv_s if i == j else 0.0) + sum(A[l][i] * VA[l][j] for l in range(nh))
                for j in range(nh)] for i in range(nh)]
        Qxu = [[sum(A[l][i] * VB[l][a] for l in range(nh)) for a in range(m)] for i in range(nh)]
        Qux = [[sum(Bm[l][a] * VA[l][i] for l in range(nh)) for i in range(nh)] for a in range(m)]
        Quu = [[(C[nh + a] * inv_s if a == b else 0.0) + sum(Bm[l][a] * VB[l][b] for l in range(nh))
                for b in range(m)] for a in range(m)]
        tQu = [0.0 + sum(Bm[l][a] * tv[l] for l in range(nh)) for a in range(m)]
        tQx = [gx[i] + sum(A[l][i] * tv[l] for l in range(nh)) for i in range(nh)]
        regs = reg * inv_s

        am = [torch.where((us[a] <= pb.u_min[a] + active_tol) | (us[a] >= pb.u_max[a] - active_tol),
                          zero, torch.ones_like(zero)) for a in range(m)]
        act = [1.0 - am[a] for a in range(m)]
        Qm = [[(Quu[a][b] + (regs if a == b else 0.0)) * am[a] * am[b] + (act[a] if a == b else 0.0)
               for b in range(m)] for a in range(m)]
        Qux_m = [[Qux[a][i] * am[a] for i in range(nh)] for a in range(m)]
        tQu_m = [tQu[a] * am[a] for a in range(m)]
        inv = _inv2(Qm[0][0], Qm[0][1], Qm[1][0], Qm[1][1])

        K = [[-sum(inv[a][b] * Qux_m[b][i] for b in range(m)) for i in range(nh)] for a in range(m)]
        kf = [-sum(inv[a][b] * tQu_m[b] for b in range(m)) for a in range(m)]
        for a in range(m):
            kff_out[k, a] = kf[a]
            for i in range(nh):
                K_out[k, a * nh + i] = K[a][i]

        tv_new = [tQx[i] + sum(Qxu[i][a] * kf[a] for a in range(m)) for i in range(nh)]
        vxx_new = [[Qxx[i][j] + sum(Qxu[i][a] * K[a][j] for a in range(m)) for j in range(nh)]
                   for i in range(nh)]
        tv, vxx, LogS = _rescale(tv_new, vxx_new, LogS)
    return K_out, kff_out


def sfwd_plain(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
               Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """Forward δ rollout dv = kff + K dx, dx⁺ = tangent of f̂ along (dx, dv),
    accumulating gx [n̂, B] = Σ 2 (x - x_ref) dx (terminal included) and
    gr [m, B] = Σ 2 (u - u_ref) dv."""
    nh, m = pb.n_hat, pb.m
    N = X.shape[0]
    bp = _bp_from_C(pb, C)
    zero = torch.zeros_like(XN[0])
    dx = [zero for _ in range(nh)]
    gx = [zero for _ in range(nh)]
    gr = [zero for _ in range(m)]
    for k in range(N):
        Kk = [[K[k, a * nh + i] for i in range(nh)] for a in range(m)]
        kf = [kff[k, a] for a in range(m)]
        xs = tuple(X[k, i] for i in range(nh))
        us = tuple(U[k, a] for a in range(m))
        dv = [kf[a] + sum(Kk[a][i] * dx[i] for i in range(nh)) for a in range(m)]
        gx = [gx[i] + 2.0 * (xs[i] - Xr[k, i]) * dx[i] for i in range(nh)]
        gr = [gr[a] + 2.0 * (us[a] - Ur[k, a]) * dv[a] for a in range(m)]
        _, tangent = pb.f_hat_lin(xs, us, bp)
        dx = list(tangent(tuple(dx), tuple(dv)))
    gx = [gx[i] + 2.0 * (XN[i] - XrN[i]) * dx[i] for i in range(nh)]
    return torch.stack(gx, dim=0), torch.stack(gr, dim=0)


def sbwd(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor, Xr: Tensor,
         C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """K3: see sbwd_plain. CPU tensors run the plain version; CUDA tensors the kernel."""
    if on_cpu(U, X, Xr, C, XN, XrN):
        return sbwd_plain(pb, reg, active_tol, U, X, Xr, C, XN, XrN)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    dtype = check_kernel_inputs("sbwd", {
        "U": ((N, m, B), U), "X": ((N, nh, B), X), "Xr": ((N, nh, B), Xr),
        "C": ((2 * nh + m + 3, B), C), "XN": ((nh, B), XN), "XrN": ((nh, B), XrN),
    })
    consts = kernel_consts(pb, reg=reg, active_tol=active_tol)
    K = torch.empty((N, m * nh, B), dtype=dtype, device=X.device)
    kff = torch.empty((N, m, B), dtype=dtype, device=X.device)
    launch("lane_sensitivity", "lane_sbwd", dtype, X.device, (U, X, Xr, C, XN, XrN, K, kff),
           N, B, consts)
    sbwd.launches += 1
    return K, kff


sbwd.launches = 0


def sfwd(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
         Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """K4: see sfwd_plain. CPU tensors run the plain version; CUDA tensors the kernel."""
    if on_cpu(K, kff, X, Xr, U, Ur, C, XN, XrN):
        return sfwd_plain(pb, K, kff, X, Xr, U, Ur, C, XN, XrN)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    dtype = check_kernel_inputs("sfwd", {
        "K": ((N, m * nh, B), K), "kff": ((N, m, B), kff), "X": ((N, nh, B), X),
        "Xr": ((N, nh, B), Xr), "U": ((N, m, B), U), "Ur": ((N, m, B), Ur),
        "C": ((2 * nh + m + 3, B), C), "XN": ((nh, B), XN), "XrN": ((nh, B), XrN),
    })
    consts = kernel_consts(pb)
    gx = torch.empty((nh, B), dtype=dtype, device=X.device)
    gr = torch.empty((m, B), dtype=dtype, device=X.device)
    launch("lane_sensitivity", "lane_sfwd", dtype, X.device,
           (K, kff, X, Xr, U, Ur, C, XN, XrN, gx, gr), N, B, consts)
    sfwd.launches += 1
    return gx, gr


sfwd.launches = 0


def lane_sensitivity_grads(
    pb: LaneProblem,
    *,
    X: Tensor,       # [N+1, n̂, B] solved aux trajectory
    U: Tensor,       # [N, m, B]
    X_ref: Tensor,   # [N+1, n̂, B] (barrier row 0)
    U_ref: Tensor,   # [N, m, B]
    C: Tensor,       # [nc, B] current aux weights
    reg: float = 1e-9,
    active_tol: float = 1e-8,
) -> Tuple[Tensor, Tensor]:
    """(gx [n̂, B], gr [m, B]): rows 0..n-1 of gx are dL/dQ (terminal included, Qf
    tied to Q), row n is dL/dq_b, gr is dL/dR."""
    Xs, Xrs = X[:-1].contiguous(), X_ref[:-1].contiguous()
    K, kff = sbwd(pb, reg, active_tol, U, Xs, Xrs, C, X[-1], X_ref[-1])
    return sfwd(pb, K, kff, Xs, Xrs, U, U_ref, C, X[-1], X_ref[-1])
