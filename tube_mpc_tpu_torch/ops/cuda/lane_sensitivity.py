"""Lane sensitivity: the backward δz sweep (K3, and its generic and
upper-gradient variants K5) and the forward δ rollout fused with the weight
gradients (K4, and its generic and reference-cotangent variants K6), their
plain PyTorch versions and the glue (port of
tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48-459).

Variants, by the JAX kernels' static flags:
- ``generic``: the backward sweep also emits its value-function carry for each k,
  and the forward sweep splits off the terminal rows (gxt) and accumulates the
  dynamics terms Σ_k δλ_{k+1}ᵀ ∂f̂/∂(α, γ, tight) (gdyn);
- ``custom_upper``: caller-supplied upper-gradient rows replace the tube loss's
  g_x = 2 (x - x_ref), g_u = 0 in the backward sweep;
- ``emit_ref_grads`` (with ``generic`` only): the forward sweep also emits the
  reference cotangents -C·dx, -C·dv and -C_N·dx_N.

One wrapper per variant: ``sbwd`` (K3), ``sbwd_generic``, ``sbwd_upper`` (K5),
``sfwd`` (K4), ``sfwd_generic``, ``sfwd_ref`` (K6). Each runs its plain version for
CPU tensors and its CUDA kernel (csrc/lane_sbwd.cu, csrc/lane_sfwd.cu) for CUDA
tensors, and counts its kernel launches in ``<wrapper>.launches``;
``lane_sensitivity_grads`` picks the variants by the JAX function's flags. The
backward sweep's plain version has the kernel's two phases (sbwd_lin_plain, then
the recursion).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from .lane_solver import (
    LaneProblem,
    _bp_from_C,
    _inv2,
    _rescale,
    check_kernel_inputs,
    counted,
    jac_lin_plain,
    kernel_consts,
    launch,
    on_cpu,
)

Value = Tuple[Tensor, Tensor, Tensor]   # tVx [N, n̂, B], Vxx [N, n̂², B], LogS [N, 1, B]


def sbwd_plain(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor, Xr: Tensor,
               C: Tensor, XN: Tensor, XrN: Tensor, *, generic: bool = False) -> Tuple[Tensor, ...]:
    """Backward δz sweep: U [N, m, B], X, Xr [N, n̂, B], C, terminal XN, XrN [n̂, B]
    -> K [N, m n̂, B], kff [N, m, B]. Upper gradient g_x = 2 (x - x_ref), g_u = 0;
    a control within active_tol of a bound gets an identity row and column in Q_uu
    and zero gains.

    With ``generic`` it also returns the carry at the start of each step k, the
    value function at k+1 in its scaled form: tV_x [N, n̂, B], V_xx [N, n̂², B],
    LogS [N, 1, B] (at k = N-1 the terminal initialisation)."""
    tv = [2.0 * (XN[i] - XrN[i]) for i in range(pb.n_hat)]
    return _sbwd_sweep(pb, reg, active_tol, U, X, C, tv, 2.0 * (X - Xr), None, generic)


def sbwd_upper_plain(pb: LaneProblem, reg: float, active_tol: float, gX: Tensor, gU: Tensor,
                     gXN: Tensor, U: Tensor, X: Tensor, C: Tensor) -> Tuple[Tensor, ...]:
    """The generic backward sweep with caller-supplied upper-gradient rows gX [N, n̂, B],
    gU [N, m, B] at k and gXN [n̂, B] at the terminal in place of the tube loss's:
    (K, kff, tVx, Vxx, LogS) as sbwd_plain with generic=True."""
    tv = [gXN[i] for i in range(pb.n_hat)]
    return _sbwd_sweep(pb, reg, active_tol, U, X, C, tv, gX, gU, True)


def sbwd_lin_plain(pb: LaneProblem, active_tol: float, U: Tensor, X: Tensor, C: Tensor,
                   gX: Tensor, gU: Optional[Tensor] = None):
    """K3/K5's phase A: the rows of every step at once, each a row [N, B]: f̂'s Jacobian
    rows A, Bm (jac_lin_plain), the upper gradient g_x[i] = gX[:, i] and g_u[a] = gU[:, a]
    (None for g_u = 0) before the carry's scale, and the active-set mask am[a], 0 where
    u_a lies within active_tol of a bound, else 1. None depends on the carry."""
    A, Bm = jac_lin_plain(pb, X, U, C)
    g_x = [gX[:, i] for i in range(pb.n_hat)]
    g_u = None if gU is None else [gU[:, a] for a in range(pb.m)]
    zero = torch.zeros_like(U[:, 0])
    am = [torch.where((U[:, a] <= pb.u_min[a] + active_tol) | (U[:, a] >= pb.u_max[a] - active_tol),
                      zero, torch.ones_like(zero)) for a in range(pb.m)]
    return A, Bm, g_x, g_u, am


def _sbwd_sweep(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor,
                C: Tensor, tv, gX: Tensor, gU: Optional[Tensor], generic: bool) -> Tuple[Tensor, ...]:
    """The sweep of sbwd_plain and sbwd_upper_plain from the terminal tV_x ``tv``, with
    the upper-gradient rows gX [N, n̂, B] and gU [N, m, B] (None for 0), in the kernel's two
    phases: the rows of every step (sbwd_lin_plain), then the recursion over k = N-1..0."""
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    A_all, Bm_all, gx_all, gu_all, am_all = sbwd_lin_plain(pb, active_tol, U, X, C, gX, gU)
    K_out = X.new_empty((N, m * nh, B))
    kff_out = X.new_empty((N, m, B))
    if generic:
        tVx_out = X.new_empty((N, nh, B))
        Vxx_out = X.new_empty((N, nh * nh, B))
        LogS_out = X.new_empty((N, 1, B))
    zero = torch.zeros_like(tv[0])
    vxx = [[C[nh + m + i] if i == j else zero for j in range(nh)] for i in range(nh)]
    LogS = torch.zeros_like(zero)

    for k in reversed(range(N)):
        if generic:
            for i in range(nh):
                tVx_out[k, i] = tv[i]
                for j in range(nh):
                    Vxx_out[k, i * nh + j] = vxx[i][j]
            LogS_out[k, 0] = LogS
        inv_s = torch.exp(-LogS)
        A = [[A_all[i][j][k] for j in range(nh)] for i in range(nh)]
        Bm = [[Bm_all[i][a][k] for a in range(m)] for i in range(nh)]
        gx = [gx_all[i][k] * inv_s for i in range(nh)]
        gu = [0.0] * m if gu_all is None else [gu_all[a][k] * inv_s for a in range(m)]

        VA = [[sum(vxx[i][l] * A[l][j] for l in range(nh)) for j in range(nh)] for i in range(nh)]
        VB = [[sum(vxx[i][l] * Bm[l][a] for l in range(nh)) for a in range(m)] for i in range(nh)]
        Qxx = [[(C[i] * inv_s if i == j else 0.0) + sum(A[l][i] * VA[l][j] for l in range(nh))
                for j in range(nh)] for i in range(nh)]
        Qxu = [[sum(A[l][i] * VB[l][a] for l in range(nh)) for a in range(m)] for i in range(nh)]
        Qux = [[sum(Bm[l][a] * VA[l][i] for l in range(nh)) for i in range(nh)] for a in range(m)]
        Quu = [[(C[nh + a] * inv_s if a == b else 0.0) + sum(Bm[l][a] * VB[l][b] for l in range(nh))
                for b in range(m)] for a in range(m)]
        tQu = [gu[a] + sum(Bm[l][a] * tv[l] for l in range(nh)) for a in range(m)]
        tQx = [gx[i] + sum(A[l][i] * tv[l] for l in range(nh)) for i in range(nh)]
        regs = reg * inv_s

        am = [am_all[a][k] for a in range(m)]
        act = [1.0 - am[a] for a in range(m)]
        Qm = [[(Quu[a][b] + (regs if a == b else 0.0)) * am[a] * am[b] + (act[a] if a == b else 0.0)
               for b in range(m)] for a in range(m)]
        Qux_m = [[Qux[a][i] * am[a] for i in range(nh)] for a in range(m)]
        tQu_m = [tQu[a] * am[a] for a in range(m)]
        if m == 1:   # as the JAX kernel writes it: no resolve-or-zero guard
            inv = [[1.0 / Qm[0][0]]]
        else:
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
    if generic:
        return K_out, kff_out, tVx_out, Vxx_out, LogS_out
    return K_out, kff_out


def sfwd_plain(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
               Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor, *, value: Optional[Value] = None,
               emit_ref_grads: bool = False) -> Tuple[Tensor, ...]:
    """Forward δ rollout dv = kff + K dx, dx⁺ = tangent of f̂ along (dx, dv),
    accumulating gx [n̂, B] = Σ 2 (x - x_ref) dx and gr [m, B] = Σ 2 (u - u_ref) dv.

    Paper variant (``value`` None): gx includes the terminal term; returns (gx, gr).
    Generic variant (``value`` = the generic backward sweep's carry rows): gx is
    the stages only, gxt [n̂, B] the terminal term, and gdyn [3, B] accumulates
    δλ_{k+1}ᵀ ∂f̂/∂(α, γ, tight) with δλ_{k+1} = exp(LogS)(tV_x + V_xx dx⁺);
    returns (gx, gr, gxt, gdyn), and with ``emit_ref_grads`` also the reference
    cotangents gxr [N, n̂, B] = -C dx, gur [N, m, B] = -C dv, gxrN [n̂, B] = -C_N dx_N
    (C holds the doubled weights). ``emit_ref_grads`` without ``value`` is ignored."""
    nh, m = pb.n_hat, pb.m
    N = X.shape[0]
    generic = value is not None
    emit = generic and emit_ref_grads
    bp = _bp_from_C(pb, C)
    zero = torch.zeros_like(XN[0])
    dx = [zero for _ in range(nh)]
    gx = [zero for _ in range(nh)]
    gr = [zero for _ in range(m)]
    gxt = [zero for _ in range(nh)]
    gdyn = [zero for _ in range(3)]
    gxrN = [zero for _ in range(nh)]
    if emit:
        gxr = X.new_empty((N, nh, X.shape[-1]))
        gur = X.new_empty((N, m, X.shape[-1]))
    for k in range(N):
        Kk = [[K[k, a * nh + i] for i in range(nh)] for a in range(m)]
        kf = [kff[k, a] for a in range(m)]
        xs = tuple(X[k, i] for i in range(nh))
        us = tuple(U[k, a] for a in range(m))
        dv = [kf[a] + sum(Kk[a][i] * dx[i] for i in range(nh)) for a in range(m)]
        gx = [gx[i] + 2.0 * (xs[i] - Xr[k, i]) * dx[i] for i in range(nh)]
        gr = [gr[a] + 2.0 * (us[a] - Ur[k, a]) * dv[a] for a in range(m)]
        if emit:
            for i in range(nh):
                gxr[k, i] = -C[i] * dx[i]
            for a in range(m):
                gur[k, a] = -C[nh + a] * dv[a]
        _, tangent = pb.f_hat_lin(xs, us, bp)
        dx = list(tangent(tuple(dx), tuple(dv)))
        if generic:
            tVx, Vxx, LogS = value
            s_k1 = torch.exp(LogS[k, 0])
            dlam = [s_k1 * (tVx[k, i] + sum(Vxx[k, i * nh + j] * dx[j] for j in range(nh)))
                    for i in range(nh)]
            for r, f in enumerate(tangent.params()):
                gdyn[r] = gdyn[r] + sum(dlam[i] * f[i] for i in range(nh))
    dterm = [2.0 * (XN[i] - XrN[i]) * dx[i] for i in range(nh)]
    if not generic:
        gx = [gx[i] + dterm[i] for i in range(nh)]
        return torch.stack(gx, dim=0), torch.stack(gr, dim=0)
    gxt = [gxt[i] + dterm[i] for i in range(nh)]
    out = (torch.stack(gx, dim=0), torch.stack(gr, dim=0), torch.stack(gxt, dim=0),
           torch.stack(gdyn, dim=0))
    if not emit:
        return out
    gxrN = [gxrN[i] + -C[nh + m + i] * dx[i] for i in range(nh)]
    return out + (gxr, gur, torch.stack(gxrN, dim=0))


def _launch(wrapper, fn: str, consts, ins, outs, N: int, B: int) -> Tuple[Tensor, ...]:
    """Check ``ins`` ({name: (shape, tensor)}), allocate ``outs`` (shapes) and launch
    ``lane_<fn>`` of csrc/lane_sbwd.cu or lane_sfwd.cu on them; count the launch on
    ``wrapper``."""
    dtype = check_kernel_inputs(fn, ins)
    dev = next(iter(ins.values()))[1].device
    out = tuple(torch.empty(shape, dtype=dtype, device=dev) for shape in outs)
    launch(f"lane_{fn.split('_')[0]}", f"lane_{fn}", dtype, dev,
           tuple(t for _, t in ins.values()) + out, N, B, consts)
    counted(wrapper, consts, B)
    return out


def _sbwd_ins(pb: LaneProblem, U: Tensor, X: Tensor, Xr: Tensor, C: Tensor, XN: Tensor,
              XrN: Tensor):
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    return {"U": ((N, m, B), U), "X": ((N, nh, B), X), "Xr": ((N, nh, B), Xr),
            "C": ((2 * nh + m + 3, B), C), "XN": ((nh, B), XN), "XrN": ((nh, B), XrN)}


def _sbwd_outs(pb: LaneProblem, N: int, B: int, generic: bool):
    nh, m = pb.n_hat, pb.m
    outs = [(N, m * nh, B), (N, m, B)]
    return outs + [(N, nh, B), (N, nh * nh, B), (N, 1, B)] if generic else outs


def sbwd(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor, Xr: Tensor,
         C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """K3, the paper sweep: (K, kff); see sbwd_plain. CPU tensors run the plain
    version; CUDA tensors the kernel."""
    if on_cpu(U, X, Xr, C, XN, XrN):
        return sbwd_plain(pb, reg, active_tol, U, X, Xr, C, XN, XrN)
    N, B = X.shape[0], X.shape[-1]
    return _launch(sbwd, "sbwd", kernel_consts(pb, reg=reg, active_tol=active_tol),
                   _sbwd_ins(pb, U, X, Xr, C, XN, XrN), _sbwd_outs(pb, N, B, False), N, B)


def sbwd_generic(pb: LaneProblem, reg: float, active_tol: float, U: Tensor, X: Tensor,
                 Xr: Tensor, C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, ...]:
    """K5, generic: (K, kff, tVx, Vxx, LogS); see sbwd_plain with generic=True."""
    if on_cpu(U, X, Xr, C, XN, XrN):
        return sbwd_plain(pb, reg, active_tol, U, X, Xr, C, XN, XrN, generic=True)
    N, B = X.shape[0], X.shape[-1]
    consts = kernel_consts(pb, reg=reg, active_tol=active_tol)
    return _launch(sbwd_generic, "sbwd_generic", consts,
                   _sbwd_ins(pb, U, X, Xr, C, XN, XrN), _sbwd_outs(pb, N, B, True), N, B)


def sbwd_upper(pb: LaneProblem, reg: float, active_tol: float, gX: Tensor, gU: Tensor,
               gXN: Tensor, U: Tensor, X: Tensor, C: Tensor) -> Tuple[Tensor, ...]:
    """K5, generic with upper-gradient rows gX [N, n̂, B], gU [N, m, B], gXN [n̂, B]:
    (K, kff, tVx, Vxx, LogS); see sbwd_upper_plain."""
    if on_cpu(gX, gU, gXN, U, X, C):
        return sbwd_upper_plain(pb, reg, active_tol, gX, gU, gXN, U, X, C)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    ins = {"gX": ((N, nh, B), gX), "gU": ((N, m, B), gU), "gXN": ((nh, B), gXN),
           "U": ((N, m, B), U), "X": ((N, nh, B), X), "C": ((2 * nh + m + 3, B), C)}
    consts = kernel_consts(pb, reg=reg, active_tol=active_tol)
    return _launch(sbwd_upper, "sbwd_upper", consts, ins, _sbwd_outs(pb, N, B, True), N, B)


def _sfwd_ins(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
              Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor, value: Optional[Value] = None):
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    ins = {"K": ((N, m * nh, B), K), "kff": ((N, m, B), kff), "X": ((N, nh, B), X),
           "Xr": ((N, nh, B), Xr), "U": ((N, m, B), U), "Ur": ((N, m, B), Ur),
           "C": ((2 * nh + m + 3, B), C), "XN": ((nh, B), XN), "XrN": ((nh, B), XrN)}
    if value is not None:
        tVx, Vxx, LogS = value
        ins.update({"tVx": ((N, nh, B), tVx), "Vxx": ((N, nh * nh, B), Vxx),
                    "LogS": ((N, 1, B), LogS)})
    return ins


def sfwd(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
         Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor) -> Tuple[Tensor, Tensor]:
    """K4, the paper rollout: (gx, gr); see sfwd_plain. CPU tensors run the plain
    version; CUDA tensors the kernel."""
    if on_cpu(K, kff, X, Xr, U, Ur, C, XN, XrN):
        return sfwd_plain(pb, K, kff, X, Xr, U, Ur, C, XN, XrN)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    return _launch(sfwd, "sfwd", kernel_consts(pb),
                   _sfwd_ins(pb, K, kff, X, Xr, U, Ur, C, XN, XrN), [(nh, B), (m, B)], N, B)


def sfwd_generic(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
                 Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor, tVx: Tensor, Vxx: Tensor,
                 LogS: Tensor) -> Tuple[Tensor, ...]:
    """K6, generic: (gx, gr, gxt, gdyn); see sfwd_plain with value=(tVx, Vxx, LogS)."""
    value = (tVx, Vxx, LogS)
    if on_cpu(K, kff, X, Xr, U, Ur, C, XN, XrN, *value):
        return sfwd_plain(pb, K, kff, X, Xr, U, Ur, C, XN, XrN, value=value)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    return _launch(sfwd_generic, "sfwd_generic", kernel_consts(pb),
                   _sfwd_ins(pb, K, kff, X, Xr, U, Ur, C, XN, XrN, value),
                   [(nh, B), (m, B), (nh, B), (3, B)], N, B)


def sfwd_ref(pb: LaneProblem, K: Tensor, kff: Tensor, X: Tensor, Xr: Tensor, U: Tensor,
             Ur: Tensor, C: Tensor, XN: Tensor, XrN: Tensor, tVx: Tensor, Vxx: Tensor,
             LogS: Tensor) -> Tuple[Tensor, ...]:
    """K6, generic with the reference cotangents: (gx, gr, gxt, gdyn, gxr, gur, gxrN);
    see sfwd_plain with value=(tVx, Vxx, LogS), emit_ref_grads=True."""
    value = (tVx, Vxx, LogS)
    if on_cpu(K, kff, X, Xr, U, Ur, C, XN, XrN, *value):
        return sfwd_plain(pb, K, kff, X, Xr, U, Ur, C, XN, XrN, value=value,
                          emit_ref_grads=True)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    return _launch(sfwd_ref, "sfwd_ref", kernel_consts(pb),
                   _sfwd_ins(pb, K, kff, X, Xr, U, Ur, C, XN, XrN, value),
                   [(nh, B), (m, B), (nh, B), (3, B), (N, nh, B), (N, m, B), (nh, B)], N, B)


for _w in (sbwd, sbwd_generic, sbwd_upper, sfwd, sfwd_generic, sfwd_ref):
    _w.launches, _w.by_system, _w.by_width = 0, {}, {}


def lane_sensitivity_grads(
    pb: LaneProblem,
    *,
    X: Tensor,       # [N+1, n̂, B] solved trajectory
    U: Tensor,       # [N, m, B]
    X_ref: Tensor,   # [N+1, n̂, B] (barrier row 0)
    U_ref: Tensor,   # [N, m, B]
    C: Tensor,       # [nc, B] current weights
    reg: float = 1e-9,
    active_tol: float = 1e-8,
    generic: bool = False,
    emit_ref_grads: bool = False,
    upper_gx: Optional[Tensor] = None,   # [N+1, n̂, B] upper-gradient rows (else the tube loss)
    upper_gu: Optional[Tensor] = None,   # [N, m, B]
) -> Tuple[Tensor, ...]:
    """The δz sweep and the closed-form gradients, as the JAX function returns them.

    generic=False: (gx [n̂, B], gr [m, B]); rows 0..n-1 of gx are dL/dQ (terminal
    included, Qf tied to Q), row n is dL/dq_b, gr is dL/dR.
    generic=True: (gx, gr, gxt [n̂, B], gdyn [3, B]) with gx the stages only, gxt the
    terminal split (dL/dQf; row n the terminal part of dL/dq_b) and gdyn
    (dL/dα, dL/dγ, dL/dtight); with emit_ref_grads also (gxr [N, n̂, B], gur [N, m, B],
    gxrN [n̂, B]). upper_gx/upper_gu replace the tube loss's upper gradient."""
    Xs, Xrs, XN, XrN = X[:-1].contiguous(), X_ref[:-1].contiguous(), X[-1], X_ref[-1]
    if upper_gx is not None:
        # K5 with upper rows; its carry rows are the generic sweep's, and the paper
        # rollout takes only K and kff
        out = sbwd_upper(pb, reg, active_tol, upper_gx[:-1].contiguous(), upper_gu,
                         upper_gx[-1], U, Xs, C)
    elif generic:
        out = sbwd_generic(pb, reg, active_tol, U, Xs, Xrs, C, XN, XrN)
    else:
        out = sbwd(pb, reg, active_tol, U, Xs, Xrs, C, XN, XrN)
    fwd = (pb, out[0], out[1], Xs, Xrs, U, U_ref, C, XN, XrN)
    if not generic:
        return sfwd(*fwd)
    return (sfwd_ref if emit_ref_grads else sfwd_generic)(*fwd, *out[2:])
