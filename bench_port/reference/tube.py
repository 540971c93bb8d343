"""Adaptive tube MPC on the reference plant, batched over lanes in plain PyTorch matrices:
the iLQR solve (Riccati sweep with diagonal cost Hessians and a ladder of line-search
steps), the δz sensitivity of the ancillary solution and its weight gradients, and the
paper step of Algorithm 2 (both solves, the tube loss, the projected momentum update, the
disturbed propagation).

Every tensor is [L, ...] with the lane first; weights are the doubled diagonal rows
Cx = 2 [Q, q_b], Cu = 2 R, Cf = 2 [Q_f, q_b]. The numerical guard of the 2x2 inverse (gains
zeroed below 100 ulps of the scaled determinant) takes the ulp of the configuration's
precision, whatever ``dtype`` the reference computes in, since it is part of the
algorithm as configured."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from .plant import BarrierParams, Plant


class Weights(NamedTuple):
    Cx: Tensor  # [L, n̂]
    Cu: Tensor  # [L, m]
    Cf: Tensor  # [L, n̂]


def weights(Q: Tensor, R: Tensor, qb: Tensor, Qf: Optional[Tensor] = None) -> Weights:
    """The doubled diagonals of the stage and terminal costs (Q [L, n], R [L, m], qb [L])."""
    Qf = Q if Qf is None else Qf
    return Weights(2.0 * torch.cat([Q, qb[:, None]], -1), 2.0 * R,
                   2.0 * torch.cat([Qf, qb[:, None]], -1))


def _bp(bp: BarrierParams, ndim: int) -> BarrierParams:
    """bp's [L] leaves viewed to broadcast over [L, ...] with ``ndim`` leading dims."""
    return BarrierParams(*(t.reshape(t.shape + (1,) * (ndim - 1)) for t in bp))


def rollout(plant: Plant, x0: Tensor, U: Tensor, bp: BarrierParams) -> Tensor:
    """X [L, N+1, n̂] of f̂ from x0 [L, n̂] under U [L, N, m]."""
    xs, x = [x0], x0
    bpl = _bp(bp, 1)
    for k in range(U.shape[1]):
        x = plant.f_hat(x, U[:, k], bpl)
        xs.append(x)
    return torch.stack(xs, 1)


def cost(X: Tensor, U: Tensor, Xr: Tensor, Ur: Tensor, W: Weights) -> Tensor:
    """Σ_k ½ Cx (x_k - xr_k)² + ½ Cu (u_k - ur_k)² + ½ Cf (x_N - xr_N)², per lane [L]."""
    dx, du, dN = X[:, :-1] - Xr[:, :-1], U - Ur, X[:, -1] - Xr[:, -1]
    return ((0.5 * W.Cx[:, None] * dx * dx).sum((1, 2)) + (0.5 * W.Cu[:, None] * du * du).sum((1, 2))
            + (0.5 * W.Cf * dN * dN).sum(1))


def inverse(M: Tensor, guard_eps: float) -> Tensor:
    """M⁻¹ of [L, m, m], m in {1, 2}; for m = 2 by the adjugate of M scaled by its largest
    entry, zero where that scaled determinant is within 100 ulps (guard_eps) of 0."""
    if M.shape[-1] == 1:
        return 1.0 / M
    s = torch.clamp(M.abs().amax((-2, -1)), min=torch.finfo(M.dtype).tiny)[:, None, None]
    n = M / s
    det = n[:, 0, 0] * n[:, 1, 1] - n[:, 0, 1] * n[:, 1, 0]
    ok = det.abs() > 100.0 * guard_eps
    scale = torch.where(ok, 1.0 / (torch.where(ok, det, torch.ones_like(det)) * s[:, 0, 0]),
                        torch.zeros_like(det))
    adj = torch.stack([torch.stack([n[:, 1, 1], -n[:, 0, 1]], -1),
                       torch.stack([-n[:, 1, 0], n[:, 0, 0]], -1)], -2)
    return adj * scale[:, None, None]


def _t(M: Tensor) -> Tensor:
    return M.transpose(-2, -1)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


V_SCALE = 1e8


def _rescale(Vx: Tensor, Vxx: Tensor, log_s: Tensor):
    """The value function's range guard: V is carried as exp(log_s) (Vx, Vxx); when its
    largest entry passes 1e8 it is scaled back to 1e8 and log_s takes the factor, and an
    entry that is not finite in float32 is set to 0. Exact in the mathematics, it keeps a
    sweep in float32 (or below) inside its range."""
    big = torch.maximum(Vx.abs().amax(-1), Vxx.abs().amax((-2, -1)))
    f = torch.where(big > V_SCALE, V_SCALE / big, torch.ones_like(big))
    safe = lambda v: torch.where(torch.isfinite(v.float()), v, torch.zeros_like(v))
    log_s = log_s - torch.log(torch.clamp(f, min=torch.finfo(f.dtype).tiny))
    return safe(Vx * f[:, None]), safe(Vxx * f[:, None, None]), log_s


def riccati(A: Tensor, Bm: Tensor, lx: Tensor, lu: Tensor, W: Weights, Vx: Tensor,
            reg: float, guard_eps: float) -> Tuple[Tensor, Tensor]:
    """The iLQR backward sweep (Gauss-Newton: no second derivative of f̂), on the scaled
    value function (_rescale): A [L, N, n̂, n̂], Bm [L, N, n̂, m], cost gradients lx [L, N, n̂],
    lu [L, N, m], terminal gradient Vx [L, n̂] -> gains K [L, N, m, n̂], kff [L, N, m]."""
    L, N, n, m = Bm.shape
    Vxx = torch.diag_embed(W.Cf)
    log_s = Vx.new_zeros((L,))
    I = torch.eye(m, dtype=A.dtype, device=A.device)
    K, kff = A.new_empty((L, N, m, n)), A.new_empty((L, N, m))
    for k in reversed(range(N)):
        a, b = A[:, k], Bm[:, k]
        inv_s = torch.exp(-log_s)
        Qx = lx[:, k] * inv_s[:, None] + _mv(_t(a), Vx)
        Qu = lu[:, k] * inv_s[:, None] + _mv(_t(b), Vx)
        VA, VB = Vxx @ a, Vxx @ b
        Qxx = torch.diag_embed(W.Cx * inv_s[:, None]) + _t(a) @ VA
        Qux = _t(b) @ VA
        Quu = torch.diag_embed(W.Cu * inv_s[:, None]) + _t(b) @ VB
        inv = inverse(Quu + (reg * inv_s)[:, None, None] * I, guard_eps)
        Kk, kk = -(inv @ Qux), -_mv(inv, Qu)
        K[:, k], kff[:, k] = Kk, kk
        Vx = Qx + _mv(_t(Kk), _mv(Quu, kk)) + _mv(_t(Kk), Qu) + _mv(_t(Qux), kk)
        Vxx = Qxx + _t(Kk) @ Quu @ Kk + _t(Kk) @ Qux + _t(Qux) @ Kk
        Vx, Vxx, log_s = _rescale(Vx, Vxx, log_s)
    return K, kff


def line_search(plant: Plant, alphas: Tensor, x0: Tensor, X: Tensor, U: Tensor, K: Tensor,
                kff: Tensor, Xr: Tensor, Ur: Tensor, W: Weights, bp: BarrierParams):
    """Every step α of the ladder at once: u = clip(u_old + α (kff + K (x - x_old))) along
    the new rollout -> (X [L, nα, N+1, n̂], U [L, nα, N, m], cost [L, nα])."""
    L, N = U.shape[:2]
    na = alphas.numel()
    x = x0[:, None].expand(L, na, x0.shape[-1])
    bpl = _bp(bp, 2)
    a = alphas[None, :, None]
    c = x0.new_zeros((L, na))
    xs, us = [x], []
    for k in range(N):
        du = kff[:, k, None] + _mv(K[:, k, None], x - X[:, k, None])
        u = plant.clamp(U[:, k, None] + a * du)
        dx, dur = x - Xr[:, k, None], u - Ur[:, k, None]
        c = c + (0.5 * W.Cx[:, None] * dx * dx).sum(-1) + (0.5 * W.Cu[:, None] * dur * dur).sum(-1)
        x = plant.f_hat(x, u, bpl)
        xs.append(x)
        us.append(u)
    dN = x - Xr[:, -1, None]
    c = c + (0.5 * W.Cf[:, None] * dN * dN).sum(-1)
    return torch.stack(xs, 2), torch.stack(us, 2), c


def solve(plant: Plant, x0: Tensor, U_init: Tensor, Xr: Tensor, Ur: Tensor, W: Weights,
          bp: BarrierParams, *, max_iter: int, tol: float, reg: float, alphas, guard_eps: float):
    """iLQR from the warm start U_init (clamped): at most max_iter iterations, each lane
    frozen once its best step improves its cost by less than tol (NaN costs never win,
    the first of equal costs wins); returns (X [L, N+1, n̂], U [L, N, m])."""
    U = plant.clamp(U_init)
    X = rollout(plant, x0, U, bp)
    L, N = U.shape[:2]
    al = torch.tensor(alphas, dtype=x0.dtype, device=x0.device)
    prev = x0.new_full((L,), float("inf"))
    done = torch.zeros((L,), dtype=torch.bool, device=x0.device)
    bpl = _bp(bp, 2)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        A, Bm = plant.jacobians(X[:, :-1], U, bpl)
        lx = W.Cx[:, None] * (X[:, :-1] - Xr[:, :-1])
        lu = W.Cu[:, None] * (U - Ur)
        K, kff = riccati(A, Bm, lx, lu, W, W.Cf * (X[:, -1] - Xr[:, -1]), reg, guard_eps)
        Xc, Uc, c = line_search(plant, al, x0, X, U, K, kff, Xr, Ur, W, bp)
        c = torch.where(torch.isnan(c), torch.full_like(c, float("inf")), c)
        best_cost, best = torch.min(c, dim=1)
        pick = lambda T: T[torch.arange(L, device=T.device), best]
        live = ~done
        X = torch.where(live[:, None, None], pick(Xc), X)
        U = torch.where(live[:, None, None], pick(Uc), U)
        done = done | ((prev - best_cost).abs() < tol)
        prev = torch.where(live, best_cost, prev)
    return X, U


def sensitivity(plant: Plant, X: Tensor, U: Tensor, Xr: Tensor, Ur: Tensor, W: Weights,
                bp: BarrierParams, *, reg: float, active_tol: float, guard_eps: float):
    """Gradients of the tube loss L = Σ_k |x̂_k - xr_k|² (barrier row of xr 0) with respect
    to the ancillary (Q, R, q_b), Q_f tied to Q, through the solution (X, U): the δz
    solve of the Gauss-Newton LQR at (X, U) on the scaled value function, whose controls
    within active_tol of a bound are held, then Σ 2 (x - xr) δx and Σ 2 (u - ur) δu.
    Returns (gQ [L, n], gR [L, m], gqb [L])."""
    L, N, m = U.shape
    n = X.shape[-1]
    A, Bm = plant.jacobians(X[:, :-1], U, _bp(bp, 2))
    free = ((U > plant.u_min + active_tol) & (U < plant.u_max - active_tol)).to(X.dtype)
    gX = 2.0 * (X - Xr)
    I = torch.eye(m, dtype=X.dtype, device=X.device)
    tv, Vxx = gX[:, -1], torch.diag_embed(W.Cf)
    log_s = X.new_zeros((L,))
    K, kff = X.new_empty((L, N, m, n)), X.new_empty((L, N, m))
    for k in reversed(range(N)):
        a, b, f = A[:, k], Bm[:, k], free[:, k]
        inv_s = torch.exp(-log_s)
        VA, VB = Vxx @ a, Vxx @ b
        Qxx = torch.diag_embed(W.Cx * inv_s[:, None]) + _t(a) @ VA
        Qxu, Qux = _t(a) @ VB, _t(b) @ VA
        Quu = torch.diag_embed(W.Cu * inv_s[:, None]) + _t(b) @ VB
        tQx, tQu = gX[:, k] * inv_s[:, None] + _mv(_t(a), tv), _mv(_t(b), tv)
        Qm = ((Quu + (reg * inv_s)[:, None, None] * I) * f[:, :, None] * f[:, None, :]
              + torch.diag_embed(1.0 - f))
        inv = inverse(Qm, guard_eps)
        Kk, kk = -(inv @ (Qux * f[:, :, None])), -_mv(inv, tQu * f)
        K[:, k], kff[:, k] = Kk, kk
        tv, Vxx, log_s = _rescale(tQx + _mv(Qxu, kk), Qxx + Qxu @ Kk, log_s)
    dx = X.new_zeros((L, n))
    gx, gr = X.new_zeros((L, n)), X.new_zeros((L, m))
    for k in range(N):
        dv = kff[:, k] + _mv(K[:, k], dx)
        gx = gx + gX[:, k] * dx
        gr = gr + 2.0 * (U[:, k] - Ur[:, k]) * dv
        dx = _mv(A[:, k], dx) + _mv(Bm[:, k], dv)
    gx = gx + gX[:, -1] * dx
    return gx[:, :n - 1], gr, gx[:, n - 1]


class State(NamedTuple):
    """The paper loop's carry, lane first: the true and nominal augmented states, the two
    warm starts, the ancillary θ = (Q, R, q_b) and its momentum."""

    x: Tensor         # [L, nx]
    b: Tensor         # [L]
    x_bar: Tensor     # [L, nx]
    b_bar: Tensor     # [L]
    U_nom_ws: Tensor  # [L, N, m]
    U_aux_ws: Tensor  # [L, N, m]
    Q: Tensor         # [L, nx]
    R: Tensor         # [L, m]
    qb: Tensor        # [L]
    vQ: Tensor
    vR: Tensor
    vqb: Tensor


class PaperTube:
    """The paper loop of one configuration in ``dtype`` on ``device``: its settings read
    from the configuration file (the repository's YAML schema under ``values``), the paper
    path's solver regularisation 1e-6, the sensitivity's 1e-9 and active-set tolerance
    1e-8."""

    REG, SENS_REG, ACTIVE_TOL = 1e-6, 1e-9, 1e-8

    def __init__(self, config: dict, dtype: torch.dtype, device="cpu"):
        v = config["values"]
        self.plant = Plant(config, dtype, device)
        self.dtype, self.device = dtype, device
        s, a, d = v["system"], v["adaptation"], v["dbas"]
        self.N, self.H = int(s["horizon_N"]), int(s["task_horizon_H"])
        self.nom_iter, self.aux_iter = int(s["nominal_max_iter"]), int(s["aux_max_iter"])
        self.tol = float(s.get("ilqr_tol", 1e-3))
        self.alphas = tuple(float(x) for x in s["line_search_alphas"])
        self.lr, self.momentum = float(a["lr_eta"]), float(a["momentum"])
        self.project = bool(a["project_params"])
        if float(a["grad_clip_norm"]) != 0.0 or int(a["steps"]) != 1:
            raise ValueError("the reference's paper step takes grad_clip_norm 0 and one step")
        self.guard_eps = float(torch.finfo(torch.float64 if v.get("use_float64")
                                           else torch.float32).eps)
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)
        self.target = t([float(x) for x in s["target"]])
        cn, ca = v["cost_nominal"], v["cost_auxiliary"]
        self.nom = (t(cn["Q"]), t(cn["R"]), t(float(cn["q_b"])), t(cn["Qf"]))
        self.theta0 = (t(ca["Q"]), t(ca["R"]), t(float(ca["q_b"])))
        self.bp_vals = (float(d["alpha"]), float(d["gamma"]), float(d["nominal_tightening"]))
        self.x0 = t([float(x) for x in (s.get("x0") or config["plant"]["x0"])])

    def bp(self, L: int) -> BarrierParams:
        return BarrierParams(*(torch.full((L,), x, dtype=self.dtype, device=self.device)
                               for x in self.bp_vals))

    def init_state(self, L: int) -> State:
        """Every lane at x0, θ the configuration's ancillary weights, zero momentum and
        warm starts."""
        x = self.x0.expand(L, -1).clone()
        b = self.plant.b0(x, self.bp(L))
        Z = torch.zeros((L, self.N, self.plant.nu), dtype=self.dtype, device=self.device)
        Q, R, qb = (t.expand((L,) + t.shape).clone() for t in self.theta0)
        return State(x, b, x.clone(), b.clone(), Z, Z.clone(), Q, R, qb,
                     torch.zeros_like(Q), torch.zeros_like(R), torch.zeros_like(qb))

    def _solve(self, x0, U_init, Xr, Ur, W, max_iter):
        return solve(self.plant, x0, U_init, Xr, Ur, W, self.bp(x0.shape[0]), max_iter=max_iter,
                     tol=self.tol, reg=self.REG, alphas=self.alphas, guard_eps=self.guard_eps)

    def nominal_problem(self, st: State):
        """(x̂̄, Xr, Ur, W) of the nominal solve: the target, no control reference."""
        L = st.x.shape[0]
        Xr = torch.cat([self.target, self.target.new_zeros(1)]).expand(L, self.N + 1, -1)
        Ur = torch.zeros((L, self.N, self.plant.nu), dtype=self.dtype, device=self.device)
        Q, R, qb, Qf = (t.expand((L,) + t.shape) for t in self.nom)
        return torch.cat([st.x_bar, st.b_bar[:, None]], -1), Xr, Ur, weights(Q, R, qb, Qf)

    def ancillary_problem(self, st: State, X_nom: Tensor, U_nom: Tensor):
        """(x̂, Xr, Ur, W) of the ancillary solve: the nominal plan's states (barrier row 0)
        and controls, the lane's θ."""
        Xr = torch.cat([X_nom[..., :-1], X_nom.new_zeros(X_nom.shape[:-1] + (1,))], -1)
        return (torch.cat([st.x, st.b[:, None]], -1), Xr, U_nom,
                weights(st.Q, st.R, st.qb))

    def solve_nominal(self, st: State):
        x0, Xr, Ur, W = self.nominal_problem(st)
        return self._solve(x0, st.U_nom_ws, Xr, Ur, W, self.nom_iter)

    def solve_ancillary(self, st: State, X_nom: Tensor, U_nom: Tensor):
        x0, Xr, Ur, W = self.ancillary_problem(st, X_nom, U_nom)
        return self._solve(x0, st.U_aux_ws, Xr, Ur, W, self.aux_iter)

    def problem_cost(self, problem, U: Tensor) -> Tensor:
        """The cost of controls U on a solve's problem (x̂0, Xr, Ur, W), along their rollout."""
        x0, Xr, Ur, W = problem
        U = self.plant.clamp(U)
        return cost(rollout(self.plant, x0, U, self.bp(x0.shape[0])), U, Xr, Ur, W)

    @staticmethod
    def tube_loss(X_aux: Tensor, X_nom: Tensor) -> Tensor:
        """L = Σ_k |x_k - x̄_k|² + b_k² over the N+1 states of the plans."""
        dx = X_aux[..., :-1] - X_nom[..., :-1]
        return (dx * dx).sum((1, 2)) + (X_aux[..., -1] * X_aux[..., -1]).sum(1)

    def update(self, st: State, X_aux, U_aux, X_nom, U_nom, loss):
        """θ and its momentum after this step: the sensitivity's gradients, zero on a lane
        whose loss or any gradient is not finite, v = μ v + g, θ = proj(θ - lr v) with
        Q >= 0, R >= 1e-4, q_b in [0, 1]."""
        _, Xr, Ur, W = self.ancillary_problem(st, X_nom, U_nom)
        gQ, gR, gqb = sensitivity(self.plant, X_aux, U_aux, Xr, Ur, W, self.bp(st.x.shape[0]),
                                  reg=self.SENS_REG, active_tol=self.ACTIVE_TOL,
                                  guard_eps=self.guard_eps)
        ok = (torch.isfinite(gQ).all(-1) & torch.isfinite(gR).all(-1) & torch.isfinite(gqb)
              & torch.isfinite(loss))
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        g = (torch.where(ok[:, None], gQ, zero), torch.where(ok[:, None], gR, zero),
             torch.where(ok, gqb, zero))
        vel = tuple(self.momentum * v + gi for v, gi in zip((st.vQ, st.vR, st.vqb), g))
        Q, R, qb = (p - self.lr * v for p, v in zip((st.Q, st.R, st.qb), vel))
        if self.project:
            Q, R, qb = torch.clamp(Q, min=0.0), torch.clamp(R, min=1e-4), torch.clamp(qb, 0.0, 1.0)
        return (Q, R, qb), vel

    def propagate(self, st: State, u: Tensor, u_bar: Tensor, w: Tensor):
        """(x, b, x̄, b̄) of the next step: the true state under u plus the disturbance w,
        the nominal state under u_bar."""
        bp = self.bp(st.x.shape[0])
        nx = self.plant.nx
        xh = self.plant.f_hat(torch.cat([st.x, st.b[:, None]], -1), u, bp)
        xb = self.plant.f_hat(torch.cat([st.x_bar, st.b_bar[:, None]], -1), u_bar, bp)
        return xh[:, :nx] + w, xh[:, nx], xb[:, :nx], xb[:, nx]

    def step(self, st: State, w: Tensor):
        """The whole paper step: {"U_nom", "U_aux", "X_nom", "X_aux", "loss", "theta", "vel",
        "next": (x, b, x̄, b̄)}."""
        X_nom, U_nom = self.solve_nominal(st)
        X_aux, U_aux = self.solve_ancillary(st, X_nom, U_nom)
        loss = self.tube_loss(X_aux, X_nom)
        theta, vel = self.update(st, X_aux, U_aux, X_nom, U_nom, loss)
        return dict(U_nom=U_nom, U_aux=U_aux, X_nom=X_nom, X_aux=X_aux, loss=loss, theta=theta,
                    vel=vel, next=self.propagate(st, U_aux[:, 0], U_nom[:, 0], w))
