"""Dynamics, obstacle safety value and DBaS barrier state of the benchmark's deployments,
written from the configuration's values: x̂ = [x, b], x̂⁺ = [f(x, u), B(h(f(x, u)) - s) -
γ (B(h(x) - s) - b)], with the relaxed inverse barrier B and the smooth minimum h of the
circle obstacles' h_i = |p - c_i|² - r_i²."""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class BarrierParams(NamedTuple):
    """Relaxation α, feedback γ and tightening s, each a tensor that broadcasts over the
    leading dims of the states."""

    alpha: Tensor
    gamma: Tensor
    tight: Tensor


class Plant:
    """One deployment's plant in ``dtype`` on ``device``, from its configuration file's
    ``values`` (the repository's YAML schema) and ``plant`` constants."""

    def __init__(self, config: dict, dtype: torch.dtype, device="cpu"):
        values = config["values"]
        sysv, env, dbas = values["system"], values["environment"], values["dbas"]
        self.name = sysv["name"]
        self.dtype, self.device = dtype, device
        self.dt = float(sysv["dt"])
        bounds = sysv["control_bounds"]
        if self.name == "dubins":
            self.nx, self.nu = 3, 2
            lo = [float(bounds["v_min"]), -float(bounds["omega_max"])]
            hi = [float(bounds["v_max"]), float(bounds["omega_max"])]
        elif self.name == "quadrotor2d":
            self.nx, self.nu = 6, 2
            lo = [float(bounds["t_min"])] * 2
            hi = [float(bounds["t_max"])] * 2
            consts = config["plant"]
            self.mass, self.inertia = float(consts["mass"]), float(consts["inertia"])
            self.arm, self.gravity = float(consts["arm"]), float(consts["gravity"])
        else:
            raise ValueError(f"no reference plant for {self.name!r}")
        if env.get("obstacle_aggregation") != "smoothmin" or dbas["barrier_type"] != "inverse":
            raise ValueError("the reference takes the smooth-min obstacles and the inverse barrier")
        t = lambda v: torch.tensor(v, dtype=dtype, device=device)
        self.u_min, self.u_max = t(lo), t(hi)
        self.centers = t([list(map(float, o["center"])) for o in env["obstacles"]])
        self.radii = t([float(o["radius"]) for o in env["obstacles"]])
        self.beta = float(env["obstacle_smoothmin_beta"])
        self.eps = float(dbas["eps"])
        self.n_hat = self.nx + 1

    def f(self, x: Tensor, u: Tensor) -> Tensor:
        """One Euler step of the plant: x [..., nx], u [..., nu] -> [..., nx]."""
        dt = self.dt
        if self.name == "dubins":
            th, v, om = x[..., 2], u[..., 0], u[..., 1]
            return torch.stack([x[..., 0] + dt * v * torch.cos(th),
                                x[..., 1] + dt * v * torch.sin(th), th + dt * om], dim=-1)
        px, pz, th, vx, vz, om = x.unbind(-1)
        thrust = u[..., 0] + u[..., 1]
        ax = -thrust * torch.sin(th) / self.mass
        az = thrust * torch.cos(th) / self.mass - self.gravity
        al = (u[..., 1] - u[..., 0]) * self.arm / self.inertia
        return torch.stack([px + dt * vx, pz + dt * vz, th + dt * om,
                            vx + dt * ax, vz + dt * az, om + dt * al], dim=-1)

    def h(self, x: Tensor) -> Tensor:
        """-(1/β) log Σ_i exp(-β h_i(p)), p the position (the first two states)."""
        d = x[..., None, :2] - self.centers
        hi = (d * d).sum(-1) - self.radii * self.radii
        return -torch.logsumexp(-self.beta * hi, dim=-1) / self.beta

    def barrier(self, zeta: Tensor, alpha: Tensor) -> Tensor:
        """The relaxed inverse barrier: 1/ζ above a = max(α, eps), below it the quadratic
        that continues 1/ζ with its value and slope at a."""
        a = torch.clamp(alpha, min=self.eps)
        d = zeta - a
        below = 1.0 / a - d / (a * a) + d * d / (a * a * a)
        return torch.where(zeta >= a, 1.0 / torch.clamp(zeta, min=self.eps), below)

    def f_hat(self, xh: Tensor, u: Tensor, bp: BarrierParams) -> Tensor:
        """The DBaS-augmented step: xh [..., nx+1], u [..., nu] -> [..., nx+1]."""
        x, b = xh[..., :self.nx], xh[..., self.nx]
        x_next = self.f(x, u)
        b_next = (self.barrier(self.h(x_next) - bp.tight, bp.alpha)
                  - bp.gamma * (self.barrier(self.h(x) - bp.tight, bp.alpha) - b))
        return torch.cat([x_next, b_next[..., None]], dim=-1)

    def b0(self, x: Tensor, bp: BarrierParams) -> Tensor:
        """The barrier state at x: B(h(x) - s)."""
        return self.barrier(self.h(x) - bp.tight, bp.alpha)

    def clamp(self, u: Tensor) -> Tensor:
        return torch.minimum(self.u_max, torch.maximum(self.u_min, u))

    def jacobians(self, X: Tensor, U: Tensor, bp: BarrierParams):
        """(A [..., n̂, n̂], B [..., n̂, nu]) of f_hat at every (X, U) [..., n̂], [..., nu], by
        forward-mode differentiation, one input direction at a time."""
        import torch.autograd.forward_ad as fwad

        cols = []
        for j in range(self.n_hat + self.nu):
            tx, tu = torch.zeros_like(X), torch.zeros_like(U)
            if j < self.n_hat:
                tx[..., j] = 1.0
            else:
                tu[..., j - self.n_hat] = 1.0
            with fwad.dual_level():
                out = self.f_hat(fwad.make_dual(X, tx), fwad.make_dual(U, tu), bp)
                cols.append(fwad.unpack_dual(out).tangent)
        J = torch.stack(cols, dim=-1)
        return J[..., :self.n_hat], J[..., self.n_hat:]

