"""Component ("structure-of-arrays") forms for the lane kernels (port of
tube_mpc_tpu/ops/lanes.py:33-168).

Each state and control component is a row tensor (any shape, usually [B]) and all
math is elementwise. Where the JAX package derives Jacobian rows with ``jax.jvp``
(``jac_rows``), the port writes the tangent map by hand: every component system
supplies ``f_lin`` and ``h_lin``, which return the value and a tangent map whose
arithmetic follows JAX's differentiation rules term by term. The CUDA kernels
(csrc/lane_common.cuh) carry the same formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from .barrier import balanced_weight, barrier_dalpha, barrier_lin, barrier_value
from .dbas import BarrierParams

Rows = Tuple[Tensor, ...]
Tangent = Callable[[Rows, Rows], Rows]


@dataclasses.dataclass(frozen=True)
class DubinsSpec:
    """The constants of a Dubins component system, which the CUDA kernels take."""

    dt: float
    centers: Tuple[Tuple[float, float], ...]
    radii: Tuple[float, ...]
    beta: float


class ComponentSystem(NamedTuple):
    """Elementwise component form of a controlled system.

    f_lin(xs, us) -> (f rows, (dxs, dus) -> tangent rows); h_lin(xs) -> (h row,
    dxs -> dh row), or None without a safety set. ``spec`` names the constants
    for the CUDA kernels (None: the kernels do not take this system).
    """

    n: int
    m: int
    f_lin: Callable[[Rows, Rows], Tuple[Rows, Tangent]]
    h_lin: Optional[Callable[[Rows], Tuple[Tensor, Callable[[Rows], Tensor]]]]
    u_min: Tuple[float, ...]
    u_max: Tuple[float, ...]
    spec: Optional[DubinsSpec] = None

    def f(self, xs: Rows, us: Rows) -> Rows:
        return self.f_lin(xs, us)[0]

    def h(self, xs: Rows) -> Tensor:
        return self.h_lin(xs)[0]


def jac_rows(tangent: Tangent, n: int, m: int, like: Tensor):
    """(A, B) with A[i][j] = ∂f_i/∂x_j and B[i][a] = ∂f_i/∂u_a, by basis tangents."""
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    cols_x = [
        tangent(tuple(one if i == j else zero for i in range(n)), tuple(zero for _ in range(m)))
        for j in range(n)
    ]
    cols_u = [
        tangent(tuple(zero for _ in range(n)), tuple(one if b == a else zero for b in range(m)))
        for a in range(m)
    ]
    A = tuple(tuple(cols_x[j][i] for j in range(n)) for i in range(n))
    B = tuple(tuple(cols_u[a][i] for a in range(m)) for i in range(n))
    return A, B


def augmented_step_fn(sys_c: ComponentSystem, *, barrier_type: str = "inverse", eps: float = 1e-6):
    """f̂(x̂ rows, u rows, bp) -> x̂⁺ rows: the value of ``augmented_lin_fn``."""
    f_hat_lin = augmented_lin_fn(sys_c, barrier_type=barrier_type, eps=eps)

    def f_hat(x_hat: Rows, us: Rows, bp: BarrierParams) -> Rows:
        return f_hat_lin(x_hat, us, bp)[0]

    return f_hat


def augmented_lin_fn(sys_c: ComponentSystem, *, barrier_type: str = "inverse", eps: float = 1e-6):
    """f̂_lin(x̂ rows, u rows, bp) -> (x̂⁺ rows, (dx̂, du) -> dx̂⁺ rows), where
    x̂⁺ = [f(x, u), B(h(f) - s) - γ (B(h(x) - s) - b)].

    The tangent of the barrier row is
    dB(h⁺ - s) ∇h(x⁺)·dx⁺ - γ (dB(h - s) ∇h(x)·dx - db), so ∂b⁺/∂b = γ.

    The tangent map also carries ``params()``, the derivatives of f̂ in the
    barrier parameters as rows (∂f̂/∂α, ∂f̂/∂γ, ∂f̂/∂tight), as the three jax.jvp
    calls of the generic sensitivity kernel compute them: only the barrier row
    depends on them, ∂b⁺/∂α = ∂B(h⁺ - s)/∂α - γ ∂B(h - s)/∂α,
    ∂b⁺/∂γ = -(B(h - s) - b) and ∂b⁺/∂s = dB(h⁺ - s)·(-1) - γ dB(h - s)·(-1)."""
    if sys_c.h_lin is None:
        raise ValueError("component system needs h for DBaS augmentation")
    f_lin, h_lin, n = sys_c.f_lin, sys_c.h_lin, sys_c.n
    kw = dict(barrier_type=barrier_type, eps=eps)

    def f_hat_lin(x_hat: Rows, us: Rows, bp: BarrierParams):
        xs, b = x_hat[:n], x_hat[n]
        xn, f_tan = f_lin(xs, us)
        h_next, hn_tan = h_lin(xn)
        h_curr, hc_tan = h_lin(xs)
        B_next, Bn_tan = barrier_lin(h_next - bp.tight, bp.alpha, **kw)
        B_curr, Bc_tan = barrier_lin(h_curr - bp.tight, bp.alpha, **kw)
        b_next = B_next - bp.gamma * (B_curr - b)

        def tangent(dx_hat: Rows, dus: Rows) -> Rows:
            dxn = f_tan(dx_hat[:n], dus)
            dB_next = Bn_tan(hn_tan(dxn))
            dB_curr = Bc_tan(hc_tan(dx_hat[:n]))
            return tuple(dxn) + (dB_next - bp.gamma * (dB_curr - dx_hat[n]),)

        def params() -> Tuple[Rows, Rows, Rows]:
            zero = torch.zeros_like(b_next)
            d_alpha = (barrier_dalpha(h_next - bp.tight, bp.alpha, **kw)
                       - bp.gamma * barrier_dalpha(h_curr - bp.tight, bp.alpha, **kw))
            d_gamma = -(B_curr - b)
            minus_one = torch.full_like(b_next, -1.0)
            d_tight = Bn_tan(minus_one) - bp.gamma * Bc_tan(minus_one)
            return tuple((zero,) * n + (d,) for d in (d_alpha, d_gamma, d_tight))

        tangent.params = params
        return tuple(xn) + (b_next,), tangent

    return f_hat_lin


def init_b0_fn(sys_c: ComponentSystem, *, barrier_type: str = "inverse", eps: float = 1e-6):
    def init_b0(xs: Rows, bp: BarrierParams) -> Tensor:
        return barrier_value(sys_c.h(xs) - bp.tight, bp.alpha, barrier_type=barrier_type, eps=eps)

    return init_b0


def dubins_components(*, dt: float, v_min: float, v_max: float, omega_max: float,
                      centers: Sequence[Tuple[float, float]] = (),
                      radii: Sequence[float] = (),
                      aggregation: str = "smoothmin", beta: float = 20.0) -> ComponentSystem:
    """Dubins in component form, with the min-shifted smooth-min h:
    h = z - (1/β) log Σ exp(-β (h_i - z)), z = min_i h_i."""
    cs = tuple((float(cx), float(cy)) for cx, cy in centers)
    rs = tuple(float(r) for r in radii)

    def f_lin(xs: Rows, us: Rows):
        px, py, th = xs
        v, om = us
        c, s = torch.cos(th), torch.sin(th)
        dtv = dt * v

        def tangent(dxs: Rows, dus: Rows) -> Rows:
            dpx, dpy, dth = dxs
            dv, dom = dus
            ddtv = dt * dv
            return (dpx + (ddtv * c + dtv * (-(dth * s))),
                    dpy + (ddtv * s + dtv * (dth * c)),
                    dth + dt * dom)

        return (px + dtv * c, py + dtv * s, th + dt * om), tangent

    h_lin = None
    if cs:
        if aggregation != "smoothmin":
            raise ValueError(f"aggregation {aggregation!r} is not ported; use 'smoothmin'")

        def _each(px: Tensor, py: Tensor):
            out = []
            for (cx, cy), r in zip(cs, rs):
                dx, dy = px - cx, py - cy
                out.append(dx * dx + dy * dy - r * r)
            return out

        def _smoothmin(hs):
            z = hs[0]
            for v_ in hs[1:]:
                z = torch.minimum(z, v_)
            es = [torch.exp(-beta * (v_ - z)) for v_ in hs]
            acc = sum(es)
            return z - (1.0 / beta) * torch.log(acc), es, acc

        def h_lin(xs: Rows):  # noqa: F811
            px, py = xs[0], xs[1]
            hs = _each(px, py)
            value, es, acc = _smoothmin(hs)

            def tangent(dxs: Rows) -> Tensor:
                dpx, dpy = dxs[0], dxs[1]
                dh = [dpx * (2.0 * (px - cx)) + dpy * (2.0 * (py - cy)) for cx, cy in cs]
                z, dz = hs[0], dh[0]
                for v_, dv_ in zip(hs[1:], dh[1:]):
                    zn = torch.minimum(z, v_)
                    dz = dz * balanced_weight(z, zn, v_) + dv_ * balanced_weight(v_, zn, z)
                    z = zn
                dacc = sum((-beta * (d - dz)) * e for d, e in zip(dh, es))
                return dz - (1.0 / beta) * (dacc / acc)

            return value, tangent

    spec = DubinsSpec(dt=float(dt), centers=cs, radii=rs, beta=float(beta))
    return ComponentSystem(
        n=3, m=2, f_lin=f_lin, h_lin=h_lin,
        u_min=(v_min, -omega_max), u_max=(v_max, omega_max), spec=spec,
    )
