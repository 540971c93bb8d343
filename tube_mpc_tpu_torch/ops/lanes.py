"""Component ("structure-of-arrays") forms for the lane kernels (port of
tube_mpc_tpu/ops/lanes.py:33-238).

Each state and control component is a row tensor (any shape, usually [B]) and all
math is elementwise. Four systems: Dubins, the double integrator, the planar
quadrotor and the cart-pole. Where the JAX package derives Jacobian rows with ``jax.jvp``
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


# The component systems the CUDA kernels take, in the order of their system ids
# (csrc/lane_common.cuh, LaneConsts.system).
FAMILIES = ("dubins", "double_integrator", "quadrotor2d", "cartpole")


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """The constants of a component system that the CUDA kernels take: its family
    (which step and which h the kernels run), the step's constants, and the circle
    obstacles, their aggregation ("smoothmin" or "min") and the smooth-min's beta (none
    for the cart-pole's track limit)."""

    family: str
    dt: float
    centers: Tuple[Tuple[float, float], ...] = ()
    radii: Tuple[float, ...] = ()
    beta: float = 20.0
    aggregation: str = "smoothmin"
    mass: float = 0.0        # quadrotor
    inertia: float = 0.0
    arm: float = 0.0
    gravity: float = 0.0     # quadrotor, cart-pole
    m_cart: float = 0.0      # cart-pole
    m_pole: float = 0.0
    length: float = 0.0
    x_lim: float = 0.0


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
    spec: Optional[LaneSpec] = None

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
            if barrier_type == "log":
                # B does not depend on α: jax.jvp's tangent is a symbolic zero, so the
                # row is an exact zero, also where γ is not finite (0 - γ·0 would be NaN)
                d_alpha = zero
            else:
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


def _div(x: Tensor, c: float) -> Tensor:
    """x / c for a Python number c, as a true division in x's dtype. PyTorch would
    multiply by a rounded 1/c on the card, which the kernels (and JAX) do not."""
    return x / torch.full_like(x, c)


def _circles(centers: Sequence[Tuple[float, float]], radii: Sequence[float]):
    """(each(px, py) -> [h_i], tangents(px, py, dpx, dpy) -> [dh_i]) of the circles:
    h_i = |p - c_i|² - r_i², with d(a**2) = da·(2a) as JAX's integer_pow."""
    cs = tuple((float(cx), float(cy)) for cx, cy in centers)
    rs = tuple(float(r) for r in radii)

    def each(px: Tensor, py: Tensor):
        out = []
        for (cx, cy), r in zip(cs, rs):
            dx, dy = px - cx, py - cy
            out.append(dx * dx + dy * dy - r * r)
        return out

    def tangents(px: Tensor, py: Tensor, dpx: Tensor, dpy: Tensor):
        return [dpx * (2.0 * (px - cx)) + dpy * (2.0 * (py - cy)) for cx, cy in cs]

    return each, tangents


def _min_chain(hs):
    """z = min(...min(h_0, h_1)..., h_k), the chain of jnp.minimum."""
    z = hs[0]
    for v_ in hs[1:]:
        z = torch.minimum(z, v_)
    return z


def _min_chain_tan(hs, dh):
    """The tangent of _min_chain by lax.min's rule: each step weighs its two sides by
    the balanced-equality factors (1 to the winner, 1/2 to each side of a tie)."""
    z, dz = hs[0], dh[0]
    for v_, dv_ in zip(hs[1:], dh[1:]):
        zn = torch.minimum(z, v_)
        dz = dz * balanced_weight(z, zn, v_) + dv_ * balanced_weight(v_, zn, z)
        z = zn
    return dz


def smoothmin_h_lin(centers: Sequence[Tuple[float, float]], radii: Sequence[float],
                    beta: float):
    """h_lin of the min-shifted smooth-min over circles on the two leading state rows:
    h = z - (1/β) log Σ exp(-β (h_i - z)), z = min_i h_i, h_i = |p - c_i|² - r_i²."""
    each, tangents = _circles(centers, radii)

    def h_lin(xs: Rows):
        px, py = xs[0], xs[1]
        hs = each(px, py)
        z = _min_chain(hs)
        es = [torch.exp(-beta * (v_ - z)) for v_ in hs]
        acc = sum(es)
        value = z - (1.0 / beta) * torch.log(acc)

        def tangent(dxs: Rows) -> Tensor:
            dh = tangents(px, py, dxs[0], dxs[1])
            dz = _min_chain_tan(hs, dh)
            dacc = sum((-beta * (d - dz)) * e for d, e in zip(dh, es))
            return dz - (1.0 / beta) * (dacc / acc)

        return value, tangent

    return h_lin


def min_h_lin(centers: Sequence[Tuple[float, float]], radii: Sequence[float]):
    """h_lin of the exact min over circles on the two leading state rows, h = min_i h_i
    (tube_mpc_tpu/ops/lanes.py:158-162): the smooth-min's z and its tangent dz."""
    each, tangents = _circles(centers, radii)

    def h_lin(xs: Rows):
        px, py = xs[0], xs[1]
        hs = each(px, py)
        return _min_chain(hs), lambda dxs: _min_chain_tan(hs, tangents(px, py, dxs[0], dxs[1]))

    return h_lin


def _circle_h(centers, radii, aggregation: str, beta: float):
    """(h_lin or None without obstacles, centers, radii) of a system with circle obstacles."""
    cs = tuple((float(cx), float(cy)) for cx, cy in centers)
    rs = tuple(float(r) for r in radii)
    if not cs:
        return None, cs, rs
    if aggregation == "smoothmin":
        return smoothmin_h_lin(cs, rs, beta), cs, rs
    if aggregation == "min":
        return min_h_lin(cs, rs), cs, rs
    # the JAX component forms raise the same when h is traced (tube_mpc_tpu/ops/lanes.py:162)
    raise ValueError(f"unsupported aggregation for component form: {aggregation}")


def dubins_components(*, dt: float, v_min: float, v_max: float, omega_max: float,
                      centers: Sequence[Tuple[float, float]] = (),
                      radii: Sequence[float] = (),
                      aggregation: str = "smoothmin", beta: float = 20.0) -> ComponentSystem:
    """Dubins in component form, with the min-shifted smooth-min h (smoothmin_h_lin) or
    the exact min (min_h_lin)."""
    h_lin, cs, rs = _circle_h(centers, radii, aggregation, beta)

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

    spec = LaneSpec(family="dubins", dt=float(dt), centers=cs, radii=rs, beta=float(beta),
                    aggregation=aggregation)
    return ComponentSystem(
        n=3, m=2, f_lin=f_lin, h_lin=h_lin,
        u_min=(v_min, -omega_max), u_max=(v_max, omega_max), spec=spec,
    )


def double_integrator_components(*, dt: float, a_max: float, centers=(), radii=(),
                                 aggregation: str = "smoothmin",
                                 beta: float = 20.0) -> ComponentSystem:
    """The 2-D double integrator [px, py, vx, vy], [ax, ay] in component form
    (tube_mpc_tpu/ops/lanes.py:171-187), with Dubins' h on (px, py)."""
    h_lin, cs, rs = _circle_h(centers, radii, aggregation, beta)

    def f_lin(xs: Rows, us: Rows):
        px, py, vx, vy = xs
        ax, ay = us

        def tangent(dxs: Rows, dus: Rows) -> Rows:
            dpx, dpy, dvx, dvy = dxs
            dax, day = dus
            return (dpx + dt * dvx, dpy + dt * dvy, dvx + dt * dax, dvy + dt * day)

        return (px + dt * vx, py + dt * vy, vx + dt * ax, vy + dt * ay), tangent

    spec = LaneSpec(family="double_integrator", dt=float(dt), centers=cs, radii=rs,
                    beta=float(beta), aggregation=aggregation)
    return ComponentSystem(n=4, m=2, f_lin=f_lin, h_lin=h_lin, u_min=(-a_max, -a_max),
                           u_max=(a_max, a_max), spec=spec)


def cartpole_components(*, dt: float, m_cart: float = 1.0, m_pole: float = 0.1,
                        length: float = 0.5, gravity: float = 9.81,
                        f_max: float = 20.0, x_lim: float = 2.4) -> ComponentSystem:
    """Cart-pole [pos, vel, th, om], [force] in component form
    (tube_mpc_tpu/ops/lanes.py:190-206), with the track limit h = x_lim² - pos².

    The arithmetic is the JAX form's, left to right: the products and sums of Python
    numbers (m_pole·length, m_cart + m_pole, 4/3, x_lim²) are formed once in double,
    and the tangent applies JAX's rules (sin, cos, mul, div, sub) term by term."""
    total_m = m_cart + m_pole
    mpl = m_pole * length
    xl2 = x_lim * x_lim

    def f_lin(xs: Rows, us: Rows):
        pos, vel, th, om = xs
        (force,) = us
        s, c = torch.sin(th), torch.cos(th)
        p1 = mpl * om
        p2 = p1 * om
        temp = _div(force + p2 * s, total_m)
        nt = gravity * s - c * temp
        q1 = m_pole * c
        den = length * (4.0 / 3.0 - _div(q1 * c, total_m))
        th_acc = nt / den
        r1 = mpl * th_acc
        x_acc = temp - _div(r1 * c, total_m)
        inv_den2 = 1.0 / (den * den)

        def tangent(dxs: Rows, dus: Rows) -> Rows:
            dpos, dvel, dth, dom = dxs
            (dforce,) = dus
            ds = dth * c
            dc = -(dth * s)
            dp2 = (mpl * dom) * om + p1 * dom
            dtemp = _div(dforce + (dp2 * s + p2 * ds), total_m)
            dnt = gravity * ds - (dc * temp + c * dtemp)
            dq2 = (m_pole * dc) * c + q1 * dc
            dden = length * (-_div(dq2, total_m))
            dth_acc = dnt / den + ((-dden) * nt) * inv_den2
            dr2 = (mpl * dth_acc) * c + r1 * dc
            dx_acc = dtemp - _div(dr2, total_m)
            return (dpos + dt * dvel, dvel + dt * dx_acc, dth + dt * dom, dom + dt * dth_acc)

        return (pos + dt * vel, vel + dt * x_acc, th + dt * om, om + dt * th_acc), tangent

    def h_lin(xs: Rows):
        pos = xs[0]
        return xl2 - pos * pos, lambda dxs: -(dxs[0] * pos + pos * dxs[0])

    spec = LaneSpec(family="cartpole", dt=float(dt), gravity=float(gravity),
                    m_cart=float(m_cart), m_pole=float(m_pole), length=float(length),
                    x_lim=float(x_lim))
    return ComponentSystem(n=4, m=1, f_lin=f_lin, h_lin=h_lin, u_min=(-f_max,), u_max=(f_max,),
                           spec=spec)


def quadrotor2d_components(*, dt: float, mass: float = 0.8, inertia: float = 0.02,
                           arm: float = 0.2, gravity: float = 9.81,
                           t_min: float = 0.0, t_max: float = 8.0,
                           centers=(), radii=(), aggregation: str = "smoothmin",
                           beta: float = 20.0) -> ComponentSystem:
    """The planar quadrotor [px, pz, th, vx, vz, om], [T1, T2] in component form
    (tube_mpc_tpu/ops/lanes.py:209-238), with Dubins' h on (px, pz)."""
    h_lin, cs, rs = _circle_h(centers, radii, aggregation, beta)

    def f_lin(xs: Rows, us: Rows):
        px, pz, th, vx, vz, om = xs
        t1, t2 = us
        thrust = t1 + t2
        s, c = torch.sin(th), torch.cos(th)
        ax = _div((-thrust) * s, mass)
        az = _div(thrust * c, mass) - gravity
        al = _div((t2 - t1) * arm, inertia)

        def tangent(dxs: Rows, dus: Rows) -> Rows:
            dpx, dpz, dth, dvx, dvz, dom = dxs
            du1, du2 = dus
            dthrust = du1 + du2
            ds = dth * c
            dc = -(dth * s)
            dax = _div((-dthrust) * s + (-thrust) * ds, mass)
            daz = _div(dthrust * c + thrust * dc, mass)
            dal = _div((du2 - du1) * arm, inertia)
            return (dpx + dt * dvx, dpz + dt * dvz, dth + dt * dom,
                    dvx + dt * dax, dvz + dt * daz, dom + dt * dal)

        return (px + dt * vx, pz + dt * vz, th + dt * om,
                vx + dt * ax, vz + dt * az, om + dt * al), tangent

    spec = LaneSpec(family="quadrotor2d", dt=float(dt), centers=cs, radii=rs, beta=float(beta),
                    aggregation=aggregation, mass=float(mass), inertia=float(inertia),
                    arm=float(arm), gravity=float(gravity))
    return ComponentSystem(n=6, m=2, f_lin=f_lin, h_lin=h_lin, u_min=(t_min, t_min),
                           u_max=(t_max, t_max), spec=spec)
