"""Lane iLQR solver: K1 (Riccati sweep) and K2 (line search) with their plain
PyTorch versions, and the solver loop around them with its straggler compaction and
iteration telemetry (port of tube_mpc_tpu/ops/pallas/lane_solver.py:47-510).

Layout: every array is [N, component, B] or [component, B], lane index fastest.
Const rows C [2n̂+m+3, B] (tube/lane_interface.py::_build_C):
  [0:n̂] stage diag (2Q.., 2qb) | [n̂:n̂+m] 2R | [n̂+m:2n̂+m] terminal diag
  (2Qf.., 2qb) | alpha | gamma | tight

Each kernel wrapper (``ric``, ``fwd``) runs the plain version for CPU tensors and
the CUDA kernel (csrc/lane_solver.cu) for CUDA tensors, and counts its kernel
launches in ``<wrapper>.launches`` (and by lane count in ``<wrapper>.by_width``). The plain versions repeat the kernels'
arithmetic in the JAX kernels' order; they are what the CPU tests hold against the
JAX package and what the card's check holds the kernels against.

Spans (utils/profiling.py::annotate): each wrapper runs under ``kernel.<name>``; the
solver loop names its host reads ``lane.host_read``, each iteration's winner selection
and freeze ``lane.epilogue``, and a compacted stage's gathers ``lane.compact`` and
scatter ``lane.scatter``. ``lane_ilqr_solve.counts`` counts the host reads and the
lanes that entered each iteration unconverged.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...utils.profiling import annotate
from ..dbas import BarrierParams
from ..lanes import FAMILIES, LaneSpec, jac_rows
from . import _build

V_SCALE_THRESH = 1e8  # renormalise the V carry beyond this (f32 range guard)
MAX_OBS = 8
MAX_ALPHAS = 8


@dataclasses.dataclass(frozen=True)
class LaneProblem:
    """Static description of a lane-major tube OCP."""

    n: int
    m: int
    f_hat: Callable          # (x̂ rows, u rows, BarrierParams of rows) -> rows
    f_hat_lin: Callable      # (x̂ rows, u rows, bp) -> (rows, tangent map)
    u_min: Tuple[float, ...]
    u_max: Tuple[float, ...]
    spec: Optional[LaneSpec]
    barrier_type: str
    eps: float

    @property
    def n_hat(self) -> int:
        return self.n + 1


def _bp_from_C(pb: LaneProblem, C: Tensor) -> BarrierParams:
    base = 2 * pb.n_hat + pb.m
    return BarrierParams(alpha=C[base], gamma=C[base + 1], tight=C[base + 2])


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _inv2(q00: Tensor, q01: Tensor, q10: Tensor, q11: Tensor):
    """Scale-invariant adjugate inverse with resolve-or-zero: below ~100 ulps of
    |det| the gains are zeroed and the lane stalls on its incumbent trajectory."""
    finfo = torch.finfo(q00.dtype)
    s = torch.maximum(torch.maximum(q00.abs(), q01.abs()), torch.maximum(q10.abs(), q11.abs()))
    s = torch.clamp(s, min=finfo.tiny)
    n00, n01, n10, n11 = q00 / s, q01 / s, q10 / s, q11 / s
    det = n00 * n11 - n01 * n10
    ok = det.abs() > 100.0 * finfo.eps
    safe_det = torch.where(ok, det, torch.ones_like(det))
    det_inv = ok.to(det.dtype) / (safe_det * s)
    return [[n11 * det_inv, -n01 * det_inv], [-n10 * det_inv, n00 * det_inv]]


def _rescale(vx_new, vxx_new, LogS: Tensor):
    """Scaled V carry: true V = exp(LogS) (Vx, Vxx). Renormalise above 1e8, and
    scrub entries that are not finite after a cast to f32 (in f64 too)."""
    nh = len(vx_new)
    mmax = torch.zeros_like(vx_new[0])
    for i in range(nh):
        mmax = torch.maximum(mmax, vx_new[i].abs())
        for j in range(nh):
            mmax = torch.maximum(mmax, vxx_new[i][j].abs())
    scale_inv = torch.where(mmax > V_SCALE_THRESH, torch.full_like(mmax, V_SCALE_THRESH) / mmax,
                            torch.ones_like(mmax))

    def safe(v):
        v = v * scale_inv
        return torch.where(torch.isfinite(v.float()), v, torch.zeros_like(v))

    Vx = [safe(vx_new[i]) for i in range(nh)]
    Vxx = [[safe(vxx_new[i][j]) for j in range(nh)] for i in range(nh)]
    LogS = LogS - torch.log(torch.clamp(scale_inv, min=torch.finfo(scale_inv.dtype).tiny))
    return Vx, Vxx, LogS


def jac_lin_plain(pb: LaneProblem, X: Tensor, U: Tensor, C: Tensor):
    """f̂'s Jacobian rows at every step at once, each a row [N, B]: A[i][j] = ∂f̂_i/∂x̂_j,
    Bm[i][a] = ∂f̂_i/∂u_a at X [N, n̂, B], U [N, m, B] (the phase A of K1 and K3/K5)."""
    xs = tuple(X[:, i] for i in range(pb.n_hat))
    us = tuple(U[:, a] for a in range(pb.m))
    _, tangent = pb.f_hat_lin(xs, us, _bp_from_C(pb, C))
    return jac_rows(tangent, pb.n_hat, pb.m, xs[0])


def ric_lin_plain(pb: LaneProblem, X: Tensor, U: Tensor, Xr: Tensor, Ur: Tensor, C: Tensor):
    """K1's phase A: f̂'s Jacobian rows and the cost gradients at every step at once,
    each a row [N, B]: A, Bm (jac_lin_plain), lx[i] = C_i (x_i - xr_i),
    lu[a] = C_{n̂+a} (u_a - ur_a). None depends on the Riccati carry."""
    nh, m = pb.n_hat, pb.m
    A, Bm = jac_lin_plain(pb, X, U, C)
    lx = [C[i] * (X[:, i] - Xr[:, i]) for i in range(nh)]
    lu = [C[nh + a] * (U[:, a] - Ur[:, a]) for a in range(m)]
    return A, Bm, lx, lu


def ric_plain(pb: LaneProblem, reg: float, X: Tensor, U: Tensor, Xr: Tensor, Ur: Tensor,
              C: Tensor, phix: Tensor) -> Tuple[Tensor, Tensor]:
    """Backward Riccati sweep with diagonal cost Hessians: X, Xr [N, n̂, B], U, Ur
    [N, m, B], C [nc, B], phix [n̂, B] -> K [N, m n̂, B], kff [N, m, B]. In the
    kernel's two phases: the linearisation of every step (ric_lin_plain), then the
    recursion over k = N-1..0."""
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    A_all, Bm_all, lx_all, lu_all = ric_lin_plain(pb, X, U, Xr, Ur, C)
    K_out = X.new_empty((N, m * nh, B))
    kff_out = X.new_empty((N, m, B))
    zero = torch.zeros_like(phix[0])
    vx = [phix[i] for i in range(nh)]
    vxx = [[C[nh + m + i] if i == j else zero for j in range(nh)] for i in range(nh)]
    LogS = torch.zeros_like(zero)

    for k in reversed(range(N)):
        inv_s = torch.exp(-LogS)
        A = [[A_all[i][j][k] for j in range(nh)] for i in range(nh)]
        Bm = [[Bm_all[i][a][k] for a in range(m)] for i in range(nh)]
        lx = [lx_all[i][k] for i in range(nh)]
        lu = [lu_all[a][k] for a in range(m)]

        Qx = [lx[i] * inv_s + sum(A[j][i] * vx[j] for j in range(nh)) for i in range(nh)]
        Qu = [lu[a] * inv_s + sum(Bm[j][a] * vx[j] for j in range(nh)) for a in range(m)]
        VA = [[sum(vxx[i][l] * A[l][j] for l in range(nh)) for j in range(nh)] for i in range(nh)]
        VB = [[sum(vxx[i][l] * Bm[l][a] for l in range(nh)) for a in range(m)] for i in range(nh)]
        Qxx = [[(C[i] * inv_s if i == j else 0.0) + sum(A[l][i] * VA[l][j] for l in range(nh))
                for j in range(nh)] for i in range(nh)]
        Qux = [[sum(Bm[l][a] * VA[l][i] for l in range(nh)) for i in range(nh)] for a in range(m)]
        Quu = [[(C[nh + a] * inv_s if a == b else 0.0) + sum(Bm[l][a] * VB[l][b] for l in range(nh))
                for b in range(m)] for a in range(m)]
        regs = reg * inv_s
        if m == 1:   # as the JAX kernel writes it: no resolve-or-zero guard
            inv = [[1.0 / (Quu[0][0] + regs)]]
        else:
            inv = _inv2(Quu[0][0] + regs, Quu[0][1], Quu[1][0], Quu[1][1] + regs)

        K = [[-sum(inv[a][b] * Qux[b][i] for b in range(m)) for i in range(nh)] for a in range(m)]
        kf = [-sum(inv[a][b] * Qu[b] for b in range(m)) for a in range(m)]
        for a in range(m):
            kff_out[k, a] = kf[a]
            for i in range(nh):
                K_out[k, a * nh + i] = K[a][i]

        Quu_k = [sum(Quu[a][b] * kf[b] for b in range(m)) for a in range(m)]
        QuuK = [[sum(Quu[a][b] * K[b][j] for b in range(m)) for j in range(nh)] for a in range(m)]
        vx_new = [
            Qx[i]
            + sum(K[a][i] * (Quu_k[a] + Qu[a]) for a in range(m))
            + sum(Qux[a][i] * kf[a] for a in range(m))
            for i in range(nh)
        ]
        vxx_new = [
            [
                Qxx[i][j]
                + sum(K[a][i] * QuuK[a][j] for a in range(m))
                + sum(K[a][i] * Qux[a][j] for a in range(m))
                + sum(Qux[a][i] * K[a][j] for a in range(m))
                for j in range(nh)
            ]
            for i in range(nh)
        ]
        vx, vxx, LogS = _rescale(vx_new, vxx_new, LogS)
    return K_out, kff_out


def fwd_plain(pb: LaneProblem, alphas: Sequence[float], x0: Tensor, Xo: Tensor, Uo: Tensor,
              K: Tensor, kff: Tensor, Xr: Tensor, XrN: Tensor, Ur: Tensor,
              C: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Line search, every alpha advancing together: u = clip(u_old + α(kff + K(x - x_old)))
    -> X [N, nα n̂, B], U [N, nα m, B], cost [nα, B] (stage sums plus terminal)."""
    nh, m = pb.n_hat, pb.m
    N, B = Xo.shape[0], Xo.shape[-1]
    na = len(alphas)
    bp = _bp_from_C(pb, C)
    Xn = Xo.new_empty((N, na * nh, B))
    Un = Xo.new_empty((N, na * m, B))
    cost = [torch.zeros_like(x0[0]) for _ in range(na)]
    xs_a = [tuple(x0[i] for i in range(nh)) for _ in range(na)]

    for k in range(N):
        xo = [Xo[k, i] for i in range(nh)]
        uo = [Uo[k, c] for c in range(m)]
        Kk = [[K[k, c * nh + i] for i in range(nh)] for c in range(m)]
        kf = [kff[k, c] for c in range(m)]
        xr = [Xr[k, i] for i in range(nh)]
        ur = [Ur[k, c] for c in range(m)]
        for a, alpha in enumerate(alphas):
            x_a = xs_a[a]
            du = [kf[c] + sum(Kk[c][i] * (x_a[i] - xo[i]) for i in range(nh)) for c in range(m)]
            u_a = tuple(torch.clamp(uo[c] + alpha * du[c], pb.u_min[c], pb.u_max[c]) for c in range(m))
            dxr = [x_a[i] - xr[i] for i in range(nh)]
            dur = [u_a[c] - ur[c] for c in range(m)]
            stage = sum(0.5 * C[i] * (dxr[i] * dxr[i]) for i in range(nh)) + sum(
                0.5 * C[nh + c] * (dur[c] * dur[c]) for c in range(m)
            )
            cost[a] = cost[a] + stage

            x_next = pb.f_hat(x_a, u_a, bp)
            for i in range(nh):
                Xn[k, a * nh + i] = x_next[i]
            for c in range(m):
                Un[k, a * m + c] = u_a[c]
            xs_a[a] = x_next
            if k == N - 1:
                dN = [x_next[i] - XrN[i] for i in range(nh)]
                cost[a] = cost[a] + sum(0.5 * C[nh + m + i] * (dN[i] * dN[i]) for i in range(nh))
    return Xn, Un, torch.stack(cost, dim=0)


# ---------------------------------------------------------------------------
# Kernel plumbing shared with lane_sensitivity.py.
# ---------------------------------------------------------------------------

# The component dimensions (n, m) of each family the kernels take (ops/lanes.py).
FAMILY_DIMS = {"dubins": (3, 2), "double_integrator": (4, 2), "quadrotor2d": (6, 2),
               "cartpole": (4, 1)}
MAX_M = 2


class LaneConsts(ctypes.Structure):
    """Mirror of ``lane::Consts`` in csrc/lane_common.cuh. The bound arrays hold up to
    MAX_M controls, of which the first m are set; the family's step constants follow
    the obstacles and the alphas."""

    _fields_ = [
        ("dt", ctypes.c_double),
        ("u_min", ctypes.c_double * MAX_M),
        ("u_max", ctypes.c_double * MAX_M),
        ("act_lo", ctypes.c_double * MAX_M),
        ("act_hi", ctypes.c_double * MAX_M),
        ("eps", ctypes.c_double),
        ("neg_beta", ctypes.c_double),
        ("inv_beta", ctypes.c_double),
        ("cx", ctypes.c_double * MAX_OBS),
        ("cy", ctypes.c_double * MAX_OBS),
        ("r2", ctypes.c_double * MAX_OBS),
        ("alphas", ctypes.c_double * MAX_ALPHAS),
        ("reg", ctypes.c_double),
        ("n_obs", ctypes.c_int32),
        ("n_alphas", ctypes.c_int32),
        ("mass", ctypes.c_double),
        ("inertia", ctypes.c_double),
        ("arm", ctypes.c_double),
        ("gravity", ctypes.c_double),
        ("m_pole", ctypes.c_double),
        ("length", ctypes.c_double),
        ("total_m", ctypes.c_double),
        ("mpl", ctypes.c_double),
        ("x_lim2", ctypes.c_double),
        ("system", ctypes.c_int32),
        ("aggregation", ctypes.c_int32),
        ("barrier", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


def kernel_consts(pb: LaneProblem, *, reg: float = 0.0, alphas: Sequence[float] = (),
                  active_tol: float = 0.0) -> LaneConsts:
    """Constants for the CUDA kernels, with the ids of the library variant that takes
    them (its system, obstacle aggregation and barrier); raises for a problem they do
    not take."""
    spec = pb.spec
    if spec is None or FAMILY_DIMS.get(spec.family) != (pb.n, pb.m):
        raise ValueError("the lane kernels take the component systems of ops/lanes.py only "
                         f"({', '.join(FAMILIES)})")
    if pb.barrier_type not in _build.BARRIERS:
        raise ValueError(f"the lane kernels take the barriers {_build.BARRIERS}, not "
                         f"{pb.barrier_type!r}")
    n_obs = len(spec.centers)
    if spec.family == "cartpole":
        if n_obs:
            raise ValueError("the cart-pole's h is its track limit; it takes no obstacles")
    elif not 1 <= n_obs <= MAX_OBS:
        raise ValueError(f"the lane kernels take 1 to {MAX_OBS} obstacles, got {n_obs}")
    if len(alphas) > MAX_ALPHAS:
        raise ValueError(f"the lane kernels take at most {MAX_ALPHAS} alphas, got {len(alphas)}")
    if spec.family == "double_integrator" and not (
            math.isfinite(spec.dt) and (spec.dt != 0.0 or math.copysign(1.0, spec.dt) > 0.0)):
        # its kernels take rows 0..n-1 of f̂'s Jacobians as the literals 0, 1 and dt
        # (csrc/lane_common.cuh, LINEAR), which is what its tangent gives for these dt only
        raise ValueError(f"the double integrator's kernels take a finite dt other than -0, "
                         f"got {spec.dt!r}")
    if spec.family == "cartpole":
        # its K3/K5 take rows of f̂'s Jacobians as literals (csrc/lane_sbwd.cu, CARTPOLE_LIT,
        # CARTPOLE_COLS), which is what its tangent gives for finite constants and dt other
        # than -0 only
        consts = {"dt": spec.dt, "m_cart + m_pole": spec.m_cart + spec.m_pole,
                  "m_pole * length": spec.m_pole * spec.length, "gravity": spec.gravity,
                  "m_pole": spec.m_pole, "length": spec.length}
        bad = {k: v for k, v in consts.items() if not math.isfinite(v)}
        if spec.dt == 0.0 and math.copysign(1.0, spec.dt) < 0.0:
            bad["dt"] = spec.dt
        if bad:
            raise ValueError(f"the cart-pole's kernels take finite constants and a dt other "
                             f"than -0, got {bad}")
    k = LaneConsts()
    k.dt = spec.dt
    for a in range(pb.m):
        k.u_min[a] = pb.u_min[a]
        k.u_max[a] = pb.u_max[a]
        k.act_lo[a] = pb.u_min[a] + active_tol
        k.act_hi[a] = pb.u_max[a] - active_tol
    k.eps = pb.eps
    k.neg_beta = -spec.beta
    k.inv_beta = 1.0 / spec.beta
    for i, ((cx, cy), r) in enumerate(zip(spec.centers, spec.radii)):
        k.cx[i], k.cy[i], k.r2[i] = cx, cy, r * r
    for i, al in enumerate(alphas):
        k.alphas[i] = al
    k.reg = reg
    k.n_obs = n_obs
    k.n_alphas = len(alphas)
    # the products and sums of constants as the JAX forms take them: Python floats,
    # formed in double and rounded once to the working type in the kernel
    k.mass, k.inertia, k.arm, k.gravity = spec.mass, spec.inertia, spec.arm, spec.gravity
    k.m_pole, k.length = spec.m_pole, spec.length
    k.total_m = spec.m_cart + spec.m_pole
    k.mpl = spec.m_pole * spec.length
    k.x_lim2 = spec.x_lim * spec.x_lim
    k.system = FAMILIES.index(spec.family)
    # the cart-pole's h is its track limit: its libraries take the default aggregation
    k.aggregation = (0 if spec.family == "cartpole"
                     else _build.AGGREGATIONS.index(spec.aggregation))
    k.barrier = _build.BARRIERS.index(pb.barrier_type)
    return k


def variant_of(consts: LaneConsts) -> str:
    """The library variant that takes ``consts`` (_build.VARIANTS)."""
    return _build.variant_name(FAMILIES[consts.system], _build.AGGREGATIONS[consts.aggregation],
                               _build.BARRIERS[consts.barrier])


def on_cpu(*tensors: Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs lie on {dev}; the lane kernels take cuda or cpu tensors")
    return False


def check_kernel_inputs(name: str, shapes: Dict[str, Tuple[Tuple[int, ...], Tensor]]) -> torch.dtype:
    """Raise unless every input has the expected shape, one float dtype, and is contiguous."""
    dtypes = {t.dtype for _, t in shapes.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: inputs need one dtype, float32 or float64; got {dtypes}")
    for arg, (shape, t) in shapes.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return dtypes.pop()


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def launch(lib: str, fn: str, dtype: torch.dtype, device: torch.device,
           tensors: Sequence[Tensor], N: int, B: int, consts: LaneConsts) -> None:
    """Call ``<fn>_f32|_f64`` of ``csrc/<lib>.cu``, built for the variant of ``consts``,
    on the current stream of ``device``; raise if the launch reports a CUDA error."""
    if B < 1 or N < 1:
        raise ValueError(f"{fn}: needs N >= 1 and B >= 1, got N={N}, B={B}")
    library = _build.library_name(lib, variant_of(consts))
    f = getattr(_build.load(library), f"{fn}_{'f32' if dtype == torch.float32 else 'f64'}")
    f.argtypes = [_PTR] * len(tensors) + [_INT, _INT, _PTR, _PTR]
    f.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = f(*[t.data_ptr() for t in tensors], N, B, ctypes.addressof(consts), stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {err}")


def counted(wrapper, consts: LaneConsts, B: int) -> None:
    """Count one launch of ``wrapper``'s kernel over B lanes: in all (``launches``), for
    the library variant it was built for (``by_system``, keyed "quadrotor2d_min_log" and
    the like) and for its lane count (``by_width``)."""
    wrapper.launches += 1
    variant = variant_of(consts)
    wrapper.by_system[variant] = wrapper.by_system.get(variant, 0) + 1
    wrapper.by_width[B] = wrapper.by_width.get(B, 0) + 1


def spanned(wrapper):
    """The kernel wrapper ``wrapper`` run under the span ``kernel.<its name>``: its plain
    version, or its constants, input checks, output allocations, library lookup and
    launch."""
    name = f"kernel.{wrapper.__name__}"

    @functools.wraps(wrapper)
    def run(*args, **kwargs):
        with annotate(name):
            return wrapper(*args, **kwargs)

    return run


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

@spanned
def ric(pb: LaneProblem, reg: float, X: Tensor, U: Tensor, Xr: Tensor, Ur: Tensor,
        C: Tensor, phix: Tensor) -> Tuple[Tensor, Tensor]:
    """K1: see ric_plain. CPU tensors run the plain version; CUDA tensors the kernel."""
    if on_cpu(X, U, Xr, Ur, C, phix):
        return ric_plain(pb, reg, X, U, Xr, Ur, C, phix)
    nh, m = pb.n_hat, pb.m
    N, B = X.shape[0], X.shape[-1]
    dtype = check_kernel_inputs("ric", {
        "X": ((N, nh, B), X), "U": ((N, m, B), U), "Xr": ((N, nh, B), Xr),
        "Ur": ((N, m, B), Ur), "C": ((2 * nh + m + 3, B), C), "phix": ((nh, B), phix),
    })
    consts = kernel_consts(pb, reg=reg)
    K = torch.empty((N, m * nh, B), dtype=dtype, device=X.device)
    kff = torch.empty((N, m, B), dtype=dtype, device=X.device)
    launch("lane_solver", "lane_ric", dtype, X.device, (X, U, Xr, Ur, C, phix, K, kff), N, B, consts)
    counted(ric, consts, B)
    return K, kff


ric.launches, ric.by_system, ric.by_width = 0, {}, {}


@spanned
def fwd(pb: LaneProblem, alphas: Sequence[float], x0: Tensor, Xo: Tensor, Uo: Tensor,
        K: Tensor, kff: Tensor, Xr: Tensor, XrN: Tensor, Ur: Tensor,
        C: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """K2: see fwd_plain. CPU tensors run the plain version; CUDA tensors the kernel."""
    if on_cpu(x0, Xo, Uo, K, kff, Xr, XrN, Ur, C):
        return fwd_plain(pb, alphas, x0, Xo, Uo, K, kff, Xr, XrN, Ur, C)
    nh, m = pb.n_hat, pb.m
    N, B = Xo.shape[0], Xo.shape[-1]
    na = len(alphas)
    if na < 1:
        raise ValueError("fwd: needs at least one alpha")
    dtype = check_kernel_inputs("fwd", {
        "x0": ((nh, B), x0), "Xo": ((N, nh, B), Xo), "Uo": ((N, m, B), Uo),
        "K": ((N, m * nh, B), K), "kff": ((N, m, B), kff), "Xr": ((N, nh, B), Xr),
        "XrN": ((nh, B), XrN), "Ur": ((N, m, B), Ur), "C": ((2 * nh + m + 3, B), C),
    })
    consts = kernel_consts(pb, alphas=alphas)
    Xn = torch.empty((N, na * nh, B), dtype=dtype, device=Xo.device)
    Un = torch.empty((N, na * m, B), dtype=dtype, device=Xo.device)
    cost = torch.empty((na, B), dtype=dtype, device=Xo.device)
    launch("lane_solver", "lane_fwd", dtype, Xo.device,
           (x0, Xo, Uo, K, kff, Xr, XrN, Ur, C, Xn, Un, cost), N, B, consts)
    counted(fwd, consts, B)
    return Xn, Un, cost


fwd.launches, fwd.by_system, fwd.by_width = 0, {}, {}


# ---------------------------------------------------------------------------
# Solver loop.
# ---------------------------------------------------------------------------

def rollout(pb: LaneProblem, x_hat0: Tensor, U0: Tensor, X_ref: Tensor, U_ref: Tensor,
            C: Tensor) -> Tensor:
    """X [N+1, n̂, B] of f̂ from x_hat0 under U0 (already clamped).

    This is K2 with zero gains and the single alpha 1: u = clip(U0 + 1 (0 + 0 (x - 0)))
    = U0 wherever x is finite, so X equals the plain rollout; a lane whose state
    is not finite stays not finite either way."""
    zeros_x = torch.zeros_like(X_ref[:-1])
    K0 = U0.new_zeros((U0.shape[0], pb.m * pb.n_hat, U0.shape[-1]))
    Xn, _, _ = fwd(pb, (1.0,), x_hat0, zeros_x, U0, K0, torch.zeros_like(U0),
                   X_ref[:-1], X_ref[-1], U_ref, C)
    return torch.cat([x_hat0[None], Xn], dim=0)


class _Carry(NamedTuple):
    """The improvement loop's state over its lanes."""

    it: int                    # iterations run (all lanes advance together)
    X: Tensor                  # [N+1, n̂, B]
    U: Tensor                  # [N, m, B]
    prev_cost: Tensor          # [B]
    done: Tensor               # [B] int64: 1 where frozen (its sum needs no cast on the card)
    lane_it: Optional[Tensor]  # [B] int32 iterations entered unconverged, or None


def _improve(pb: LaneProblem, x_hat0: Tensor, X_ref: Tensor, U_ref: Tensor, C: Tensor,
             s: _Carry, cap: int, tol: float, reg: float,
             alphas: Tuple[float, ...]) -> _Carry:
    """Iterate until ``cap`` iterations in all or every lane frozen, at the lane count of
    the given inputs. Per lane: the best candidate of the alpha ladder (NaN costs never
    win, the first minimum wins ties), and |prev_cost - best_cost| < tol freezes the
    lane. The host reads the count of frozen lanes once per iteration (one reduction and
    one read, as the reference's while_loop condition all(done) is), and the loop ends when
    it is B."""
    nh, m = pb.n_hat, pb.m
    N, B = s.U.shape[0], s.U.shape[-1]
    na = len(alphas)
    term_rows = C[nh + m: 2 * nh + m]
    counts = lane_ilqr_solve.counts
    it, X, U, prev_cost, done, lane_it = s
    while it < cap:
        with annotate("lane.host_read"):
            unconverged = B - int(done.sum())
        counts["host_reads"] += 1
        if unconverged == 0:
            break
        counts["live_lane_iters"] += unconverged
        with annotate("kernel.ric"):   # K1's terminal input, then K1 under one span
            phix = term_rows * (X[-1] - X_ref[-1])
            K, kff = ric.__wrapped__(pb, reg, X[:-1], U, X_ref[:-1], U_ref, C, phix)
        Xn, Un, costs = fwd(pb, alphas, x_hat0, X[:-1], U, K, kff, X_ref[:-1], X_ref[-1], U_ref, C)

        with annotate("lane.epilogue"):
            costs = torch.where(torch.isnan(costs.float()), torch.full_like(costs, float("inf")),
                                costs)
            best_cost, best = torch.min(costs, dim=0)   # first minimum on ties
            # Gather the winner by index, never by a one-hot product: a losing
            # candidate with NaN states would poison the winner through NaN * 0.
            sel_x = best.view(1, 1, 1, B).expand(N, 1, nh, B)
            sel_u = best.view(1, 1, 1, B).expand(N, 1, m, B)
            X_tail = torch.gather(Xn.view(N, na, nh, B), 1, sel_x)[:, 0]
            U_new = torch.gather(Un.view(N, na, m, B), 1, sel_u)[:, 0]
            X_new = torch.cat([x_hat0[None], X_tail], dim=0)

            live = done == 0
            X = torch.where(live, X_new, X)
            U = torch.where(live, U_new, U)
            done = done | ((prev_cost - best_cost).abs() < tol)
            prev_cost = torch.where(live, best_cost, prev_cost)
            if lane_it is not None:
                lane_it = lane_it + live.to(torch.int32)
        it += 1
    return _Carry(it, X, U, prev_cost, done, lane_it)


# The JAX solver's lane block (block_b): the compaction stages halve the width it pads the
# batch to, so that the port takes the JAX package's stages at the same B.
JAX_BLOCK_B = 4096


def stage_widths(B: int, n_stages: int) -> Tuple[int, ...]:
    """The working width of each compaction stage after the first cap, by the JAX rule
    (lane_solver.py:309-311, 465-466): B padded to whole blocks, halved at each stage,
    at least 128 lanes, rounded up to whole blocks of its own; a width of at least the
    padded B keeps the stage at full width."""
    Bt = min(JAX_BLOCK_B, max(128, -(-B // 128) * 128))
    B_pad = -(-B // Bt) * Bt
    widths = []
    for si in range(n_stages):
        W = max(128, B_pad >> (si + 1))
        Wt = min(Bt, W)
        W = -(-W // Wt) * Wt
        widths.append(B if W >= B_pad else W)
    return tuple(widths)


def lane_ilqr_solve(
    pb: LaneProblem,
    *,
    x_hat0: Tensor,   # [n̂, B]
    U0: Tensor,       # [N, m, B] (already clamped)
    X0: Tensor,       # [N+1, n̂, B] (rollout of U0)
    X_ref: Tensor,    # [N+1, n̂, B] (barrier row 0)
    U_ref: Tensor,    # [N, m, B]
    C: Tensor,        # [nc, B]
    max_iter: int,
    tol: float,
    reg: float,
    alphas: Tuple[float, ...],
    with_lane_iters: bool = False,
    compact_caps: Tuple[int, ...] = (),
) -> Tuple:
    """Fused-kernel iLQR; returns (X [N+1, n̂, B], U [N, m, B]), then each lane's count of
    the iterations it entered unconverged ([B] int32) with ``with_lane_iters`` (their
    maximum is the iterations the batch ran). The loop ends at max_iter or when every lane
    is frozen (see _improve).

    compact_caps = (c1, c2, ...): straggler compaction. The loop runs at full width up to
    c1 iterations; at each later cap (and max_iter) the next stage runs on stage_widths'
    narrower width W when the unconverged lanes fit in it: they are gathered first (a
    stable sort of done), converged lanes fill the rest, the stage iterates on the W
    lanes, and its results are scattered back. Otherwise the stage runs at full width.
    The kernels compute each lane alone and the fillers are frozen, so the result is
    bitwise that of compact_caps=() in every case. ``lane_ilqr_solve.stages`` counts the
    stages after c1 that ran: "compacted" and "full" (width).

    ``lane_ilqr_solve.counts``: "host_reads", each read of the device by the host (one an
    iteration's loop test, one a stage's count of unconverged lanes), and
    "live_lane_iters", the lanes that entered each iteration unconverged, summed over the
    iterations (the sum of ``with_lane_iters``' counts)."""
    B = U0.shape[-1]
    s = _Carry(0, X0, U0, torch.full((B,), float("inf"), dtype=U0.dtype, device=U0.device),
               torch.zeros((B,), dtype=torch.int64, device=U0.device),
               torch.zeros((B,), dtype=torch.int32, device=U0.device) if with_lane_iters
               else None)
    consts = (x_hat0, X_ref, U_ref, C)
    loop = dict(tol=tol, reg=reg, alphas=alphas)
    caps = tuple(int(c) for c in compact_caps if int(c) < max_iter)
    s = _improve(pb, *consts, s, caps[0] if caps else max_iter, **loop)
    later = caps[1:] + ((max_iter,) if caps else ())
    for cap, W in zip(later, stage_widths(B, len(later))):
        with annotate("lane.host_read"):
            unconverged = B - int(s.done.sum())
        lane_ilqr_solve.counts["host_reads"] += 1
        if unconverged == 0 or s.it >= cap:
            continue
        if W >= B or unconverged > W:
            s = _improve(pb, *consts, s, cap, **loop)
            lane_ilqr_solve.stages["full"] += 1
            continue
        # unconverged lanes first, then converged fillers; the first W entries of a
        # permutation hold no index twice, so the scatter back writes each lane once
        with annotate("lane.compact"):
            idx = torch.argsort(s.done.to(torch.uint8), stable=True)[:W]
            take = lambda t: None if t is None else t.index_select(-1, idx)
            sub_consts, sub_carry = tuple(map(take, consts)), _Carry(s.it, *map(take, s[1:]))
        sub = _improve(pb, *sub_consts, sub_carry, cap, **loop)
        with annotate("lane.scatter"):
            s = _Carry(sub.it, *(None if t is None else t.index_copy(-1, idx, u)
                                 for t, u in zip(s[1:], sub[1:])))
        lane_ilqr_solve.stages["compacted"] += 1
    return (s.X, s.U, s.lane_it) if with_lane_iters else (s.X, s.U)


lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
lane_ilqr_solve.counts = {"host_reads": 0, "live_lane_iters": 0}
