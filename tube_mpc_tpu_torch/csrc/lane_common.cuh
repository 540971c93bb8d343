// Shared device code of the lane kernels: the component systems (their step, its
// tangent map, and their safety value h: the smooth-min or the exact min over circle
// obstacles, or the cart-pole's track limit), the relaxed inverse and the log barrier,
// the DBaS-augmented step f̂,
// its hand-written tangent map (the counterpart of jax.jvp in
// tube_mpc_tpu/ops/lanes.py::jac_rows) and its derivatives in the barrier parameters
// (the three jax.jvp calls of the generic _sfwd_kernel); the chunked sweep that K1 and
// K3-K6 share (sweep), the split sweep that K3/K5 take above n̂ = 5 (sweep_split), and
// with_system, which launches a kernel for the problem's obstacle count.
//
// A system whose step is linear (LINEAR: the double integrator) has f̂'s Jacobian rows
// 0..NX-1 as constants, which its K1 and K3/K5 take as literals (JAC_ROWS,
// load_jac_linear), and its K1 and K3/K5 form the balanced-equality factors by select
// (SELECT, fhat_lin_select). Neither changes any other system's code.
//
// Every kernel is a template on its system, System<T, SYS, NOBS> (SYS one of the ids
// below, NOBS the obstacle count); a library is built for one system, LANE_SYSTEM, one
// obstacle aggregation, LANE_AGG, and one barrier, LANE_BARRIER (ops/cuda/_build.py),
// so the arrays' sizes (n̂, m, the const rows), the policies of h and B and the rows of
// the sweeps' shared memory follow from the library at compile time.
//
// Layout: every array is [.., component, B] with the lane index fastest, so
// neighbouring threads of a warp, which own neighbouring lanes, read neighbouring
// addresses.
//
// Arithmetic order follows the JAX kernels and their JVP rules term by term, and
// the sources are built with -fmad=false, so a kernel and its plain PyTorch
// version (tube_mpc_tpu_torch/ops/cuda/*.py) round identically on the card.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The system a library is built for: an id of ops/lanes.py::FAMILIES; its obstacle
// aggregation and its barrier: ids of ops/cuda/_build.py::AGGREGATIONS, BARRIERS.
#ifndef LANE_SYSTEM
#define LANE_SYSTEM 0
#endif
#ifndef LANE_AGG
#define LANE_AGG 0
#endif
#ifndef LANE_BARRIER
#define LANE_BARRIER 0
#endif

namespace lane {

constexpr int DUBINS = 0, DOUBLE_INTEGRATOR = 1, QUADROTOR2D = 2, CARTPOLE = 3;
constexpr int SMOOTHMIN = 0, MIN = 1;   // LANE_AGG
constexpr int INVERSE = 0, LOG = 1;     // LANE_BARRIER
constexpr int MAX_M = 2;
constexpr int MAX_OBS = 8;
constexpr int MAX_ALPHAS = 8;

// Runtime constants, passed by value to every kernel. Mirrors
// ops/cuda/lane_solver.py::LaneConsts field by field. Sums and products such as
// u_min + active_tol or m_pole * length are formed in double on the host and rounded
// once to the working type, as the reference does with Python floats.
struct Consts {
  double dt;
  double u_min[MAX_M];
  double u_max[MAX_M];
  double act_lo[MAX_M];   // u_min + active_tol
  double act_hi[MAX_M];   // u_max - active_tol
  double eps;         // barrier floor
  double neg_beta;    // -beta
  double inv_beta;    // 1 / beta
  double cx[MAX_OBS];
  double cy[MAX_OBS];
  double r2[MAX_OBS]; // radius * radius
  double alphas[MAX_ALPHAS];
  double reg;
  int32_t n_obs;
  int32_t n_alphas;
  double mass;        // quadrotor
  double inertia;
  double arm;
  double gravity;     // quadrotor, cart-pole
  double m_pole;      // cart-pole
  double length;
  double total_m;     // m_cart + m_pole
  double mpl;         // m_pole * length
  double x_lim2;      // x_lim * x_lim
  int32_t system;     // the ids of the system, the aggregation and the barrier the
  int32_t aggregation;  // constants are for
  int32_t barrier;
  int32_t pad;
};

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
template <typename T> __device__ __forceinline__ T epsilon();
template <> __device__ __forceinline__ float epsilon<float>() { return FLT_EPSILON; }
template <> __device__ __forceinline__ double epsilon<double>() { return DBL_EPSILON; }

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN (fmax would drop it).
template <typename T> __device__ __forceinline__ T jmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> __device__ __forceinline__ T jmin(T a, T b) { return (a < b || a != a) ? a : b; }

// The larger of a and b, NaN if either is: PTX's max.NaN, one instruction for f32 where
// jmax takes a compare and a select. Its NaN is canonical where jmax returns the NaN
// operand, so it serves where the result only meets a comparison, which both fail alike
// (the rescale's maximum over the carry, rescale_carry).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double nan_max(double a, double b) { return jmax(a, b); }

// The reference scrubs a carry entry unless it is finite after a cast to f32,
// in f64 too: a double above FLT_MAX is scrubbed to 0.
template <typename T> __device__ __forceinline__ T scrub(T v) {
  return isfinite(static_cast<float>(v)) ? v : T(0);
}

// ---------------------------------------------------------------------------
// Obstacle values in component form on the state's two leading rows (Dubins, the
// double integrator, the quadrotor): h_i = |p - c_i|^2 - r_i^2, the chain
// z = min(...min(h_0, h_1)..., h_{NOBS-1}) of jnp.minimum, and on top of it
//   the smooth-min (ops/lanes.py::smoothmin_h_lin), h = z - (1/beta) log sum_i
//     exp(-beta (h_i - z)), or
//   the exact min (ops/lanes.py::min_h_lin), h = z.
//
// NOBS is the obstacle count (p.n_obs), fixed at compile time so that every
// obstacle loop unrolls into straight-line code the compiler can schedule; every
// kernel is instantiated for 1 to MAX_OBS and launched through with_system.
// Runtime-guarded loops over MAX_OBS slots cut a linearisation into blocks the
// compiler could not schedule across, several times slower on an H100 (PERF.md).
//
// min_chain also computes what the tangent needs that depends on the point alone: the
// weights of the chain, so that a tangent from stored fields (lane_sfwd.cu) does no
// more than the carry needs.
// ---------------------------------------------------------------------------

// Each h_i at (px, py) into hs, and z with lax.min's balanced-equality factors along
// the chain into wz, wv (at obstacles 1..NOBS-1): 1 to the winner, 1/2 to each side of
// a tie, 0 to the loser.
template <typename T, int NOBS>
__device__ __forceinline__ T min_chain(const Consts& p, T px, T py, T hs[NOBS], T wz[NOBS],
                                       T wv[NOBS]) {
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T dx = px - T(p.cx[i]);
    const T dy = py - T(p.cy[i]);
    hs[i] = (dx * dx + dy * dy) - T(p.r2[i]);
  }
  T z = hs[0];
#pragma unroll
  for (int i = 1; i < NOBS; ++i) {
    const T v = hs[i];
    const T zn = jmin(z, v);
    wz[i] = (z == zn ? T(1) : T(0)) / (v == zn ? T(2) : T(1));
    wv[i] = (v == zn ? T(1) : T(0)) / (z == zn ? T(2) : T(1));
    z = zn;
  }
  return z;
}

// The tangents dh_i along (dpx, dpy) by JAX's rules, d(a**2) = da * (2a), into dh, and
// dz, the chain's tangent weighed by wz, wv.
template <typename T, int NOBS>
__device__ __forceinline__ T min_chain_tan(const Consts& p, T px, T py, const T wz[NOBS],
                                           const T wv[NOBS], T dpx, T dpy, T dh[NOBS]) {
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T ax = T(2) * (px - T(p.cx[i]));
    const T ay = T(2) * (py - T(p.cy[i]));
    dh[i] = dpx * ax + dpy * ay;
  }
  T dz = dh[0];
#pragma unroll
  for (int i = 1; i < NOBS; ++i) dz = dz * wz[i] + dh[i] * wv[i];
  return dz;
}

// min_chain's factors wz, wv by select from the chain over hs: (won ? 1 : 0) / (tie ? 2 :
// 1) picked from its exact values 0, 1 and 1/2, so the same bits without the division
// (fhat_lin_select).
template <typename T, int NOBS>
__device__ __forceinline__ void select_chain(const T hs[NOBS], T wz[NOBS], T wv[NOBS]) {
  T z = hs[0];
#pragma unroll
  for (int i = 1; i < NOBS; ++i) {
    const T v = hs[i];
    const T zn = jmin(z, v);
    wz[i] = z == zn ? (v == zn ? T(0.5) : T(1)) : T(0);
    wv[i] = v == zn ? (z == zn ? T(0.5) : T(1)) : T(0);
    z = zn;
  }
}

// A barrier's balanced-equality factor of max(zeta, eps) by select, as select_chain's.
template <typename T>
__device__ __forceinline__ T select_beq(const Consts& p, T zeta, T m) {
  return zeta == m ? (T(p.eps) == m ? T(0.5) : T(1)) : T(0);
}

// The smooth-min.
template <typename T, int NOBS> struct HLin {
  T px, py;
  T hs[NOBS];
  T e[NOBS];
  T acc;
  T value;
  T wz[NOBS], wv[NOBS];   // the min chain's tangent weights at obstacles 1..NOBS-1
};

template <typename T, int NOBS>
__device__ __forceinline__ void h_lin(const Consts& p, T px, T py, HLin<T, NOBS>& L) {
  L.px = px;
  L.py = py;
  const T z = min_chain<T, NOBS>(p, px, py, L.hs, L.wz, L.wv);
  const T nb = T(p.neg_beta);
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    L.e[i] = m_exp(nb * (L.hs[i] - z));
    L.acc = (i == 0) ? L.e[0] : L.acc + L.e[i];
  }
  L.value = z - T(p.inv_beta) * m_log(L.acc);
}

// Tangent of the smooth-min along (dpx, dpy), by JAX's rules: the min chain's
// (min_chain_tan); d exp = g * ans; d log = g / x.
template <typename T, int NOBS>
__device__ __forceinline__ T h_tan(const Consts& p, const HLin<T, NOBS>& L, T dpx, T dpy) {
  T dh[NOBS];
  const T dz = min_chain_tan<T, NOBS>(p, L.px, L.py, L.wz, L.wv, dpx, dpy, dh);
  const T nb = T(p.neg_beta);
  T dacc = T(0);
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T de = (nb * (dh[i] - dz)) * L.e[i];
    dacc = (i == 0) ? de : dacc + de;
  }
  return dz - T(p.inv_beta) * (dacc / L.acc);
}

// The h policies: Lin holds h's value and what its tangent needs; rows(L, f) calls f
// on each field of Lin that the tangent reads, in a fixed order (K4/K6 store and load
// them, lane_sfwd.cu), ROWS of them; select(p, x, L) forms lin's factors again by select
// (fhat_lin_select). CircleH is the smooth-min, MinCircleH the exact min, TrackH the
// cart-pole's track limit.
template <typename T, int NOBS> struct CircleH {
  using Lin = HLin<T, NOBS>;
  static constexpr int ROWS = 3 + NOBS + 2 * (NOBS - 1);
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, Lin& L) {
    h_lin(p, x[0], x[1], L);
  }
  static __device__ __forceinline__ T tan(const Consts& p, const Lin& L, const T* dx) {
    return h_tan(p, L, dx[0], dx[1]);
  }
  static __device__ __forceinline__ void select(const Consts&, const T*, Lin& L) {
    select_chain<T, NOBS>(L.hs, L.wz, L.wv);
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.px);
    f(L.py);
    f(L.acc);
#pragma unroll
    for (int i = 0; i < NOBS; ++i) f(L.e[i]);
#pragma unroll
    for (int i = 1; i < NOBS; ++i) {
      f(L.wz[i]);
      f(L.wv[i]);
    }
  }
};

// The exact min h = z (ops/lanes.py::min_h_lin) and its tangent dz.
template <typename T, int NOBS> struct MinCircleH {
  struct Lin {
    T px, py, value;
    T wz[NOBS], wv[NOBS];   // the min chain's tangent weights at obstacles 1..NOBS-1
  };
  static constexpr int ROWS = 2 + 2 * (NOBS - 1);
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, Lin& L) {
    T hs[NOBS];
    L.px = x[0];
    L.py = x[1];
    L.value = min_chain<T, NOBS>(p, x[0], x[1], hs, L.wz, L.wv);
  }
  static __device__ __forceinline__ T tan(const Consts& p, const Lin& L, const T* dx) {
    T dh[NOBS];
    return min_chain_tan<T, NOBS>(p, L.px, L.py, L.wz, L.wv, dx[0], dx[1], dh);
  }
  static __device__ __forceinline__ void select(const Consts& p, const T* x, Lin& L) {
    T hs[NOBS];
#pragma unroll
    for (int i = 0; i < NOBS; ++i) {   // min_chain's h_i, the same operations
      const T dx = x[0] - T(p.cx[i]);
      const T dy = x[1] - T(p.cy[i]);
      hs[i] = (dx * dx + dy * dy) - T(p.r2[i]);
    }
    select_chain<T, NOBS>(hs, L.wz, L.wv);
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.px);
    f(L.py);
#pragma unroll
    for (int i = 1; i < NOBS; ++i) {
      f(L.wz[i]);
      f(L.wv[i]);
    }
  }
};

// The cart-pole's track limit h = x_lim^2 - pos^2 (ops/lanes.py::cartpole_components),
// with the tangent of JAX's rules for sub and mul: -(dpos pos + pos dpos).
template <typename T> struct TrackH {
  struct Lin {
    T pos, value;
  };
  static constexpr int ROWS = 1;
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, Lin& L) {
    L.pos = x[0];
    L.value = T(p.x_lim2) - x[0] * x[0];
  }
  static __device__ __forceinline__ T tan(const Consts&, const Lin& L, const T* dx) {
    return -(dx[0] * L.pos + L.pos * dx[0]);
  }
  static __device__ __forceinline__ void select(const Consts&, const T*, Lin&) {}
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) { f(L.pos); }
};

// ---------------------------------------------------------------------------
// Relaxed inverse barrier (ops/barrier.py::relaxed_inverse_barrier) and its
// tangent by JAX's rules for max, div and integer_pow. barrier_lin also forms the
// tangent's factors that depend on the point alone (inv_mm, aa, a3, d2).
// ---------------------------------------------------------------------------
template <typename T> struct BLin {
  T value, m, a, diff, beq;
  T inv_mm, aa, a3, d2;   // 1 / m^2 (safe); a^2, a^3, 2 diff (unsafe)
  bool safe;
};

template <typename T>
__device__ __forceinline__ void barrier_lin(const Consts& p, T zeta, T alpha, BLin<T>& L) {
  const T eps = T(p.eps);
  L.a = jmax(alpha, eps);
  L.safe = zeta >= L.a;
  L.m = jmax(zeta, eps);
  const T b_safe = T(1) / L.m;
  L.diff = zeta - L.a;
  L.aa = L.a * L.a;
  L.a3 = L.aa * L.a;
  const T b_unsafe = (T(1) / L.a - L.diff / L.aa) + (L.diff * L.diff) / L.a3;
  L.value = L.safe ? b_safe : b_unsafe;
  L.beq = (zeta == L.m ? T(1) : T(0)) / (eps == L.m ? T(2) : T(1));
  L.inv_mm = T(1) / (L.m * L.m);
  L.d2 = T(2) * L.diff;
}

template <typename T>
__device__ __forceinline__ T barrier_tan(const BLin<T>& L, T dzeta) {
  if (L.safe) {
    const T dm = dzeta * L.beq;
    return (-dm) * L.inv_mm;
  }
  return -(dzeta / L.aa) + (dzeta * L.d2) / L.a3;
}

// dB/dalpha (tangent 1 in alpha), as jax.jvp computes it (ops/barrier.py::
// barrier_dalpha): da is the balanced-equality weight of max(alpha, eps); the
// quotient rule for 1/a, diff/a^2 and diff^2/a^3 with d(a^2) = da (2a),
// d(a^3) = da (3 a^2), d(diff) = -da; zero on the safe branch, where
// B = 1/max(zeta, eps) does not depend on alpha.
template <typename T>
__device__ __forceinline__ T barrier_dalpha(const Consts& p, const BLin<T>& L, T alpha) {
  if (L.safe) return T(0);
  const T eps = T(p.eps);
  const T da = (alpha == L.a ? T(1) : T(0)) / (eps == L.a ? T(2) : T(1));
  const T aa = L.a * L.a;
  const T a3 = L.a * aa;
  const T d_diff = -da;
  const T d_inv = (-da) * (T(1) / aa);
  const T d_lin = d_diff / aa + ((-(da * (T(2) * L.a))) * L.diff) * (T(1) / (aa * aa));
  const T d_quad = (d_diff * (T(2) * L.diff)) / a3
                 + ((-(da * (T(3) * aa))) * (L.diff * L.diff)) * (T(1) / (a3 * a3));
  return (d_inv - d_lin) + d_quad;
}

// The barrier policies: lin(p, zeta, alpha, L) forms B(zeta) into L.value and what the
// tangent needs (select(p, zeta, L): its factor again by select, fhat_lin_select);
// tan(L, dzeta) is dB; dalpha(p, Ln, Lc, alpha, gamma) is the barrier row of d f̂/d alpha,
// dB(zeta_n)/d alpha - gamma dB(zeta_c)/d alpha; rows(L, f) as the h policies', ROWS of
// them (a bool field goes as 0 or 1).
template <typename T> struct InverseBarrier {
  using Lin = BLin<T>;
  static constexpr int ROWS = 6;
  static __device__ __forceinline__ void lin(const Consts& p, T zeta, T alpha, Lin& L) {
    barrier_lin(p, zeta, alpha, L);
  }
  static __device__ __forceinline__ T tan(const Lin& L, T dzeta) { return barrier_tan(L, dzeta); }
  static __device__ __forceinline__ void select(const Consts& p, T zeta, Lin& L) {
    L.beq = select_beq(p, zeta, L.m);
  }
  static __device__ __forceinline__ T dalpha(const Consts& p, const Lin& Ln, const Lin& Lc,
                                             T alpha, T gamma) {
    return barrier_dalpha(p, Ln, alpha) - gamma * barrier_dalpha(p, Lc, alpha);
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.safe);
    f(L.beq);
    f(L.inv_mm);
    f(L.aa);
    f(L.a3);
    f(L.d2);
  }
};

// The log barrier B(zeta) = -log(max(zeta, eps)) (ops/barrier.py::log_barrier) and its
// tangent by JAX's rules for max, log (g / x, a true division) and neg: zero below
// eps, where max's weight for zeta is 0, and half on the tie zeta == eps. B does not
// depend on alpha, so jax.jvp's tangent in alpha is a symbolic zero: the row of
// d f̂/d alpha is an exact 0, also where gamma is not finite.
template <typename T> struct LogBarrier {
  struct Lin {
    T value, m, beq;
  };
  static constexpr int ROWS = 2;
  static __device__ __forceinline__ void lin(const Consts& p, T zeta, T, Lin& L) {
    const T eps = T(p.eps);
    L.m = jmax(zeta, eps);
    L.value = -m_log(L.m);
    L.beq = (zeta == L.m ? T(1) : T(0)) / (eps == L.m ? T(2) : T(1));
  }
  static __device__ __forceinline__ T tan(const Lin& L, T dzeta) {
    return -((dzeta * L.beq) / L.m);
  }
  static __device__ __forceinline__ void select(const Consts& p, T zeta, Lin& L) {
    L.beq = select_beq(p, zeta, L.m);
  }
  static __device__ __forceinline__ T dalpha(const Consts&, const Lin&, const Lin&, T, T) {
    return T(0);
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.m);
    f(L.beq);
  }
};

// ---------------------------------------------------------------------------
// The component steps x+ = f(x, u) (ops/lanes.py): lin computes the step and Lin,
// what its tangent needs that depends on the point alone; tan is the tangent map by
// JAX's rules, term by term; rows(L, f) calls f on each field of Lin, ROWS of them.
// A division by a constant is a true division, as JAX's (and the plain versions').
// ---------------------------------------------------------------------------
template <typename T> struct DubinsStep {   // [px, py, theta], [v, omega]
  static constexpr int NX = 3, NU = 2, ROWS = 3;
  struct Lin {
    T c, s, dtv;
  };
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, const T* u, Lin& L,
                                             T* out) {
    const T dt = T(p.dt);
    L.c = m_cos(x[2]);
    L.s = m_sin(x[2]);
    L.dtv = dt * u[0];
    out[0] = x[0] + L.dtv * L.c;
    out[1] = x[1] + L.dtv * L.s;
    out[2] = x[2] + dt * u[1];
  }
  static __device__ __forceinline__ void tan(const Consts& p, const Lin& L, const T* dx,
                                             const T* du, T* out) {
    const T dt = T(p.dt);
    const T ddtv = dt * du[0];
    out[0] = dx[0] + (ddtv * L.c + L.dtv * (-(dx[2] * L.s)));
    out[1] = dx[1] + (ddtv * L.s + L.dtv * (dx[2] * L.c));
    out[2] = dx[2] + dt * du[1];
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.c);
    f(L.s);
    f(L.dtv);
  }
};

template <typename T> struct DoubleIntegratorStep {   // [px, py, vx, vy], [ax, ay]
  static constexpr int NX = 4, NU = 2, ROWS = 0;
  struct Lin {};
  // The tangent's value at a basis tangent, column c of x̂ (c < NX + 1) or of u (NX + 1 +
  // a), in row i: 1 on the diagonal, dt from v into p and from a into v, else 0. These are
  // the values tan gives there, bit for bit, for every finite dt but -0: dx_i + dt * 0 =
  // dx_i, 0 + dt * 1 = dt and 0 + dt * 0 = +0, whatever the state (linear_dt checks dt).
  __host__ __device__ static constexpr int tan_kind(int i, int c) {   // 0: 0, 1: 1, 2: dt
    return c == i ? 1 : (i < 2 && c == i + 2) || (i >= 2 && c == NX + 1 + (i - 2)) ? 2 : 0;
  }
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, const T* u, Lin&,
                                             T* out) {
    const T dt = T(p.dt);
    out[0] = x[0] + dt * x[2];
    out[1] = x[1] + dt * x[3];
    out[2] = x[2] + dt * u[0];
    out[3] = x[3] + dt * u[1];
  }
  static __device__ __forceinline__ void tan(const Consts& p, const Lin&, const T* dx,
                                             const T* du, T* out) {
    const T dt = T(p.dt);
    out[0] = dx[0] + dt * dx[2];
    out[1] = dx[1] + dt * dx[3];
    out[2] = dx[2] + dt * du[0];
    out[3] = dx[3] + dt * du[1];
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin&, F&&) {}
};

template <typename T> struct Quadrotor2DStep {   // [px, pz, th, vx, vz, om], [T1, T2]
  static constexpr int NX = 6, NU = 2, ROWS = 3;
  struct Lin {
    T s, c, thrust;
  };
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, const T* u, Lin& L,
                                             T* out) {
    const T dt = T(p.dt), mass = T(p.mass);
    L.thrust = u[0] + u[1];
    L.s = m_sin(x[2]);
    L.c = m_cos(x[2]);
    const T ax = ((-L.thrust) * L.s) / mass;
    const T az = (L.thrust * L.c) / mass - T(p.gravity);
    const T al = ((u[1] - u[0]) * T(p.arm)) / T(p.inertia);
    out[0] = x[0] + dt * x[3];
    out[1] = x[1] + dt * x[4];
    out[2] = x[2] + dt * x[5];
    out[3] = x[3] + dt * ax;
    out[4] = x[4] + dt * az;
    out[5] = x[5] + dt * al;
  }
  static __device__ __forceinline__ void tan(const Consts& p, const Lin& L, const T* dx,
                                             const T* du, T* out) {
    const T dt = T(p.dt), mass = T(p.mass);
    const T dthrust = du[0] + du[1];
    const T ds = dx[2] * L.c;
    const T dc = -(dx[2] * L.s);
    const T dax = ((-dthrust) * L.s + (-L.thrust) * ds) / mass;
    const T daz = (dthrust * L.c + L.thrust * dc) / mass;
    const T dal = ((du[1] - du[0]) * T(p.arm)) / T(p.inertia);
    out[0] = dx[0] + dt * dx[3];
    out[1] = dx[1] + dt * dx[4];
    out[2] = dx[2] + dt * dx[5];
    out[3] = dx[3] + dt * dax;
    out[4] = dx[4] + dt * daz;
    out[5] = dx[5] + dt * dal;
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.s);
    f(L.c);
    f(L.thrust);
  }
};

// The cart-pole (ops/lanes.py::cartpole_components), left to right as the JAX form:
// temp = (F + mpl om om s) / tm, th_acc = (g s - c temp) / (l (4/3 - mp c c / tm)),
// x_acc = temp - mpl th_acc c / tm, with tm = m_cart + m_pole and mpl = m_pole length
// formed on the host. The tangent's division th_acc = nt / den takes JAX's div rule,
// dnt / den + ((-dden) nt) (1 / (den den)).
template <typename T> struct CartPoleStep {   // [pos, vel, th, om], [force]
  static constexpr int NX = 4, NU = 1, ROWS = 11;
  struct Lin {
    T s, c, om, p1, p2, temp, q1, nt, den, inv_den2, r1;
  };
  static __device__ __forceinline__ void lin(const Consts& p, const T* x, const T* u, Lin& L,
                                             T* out) {
    const T dt = T(p.dt), tm = T(p.total_m), mpl = T(p.mpl);
    L.s = m_sin(x[2]);
    L.c = m_cos(x[2]);
    L.om = x[3];
    L.p1 = mpl * L.om;
    L.p2 = L.p1 * L.om;
    L.temp = (u[0] + L.p2 * L.s) / tm;
    L.nt = T(p.gravity) * L.s - L.c * L.temp;
    L.q1 = T(p.m_pole) * L.c;
    L.den = T(p.length) * (T(4.0 / 3.0) - (L.q1 * L.c) / tm);
    const T th_acc = L.nt / L.den;
    L.r1 = mpl * th_acc;
    const T x_acc = L.temp - (L.r1 * L.c) / tm;
    L.inv_den2 = T(1) / (L.den * L.den);
    out[0] = x[0] + dt * x[1];
    out[1] = x[1] + dt * x_acc;
    out[2] = x[2] + dt * x[3];
    out[3] = x[3] + dt * th_acc;
  }
  static __device__ __forceinline__ void tan(const Consts& p, const Lin& L, const T* dx,
                                             const T* du, T* out) {
    const T dt = T(p.dt), tm = T(p.total_m), mpl = T(p.mpl);
    const T ds = dx[2] * L.c;
    const T dc = -(dx[2] * L.s);
    const T dp2 = (mpl * dx[3]) * L.om + L.p1 * dx[3];
    const T dtemp = (du[0] + (dp2 * L.s + L.p2 * ds)) / tm;
    const T dnt = T(p.gravity) * ds - (dc * L.temp + L.c * dtemp);
    const T dq2 = (T(p.m_pole) * dc) * L.c + L.q1 * dc;
    const T dden = T(p.length) * (-(dq2 / tm));
    const T dth_acc = dnt / L.den + ((-dden) * L.nt) * L.inv_den2;
    const T dr2 = (mpl * dth_acc) * L.c + L.r1 * dc;
    const T dx_acc = dtemp - dr2 / tm;
    out[0] = dx[0] + dt * dx[1];
    out[1] = dx[1] + dt * dx_acc;
    out[2] = dx[2] + dt * dx[3];
    out[3] = dx[3] + dt * dth_acc;
  }
  template <typename F> static __device__ __forceinline__ void rows(Lin& L, F&& f) {
    f(L.s);
    f(L.c);
    f(L.om);
    f(L.p1);
    f(L.p2);
    f(L.temp);
    f(L.q1);
    f(L.nt);
    f(L.den);
    f(L.inv_den2);
    f(L.r1);
  }
};

// A system: its step, its h and its barrier, and the sizes that follow: the augmented
// state n̂ = n + 1, the controls m, and the const rows C (tube/lane_interface.py::_build_C):
// [0, n̂) stage diag | [n̂, n̂+m) 2R | [n̂+m, 2n̂+m) terminal diag | alpha, gamma, tight.
// LINEAR: the step's tangent does not depend on the point (the double integrator), so
// rows 0..NX-1 of f̂'s Jacobians are constants and only the barrier row NX depends on the
// step's inputs. SELECT: its K1 and K3/K5 form fhat_lin's balanced-equality factors by
// select (fhat_lin_select), since their phase A sets their pace (PERF.md §6).
template <typename Step> constexpr bool LinearStep = false;
template <typename T> constexpr bool LinearStep<DoubleIntegratorStep<T>> = true;
template <typename Step> constexpr bool SelectFactors = false;
template <typename T> constexpr bool SelectFactors<DoubleIntegratorStep<T>> = true;

template <typename Step, typename Hp, typename BarP> struct Sys : Step {
  using H = Hp;
  using Bar = BarP;
  static constexpr int NX = Step::NX;
  static constexpr int NH = Step::NX + 1;
  static constexpr int M = Step::NU;
  static constexpr int NC = 2 * NH + M + 3;
  static constexpr int ROW_ALPHA = 2 * NH + M;
  static constexpr bool LINEAR = LinearStep<Step>;
  static constexpr bool SELECT = SelectFactors<Step>;
};

// Whether dt, rounded to T, gives a LINEAR system's constant rows: finite (t - t is 0) and
// not -0 (1 / -0 is -inf).
template <typename T> inline bool linear_dt(double dt) {
  const T t = static_cast<T>(dt);
  return t - t == T(0) && !(t == T(0) && T(1) / t < T(0));
}

// The library's policies: the circle systems' h by LANE_AGG, every system's barrier by
// LANE_BARRIER.
template <typename T, int NOBS>
using CircleOf = std::conditional_t<LANE_AGG == MIN, MinCircleH<T, NOBS>, CircleH<T, NOBS>>;
template <typename T>
using BarrierOf = std::conditional_t<LANE_BARRIER == LOG, LogBarrier<T>, InverseBarrier<T>>;

template <typename T, int SYS, int NOBS> struct SystemOf;
template <typename T, int NOBS> struct SystemOf<T, DUBINS, NOBS> {
  using type = Sys<DubinsStep<T>, CircleOf<T, NOBS>, BarrierOf<T>>;
};
template <typename T, int NOBS> struct SystemOf<T, DOUBLE_INTEGRATOR, NOBS> {
  using type = Sys<DoubleIntegratorStep<T>, CircleOf<T, NOBS>, BarrierOf<T>>;
};
template <typename T, int NOBS> struct SystemOf<T, QUADROTOR2D, NOBS> {
  using type = Sys<Quadrotor2DStep<T>, CircleOf<T, NOBS>, BarrierOf<T>>;
};
template <typename T, int NOBS> struct SystemOf<T, CARTPOLE, NOBS> {
  using type = Sys<CartPoleStep<T>, TrackH<T>, BarrierOf<T>>;
};
template <typename T, int SYS, int NOBS> using System = typename SystemOf<T, SYS, NOBS>::type;

// ---------------------------------------------------------------------------
// Augmented step f̂(x̂, u) = [f(x, u), B(h(f) - s) - gamma (B(h(x) - s) - b)]
// (ops/lanes.py::augmented_step_fn) and its tangent map.
// ---------------------------------------------------------------------------
template <typename T, typename S> struct FLin {
  T gamma;
  typename S::Lin f;
  typename S::H::Lin hc, hn;
  typename S::Bar::Lin bc, bn;
  T out[S::NH];
};

template <typename S, typename T>
__device__ __forceinline__ void fhat_lin(const Consts& p, const T x[S::NH], const T u[S::M],
                                         T alpha, T gamma, T tight, FLin<T, S>& L) {
  L.gamma = gamma;
  S::lin(p, x, u, L.f, L.out);
  S::H::lin(p, L.out, L.hn);
  S::H::lin(p, x, L.hc);
  S::Bar::lin(p, L.hn.value - tight, alpha, L.bn);
  S::Bar::lin(p, L.hc.value - tight, alpha, L.bc);
  L.out[S::NX] = L.bn.value - gamma * (L.bc.value - x[S::NX]);
}

// The barrier value B(h(x) - tight) of fhat_lin's bc and bn.
template <typename S, typename T>
__device__ __forceinline__ T barrier_at(const Consts& p, const T* x, T alpha, T tight) {
  typename S::H::Lin h;
  S::H::lin(p, x, h);
  typename S::Bar::Lin b;
  S::Bar::lin(p, h.value - tight, alpha, b);
  return b.value;
}

// fhat_lin with the policies' balanced-equality factors formed again by select, which
// leaves fhat_lin's divisions for them unused: the same values (the SELECT systems' K1
// and K3/K5).
template <typename S, typename T>
__device__ __forceinline__ void fhat_lin_select(const Consts& p, const T x[S::NH],
                                                const T u[S::M], T alpha, T gamma, T tight,
                                                FLin<T, S>& L) {
  fhat_lin<S>(p, x, u, alpha, gamma, tight, L);
  S::H::select(p, L.out, L.hn);
  S::H::select(p, x, L.hc);
  S::Bar::select(p, L.hn.value - tight, L.bn);
  S::Bar::select(p, L.hc.value - tight, L.bc);
}

// The value of f̂ alone, given the barrier value at the current state,
// bc = B(h(x) - tight), which is replaced by the barrier value at the next state.
// A rollout carries it from step to step, so each step evaluates h once: the next
// state of step k is, bit for bit, the current state of step k+1. The operations
// are fhat_lin's, so the values are too.
template <typename S, typename T>
__device__ __forceinline__ void fhat_carry(const Consts& p, const T x[S::NH], const T u[S::M],
                                           T alpha, T gamma, T tight, T& bc, T out[S::NH]) {
  typename S::Lin f;
  S::lin(p, x, u, f, out);
  const T bn = barrier_at<S>(p, out, alpha, tight);
  out[S::NX] = bn - gamma * (bc - x[S::NX]);
  bc = bn;
}

template <typename S, typename T>
__device__ __forceinline__ void fhat_tan(const Consts& p, const FLin<T, S>& L,
                                         const T dx[S::NH], const T du[S::M], T out[S::NH]) {
  S::tan(p, L.f, dx, du, out);
  const T dBn = S::Bar::tan(L.bn, S::H::tan(p, L.hn, out));
  const T dBc = S::Bar::tan(L.bc, S::H::tan(p, L.hc, dx));
  out[S::NX] = dBn - L.gamma * (dBc - dx[S::NX]);
}

// Derivatives of f̂ in the barrier parameters at the point of L (b is the
// barrier state x̂[n] there), the rows (d f̂/d alpha, d f̂/d gamma, d f̂/d tight)
// of ops/lanes.py::augmented_lin_fn: only the barrier row depends on them.
// The zero rows stay in the sums that use them, as in the reference, so that
// an infinite weight on them gives NaN there too.
template <typename S, typename T>
__device__ __forceinline__ void fhat_dparams(const Consts& p, const FLin<T, S>& L, T alpha, T b,
                                             T fa[S::NH], T fg[S::NH], T ft[S::NH]) {
#pragma unroll
  for (int i = 0; i < S::NX; ++i) {
    fa[i] = T(0);
    fg[i] = T(0);
    ft[i] = T(0);
  }
  fa[S::NX] = S::Bar::dalpha(p, L.bn, L.bc, alpha, L.gamma);
  fg[S::NX] = -(L.bc.value - b);
  ft[S::NX] = S::Bar::tan(L.bn, T(-1)) - L.gamma * S::Bar::tan(L.bc, T(-1));
}

// Jacobian rows A[i][j] = d f̂_i / d x̂_j, Bm[i][a] = d f̂_i / d u_a by basis
// tangents, as jac_rows does.
template <typename S, typename T>
__device__ __forceinline__ void fhat_jac(const Consts& p, const FLin<T, S>& L,
                                         T A[S::NH][S::NH], T Bm[S::NH][S::M]) {
  constexpr int NH = S::NH, M = S::M;
#pragma unroll
  for (int j = 0; j < NH + M; ++j) {
    T dx[NH], du[M], col[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) dx[i] = (i == j) ? T(1) : T(0);
#pragma unroll
    for (int a = 0; a < M; ++a) du[a] = (NH + a == j) ? T(1) : T(0);
    fhat_tan(p, L, dx, du, col);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if (j < NH) A[i][j] = col[i];
      else Bm[i][j - NH] = col[i];
    }
  }
}

// Scale-invariant adjugate inverse of a 2x2 block with resolve-or-zero
// (ops/pallas/lane_solver.py:126-143).
template <typename T>
__device__ __forceinline__ void inv2(T q00, T q01, T q10, T q11, T inv[2][2]) {
  T s = jmax(jmax(m_abs(q00), m_abs(q01)), jmax(m_abs(q10), m_abs(q11)));
  s = jmax(s, tiny<T>());
  const T n00 = q00 / s, n01 = q01 / s, n10 = q10 / s, n11 = q11 / s;
  const T det = n00 * n11 - n01 * n10;
  const bool ok = m_abs(det) > T(100) * epsilon<T>();
  const T safe_det = ok ? det : T(1);
  const T det_inv = (ok ? T(1) : T(0)) / (safe_det * s);
  inv[0][0] = n11 * det_inv;
  inv[0][1] = -n01 * det_inv;
  inv[1][0] = -n10 * det_inv;
  inv[1][1] = n00 * det_inv;
}

// Renormalise the value-function carry above 1e8 and scrub non-finite entries
// (ops/pallas/lane_solver.py:173-189). vx is V_x (K1) or tV_x (K3).
// LEAN (the cart-pole's K1, on its chain's critical path): the maximum over |carry| by
// nan_max as a tree, 5 steps deep where jmax's chain is 30 compare-and-selects long (a
// maximum is exact in any order, and either way a NaN fails the test against 1e8), and a
// warp none of whose lanes rescales skips the multiplies by scale_inv = 1 and LogS's
// log(1) = 0: x * 1 is x for every x that scrub keeps, and LogS - 0 is LogS, so the carry
// is the same. Every active lane of the warp must call it.
template <int NH, bool LEAN = false, typename T>
__device__ __forceinline__ void rescale_carry(const T vx_new[NH], const T vxx_new[NH][NH],
                                              T vx[NH], T vxx[NH][NH], T& logs) {
  T mmax = T(0);
  if constexpr (LEAN) {
    constexpr int K = NH + NH * NH;
    T m[K];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      m[i] = m_abs(vx_new[i]);
#pragma unroll
      for (int j = 0; j < NH; ++j) m[NH + i * NH + j] = m_abs(vxx_new[i][j]);
    }
#pragma unroll
    for (int w = 1; w < K; w *= 2)
#pragma unroll
      for (int i = 0; i + w < K; i += 2 * w) m[i] = nan_max(m[i], m[i + w]);
    mmax = m[0];
  } else {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      mmax = jmax(mmax, m_abs(vx_new[i]));
#pragma unroll
      for (int j = 0; j < NH; ++j) mmax = jmax(mmax, m_abs(vxx_new[i][j]));
    }
  }
  const T thresh = T(1e8);
  if constexpr (LEAN) {
    if (!__any_sync(__activemask(), mmax > thresh)) {
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        vx[i] = scrub(vx_new[i]);
#pragma unroll
        for (int j = 0; j < NH; ++j) vxx[i][j] = scrub(vxx_new[i][j]);
      }
      return;
    }
  }
  const T scale_inv = (mmax > thresh) ? thresh / mmax : T(1);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    vx[i] = scrub(vx_new[i] * scale_inv);
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = scrub(vxx_new[i][j] * scale_inv);
  }
  logs = logs - m_log(jmax(scale_inv, tiny<T>()));
}

// ---------------------------------------------------------------------------
// The chunked sweep of K1 (lane_solver.cu), K3/K5 (lane_sbwd.cu) and K4/K6
// (lane_sfwd.cu). A block owns 32 lanes and has SWEEP_WARPS warps, and walks the
// steps in chunks of SWEEP_KC, from the end (a backward sweep) or from the start.
// Phase A writes each (step, lane)'s rows, which depend on the step's inputs alone,
// into shared memory laid out [2][SWEEP_KC][ROWS][32]: a warp's stores and the
// recursion warp's loads are 32 consecutive words, free of bank conflicts. Phase B,
// in warp 0, runs the chain that needs the carry over the chunk's steps in sweep
// order. Warps 1..SWEEP_WARPS-1 write chunk j+1 into one buffer while warp 0 reads
// chunk j from the other; a named barrier closes each chunk, and all warps write
// chunk 0 first. Lanes past B do no work but reach every barrier.
// ---------------------------------------------------------------------------
constexpr int SWEEP_WARPS = 4;
constexpr int SWEEP_THREADS = 32 * SWEEP_WARPS;
constexpr int SWEEP_KC = 3;            // steps per chunk, one per phase-A warp

// Blocks each SM must hold at once (K1, K3/K5; K4/K6 take SfwdBlocksPerSM): four f32
// blocks of 128 threads (at most 128 registers a thread) hold all 512 blocks of B=16384
// on the 132 SMs in one wave. Above n̂ = 5 (the quadrotor) the same four: K1 spills 312
// bytes there and still runs 1.5x faster than at two blocks (255 registers, two waves),
// and K3/K5's split sweep (sweep_split) holds half the carry in each thread.
// tools/ric_probe.py varies the two caps apart. f64 is not capped.
template <typename T, int NH> struct SweepBlocksPerSM {
  static constexpr int value = NH > 5 ? (sizeof(T) == 4 ? 4 : 1) : (sizeof(T) == 4 ? 4 : 1);
};

// Barrier 1 over the block's threads, which warp 0 and the phase-A warps reach from
// loops of their own.
__device__ __forceinline__ void sweep_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(SWEEP_THREADS) : "memory");
}

// Dynamic shared memory of a sweep with ROWS rows a step.
template <typename T, int ROWS> constexpr int sweep_smem() {
  return 2 * SWEEP_KC * ROWS * 32 * static_cast<int>(sizeof(T));
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above the 48 KB a launch
// gets by default it needs cudaFuncAttributeMaxDynamicSharedMemorySize.
template <typename K> int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return static_cast<int>(cudaSuccess);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// lin(k, row) writes step k's rows at row[r * 32] (phase A); rec(k, row) reads them
// (phase B, warp 0, k = N-1..0 when BACKWARD, else 0..N-1).
template <bool BACKWARD, int ROWS, typename T, typename Lin, typename Rec>
__device__ __forceinline__ void sweep(int N, bool live, T* lin, Lin&& lin_step, Rec&& rec_step) {
  constexpr int STEP = ROWS * 32, CHUNK = SWEEP_KC * STEP;
  const int l = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (N + SWEEP_KC - 1) / SWEEP_KC;
  // Chunk j holds the steps [lo, hi): BACKWARD hi = N - j SWEEP_KC, lo = max(hi -
  // SWEEP_KC, 0); else lo = j SWEEP_KC, hi = min(lo + SWEEP_KC, N). The last chunk is
  // ragged when SWEEP_KC does not divide N.
  auto lo_of = [&](int j) {
    const int hi = N - j * SWEEP_KC;
    return BACKWARD ? (hi > SWEEP_KC ? hi - SWEEP_KC : 0) : j * SWEEP_KC;
  };
  auto hi_of = [&](int j) {
    const int lo = j * SWEEP_KC;
    return BACKWARD ? N - j * SWEEP_KC : (lo + SWEEP_KC < N ? lo + SWEEP_KC : N);
  };
  auto linearise = [&](int j, int first, int stride) {   // steps lo + first, + stride, ...
    const int lo = lo_of(j), hi = hi_of(j);
    T* buf = lin + (j & 1) * CHUNK + l;
    if (live)
      for (int k = lo + first; k < hi; k += stride) lin_step(k, buf + (k - lo) * STEP);
  };

  linearise(0, warp, SWEEP_WARPS);
  sweep_sync();
  if (warp == 0) {
    for (int j = 0; j < chunks; ++j) {
      const int lo = lo_of(j), hi = hi_of(j);
      const T* buf = lin + (j & 1) * CHUNK + l;
      if (live) {
        if constexpr (BACKWARD) {
          for (int k = hi - 1; k >= lo; --k) rec_step(k, buf + (k - lo) * STEP);
        } else {
          for (int k = lo; k < hi; ++k) rec_step(k, buf + (k - lo) * STEP);
        }
      }
      sweep_sync();
    }
  } else {
    for (int j = 0; j < chunks; ++j) {
      if (j + 1 < chunks) linearise(j + 1, warp - 1, SWEEP_WARPS - 1);
      sweep_sync();
    }
  }
}

// ---------------------------------------------------------------------------
// The split sweep of K3/K5 (lane_sbwd.cu) above n̂ = 5: the quadrotor's n̂ = 7, whose
// recursion is some 2,500 operations a lane and step, five times Dubins', and whose
// 7x7 V_xx carry and Q blocks took 253-255 registers a thread in the chunked sweep: two
// f32 blocks an SM, two waves for B=16384, one chain warp in four, and phase B alone 89%
// of the kernel's time (tools/ric_probe.py --family quadrotor2d; PERF.md §6, PR 12).
// - A block owns 32 lanes, as in sweep: SPLIT_CW warps run phase B, SPLIT_AW warps
//   phase A, double-buffered as in sweep (the phase-A warps write chunk j+1 while the
//   phase-B warps run chunk j), SPLIT_KC = SPLIT_AW steps a chunk.
// - Phase B: SPLIT_PARTS neighbouring threads of a phase-B warp share one lane. The part
//   p owns the carry's rows i = p + SPLIT_PARTS r (SPLIT_ROWS of them; a last one past
//   n̂ is computed on row n̂ - 1 and thrown away) and computes its rows of V A, V Bm,
//   Q_xx, Q_xu, tQ_x, the new carry, and its columns of Q_ux and K; every part forms
//   Q_uu, tQ_u, the 2x2 solve and kff alike. The parts exchange V A, V Bm, tV_x (before
//   Q) and K (before the new carry) through an exchange area after the buffers, XROWS
//   rows of 32 lanes, behind __syncwarp over the lane's group; rescale_split's maximum
//   over the carry is a shuffle across the group (exact, and jmax gives NaN whatever the
//   order). So every value is computed by the same operations in the same order as the
//   plain version's and rounds as it does.
// - Two parts a lane hold half the carry each: the kernel fits 128 registers (with
//   84-152 bytes of f32 spill), four blocks an SM (SweepBlocksPerSM) hold B=16384 in one
//   wave, and 8 warps an SM run the chain where there were 2. Shared memory: two buffers
//   of two steps (72 rows, 74 with UPPER) and the exchange's 84 rows, 47,616 or 48,640
//   bytes f32, fit four blocks in the SM's 228 KB.
// - Measured against the alternatives (PERF.md §6): four parts a lane in every warp
//   (each warp both phases, one buffer) and four parts with one or two phase-A warps
//   (80-96 registers, 260-488 bytes of spill) were slower; so were two parts with one
//   phase-A warp, which could not keep up.
// ---------------------------------------------------------------------------
constexpr int SPLIT_PARTS = 2;                          // threads of one lane in phase B
constexpr int SPLIT_AW = 2;                             // phase-A warps of a block
constexpr int SPLIT_CW = SPLIT_PARTS;                   // phase-B warps: 32 lanes a block
constexpr int SPLIT_THREADS = 32 * (SPLIT_CW + SPLIT_AW);
constexpr int SPLIT_KC = SPLIT_AW;                      // steps per chunk: one per phase-A warp

// The carry rows a part owns.
template <int NH> constexpr int SPLIT_ROWS = (NH + SPLIT_PARTS - 1) / SPLIT_PARTS;

// Phase B's lane of this thread within its block (a thread of the first SPLIT_CW
// warps), its part, and its group's mask.
__device__ __forceinline__ int split_lane() { return threadIdx.x / SPLIT_PARTS; }
__device__ __forceinline__ int split_part() { return threadIdx.x & (SPLIT_PARTS - 1); }
__device__ __forceinline__ unsigned split_group() {
  return ((1u << SPLIT_PARTS) - 1) << ((threadIdx.x & 31) & ~(SPLIT_PARTS - 1));
}

// Barrier 1 over the split sweep's block.
__device__ __forceinline__ void split_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(SPLIT_THREADS) : "memory");
}

// Dynamic shared memory of a split sweep with ROWS rows a step and XROWS exchange rows:
// two buffers of SPLIT_KC steps, then the exchange area.
template <typename T, int ROWS, int XROWS> constexpr int split_smem() {
  return (2 * SPLIT_KC * ROWS + XROWS) * 32 * static_cast<int>(sizeof(T));
}

// Backwards from k = N-1, as sweep: every warp linearises chunk 0, then the phase-A
// warps write chunk j+1 into one buffer while the phase-B warps run chunk j from the
// other. lin(k, row) writes step k's rows at row[r * 32] for the lane
// threadIdx.x % 32 (live_a: below B); rec(k, row) reads them at phase B's lane (live_b:
// a phase-B thread's lane below B) and keeps its part of the carry.
template <int ROWS, typename T, typename Lin, typename Rec>
__device__ __forceinline__ void sweep_split(int N, bool live_a, bool live_b, T* lin,
                                            Lin&& lin_step, Rec&& rec_step) {
  constexpr int STEP = ROWS * 32, CHUNK = SPLIT_KC * STEP;
  const int warp = threadIdx.x >> 5;
  const int chunks = (N + SPLIT_KC - 1) / SPLIT_KC;
  auto lo_of = [&](int j) { return N - j * SPLIT_KC > SPLIT_KC ? N - (j + 1) * SPLIT_KC : 0; };
  auto linearise = [&](int j, int first, int stride) {   // steps lo + first, + stride, ...
    const int lo = lo_of(j), hi = N - j * SPLIT_KC;
    T* buf = lin + (j & 1) * CHUNK + (threadIdx.x & 31);
    if (live_a)
      for (int k = lo + first; k < hi; k += stride) lin_step(k, buf + (k - lo) * STEP);
  };

  linearise(0, warp, SPLIT_CW + SPLIT_AW);
  split_sync();
  if (warp < SPLIT_CW) {
    for (int j = 0; j < chunks; ++j) {
      const int lo = lo_of(j), hi = N - j * SPLIT_KC;
      const T* buf = lin + (j & 1) * CHUNK + split_lane();
      if (live_b)
        for (int k = hi - 1; k >= lo; --k) rec_step(k, buf + (k - lo) * STEP);
      split_sync();
    }
  } else {
    for (int j = 0; j < chunks; ++j) {
      if (j + 1 < chunks) linearise(j + 1, warp - SPLIT_CW, SPLIT_AW);
      split_sync();
    }
  }
}

// rescale_carry on a part's rows (vx_new, vxx_new: rows part + SPLIT_PARTS r): the
// maximum over the lane's whole carry by a shuffle across its group.
template <int NH, typename T>
__device__ __forceinline__ void rescale_split(int part, unsigned group,
                                              const T vx_new[SPLIT_ROWS<NH>],
                                              const T vxx_new[SPLIT_ROWS<NH>][NH],
                                              T vx[SPLIT_ROWS<NH>],
                                              T vxx[SPLIT_ROWS<NH>][NH], T& logs) {
  constexpr int RP = SPLIT_ROWS<NH>;
  T mmax = T(0);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    T m = jmax(mmax, m_abs(vx_new[r]));
#pragma unroll
    for (int j = 0; j < NH; ++j) m = jmax(m, m_abs(vxx_new[r][j]));
    mmax = (part + SPLIT_PARTS * r < NH) ? m : mmax;
  }
#pragma unroll
  for (int o = 1; o < SPLIT_PARTS; o <<= 1) mmax = jmax(mmax, __shfl_xor_sync(group, mmax, o));
  const T thresh = T(1e8);
  const T scale_inv = (mmax > thresh) ? thresh / mmax : T(1);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    vx[r] = scrub(vx_new[r] * scale_inv);
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[r][j] = scrub(vxx_new[r][j] * scale_inv);
  }
  logs = logs - m_log(jmax(scale_inv, tiny<T>()));
}

// Rows of f̂'s Jacobians in a step's phase-A rows (K1, K3/K5): A [0, n̂²), Bm [n̂², n̂² + n̂m);
// for a LINEAR system only their barrier rows, A's [0, n̂) and Bm's [n̂, n̂ + m): the double
// integrator's 7 rows where there were 35, and phase B takes the others as the literal 0
// and 1 and the uniform dt (load_jac_linear), so that a product with 1 folds and none
// reads shared memory. Every other product stays in its sum, in its order, the ones with a
// 0 too (0 * inf is NaN, 0 * -1 is -0), so the values are those of the stored rows.
template <typename S> constexpr int ROW_BM = S::LINEAR ? S::NH : S::NH * S::NH;
template <typename S> constexpr int JAC_ROWS = ROW_BM<S> + (S::LINEAR ? S::M : S::NH * S::M);

// Rows of the split sweep's exchange area (per lane, 32 apart): V A [0, n̂²), V Bm
// [n̂², n̂² + n̂m), the tV_x carry (n̂), K (m n̂, row a n̂ + i).
template <typename S> constexpr int XCH_VB = S::NH * S::NH;
template <typename S> constexpr int XCH_VX = XCH_VB<S> + S::NH * S::M;
template <typename S> constexpr int XCH_K = XCH_VX<S> + S::NH;
template <typename S> constexpr int XCH_ROWS = XCH_K<S> + S::M * S::NH;

template <typename S, typename T>
__device__ __forceinline__ void store_jac(const T A[S::NH][S::NH], const T Bm[S::NH][S::M],
                                          T* row) {
  if constexpr (S::LINEAR) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) row[j * 32] = A[S::NX][j];
#pragma unroll
    for (int a = 0; a < S::M; ++a) row[(ROW_BM<S> + a) * 32] = Bm[S::NX][a];
    return;
  }
#pragma unroll
  for (int i = 0; i < S::NH; ++i) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) row[(i * S::NH + j) * 32] = A[i][j];
#pragma unroll
    for (int a = 0; a < S::M; ++a) row[(ROW_BM<S> + i * S::M + a) * 32] = Bm[i][a];
  }
}

template <typename S, typename T>
__device__ __forceinline__ void load_jac(const T* row, T A[S::NH][S::NH], T Bm[S::NH][S::M]) {
#pragma unroll
  for (int i = 0; i < S::NH; ++i) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) A[i][j] = row[(i * S::NH + j) * 32];
#pragma unroll
    for (int a = 0; a < S::M; ++a) Bm[i][a] = row[(ROW_BM<S> + i * S::M + a) * 32];
  }
}

// load_jac for a LINEAR system: rows 0..NX-1 the literal 0 or 1 or dt = T(p.dt)
// (tan_kind), the barrier rows from the step's rows.
template <typename S, typename T>
__device__ __forceinline__ void load_jac_linear(const T* row, T dt, T A[S::NH][S::NH],
                                                T Bm[S::NH][S::M]) {
  auto entry = [&](int i, int c) {
    const int kind = S::tan_kind(i, c);
    return kind == 1 ? T(1) : kind == 2 ? dt : T(0);
  };
#pragma unroll
  for (int i = 0; i < S::NX; ++i) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) A[i][j] = entry(i, j);
#pragma unroll
    for (int a = 0; a < S::M; ++a) Bm[i][a] = entry(i, S::NH + a);
  }
#pragma unroll
  for (int j = 0; j < S::NH; ++j) A[S::NX][j] = row[j * 32];
#pragma unroll
  for (int a = 0; a < S::M; ++a) Bm[S::NX][a] = row[(ROW_BM<S> + a) * 32];
}

// Calls f(std::integral_constant<int, NOBS>{}) for NOBS = n_obs, so that the kernel it
// launches has the obstacle loops unrolled (HLin).
template <int NOBS = 1, typename F>
int with_obs(int n_obs, F&& f) {
  if constexpr (NOBS > MAX_OBS) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (n_obs == NOBS) return f(std::integral_constant<int, NOBS>{});
    return with_obs<NOBS + 1>(n_obs, f);
  }
}

// Calls f(std::integral_constant<int, NOBS>{}) for the kernels of this library's system
// (LANE_SYSTEM): with the problem's obstacle count through with_obs, or NOBS = 0 for the
// cart-pole, whose h is its track limit. Refuses constants made for another system,
// aggregation or barrier than the library's (LANE_AGG, LANE_BARRIER).
template <typename F>
int with_system(const Consts& p, F&& f) {
  if (p.system != LANE_SYSTEM || p.aggregation != LANE_AGG || p.barrier != LANE_BARRIER)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (LANE_SYSTEM == CARTPOLE) {
    if (p.n_obs != 0) return static_cast<int>(cudaErrorInvalidValue);
    return f(std::integral_constant<int, 0>{});
  } else {
    return with_obs(p.n_obs, f);
  }
}

}  // namespace lane
