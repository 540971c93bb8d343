// Shared device code of the lane kernels: the Dubins component step, the
// smooth-min obstacle value h, the relaxed inverse barrier, the DBaS-augmented
// step f̂, its hand-written tangent map (the counterpart of jax.jvp in
// tube_mpc_tpu/ops/lanes.py::jac_rows) and its derivatives in the barrier
// parameters (the three jax.jvp calls of the generic _sfwd_kernel); the chunked
// sweep that K1 and K3-K6 share (sweep), and with_obs, which launches a kernel
// for the problem's obstacle count.
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

namespace lane {

constexpr int NH = 4;                 // augmented state (px, py, theta, b)
constexpr int M = 2;                  // controls (v, omega)
constexpr int NC = 2 * NH + M + 3;    // const rows, see tube/lane_interface.py::_build_C
constexpr int ROW_ALPHA = 2 * NH + M;
constexpr int MAX_OBS = 8;
constexpr int MAX_ALPHAS = 8;

// Runtime constants, passed by value to every kernel. Mirrors
// ops/cuda/lane_solver.py::LaneConsts field by field. Sums such as
// u_min + active_tol are formed in double on the host and rounded once to the
// working type, as the reference does with Python floats.
struct Consts {
  double dt;
  double u_min[M];
  double u_max[M];
  double act_lo[M];   // u_min + active_tol
  double act_hi[M];   // u_max - active_tol
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

// The reference scrubs a carry entry unless it is finite after a cast to f32,
// in f64 too: a double above FLT_MAX is scrubbed to 0.
template <typename T> __device__ __forceinline__ T scrub(T v) {
  return isfinite(static_cast<float>(v)) ? v : T(0);
}

// ---------------------------------------------------------------------------
// Smooth-min obstacle value in component form (ops/lanes.py::dubins_components):
//   h = z - (1/beta) log sum_i exp(-beta (h_i - z)),  z = min_i h_i.
//
// NOBS is the obstacle count (p.n_obs), fixed at compile time so that every
// obstacle loop unrolls into straight-line code the compiler can schedule; every
// kernel is instantiated for 1 to MAX_OBS and launched through with_obs.
// Runtime-guarded loops over MAX_OBS slots cut a linearisation into blocks the
// compiler could not schedule across, several times slower on an H100 (PERF.md).
//
// h_lin also computes what h_tan needs that depends on the point alone: the
// weights of the min chain, so that a tangent from stored fields (lane_sfwd.cu)
// does no more than the carry needs.
// ---------------------------------------------------------------------------
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
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T dx = px - T(p.cx[i]);
    const T dy = py - T(p.cy[i]);
    L.hs[i] = (dx * dx + dy * dy) - T(p.r2[i]);
  }
  // The balanced-equality factors of lax.min along the chain z = min(z, h_i).
  T z = L.hs[0];
#pragma unroll
  for (int i = 1; i < NOBS; ++i) {
    const T v = L.hs[i];
    const T zn = jmin(z, v);
    L.wz[i] = (z == zn ? T(1) : T(0)) / (v == zn ? T(2) : T(1));
    L.wv[i] = (v == zn ? T(1) : T(0)) / (z == zn ? T(2) : T(1));
    z = zn;
  }
  const T nb = T(p.neg_beta);
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    L.e[i] = m_exp(nb * (L.hs[i] - z));
    L.acc = (i == 0) ? L.e[0] : L.acc + L.e[i];
  }
  L.value = z - T(p.inv_beta) * m_log(L.acc);
}

// Tangent of h along (dpx, dpy), by JAX's rules: d(a**2) = da * (2a); the min
// chain weighs tangents by the balanced-equality factors of lax.min; d exp =
// g * ans; d log = g / x.
template <typename T, int NOBS>
__device__ __forceinline__ T h_tan(const Consts& p, const HLin<T, NOBS>& L, T dpx, T dpy) {
  T dh[NOBS];
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T ax = T(2) * (L.px - T(p.cx[i]));
    const T ay = T(2) * (L.py - T(p.cy[i]));
    dh[i] = dpx * ax + dpy * ay;
  }
  T dz = dh[0];
#pragma unroll
  for (int i = 1; i < NOBS; ++i) dz = dz * L.wz[i] + dh[i] * L.wv[i];
  const T nb = T(p.neg_beta);
  T dacc = T(0);
#pragma unroll
  for (int i = 0; i < NOBS; ++i) {
    const T de = (nb * (dh[i] - dz)) * L.e[i];
    dacc = (i == 0) ? de : dacc + de;
  }
  return dz - T(p.inv_beta) * (dacc / L.acc);
}

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

// ---------------------------------------------------------------------------
// Augmented step f̂(x̂, u) = [f(x, u), B(h(f) - s) - gamma (B(h(x) - s) - b)]
// (ops/lanes.py::augmented_step_fn) and its tangent map.
// ---------------------------------------------------------------------------
template <typename T, int NOBS> struct FLin {
  T c, s, dtv, dt, gamma;
  HLin<T, NOBS> hc, hn;
  BLin<T> bc, bn;
  T out[NH];
};

template <typename T, int NOBS>
__device__ __forceinline__ void fhat_lin(const Consts& p, const T x[NH], const T u[M],
                                         T alpha, T gamma, T tight, FLin<T, NOBS>& L) {
  L.dt = T(p.dt);
  L.gamma = gamma;
  L.c = m_cos(x[2]);
  L.s = m_sin(x[2]);
  L.dtv = L.dt * u[0];
  const T pxn = x[0] + L.dtv * L.c;
  const T pyn = x[1] + L.dtv * L.s;
  const T thn = x[2] + L.dt * u[1];
  h_lin(p, pxn, pyn, L.hn);
  h_lin(p, x[0], x[1], L.hc);
  barrier_lin(p, L.hn.value - tight, alpha, L.bn);
  barrier_lin(p, L.hc.value - tight, alpha, L.bc);
  L.out[0] = pxn;
  L.out[1] = pyn;
  L.out[2] = thn;
  L.out[3] = L.bn.value - gamma * (L.bc.value - x[3]);
}

// The barrier value B(h(px, py) - tight) of fhat_lin's bc and bn.
template <int NOBS, typename T>
__device__ __forceinline__ T barrier_at(const Consts& p, T px, T py, T alpha, T tight) {
  HLin<T, NOBS> h;
  h_lin(p, px, py, h);
  BLin<T> b;
  barrier_lin(p, h.value - tight, alpha, b);
  return b.value;
}

// The value of f̂ alone, given the barrier value at the current state,
// bc = B(h(x) - tight), which is replaced by the barrier value at the next state.
// A rollout carries it from step to step, so each step evaluates h once: the next
// state of step k is, bit for bit, the current state of step k+1. The operations
// are fhat_lin's, so the values are too.
template <int NOBS, typename T>
__device__ __forceinline__ void fhat_carry(const Consts& p, const T x[NH], const T u[M], T alpha,
                                           T gamma, T tight, T& bc, T out[NH]) {
  const T dt = T(p.dt);
  const T dtv = dt * u[0];
  out[0] = x[0] + dtv * m_cos(x[2]);
  out[1] = x[1] + dtv * m_sin(x[2]);
  out[2] = x[2] + dt * u[1];
  const T bn = barrier_at<NOBS>(p, out[0], out[1], alpha, tight);
  out[3] = bn - gamma * (bc - x[3]);
  bc = bn;
}

template <typename T, int NOBS>
__device__ __forceinline__ void fhat_tan(const Consts& p, const FLin<T, NOBS>& L,
                                         const T dx[NH], const T du[M], T out[NH]) {
  const T ddtv = L.dt * du[0];
  const T dpxn = dx[0] + (ddtv * L.c + L.dtv * (-(dx[2] * L.s)));
  const T dpyn = dx[1] + (ddtv * L.s + L.dtv * (dx[2] * L.c));
  const T dthn = dx[2] + L.dt * du[1];
  const T dBn = barrier_tan(L.bn, h_tan(p, L.hn, dpxn, dpyn));
  const T dBc = barrier_tan(L.bc, h_tan(p, L.hc, dx[0], dx[1]));
  out[0] = dpxn;
  out[1] = dpyn;
  out[2] = dthn;
  out[3] = dBn - L.gamma * (dBc - dx[3]);
}

// Derivatives of f̂ in the barrier parameters at the point of L (b is the
// barrier state x̂[3] there), the rows (d f̂/d alpha, d f̂/d gamma, d f̂/d tight)
// of ops/lanes.py::augmented_lin_fn: only the barrier row depends on them.
// The zero rows stay in the sums that use them, as in the reference, so that
// an infinite weight on them gives NaN there too.
template <typename T, int NOBS>
__device__ __forceinline__ void fhat_dparams(const Consts& p, const FLin<T, NOBS>& L, T alpha, T b,
                                             T fa[NH], T fg[NH], T ft[NH]) {
#pragma unroll
  for (int i = 0; i < NH - 1; ++i) {
    fa[i] = T(0);
    fg[i] = T(0);
    ft[i] = T(0);
  }
  fa[NH - 1] = barrier_dalpha(p, L.bn, alpha) - L.gamma * barrier_dalpha(p, L.bc, alpha);
  fg[NH - 1] = -(L.bc.value - b);
  ft[NH - 1] = barrier_tan(L.bn, T(-1)) - L.gamma * barrier_tan(L.bc, T(-1));
}

// Jacobian rows A[i][j] = d f̂_i / d x̂_j, Bm[i][a] = d f̂_i / d u_a by basis
// tangents, as jac_rows does.
template <typename T, int NOBS>
__device__ __forceinline__ void fhat_jac(const Consts& p, const FLin<T, NOBS>& L, T A[NH][NH],
                                         T Bm[NH][M]) {
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
__device__ __forceinline__ void inv2(T q00, T q01, T q10, T q11, T inv[M][M]) {
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
template <typename T>
__device__ __forceinline__ void rescale_carry(const T vx_new[NH], const T vxx_new[NH][NH],
                                              T vx[NH], T vxx[NH][NH], T& logs) {
  T mmax = T(0);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    mmax = jmax(mmax, m_abs(vx_new[i]));
#pragma unroll
    for (int j = 0; j < NH; ++j) mmax = jmax(mmax, m_abs(vxx_new[i][j]));
  }
  const T thresh = T(1e8);
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

// Blocks each SM must hold at once: four f32 blocks (at most 128 registers a thread)
// hold all 512 blocks of B=16384 on the 132 SMs. f64 is not capped.
template <typename T> struct SweepBlocksPerSM {
  static constexpr int value = sizeof(T) == 4 ? 4 : 1;
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

// Rows of f̂'s Jacobians in a step's phase-A rows (K1, K3/K5): A [0, 16), Bm [16, 24).
constexpr int ROW_BM = NH * NH;
constexpr int JAC_ROWS = ROW_BM + NH * M;

template <typename T>
__device__ __forceinline__ void store_jac(const T A[NH][NH], const T Bm[NH][M], T* row) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) row[(i * NH + j) * 32] = A[i][j];
#pragma unroll
    for (int a = 0; a < M; ++a) row[(ROW_BM + i * M + a) * 32] = Bm[i][a];
  }
}

template <typename T>
__device__ __forceinline__ void load_jac(const T* row, T A[NH][NH], T Bm[NH][M]) {
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) A[i][j] = row[(i * NH + j) * 32];
#pragma unroll
    for (int a = 0; a < M; ++a) Bm[i][a] = row[(ROW_BM + i * M + a) * 32];
  }
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

}  // namespace lane
