// K3/K5 of the lane sensitivity on Hopper: the backward delta-z sweep, for the system
// LANE_SYSTEM (lane_common.cuh).
//
// sbwd_kernel<T, GENERIC, UPPER, SYS, NOBS> replaces
// tube_mpc_tpu/ops/pallas/lane_sensitivity.py::_sbwd_kernel: the backward sweep
// with active-set elimination. UPPER=false builds the tube upper gradient
// g_x = 2 (x - x_ref), g_u = 0 in-kernel; UPPER=true reads caller-supplied rows
// gX, gU (at k) and gXN (terminal) instead (custom_upper). GENERIC=true also
// writes, at each k, the carry the step starts from, i.e. the value function at
// k+1 in its scaled form: tV_x, V_xx, LogS (at k = N-1 the terminal
// initialisation). Instantiated: <false, false> (K3, paper), <true, false> (K5,
// the ancillary sweep), <true, true> (K5, the coupled nominal sweep), each for
// 1 to 8 obstacles (NOBS, launched through with_system; the cart-pole's once), in every
// system's library; with one control (the cart-pole) the reduced solve is 1 / Q_m, as
// the JAX kernel writes it, without resolve-or-zero.
//
// What bounds it on an H100 (Dubins, B=16384, N=50, f32): per lane and step K3 reads 10
// values and writes 10, 66 MB a sweep; K5 also writes the 21 carry values and, with
// UPPER, reads gX, gU in place of Xr. Nearly all of its operations, some 2,900 per
// lane and step, are f̂'s linearisation (fhat_lin and the six tangents of fhat_jac),
// which depends on the step's X, U and C alone; only the recursion (the Q blocks,
// the active-set elimination, the 2x2 solve, the carry update, ~500 operations)
// needs the carry from step k+1. So K3 is bound by operations and K5, with its carry
// rows, by bytes (chip_smoke.py prints both bounds; PERF.md keeps the numbers with
// the card they came from).
//
// Design: K1's (lane_solver.cu), on the chunked sweep of lane_common.cuh, backwards.
// - Phase A writes, for each (step, lane), A (n̂² rows) and Bm (n̂m) from fhat_lin and
//   fhat_jac, the upper gradient g_x (n̂) unscaled, the active-set mask (m) and, with
//   UPPER, g_u (m): Dubins' 30 or 32 rows, two buffers of 3 steps, fit the 48 KB a
//   launch gets by default in f64 too; the quadrotor's 72 rows need the dynamic shared
//   memory attribute (allow_smem).
// - Phase B, in warp 0, runs the recursion from those rows with its carry (tV_x,
//   V_xx, LogS) in registers: it scales g_x and g_u by exp(-LogS) as before, so a
//   value rounded to T, stored and multiplied rounds as it did, writes K, kff and,
//   with GENERIC, the carry before each step.
// Where the time goes (tools/ric_probe.py times each phase alone): as in K1, phase A
// sets it, the linearisation's instruction count (UPPER's extra loads make its phase A
// longer), and the two phases mostly add, since their warps share each SM's dispatch
// slots. The f32 register cap (SweepBlocksPerSM) keeps all 512 blocks of B=16384 in one
// wave for a few bytes of spill at 5 obstacles; lifting it is far slower.
// Above n̂ = 5 (the quadrotor's n̂ = 7, sbwd_split) phase B bounds it: its recursion is
// O(n̂³), and its carry and Q blocks took 253-255 f32 registers in the chunked sweep, so
// two blocks an SM ran B=16384 in two waves with one chain warp in four.
// tools/ric_probe.py --family quadrotor2d on that design (f32; PERF.md §6, PR 12): K3 at
// N=50 0.485 ms, phase B alone 0.433, phase A alone 0.110; four blocks an SM at 128
// registers, with 460-520 bytes of spill, 0.339 (K5 at N=200: 1.43-1.48 against
// 1.87-1.88). So K3/K5 take the split sweep (lane_common.cuh, sweep_split): two
// threads a lane in two phase-B warps, each with half the rows of the carry and of
// V A, Q_xx, Q_xu, tQ_x and the new carry and its columns of Q_ux and K, exchanging
// V A, V Bm, tV_x and K through shared memory, beside two phase-A warps; with GENERIC
// each part writes its rows of the carry, lane fastest as before. Registers, spills and
// times: PERF.md §6.
// The double integrator's K3/K5 take K1's design for its linear step (lane_solver.cu):
// phase A stores A's and Bm's barrier rows only (14 rows a step, 16 with UPPER, where
// there were 42 and 44), phase B takes rows 0..3 as the literals 0, 1 and dt (load_jac),
// phase A's balanced-equality factors by select, and phase B is LEAN (SBWD_LEAN). Its
// chain also writes tV_x, V_xx and LogS each step with GENERIC, yet the chain sets its
// pace, not the bytes: at N=30 phase B alone takes 0.040 ms (A alone 0.040) of K5's 0.075,
// against a byte bound of 0.033 for the whole kernel (PERF.md §6).
// The split sweep at n̂ = 5 (three rows a part, one wasted) was 1.3-1.4x slower.
// The cart-pole's K3/K5 (n̂ = 5, m = 1; sbwd_cartpole) are bound by their instruction count:
// without the changes below phase A alone took 0.053 ms and phase B alone 0.044 of K3's
// 0.084 at N=50, and the two added (tools/ric_probe.py --family cartpole; PERF.md §6). So both
// phases shed instructions, every value bitwise the same. Rows 0 and 2 of f̂'s Jacobians
// are the literals 1, dt and +0 at any input: phase A stores 18 rows a step where there
// were 30, and phase B takes the literals and is LEAN. Along pos, vel and b every term of
// the step's acceleration rows is a product with a literal 0, so where the step's fields
// are finite on every lane of the warp (a vote) three of the six step tangents, with their
// twelve IEEE divisions, are literals too, and phase A forms the barriers' factors by
// select. Loading phase A's state and control a step ahead lost 4% (PERF.md §6).
// The arithmetic and its order are those of the plain version
// (ops/cuda/lane_sensitivity.py::_sbwd_sweep, whose two phases are these).
#include "lane_common.cuh"

namespace lane {

// The cart-pole's K3/K5 (n̂ = 5, m = 1, sbwd_cartpole) take changes of their own, each
// switched here (tools/ric_probe.py builds them apart): CARTPOLE_LIT, rows 0 and 2 of f̂'s
// Jacobians as literals (phase A stores rows 1, 3 and 4: 18 rows where there were 30);
// CARTPOLE_COLS, columns 0, 1 and 4 of rows 0..3 as literals behind a warp's vote
// (cartpole_jac); CARTPOLE_SEL, phase A's balanced-equality factors by select
// (fhat_lin_select). With none of them it runs sbwd_kernel's own sweep.
constexpr bool CARTPOLE_LIT = true;
constexpr bool CARTPOLE_COLS = true;
constexpr bool CARTPOLE_SEL = true;

template <typename S> struct IsCartPole : std::false_type {};
template <typename T, typename Hp, typename BarP>
struct IsCartPole<Sys<CartPoleStep<T>, Hp, BarP>> : std::true_type {};
template <typename S>
constexpr bool CARTPOLE_OWN = IsCartPole<S>::value && (CARTPOLE_LIT || CARTPOLE_COLS || CARTPOLE_SEL);
template <typename S> constexpr bool CARTPOLE_ROWS = IsCartPole<S>::value && CARTPOLE_LIT;
// Whether the launcher checks the cart-pole's constants (cartpole_consts).
template <typename S>
constexpr bool CARTPOLE_LITERALS = IsCartPole<S>::value && (CARTPOLE_LIT || CARTPOLE_COLS);

// Rows of f̂'s Jacobians in a step's rows: JAC_ROWS, or with CARTPOLE_ROWS rows 1, 3 and 4
// of A (n̂ each), then of Bm (m each).
template <typename S>
constexpr int SBWD_JAC_ROWS = CARTPOLE_ROWS<S> ? 3 * (S::NH + S::M) : JAC_ROWS<S>;
template <typename S> constexpr int ROW_G = SBWD_JAC_ROWS<S>;     // rows of a step in shared
template <typename S> constexpr int ROW_AM = ROW_G<S> + S::NH;    //   memory: A, Bm, g_x before
template <typename S> constexpr int ROW_GU = ROW_AM<S> + S::M;    //   the scale, the mask am,
template <typename S, bool UPPER>                                 //   g_u (UPPER)
constexpr int SBWD_ROWS = ROW_GU<S> + (UPPER ? S::M : 0);

// Phase A for step k of one lane.
template <typename S, bool UPPER, typename T>
__device__ __forceinline__ void sbwd_lin(const Consts& p, const T* __restrict__ gX,
                                         const T* __restrict__ gU, const T* __restrict__ U,
                                         const T* __restrict__ X, const T* __restrict__ Xr,
                                         const T c[S::NC], int k, size_t Bs, int lane, T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], us[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
  for (int a = 0; a < M; ++a) us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
  FLin<T, S> L;
  if constexpr (S::SELECT) {
    fhat_lin_select<S>(p, xs, us, c[S::ROW_ALPHA], c[S::ROW_ALPHA + 1], c[S::ROW_ALPHA + 2], L);
  } else {
    fhat_lin<S>(p, xs, us, c[S::ROW_ALPHA], c[S::ROW_ALPHA + 1], c[S::ROW_ALPHA + 2], L);
  }
  T A[NH][NH], Bm[NH][M];
  fhat_jac<S>(p, L, A, Bm);
  store_jac<S>(A, Bm, row);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const size_t at = (static_cast<size_t>(k) * NH + i) * Bs + lane;
    if constexpr (UPPER) {
      row[(ROW_G<S> + i) * 32] = gX[at];
    } else {
      row[(ROW_G<S> + i) * 32] = T(2) * (xs[i] - Xr[at]);
    }
  }
  // Active set: a control within active_tol of a bound is eliminated (identity row
  // and column, zero gains).
#pragma unroll
  for (int a = 0; a < M; ++a) {
    row[(ROW_AM<S> + a) * 32] =
        (us[a] <= T(p.act_lo[a]) || us[a] >= T(p.act_hi[a])) ? T(0) : T(1);
    if constexpr (UPPER)
      row[(ROW_GU<S> + a) * 32] = gU[(static_cast<size_t>(k) * M + a) * Bs + lane];
  }
}

// Row i (0 or 2) of the cart-pole's f̂ Jacobians at column c of (x̂, u): pos+ = pos + dt vel
// and th+ = th + dt om give 1 at c = i, dt at c = i + 1, else +0, bit for bit at any state
// and control, for every finite dt but -0 (cartpole_consts): dx_i + dt * 0 = dx_i,
// 0 + dt * 1 = dt and 0 + dt * 0 = +0.
template <typename T> __device__ __forceinline__ T cartpole_lit(int i, int c, T dt) {
  return c == i ? T(1) : c == i + 1 ? dt : T(0);
}

// Whether the cart-pole's constants, rounded to T, give its literals: dt as linear_dt
// takes it, total_m, mpl, gravity, m_pole and length finite (a product of a literal 0 with
// each of them is then ±0).
template <typename T> inline bool cartpole_consts(const Consts& p) {
  auto finite = [](double v) {
    const T t = static_cast<T>(v);
    return t - t == T(0);
  };
  return linear_dt<T>(p.dt) && finite(p.total_m) && finite(p.mpl) && finite(p.gravity) &&
         finite(p.m_pole) && finite(p.length);
}

// Whether the fields of the cart-pole step's Lin are all finite.
template <typename L> __device__ __forceinline__ bool cartpole_finite(const L& f) {
  return isfinite(f.s) && isfinite(f.c) && isfinite(f.om) && isfinite(f.p1) &&
         isfinite(f.p2) && isfinite(f.temp) && isfinite(f.q1) && isfinite(f.nt) &&
         isfinite(f.den) && isfinite(f.inv_den2) && isfinite(f.r1);
}

// Column j of f̂'s Jacobians of the cart-pole into A or Bm (fhat_jac's column j): by
// fhat_tan, or with `lit` (columns 0, 1 and 4: pos, vel and b) rows 0..3 as the literals
// the step's tangent gives there and the barrier row by fhat_tan's last lines. Along those
// columns dx[2] = dx[3] = du = 0, so every term of CartPoleStep::tan's acceleration rows is a
// product with a literal 0, ±0 where the step's Lin fields and constants are finite; rows 1
// and 3 are then dx_i + dt (±0): 1 at (1, 1), else +0 (+0 + -0 is +0). TrackH::tan reads
// row 0 alone.
template <typename S, typename T>
__device__ __forceinline__ void cartpole_col(const Consts& p, const FLin<T, S>& L, int j, bool lit,
                                             T dt, T A[S::NH][S::NH], T Bm[S::NH][S::M]) {
  constexpr int NH = S::NH, M = S::M, NX = S::NX;
  T dx[NH], du[M], col[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) dx[i] = (i == j) ? T(1) : T(0);
#pragma unroll
  for (int a = 0; a < M; ++a) du[a] = (NH + a == j) ? T(1) : T(0);
  if (lit) {
    col[0] = cartpole_lit(0, j, dt);
    col[1] = j == 1 ? T(1) : T(0);
    col[2] = cartpole_lit(2, j, dt);
    col[3] = T(0);
    const T dBn = S::Bar::tan(L.bn, S::H::tan(p, L.hn, col));
    const T dBc = S::Bar::tan(L.bc, S::H::tan(p, L.hc, dx));
    col[NX] = dBn - L.gamma * (dBc - dx[NX]);
  } else {
    fhat_tan(p, L, dx, du, col);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    if (j < NH) A[i][j] = col[i];
    else Bm[i][j - NH] = col[i];
  }
}

// fhat_jac of the cart-pole with columns 0, 1 and 4 as literals (cartpole_col) where every
// lane of the warp has the step's Lin fields finite; a warp with a lane that has not takes
// fhat_tan there too. Each lane's values are fhat_jac's either way.
template <typename S, typename T>
__device__ __forceinline__ void cartpole_jac(const Consts& p, const FLin<T, S>& L,
                                             T A[S::NH][S::NH], T Bm[S::NH][S::M]) {
  const T dt = T(p.dt);
  if (__all_sync(__activemask(), cartpole_finite(L.f))) {
    cartpole_col<S>(p, L, 0, true, dt, A, Bm);
    cartpole_col<S>(p, L, 1, true, dt, A, Bm);
    cartpole_col<S>(p, L, S::NX, true, dt, A, Bm);
  } else {
    cartpole_col<S>(p, L, 0, false, dt, A, Bm);
    cartpole_col<S>(p, L, 1, false, dt, A, Bm);
    cartpole_col<S>(p, L, S::NX, false, dt, A, Bm);
  }
  cartpole_col<S>(p, L, 2, false, dt, A, Bm);
  cartpole_col<S>(p, L, 3, false, dt, A, Bm);
#pragma unroll
  for (int a = 0; a < S::M; ++a) cartpole_col<S>(p, L, S::NH + a, false, dt, A, Bm);
}

// The rows CARTPOLE_ROWS stores: A's and Bm's rows 1, 3 and NX (r = 0, 1, 2).
__host__ __device__ constexpr int cartpole_row(int r) { return r < 2 ? 2 * r + 1 : 4; }

template <typename S, typename T>
__device__ __forceinline__ void store_jac_cartpole(const T A[S::NH][S::NH],
                                                   const T Bm[S::NH][S::M], T* row) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) row[(r * S::NH + j) * 32] = A[cartpole_row(r)][j];
#pragma unroll
    for (int a = 0; a < S::M; ++a) row[(3 * S::NH + r * S::M + a) * 32] = Bm[cartpole_row(r)][a];
  }
}

// load_jac for CARTPOLE_ROWS: rows 0 and 2 the literals of cartpole_lit, so that a product
// with 1 folds and none reads shared memory; every other product stays in its sum, in its
// order, so the values are those of the stored rows.
template <typename S, typename T>
__device__ __forceinline__ void load_jac_cartpole(const T* row, T dt, T A[S::NH][S::NH],
                                                  T Bm[S::NH][S::M]) {
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) A[i][j] = cartpole_lit(i, j, dt);
#pragma unroll
    for (int a = 0; a < S::M; ++a) Bm[i][a] = cartpole_lit(i, S::NH + a, dt);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < S::NH; ++j) A[cartpole_row(r)][j] = row[(r * S::NH + j) * 32];
#pragma unroll
    for (int a = 0; a < S::M; ++a) Bm[cartpole_row(r)][a] = row[(3 * S::NH + r * S::M + a) * 32];
  }
}

// The cart-pole's phase A (sbwd_lin) for step k of one lane: the factors by select
// (CARTPOLE_SEL), columns 0, 1 and 4 by vote (CARTPOLE_COLS), rows 1, 3 and 4 stored
// (CARTPOLE_LIT).
template <typename S, bool UPPER, typename T>
__device__ __forceinline__ void cartpole_lin(const Consts& p, const T* __restrict__ gX,
                                             const T* __restrict__ gU, const T* __restrict__ U,
                                             const T* __restrict__ X, const T* __restrict__ Xr,
                                             const T c[S::NC], int k, size_t Bs, int lane,
                                             T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], us[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
  for (int a = 0; a < M; ++a) us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
  FLin<T, S> L;
  if constexpr (CARTPOLE_SEL) {
    fhat_lin_select<S>(p, xs, us, c[S::ROW_ALPHA], c[S::ROW_ALPHA + 1], c[S::ROW_ALPHA + 2], L);
  } else {
    fhat_lin<S>(p, xs, us, c[S::ROW_ALPHA], c[S::ROW_ALPHA + 1], c[S::ROW_ALPHA + 2], L);
  }
  T A[NH][NH], Bm[NH][M];
  if constexpr (CARTPOLE_COLS) {
    cartpole_jac<S>(p, L, A, Bm);
  } else {
    fhat_jac<S>(p, L, A, Bm);
  }
  if constexpr (CARTPOLE_LIT) {
    store_jac_cartpole<S>(A, Bm, row);
  } else {
    store_jac<S>(A, Bm, row);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const size_t at = (static_cast<size_t>(k) * NH + i) * Bs + lane;
    if constexpr (UPPER) {
      row[(ROW_G<S> + i) * 32] = gX[at];
    } else {
      row[(ROW_G<S> + i) * 32] = T(2) * (xs[i] - Xr[at]);
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    row[(ROW_AM<S> + a) * 32] =
        (us[a] <= T(p.act_lo[a]) || us[a] >= T(p.act_hi[a])) ? T(0) : T(1);
    if constexpr (UPPER)
      row[(ROW_GU<S> + a) * 32] = gU[(static_cast<size_t>(k) * M + a) * Bs + lane];
  }
}

// Phase B for step k of one lane: K and kff from the step's rows (row[r * 32]) and
// the carry, which it advances to step k; with GENERIC it first writes the carry.
// Every sum over the controls runs a = 0..m-1 left to right, as the reference's. LEAN:
// K1's (lane_solver.cu::ric_step): rescale_carry's, and exp(-LogS) = 1 not computed where
// LogS is 0 on every lane of the warp.
template <typename S, bool GENERIC, bool UPPER, bool LEAN, typename T>
__device__ __forceinline__ void sbwd_step(const T* row, const T c[S::NC], T reg0, T dt,
                                          T tv[S::NH], T vxx[S::NH][S::NH], T& logs,
                                          T* __restrict__ Kout, T* __restrict__ kffout,
                                          T* __restrict__ tVx_out, T* __restrict__ Vxx_out,
                                          T* __restrict__ LogS_out, int k, size_t Bs, int lane) {
  constexpr int NH = S::NH, M = S::M;
  if constexpr (GENERIC) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      tVx_out[(static_cast<size_t>(k) * NH + i) * Bs + lane] = tv[i];
#pragma unroll
      for (int j = 0; j < NH; ++j)
        Vxx_out[(static_cast<size_t>(k) * (NH * NH) + i * NH + j) * Bs + lane] = vxx[i][j];
    }
    LogS_out[static_cast<size_t>(k) * Bs + lane] = logs;
  }
  const T inv_s = (LEAN && !__any_sync(__activemask(), logs != T(0))) ? T(1) : m_exp(-logs);
  T A[NH][NH], Bm[NH][M], gx[NH];
  if constexpr (S::LINEAR) {
    load_jac_linear<S>(row, dt, A, Bm);
  } else if constexpr (CARTPOLE_ROWS<S>) {
    load_jac_cartpole<S>(row, dt, A, Bm);
  } else {
    load_jac<S>(row, A, Bm);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) gx[i] = row[(ROW_G<S> + i) * 32] * inv_s;

  T VA[NH][NH], VB[NH][M], Qxx[NH][NH], Qxu[NH][M], Qux[M][NH], Quu[M][M], tQu[M], tQx[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = vxx[i][0] * A[0][j];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + vxx[i][l] * A[l][j];
      VA[i][j] = s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = vxx[i][0] * Bm[0][a];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + vxx[i][l] * Bm[l][a];
      VB[i][a] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = A[0][i] * VA[0][j];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + A[l][i] * VA[l][j];
      Qxx[i][j] = (i == j) ? c[i] * inv_s + s : s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = A[0][i] * VB[0][a];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + A[l][i] * VB[l][a];
      Qxu[i][a] = s;
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = Bm[0][a] * VA[0][i];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + Bm[l][a] * VA[l][i];
      Qux[a][i] = s;
    }
#pragma unroll
    for (int b = 0; b < M; ++b) {
      T s = Bm[0][a] * VB[0][b];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + Bm[l][a] * VB[l][b];
      Quu[a][b] = (a == b) ? c[NH + a] * inv_s + s : s;
    }
    T s = Bm[0][a] * tv[0];
#pragma unroll
    for (int l = 1; l < NH; ++l) s = s + Bm[l][a] * tv[l];
    if constexpr (UPPER) {
      tQu[a] = row[(ROW_GU<S> + a) * 32] * inv_s + s;
    } else {
      tQu[a] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    T s = A[0][i] * tv[0];
#pragma unroll
    for (int l = 1; l < NH; ++l) s = s + A[l][i] * tv[l];
    tQx[i] = gx[i] + s;
  }
  const T regs = reg0 * inv_s;

  T am[M], act[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    am[a] = row[(ROW_AM<S> + a) * 32];
    act[a] = T(1) - am[a];
  }
  T Qm[M][M], Qux_m[M][NH], tQu_m[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int b = 0; b < M; ++b)
      Qm[a][b] = (a == b) ? ((Quu[a][b] + regs) * am[a]) * am[b] + act[a]
                          : (Quu[a][b] * am[a]) * am[b];
#pragma unroll
    for (int i = 0; i < NH; ++i) Qux_m[a][i] = Qux[a][i] * am[a];
    tQu_m[a] = tQu[a] * am[a];
  }

  T inv[M][M];
  if constexpr (M == 1) {
    inv[0][0] = T(1) / Qm[0][0];
  } else {
    inv2(Qm[0][0], Qm[0][1], Qm[1][0], Qm[1][1], inv);
  }

  T K[M][NH], kf[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = inv[a][0] * Qux_m[0][i];
#pragma unroll
      for (int b = 1; b < M; ++b) s = s + inv[a][b] * Qux_m[b][i];
      K[a][i] = -s;
    }
    T s = inv[a][0] * tQu_m[0];
#pragma unroll
    for (int b = 1; b < M; ++b) s = s + inv[a][b] * tQu_m[b];
    kf[a] = -s;
    kffout[(static_cast<size_t>(k) * M + a) * Bs + lane] = kf[a];
#pragma unroll
    for (int i = 0; i < NH; ++i)
      Kout[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] = K[a][i];
  }

  T tv_new[NH], vxx_new[NH][NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    T s = Qxu[i][0] * kf[0];
#pragma unroll
    for (int a = 1; a < M; ++a) s = s + Qxu[i][a] * kf[a];
    tv_new[i] = tQx[i] + s;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T t = Qxu[i][0] * K[0][j];
#pragma unroll
      for (int a = 1; a < M; ++a) t = t + Qxu[i][a] * K[a][j];
      vxx_new[i][j] = Qxx[i][j] + t;
    }
  }
  rescale_carry<NH, LEAN>(tv_new, vxx_new, tv, vxx, logs);
}

// The systems whose K3/K5 take sbwd_step's LEAN phase B.
template <int SYS> constexpr bool SBWD_LEAN = SYS == DOUBLE_INTEGRATOR || SYS == CARTPOLE;

// sbwd_kernel's sweep for the cart-pole (CARTPOLE_OWN): its own phase A (cartpole_lin) and
// sbwd_step's LEAN phase B. It and cartpole_lin are functions of their own, as sfwd_wide
// (lane_sfwd.cu), so that the other systems' K3/K5 compile from the text they had.
template <typename S, bool GENERIC, bool UPPER, typename T>
__device__ __forceinline__ void sbwd_cartpole(
    const Consts& p, const T* __restrict__ gX, const T* __restrict__ gU,
    const T* __restrict__ gXN, const T* __restrict__ U, const T* __restrict__ X,
    const T* __restrict__ Xr, const T* __restrict__ C, const T* __restrict__ XN,
    const T* __restrict__ XrN, T* __restrict__ Kout, T* __restrict__ kffout,
    T* __restrict__ tVx_out, T* __restrict__ Vxx_out, T* __restrict__ LogS_out, int N, int B,
    T* smem) {
  constexpr int NH = S::NH, M = S::M;
  const int lane = blockIdx.x * 32 + (threadIdx.x & 31);
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);

  T c[S::NC];
#pragma unroll
  for (int r = 0; r < S::NC; ++r) c[r] = live ? C[r * Bs + lane] : T(0);
  T tv[NH], vxx[NH][NH];
  T logs = T(0);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    if (!live) {
      tv[i] = T(0);
    } else if constexpr (UPPER) {
      tv[i] = gXN[i * Bs + lane];
    } else {
      tv[i] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
  }
  const T reg0 = T(p.reg), dt = T(p.dt);
  sweep<true, SBWD_ROWS<S, UPPER>>(
      N, live, smem,
      [&](int k, T* row) { cartpole_lin<S, UPPER>(p, gX, gU, U, X, Xr, c, k, Bs, lane, row); },
      [&](int k, const T* row) {
        sbwd_step<S, GENERIC, UPPER, SBWD_LEAN<CARTPOLE>>(row, c, reg0, dt, tv, vxx, logs, Kout,
                                                          kffout, tVx_out, Vxx_out, LogS_out, k,
                                                          Bs, lane);
      });
}

// sbwd_step on the split sweep (lane_common.cuh, sweep_split) for the part `part` of a
// lane: its rows i = part + SPLIT_PARTS r of the carry (tv, vxx) and of the step's
// products, the exchange area at xch[r * 32]; cd[r] = c[i], cu[a] = c[n̂ + a]. Every
// value is sbwd_step's, by the same operations in the same order.
template <typename S, bool GENERIC, bool UPPER, typename T>
__device__ __forceinline__ void sbwd_step_split(
    const T* __restrict__ row, T* __restrict__ xch, int part, unsigned group,
    const T cd[SPLIT_ROWS<S::NH>], const T cu[S::M], T reg0, T tv[SPLIT_ROWS<S::NH>],
    T vxx[SPLIT_ROWS<S::NH>][S::NH], T& logs, T* __restrict__ Kout, T* __restrict__ kffout,
    T* __restrict__ tVx_out, T* __restrict__ Vxx_out, T* __restrict__ LogS_out, int k,
    size_t Bs, int lane) {
  constexpr int NH = S::NH, M = S::M, RP = SPLIT_ROWS<NH>;
  auto A = [&](int q, int j) { return row[(q * NH + j) * 32]; };
  auto Bm = [&](int q, int a) { return row[(ROW_BM<S> + q * M + a) * 32]; };
  auto VA = [&](int q, int j) { return xch[(q * NH + j) * 32]; };
  auto VB = [&](int q, int a) { return xch[(XCH_VB<S> + q * M + a) * 32]; };
  auto TV = [&](int j) { return xch[(XCH_VX<S> + j) * 32]; };
  auto Kx = [&](int a, int j) { return xch[(XCH_K<S> + a * NH + j) * 32]; };
  if constexpr (GENERIC) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      const int i = part + SPLIT_PARTS * r;
      if (i < NH) {
        tVx_out[(static_cast<size_t>(k) * NH + i) * Bs + lane] = tv[r];
#pragma unroll
        for (int j = 0; j < NH; ++j)
          Vxx_out[(static_cast<size_t>(k) * (NH * NH) + i * NH + j) * Bs + lane] = vxx[r][j];
      }
    }
    if (part == 0) LogS_out[static_cast<size_t>(k) * Bs + lane] = logs;
  }
  const T inv_s = m_exp(-logs);
#pragma unroll
  for (int r = 0; r < RP; ++r) {   // this part's rows of V A, V Bm and the carry tV_x
    const int i = part + SPLIT_PARTS * r;
    T va[NH], vb[M];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = vxx[r][0] * A(0, j);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + vxx[r][l] * A(l, j);
      va[j] = s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = vxx[r][0] * Bm(0, a);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + vxx[r][l] * Bm(l, a);
      vb[a] = s;
    }
    if (i < NH) {
#pragma unroll
      for (int j = 0; j < NH; ++j) xch[(i * NH + j) * 32] = va[j];
#pragma unroll
      for (int a = 0; a < M; ++a) xch[(XCH_VB<S> + i * M + a) * 32] = vb[a];
      xch[(XCH_VX<S> + i) * 32] = tv[r];
    }
  }
  __syncwarp(group);

  // this part's rows of Q_xx, Q_xu and tQ_x, and its columns of Q_ux
  T Qxx[RP][NH], Qxu[RP][M], tQx[RP], Qux[M][RP];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int i = part + SPLIT_PARTS * r < NH ? part + SPLIT_PARTS * r : NH - 1;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = A(0, i) * VA(0, j);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + A(l, i) * VA(l, j);
      Qxx[r][j] = (i == j) ? cd[r] * inv_s + s : s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = A(0, i) * VB(0, a);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + A(l, i) * VB(l, a);
      Qxu[r][a] = s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = Bm(0, a) * VA(0, i);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + Bm(l, a) * VA(l, i);
      Qux[a][r] = s;
    }
    T s = A(0, i) * TV(0);
#pragma unroll
    for (int l = 1; l < NH; ++l) s = s + A(l, i) * TV(l);
    tQx[r] = row[(ROW_G<S> + i) * 32] * inv_s + s;
  }
  T Quu[M][M], tQu[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int b = 0; b < M; ++b) {
      T s = Bm(0, a) * VB(0, b);
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + Bm(l, a) * VB(l, b);
      Quu[a][b] = (a == b) ? cu[a] * inv_s + s : s;
    }
    T s = Bm(0, a) * TV(0);
#pragma unroll
    for (int l = 1; l < NH; ++l) s = s + Bm(l, a) * TV(l);
    if constexpr (UPPER) {
      tQu[a] = row[(ROW_GU<S> + a) * 32] * inv_s + s;
    } else {
      tQu[a] = s;
    }
  }
  const T regs = reg0 * inv_s;

  T am[M], act[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    am[a] = row[(ROW_AM<S> + a) * 32];
    act[a] = T(1) - am[a];
  }
  T Qm[M][M], Qux_m[M][RP], tQu_m[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int b = 0; b < M; ++b)
      Qm[a][b] = (a == b) ? ((Quu[a][b] + regs) * am[a]) * am[b] + act[a]
                          : (Quu[a][b] * am[a]) * am[b];
#pragma unroll
    for (int r = 0; r < RP; ++r) Qux_m[a][r] = Qux[a][r] * am[a];
    tQu_m[a] = tQu[a] * am[a];
  }

  T inv[M][M];
  if constexpr (M == 1) {
    inv[0][0] = T(1) / Qm[0][0];
  } else {
    inv2(Qm[0][0], Qm[0][1], Qm[1][0], Qm[1][1], inv);
  }

  T K[M][RP], kf[M];   // this part's columns of K
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      T s = inv[a][0] * Qux_m[0][r];
#pragma unroll
      for (int b = 1; b < M; ++b) s = s + inv[a][b] * Qux_m[b][r];
      K[a][r] = -s;
    }
    T s = inv[a][0] * tQu_m[0];
#pragma unroll
    for (int b = 1; b < M; ++b) s = s + inv[a][b] * tQu_m[b];
    kf[a] = -s;
    if (part == 0) kffout[(static_cast<size_t>(k) * M + a) * Bs + lane] = kf[a];
  }
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int i = part + SPLIT_PARTS * r;
    if (i < NH) {
#pragma unroll
      for (int a = 0; a < M; ++a) {
        Kout[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] = K[a][r];
        xch[(XCH_K<S> + a * NH + i) * 32] = K[a][r];
      }
    }
  }
  __syncwarp(group);

  T tv_new[RP], vxx_new[RP][NH];
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    T s = Qxu[r][0] * kf[0];
#pragma unroll
    for (int a = 1; a < M; ++a) s = s + Qxu[r][a] * kf[a];
    tv_new[r] = tQx[r] + s;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T t = Qxu[r][0] * Kx(0, j);
#pragma unroll
      for (int a = 1; a < M; ++a) t = t + Qxu[r][a] * Kx(a, j);
      vxx_new[r][j] = Qxx[r][j] + t;
    }
  }
  rescale_split<NH>(part, group, tv_new, vxx_new, tv, vxx, logs);
}

// K3/K5 on the split sweep (n̂ > 5).
template <typename S, bool GENERIC, bool UPPER, typename T>
__device__ __forceinline__ void sbwd_split(
    const Consts& p, const T* __restrict__ gX, const T* __restrict__ gU,
    const T* __restrict__ gXN, const T* __restrict__ U, const T* __restrict__ X,
    const T* __restrict__ Xr, const T* __restrict__ C, const T* __restrict__ XN,
    const T* __restrict__ XrN, T* __restrict__ Kout, T* __restrict__ kffout,
    T* __restrict__ tVx_out, T* __restrict__ Vxx_out, T* __restrict__ LogS_out, int N, int B,
    T* smem) {
  constexpr int NH = S::NH, M = S::M, RP = SPLIT_ROWS<NH>, ROWS = SBWD_ROWS<S, UPPER>;
  const size_t Bs = static_cast<size_t>(B);
  const int lane_a = blockIdx.x * 32 + (threadIdx.x & 31);
  const int lane = blockIdx.x * 32 + split_lane();
  const int part = split_part();
  const unsigned group = split_group();
  const bool live = threadIdx.x < 32 * SPLIT_CW && lane < B;   // a phase-B thread's
  T cd[RP], cu[M], tv[RP], vxx[RP][NH];
  T logs = T(0);
#pragma unroll
  for (int a = 0; a < M; ++a) cu[a] = live ? C[(NH + a) * Bs + lane] : T(0);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const int i = part + SPLIT_PARTS * r;
    const bool own = live && i < NH;
    cd[r] = own ? C[i * Bs + lane] : T(0);
    if (!own) {
      tv[r] = T(0);
    } else if constexpr (UPPER) {
      tv[r] = gXN[i * Bs + lane];
    } else {
      tv[r] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
    }
    const T term = own ? C[(NH + M + i) * Bs + lane] : T(0);
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[r][j] = (i == j) ? term : T(0);
  }
  const T reg0 = T(p.reg);
  T* xch = smem + 2 * SPLIT_KC * ROWS * 32 + split_lane();
  sweep_split<ROWS>(
      N, lane_a < B, live, smem,
      [&](int k, T* row) {
        T c[S::NC];
#pragma unroll
        for (int r = 0; r < S::NC; ++r) c[r] = C[r * Bs + lane_a];
        sbwd_lin<S, UPPER>(p, gX, gU, U, X, Xr, c, k, Bs, lane_a, row);
      },
      [&](int k, const T* row) {
        sbwd_step_split<S, GENERIC, UPPER>(row, xch, part, group, cd, cu, reg0, tv, vxx, logs,
                                           Kout, kffout, tVx_out, Vxx_out, LogS_out, k, Bs,
                                           lane);
      });
}

template <typename T, bool GENERIC, bool UPPER, int SYS, int NOBS>
__global__ void __launch_bounds__(System<T, SYS, NOBS>::NH > 5 ? SPLIT_THREADS : SWEEP_THREADS,
                                  SweepBlocksPerSM<T, System<T, SYS, NOBS>::NH>::value)
sbwd_kernel(const T* __restrict__ gX, const T* __restrict__ gU, const T* __restrict__ gXN,
            const T* __restrict__ U, const T* __restrict__ X, const T* __restrict__ Xr,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            T* __restrict__ Kout, T* __restrict__ kffout, T* __restrict__ tVx_out,
            T* __restrict__ Vxx_out, T* __restrict__ LogS_out, int N, int B, Consts p) {
  using S = System<T, SYS, NOBS>;
  constexpr int NH = S::NH, M = S::M;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (CARTPOLE_OWN<S>) {
    sbwd_cartpole<S, GENERIC, UPPER>(p, gX, gU, gXN, U, X, Xr, C, XN, XrN, Kout, kffout,
                                     tVx_out, Vxx_out, LogS_out, N, B,
                                     reinterpret_cast<T*>(smem));
    return;
  }
  if constexpr (NH > 5) {
    sbwd_split<S, GENERIC, UPPER>(p, gX, gU, gXN, U, X, Xr, C, XN, XrN, Kout, kffout, tVx_out,
                                  Vxx_out, LogS_out, N, B, reinterpret_cast<T*>(smem));
  } else {
    const int lane = blockIdx.x * 32 + (threadIdx.x & 31);
    const bool live = lane < B;
    const size_t Bs = static_cast<size_t>(B);

    T c[S::NC];
#pragma unroll
    for (int r = 0; r < S::NC; ++r) c[r] = live ? C[r * Bs + lane] : T(0);
    T tv[NH], vxx[NH][NH];
    T logs = T(0);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      if (!live) {
        tv[i] = T(0);
      } else if constexpr (UPPER) {
        tv[i] = gXN[i * Bs + lane];
      } else {
        tv[i] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
      }
#pragma unroll
      for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
    }
    const T reg0 = T(p.reg), dt = T(p.dt);
    sweep<true, SBWD_ROWS<S, UPPER>>(
        N, live, reinterpret_cast<T*>(smem),
        [&](int k, T* row) { sbwd_lin<S, UPPER>(p, gX, gU, U, X, Xr, c, k, Bs, lane, row); },
        [&](int k, const T* row) {
          sbwd_step<S, GENERIC, UPPER, SBWD_LEAN<SYS>>(row, c, reg0, dt, tv, vxx, logs, Kout,
                                                       kffout, tVx_out, Vxx_out, LogS_out, k,
                                                       Bs, lane);
        });
  }
}

template <typename T, bool GENERIC, bool UPPER>
int launch_sbwd(const void* gX, const void* gU, const void* gXN, const void* U, const void* X,
                const void* Xr, const void* C, const void* XN, const void* XrN, void* K,
                void* kff, void* tVx, void* Vxx, void* LogS, int N, int B, const Consts* p,
                void* stream) {
  // Two buffers: Dubins' 30 rows f32 23,040 bytes, f64 46,080; 32 rows (UPPER) f64
  // 49,152; the quadrotor's split sweep two buffers of two steps of 72 rows (74 with
  // UPPER) and the exchange's 84, f32 47,616 (48,640), f64 95,232 (97,280) (allow_smem).
  return with_system(*p, [&](auto nobs) {
    constexpr int NOBS = decltype(nobs)::value;
    using S = System<T, LANE_SYSTEM, NOBS>;
    if constexpr (S::LINEAR) {
      if (!linear_dt<T>(p->dt)) return static_cast<int>(cudaErrorInvalidValue);
    }
    if constexpr (CARTPOLE_LITERALS<S>) {
      if (!cartpole_consts<T>(*p)) return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int smem = S::NH > 5 ? split_smem<T, SBWD_ROWS<S, UPPER>, XCH_ROWS<S>>()
                                   : sweep_smem<T, SBWD_ROWS<S, UPPER>>();
    const dim3 grid((B + 31) / 32);
    const auto kernel = sbwd_kernel<T, GENERIC, UPPER, LANE_SYSTEM, NOBS>;
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, S::NH > 5 ? SPLIT_THREADS : SWEEP_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(gX), static_cast<const T*>(gU), static_cast<const T*>(gXN),
        static_cast<const T*>(U), static_cast<const T*>(X), static_cast<const T*>(Xr),
        static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
        static_cast<T*>(K), static_cast<T*>(kff), static_cast<T*>(tVx),
        static_cast<T*>(Vxx), static_cast<T*>(LogS), N, B, *p);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace lane

// C entry points, one per variant and type: the tensors in the order of the
// Python wrapper (ops/cuda/lane_sensitivity.py), then N, B, the constants and
// the stream. Each returns cudaGetLastError() after the launch.
#define LANE_SBWD_ENTRIES(T, SUFFIX)                                                          \
  int lane_sbwd_##SUFFIX(const void* U, const void* X, const void* Xr, const void* C,         \
                         const void* XN, const void* XrN, void* K, void* kff, int N, int B,   \
                         const lane::Consts* p, void* stream) {                               \
    return lane::launch_sbwd<T, false, false>(nullptr, nullptr, nullptr, U, X, Xr, C, XN,     \
                                              XrN, K, kff, nullptr, nullptr, nullptr, N, B,   \
                                              p, stream);                                     \
  }
#define LANE_SBWD_GENERIC_ENTRIES(T, SUFFIX)                                                  \
  int lane_sbwd_generic_##SUFFIX(const void* U, const void* X, const void* Xr, const void* C, \
                                 const void* XN, const void* XrN, void* K, void* kff,         \
                                 void* tVx, void* Vxx, void* LogS, int N, int B,              \
                                 const lane::Consts* p, void* stream) {                       \
    return lane::launch_sbwd<T, true, false>(nullptr, nullptr, nullptr, U, X, Xr, C, XN, XrN, \
                                             K, kff, tVx, Vxx, LogS, N, B, p, stream);        \
  }                                                                                           \
  int lane_sbwd_upper_##SUFFIX(const void* gX, const void* gU, const void* gXN,               \
                               const void* U, const void* X, const void* C, void* K,          \
                               void* kff, void* tVx, void* Vxx, void* LogS, int N, int B,     \
                               const lane::Consts* p, void* stream) {                         \
    return lane::launch_sbwd<T, true, true>(gX, gU, gXN, U, X, nullptr, C, nullptr, nullptr,  \
                                            K, kff, tVx, Vxx, LogS, N, B, p, stream);         \
  }

extern "C" {
LANE_SBWD_ENTRIES(float, f32)
LANE_SBWD_ENTRIES(double, f64)
LANE_SBWD_GENERIC_ENTRIES(float, f32)
LANE_SBWD_GENERIC_ENTRIES(double, f64)
}  // extern "C"
