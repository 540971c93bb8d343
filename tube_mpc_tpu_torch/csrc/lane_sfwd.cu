// K4/K6 of the lane sensitivity on Hopper: the forward delta rollout fused with the
// weight gradients, for the system LANE_SYSTEM (lane_common.cuh).
//
// sfwd_kernel<T, GENERIC, EMIT, SYS, NOBS> replaces
// tube_mpc_tpu/ops/pallas/lane_sensitivity.py::_sfwd_kernel: the rollout
// dv = kff + K dx, dx+ = the tangent of f̂ along (dx, dv), with the closed-form
// gradients gQ/gqb = sum 2 (x - x_ref) dx and gR = sum 2 (u - u_ref) dv. GENERIC=true
// adds the terminal term to gxt (not gx) and accumulates gdyn = sum_k dlam_{k+1} .
// d f̂/d(alpha, gamma, tight) with dlam_{k+1} = exp(LogS) (tV_x + V_xx dx+), from the
// rows the generic K5 wrote; the parameter derivatives come from the step's FLin
// (lane_common.cuh::fhat_dparams). EMIT=true (emit_ref_grads) also writes the
// reference cotangents -C dx, -C dv at each k and -C_N dx_N. Instantiated:
// <false, false> (K4, paper), <true, false> (K6, the nominal sweep), <true, true>
// (K6, the ancillary sweep of the coupled chain), each for 1 to 8 obstacles (NOBS,
// launched through with_system; the cart-pole's once), in every system's library.
//
// What bounds it on an H100 (Dubins, B=16384, N=50, f32): per lane and step K4 reads 22
// values, 72 MB a sweep; K6 reads the 21 carry rows K5 wrote and, with EMIT, writes 6
// more values. Its operations, one tangent of f̂ a step, take less time than those
// bytes, so every variant is bound by bytes (chip_smoke.py prints both bounds; PERF.md
// keeps the numbers with the card they came from).
//
// Design: the chunked sweep of lane_common.cuh, forwards. Only dx is carried from step
// to step. fhat_lin, which holds all the transcendentals (sin, cos, an exp per
// obstacle and a log in each of the two smooth-mins, the barriers' divisions or logs),
// and fhat_dparams depend on X, U and C alone.
// - Phase A writes, for each (step, lane), the fields of FLin that fhat_tan reads
//   (tan_rows: the step's own (Dubins 3, the double integrator none, the quadrotor 3,
//   the cart-pole 11), each h's (3 NOBS + 1 for the smooth-min, 2 NOBS for the min,
//   1 for the track limit) and each barrier's (6 inverse, 2 log), with the min chain's
//   weights and the barriers' factors already formed), 2 (x - x_ref) (n̂ rows),
//   2 (u - u_ref) (m) and, with GENERIC, the barrier rows of the three parameter
//   derivatives (3).
// - Phase B, in warp 0, runs fhat_tan on those fields with the same operations in the
//   same order, and the sums. It loads step k+1's K and kff while it computes step k,
//   as K2 does, and with GENERIC the step's carry rows before its tangent, though they
//   are used after it: a warp runs in program order, so a load whose value the step waits for
//   stalls every later step (PERF.md).
// Dubins at 5 obstacles has 53-56 rows a step: 41-43 KB of shared memory in f32 (four
// blocks an SM hold all 512 blocks of B=16384 in one wave); above 48 KB (f64, or 8
// obstacles with GENERIC, or the quadrotor's 50-74 rows) the launcher raises the
// block's dynamic shared memory limit (allow_smem).
// Longer chunks would cost that wave. Where the time goes (tools/ric_probe.py): K4's
// two phases take about as long each and overlap well; with GENERIC, phase B (the
// carry rows, dlam and the gdyn sums on top of the tangent) sets the time.
// Above n̂ = 5 (the quadrotor; sfwd_wide) K4 fit 122 registers, so four blocks an SM held
// B=16384 in one wave already, and phase A alone took 0.058 ms of its 0.086 at N=50: the
// linearisation's transcendentals and 16 IEEE divisions a step. With the balanced-equality
// factors by select phase A alone takes 0.038 and the chain in phase B, one warp a block
// beside three phase-A warps, sets K4's pace. K6 there took 168-188 registers, two blocks
// an SM and two waves; loading the tangent's fields where they are used fits it in 128,
// four blocks an SM (PERF.md §6).
// The double integrator's and the cart-pole's K4 (sfwd_staged) had their chain wait at each
// step for step k+1's gains from device memory; their gains and phase A's inputs now reach
// shared memory by cp.async a chunk ahead, so their chain reads no device memory.
// The arithmetic and its order are those of the plain version
// (ops/cuda/lane_sensitivity.py::sfwd_plain); only where each value is computed differs.
#include "lane_common.cuh"

namespace lane {

// Rows of a step in shared memory: the tangent's fields [0, TAN_ROWS) (the step's, then
// each h's and each barrier's), 2 (x - x_ref), 2 (u - u_ref), and with GENERIC the
// barrier rows of d f̂/d(alpha, gamma, tight).
template <typename S> constexpr int TAN_ROWS = S::ROWS + 2 * S::H::ROWS + 2 * S::Bar::ROWS;
template <typename S> constexpr int ROW_G2X = TAN_ROWS<S>;
template <typename S> constexpr int ROW_G2U = ROW_G2X<S> + S::NH;
template <typename S> constexpr int ROW_DP = ROW_G2U<S> + S::M;
template <typename S, bool GENERIC> constexpr int SFWD_ROWS = ROW_DP<S> + (GENERIC ? 3 : 0);

// Stores (STORE) or loads the fields of L that fhat_tan reads, but gamma:
// row[r * 32] for row r; a bool field as 1 or 0.
template <bool STORE, typename S, typename T, typename P>
__device__ __forceinline__ void tan_rows(FLin<T, S>& L, P row) {
  int r = 0;
  auto f = [&](auto& v) {
    if constexpr (std::is_same_v<std::remove_reference_t<decltype(v)>, bool>) {
      if constexpr (STORE) {
        row[r * 32] = v ? T(1) : T(0);
      } else {
        v = row[r * 32] != T(0);
      }
    } else if constexpr (STORE) {
      row[r * 32] = v;
    } else {
      v = row[r * 32];
    }
    ++r;
  };
  S::rows(L.f, f);
  S::H::rows(L.hc, f);
  S::H::rows(L.hn, f);
  S::Bar::rows(L.bc, f);
  S::Bar::rows(L.bn, f);
}

// Phase A for step k of one lane.
template <typename S, bool GENERIC, typename T>
__device__ __forceinline__ void sfwd_lin(const Consts& p, const T* __restrict__ X,
                                         const T* __restrict__ Xr, const T* __restrict__ U,
                                         const T* __restrict__ Ur, T alpha, T gamma, T tight,
                                         int k, size_t Bs, int lane, T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], us[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
  for (int a = 0; a < M; ++a) us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
  FLin<T, S> L;
  fhat_lin<S>(p, xs, us, alpha, gamma, tight, L);
  tan_rows<true>(L, row);
#pragma unroll
  for (int i = 0; i < NH; ++i)
    row[(ROW_G2X<S> + i) * 32] =
        T(2) * (xs[i] - Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane]);
#pragma unroll
  for (int a = 0; a < M; ++a)
    row[(ROW_G2U<S> + a) * 32] =
        T(2) * (us[a] - Ur[(static_cast<size_t>(k) * M + a) * Bs + lane]);
  if constexpr (GENERIC) {
    // Only the barrier row of d f̂/d(alpha, gamma, tight) depends on the point; phase
    // B puts the zeros of the other rows back into its sums.
    T fp[3][NH];
    fhat_dparams<S>(p, L, alpha, xs[S::NX], fp[0], fp[1], fp[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) row[(ROW_DP<S> + r) * 32] = fp[r][S::NX];
  }
}

// The gains of step k.
template <typename T, typename S> struct Gains {
  T K[S::M][S::NH], kf[S::M];
};

template <typename S, typename T>
__device__ __forceinline__ void load_gains(Gains<T, S>& g, const T* __restrict__ Kg,
                                           const T* __restrict__ kff, int k, size_t Bs,
                                           int lane) {
  constexpr int NH = S::NH, M = S::M;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    g.kf[a] = kff[(static_cast<size_t>(k) * M + a) * Bs + lane];
#pragma unroll
    for (int i = 0; i < NH; ++i)
      g.K[a][i] = Kg[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane];
  }
}

// K4/K6 take four f32 blocks an SM above n̂ = 5 too, as K1 and K3/K5 do (SweepBlocksPerSM):
// the quadrotor's K4 fits 110 registers, its K6 128 with 0-32 bytes of spill (sfwd_wide).
template <typename T, int NH> struct SfwdBlocksPerSM {
  static constexpr int value = NH <= 5 ? SweepBlocksPerSM<T, NH>::value : (sizeof(T) == 4 ? 4 : 1);
};

// ---------------------------------------------------------------------------
// K4/K6 above n̂ = 5 (the quadrotor, SFWD_WIDE): the sweep and the arithmetic of
// sfwd_kernel, with two changes that tools/ric_probe.py switches apart:
// - SFWD_SELECT: phase A forms its balanced-equality factors by select
//   (fhat_lin_select), 14 of its 16 IEEE divisions a step at four obstacles;
// - SFWD_LAZY: phase B loads the tangent's fields where fhat_tan uses them
//   (fhat_tan_rows), not all of FLin up front (tan_rows<false>), which takes K6 from
//   168-188 registers to 128 with a few bytes of spill, so four blocks an SM hold it.
// ---------------------------------------------------------------------------
template <int NH> constexpr bool SFWD_WIDE = NH > 5;
constexpr bool SFWD_SELECT = true;
constexpr bool SFWD_LAZY = true;

// Loads the fields of L, a part of FLin whose policy is P (a step, an h or a barrier), from
// row[r * 32] for r = first, first + 1, ..., as tan_rows<false> does.
template <typename P, typename Lin, typename T>
__device__ __forceinline__ void load_part(Lin& L, const T* row, int first) {
  int r = first;
  P::rows(L, [&](auto& v) {
    if constexpr (std::is_same_v<std::remove_reference_t<decltype(v)>, bool>) {
      v = row[r * 32] != T(0);
    } else {
      v = row[r * 32];
    }
    ++r;
  });
}

// fhat_tan on the fields that tan_rows stored, each part of FLin loaded where fhat_tan
// first uses it (the step's, then hn's and bn's, then hc's and bc's): the same operations
// in the same order.
template <typename S, typename T>
__device__ __forceinline__ void fhat_tan_rows(const Consts& p, const T* row, T gamma,
                                              const T dx[S::NH], const T du[S::M],
                                              T out[S::NH]) {
  constexpr int HC = S::ROWS, HN = HC + S::H::ROWS, BC = HN + S::H::ROWS;
  constexpr int BN = BC + S::Bar::ROWS;
  typename S::Lin f;
  load_part<S>(f, row, 0);
  S::tan(p, f, dx, du, out);
  typename S::H::Lin hn;
  typename S::Bar::Lin bn;
  load_part<typename S::H>(hn, row, HN);
  load_part<typename S::Bar>(bn, row, BN);
  const T dBn = S::Bar::tan(bn, S::H::tan(p, hn, out));
  typename S::H::Lin hc;
  typename S::Bar::Lin bc;
  load_part<typename S::H>(hc, row, HC);
  load_part<typename S::Bar>(bc, row, BC);
  const T dBc = S::Bar::tan(bc, S::H::tan(p, hc, dx));
  out[S::NX] = dBn - gamma * (dBc - dx[S::NX]);
}

// sfwd_lin with SFWD_SELECT's factors.
template <typename S, bool GENERIC, typename T>
__device__ __forceinline__ void sfwd_wide_lin(const Consts& p, const T* __restrict__ X,
                                              const T* __restrict__ Xr,
                                              const T* __restrict__ U,
                                              const T* __restrict__ Ur, T alpha, T gamma,
                                              T tight, int k, size_t Bs, int lane, T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], us[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
  for (int a = 0; a < M; ++a) us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
  FLin<T, S> L;
  if constexpr (SFWD_SELECT) {
    fhat_lin_select<S>(p, xs, us, alpha, gamma, tight, L);
  } else {
    fhat_lin<S>(p, xs, us, alpha, gamma, tight, L);
  }
  tan_rows<true>(L, row);
#pragma unroll
  for (int i = 0; i < NH; ++i)
    row[(ROW_G2X<S> + i) * 32] =
        T(2) * (xs[i] - Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane]);
#pragma unroll
  for (int a = 0; a < M; ++a)
    row[(ROW_G2U<S> + a) * 32] =
        T(2) * (us[a] - Ur[(static_cast<size_t>(k) * M + a) * Bs + lane]);
  if constexpr (GENERIC) {
    T fp[3][NH];
    fhat_dparams<S>(p, L, alpha, xs[S::NX], fp[0], fp[1], fp[2]);
#pragma unroll
    for (int r = 0; r < 3; ++r) row[(ROW_DP<S> + r) * 32] = fp[r][S::NX];
  }
}

// sfwd_kernel's body for SFWD_WIDE: the same values by the same operations in the same
// order. It is a function of its own so that the other systems' K4/K6 compile from
// sfwd_kernel's text as it was: edits inside that body moved the cart-pole's SASS.
template <typename S, bool GENERIC, bool EMIT, typename T>
__device__ __forceinline__ void sfwd_wide(
    const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ X,
    const T* __restrict__ Xr, const T* __restrict__ U, const T* __restrict__ Ur,
    const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
    const T* __restrict__ tVx, const T* __restrict__ Vxx, const T* __restrict__ LogS,
    T* __restrict__ gx_out, T* __restrict__ gr_out, T* __restrict__ gxt_out,
    T* __restrict__ gdyn_out, T* __restrict__ gxr_out, T* __restrict__ gur_out,
    T* __restrict__ gxrN_out, int N, int B, const Consts& p, T* smem) {
  constexpr int NH = S::NH, M = S::M;
  const int lane = blockIdx.x * 32 + (threadIdx.x & 31);
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);

  const T alpha = live ? C[S::ROW_ALPHA * Bs + lane] : T(0);
  const T gamma = live ? C[(S::ROW_ALPHA + 1) * Bs + lane] : T(0);
  const T tight = live ? C[(S::ROW_ALPHA + 2) * Bs + lane] : T(0);

  T dx[NH], gx[NH], gr[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    dx[i] = T(0);
    gx[i] = T(0);
  }
#pragma unroll
  for (int a = 0; a < M; ++a) gr[a] = T(0);
  T gdyn[3] = {T(0), T(0), T(0)};
  Gains<T, S> next;   // step k+1's gains, loaded while step k runs
  if (live) load_gains<S>(next, Kg, kff, 0, Bs, lane);

  sweep<false, SFWD_ROWS<S, GENERIC>>(
      N, live, smem,
      [&](int k, T* row) {
        sfwd_wide_lin<S, GENERIC>(p, X, Xr, U, Ur, alpha, gamma, tight, k, Bs, lane, row);
      },
      [&](int k, const T* row) {
        const Gains<T, S> g = next;
        load_gains<S>(next, Kg, kff, k + 1 < N ? k + 1 : k, Bs, lane);
        T tv_k[NH], vxx_k[NH][NH], logs_k;   // the carry rows, used after the tangent
        if constexpr (GENERIC) {
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            tv_k[i] = tVx[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
            for (int j = 0; j < NH; ++j)
              vxx_k[i][j] = Vxx[(static_cast<size_t>(k) * (NH * NH) + i * NH + j) * Bs + lane];
          }
          logs_k = LogS[static_cast<size_t>(k) * Bs + lane];
        }
        T dv[M];
#pragma unroll
        for (int a = 0; a < M; ++a) {
          T s = g.K[a][0] * dx[0];
#pragma unroll
          for (int i = 1; i < NH; ++i) s = s + g.K[a][i] * dx[i];
          dv[a] = g.kf[a] + s;
        }
#pragma unroll
        for (int i = 0; i < NH; ++i) gx[i] = gx[i] + row[(ROW_G2X<S> + i) * 32] * dx[i];
#pragma unroll
        for (int a = 0; a < M; ++a) gr[a] = gr[a] + row[(ROW_G2U<S> + a) * 32] * dv[a];
        if constexpr (EMIT) {
#pragma unroll
          for (int i = 0; i < NH; ++i)
            gxr_out[(static_cast<size_t>(k) * NH + i) * Bs + lane] = (-C[i * Bs + lane]) * dx[i];
#pragma unroll
          for (int a = 0; a < M; ++a)
            gur_out[(static_cast<size_t>(k) * M + a) * Bs + lane] =
                (-C[(NH + a) * Bs + lane]) * dv[a];
        }

        T dxn[NH];
        if constexpr (SFWD_LAZY) {
          fhat_tan_rows<S>(p, row, gamma, dx, dv, dxn);
        } else {
          FLin<T, S> L;
          L.gamma = gamma;
          tan_rows<false>(L, row);
          fhat_tan<S>(p, L, dx, dv, dxn);
        }
#pragma unroll
        for (int i = 0; i < NH; ++i) dx[i] = dxn[i];
        if (k == N - 1) {
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const T term = (T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane])) * dxn[i];
            if constexpr (GENERIC) {
              gxt_out[i * Bs + lane] = T(0) + term;
            } else {
              gx[i] = gx[i] + term;
            }
            if constexpr (EMIT) {
              gxrN_out[i * Bs + lane] = T(0) + (-C[(NH + M + i) * Bs + lane]) * dxn[i];
            }
          }
        }

        if constexpr (GENERIC) {
          const T s_k1 = m_exp(logs_k);
          T dlam[NH];
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            T s = vxx_k[i][0] * dxn[0];
#pragma unroll
            for (int j = 1; j < NH; ++j) s = s + vxx_k[i][j] * dxn[j];
            dlam[i] = s_k1 * (tv_k[i] + s);
          }
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            T fp[NH];
#pragma unroll
            for (int i = 0; i < S::NX; ++i) fp[i] = T(0);
            fp[S::NX] = row[(ROW_DP<S> + r) * 32];
            T s = dlam[0] * fp[0];
#pragma unroll
            for (int i = 1; i < NH; ++i) s = s + dlam[i] * fp[i];
            gdyn[r] = gdyn[r] + s;
          }
        }
      });

  if (live && threadIdx.x < 32) {   // warp 0 holds the sums
#pragma unroll
    for (int i = 0; i < NH; ++i) gx_out[i * Bs + lane] = gx[i];
#pragma unroll
    for (int a = 0; a < M; ++a) gr_out[a * Bs + lane] = gr[a];
    if constexpr (GENERIC) {
#pragma unroll
      for (int r = 0; r < 3; ++r) gdyn_out[r * Bs + lane] = gdyn[r];
    }
  }
}

// ---------------------------------------------------------------------------
// K4 of the double integrator and the cart-pole (SFWD_STAGED): sfwd_kernel's arithmetic on a
// sweep whose chain reads no device memory. On sfwd_kernel's own body their chain waited at
// each step for step k+1's gains, loaded from device memory while step k ran: ~1 µs a step
// at N=50, where the chain's arithmetic alone takes 0.4-0.6 µs (tools/ric_probe.py, PERF.md
// §6). Here
// - phase-A warp w owns steps w-1, w-1 + SWEEP_WARPS-1, ... of every chunk: a chunk ahead of
//   their linearisation it copies their inputs X, Xr, U, Ur into a ring of two stages in
//   shared memory by cp.async (4 or 8 bytes a lane and value, 32 lanes a row: coalesced;
//   lanes past B copy nothing), and while it linearises chunk j+1 from its stage, it copies
//   that chunk's gains K, kff into the chunk's rows beside the fields phase A writes; it
//   waits for the gains' group before the chunk's barrier, which makes them visible to the
//   chain, and for the inputs' before their linearisation;
// - the chain (warp 0) reads its gains, the tangent's fields and 2 (x - x_ref), 2 (u - u_ref)
//   from the rows, and the terminal 2 (x_N - x_ref,N) from rows warp 1 wrote before the first
//   barrier: its only device accesses are the final stores;
// - phase A forms its balanced-equality factors by select (SFWD_SELECT, fhat_lin_select).
// The values are sfwd_kernel's, by the same operations in the same order; only where each is
// loaded from differs. What bounds it now is the copies' stream: at N=50 f32 about 60% of the
// byte bound's rate, the bytes one chunk ahead being all a block has in flight (a third
// stage, copying the gains two chunks ahead, measured no faster). Shared memory (f32):
// 44.9 KB a block for the double integrator at 2 obstacles, 37.4 KB for the cart-pole, so
// four blocks an SM still hold B=16384 in one wave; f64 takes twice that, two or three
// blocks an SM, which costs the cart-pole's f64 K4 the one wave its own body had.
// ---------------------------------------------------------------------------
template <int SYS, bool GENERIC>
constexpr bool SFWD_STAGED = !GENERIC && (SYS == DOUBLE_INTEGRATOR || SYS == CARTPOLE);

// A staged step's rows: sfwd_kernel's, then its gains K [M NH] and kff [M] in the device
// arrays' order; its inputs in its stage: X, Xr [NH], U, Ur [M].
template <typename S> constexpr int ROW_GAINS = SFWD_ROWS<S, false>;
template <typename S> constexpr int STAGED_ROWS = ROW_GAINS<S> + S::M * S::NH + S::M;
template <typename S> constexpr int STAGED_IN = 2 * S::NH + 2 * S::M;

// Its dynamic shared memory: the rows [2][SWEEP_KC][STAGED_ROWS][32], the stages
// [2][SWEEP_KC][STAGED_IN][32] and the terminal rows [NH][32].
template <typename T, typename S> constexpr int staged_smem() {
  return (2 * SWEEP_KC * (STAGED_ROWS<S> + STAGED_IN<S>) + S::NH) * 32 *
         static_cast<int>(sizeof(T));
}

// One asynchronous copy of a T from device to shared memory; the group of the copies the
// thread issued since the last; the wait until at most its PENDING latest groups are not
// complete.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

// sfwd_lin on the inputs in the step's stage, st[r * 32].
template <typename S, typename T>
__device__ __forceinline__ void sfwd_staged_lin(const Consts& p, const T* st, T alpha, T gamma,
                                                T tight, T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], us[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) xs[i] = st[i * 32];
#pragma unroll
  for (int a = 0; a < M; ++a) us[a] = st[(2 * NH + a) * 32];
  FLin<T, S> L;
  if constexpr (SFWD_SELECT) {
    fhat_lin_select<S>(p, xs, us, alpha, gamma, tight, L);
  } else {
    fhat_lin<S>(p, xs, us, alpha, gamma, tight, L);
  }
  tan_rows<true>(L, row);
#pragma unroll
  for (int i = 0; i < NH; ++i) row[(ROW_G2X<S> + i) * 32] = T(2) * (xs[i] - st[(NH + i) * 32]);
#pragma unroll
  for (int a = 0; a < M; ++a)
    row[(ROW_G2U<S> + a) * 32] = T(2) * (us[a] - st[(2 * NH + M + a) * 32]);
}

template <typename S, typename T>
__device__ __forceinline__ void sfwd_staged(
    const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ X,
    const T* __restrict__ Xr, const T* __restrict__ U, const T* __restrict__ Ur,
    const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
    T* __restrict__ gx_out, T* __restrict__ gr_out, int N, int B, const Consts& p, T* smem) {
  constexpr int NH = S::NH, M = S::M, G = M * NH;
  constexpr int STEP = STAGED_ROWS<S> * 32, CHUNK = SWEEP_KC * STEP;
  constexpr int SSTEP = STAGED_IN<S> * 32, SCHUNK = SWEEP_KC * SSTEP;
  const int l = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * 32 + l;
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);
  T* const rows = smem;
  T* const stage = rows + 2 * CHUNK;
  T* const term = stage + 2 * SCHUNK;   // 2 (x_N - x_ref,N), row i at term[i * 32]
  const int chunks = (N + SWEEP_KC - 1) / SWEEP_KC;

  const T alpha = live ? C[S::ROW_ALPHA * Bs + lane] : T(0);
  const T gamma = live ? C[(S::ROW_ALPHA + 1) * Bs + lane] : T(0);
  const T tight = live ? C[(S::ROW_ALPHA + 2) * Bs + lane] : T(0);

  if (warp > 0) {   // phase A: the steps lo + t of each chunk, t = warp - 1, + SWEEP_WARPS - 1, ...
    auto copy_inputs = [&](int j) {   // into the stage (j & 1)
      for (int t = warp - 1; t < SWEEP_KC; t += SWEEP_WARPS - 1) {
        const int k = j * SWEEP_KC + t;
        if (!live || k >= N) return;
        T* st = stage + (j & 1) * SCHUNK + t * SSTEP + l;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          copy_async(st + i * 32, X + (static_cast<size_t>(k) * NH + i) * Bs + lane);
          copy_async(st + (NH + i) * 32, Xr + (static_cast<size_t>(k) * NH + i) * Bs + lane);
        }
#pragma unroll
        for (int a = 0; a < M; ++a) {
          copy_async(st + (2 * NH + a) * 32, U + (static_cast<size_t>(k) * M + a) * Bs + lane);
          copy_async(st + (2 * NH + M + a) * 32,
                     Ur + (static_cast<size_t>(k) * M + a) * Bs + lane);
        }
      }
    };
    auto copy_gains = [&](int j) {   // into the rows (j & 1)
      for (int t = warp - 1; t < SWEEP_KC; t += SWEEP_WARPS - 1) {
        const int k = j * SWEEP_KC + t;
        if (!live || k >= N) return;
        T* row = rows + (j & 1) * CHUNK + t * STEP + l;
#pragma unroll
        for (int r = 0; r < G; ++r)
          copy_async(row + (ROW_GAINS<S> + r) * 32,
                     Kg + (static_cast<size_t>(k) * G + r) * Bs + lane);
#pragma unroll
        for (int a = 0; a < M; ++a)
          copy_async(row + (ROW_GAINS<S> + G + a) * 32,
                     kff + (static_cast<size_t>(k) * M + a) * Bs + lane);
      }
    };
    auto linearise = [&](int j) {
      for (int t = warp - 1; t < SWEEP_KC; t += SWEEP_WARPS - 1) {
        const int k = j * SWEEP_KC + t;
        if (!live || k >= N) return;
        sfwd_staged_lin<S>(p, stage + (j & 1) * SCHUNK + t * SSTEP + l, alpha, gamma, tight,
                           rows + (j & 1) * CHUNK + t * STEP + l);
      }
    };
    // A group of copies for chunk 0, one for chunk 1's inputs; then in each chunk j one for
    // chunk j+1's gains, due at the chunk's barrier, and one for chunk j+2's inputs, due at
    // the next chunk's linearisation.
    copy_inputs(0);
    copy_gains(0);
    copy_commit();
    copy_inputs(1);
    copy_commit();
    if (warp == 1 && live) {
#pragma unroll
      for (int i = 0; i < NH; ++i)
        term[i * 32 + l] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
    }
    copy_wait<1>();
    linearise(0);
    sweep_sync();
    for (int j = 0; j < chunks; ++j) {   // chunk j+1's rows while the chain runs chunk j
      if (j + 1 < chunks) {
        copy_gains(j + 1);    // its rows were chunk j-1's, which the chain read before the barrier
        copy_commit();
        copy_inputs(j + 2);   // its stage was chunk j's, which this thread linearised
        copy_commit();
        copy_wait<2>();       // chunk j+1's inputs
        linearise(j + 1);
        copy_wait<1>();       // chunk j+1's gains
      }
      sweep_sync();
    }
    copy_wait<0>();
    return;
  }

  T dx[NH], gx[NH], gr[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    dx[i] = T(0);
    gx[i] = T(0);
  }
#pragma unroll
  for (int a = 0; a < M; ++a) gr[a] = T(0);
  auto chain = [&](int k, const T* row) {
    Gains<T, S> g;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      g.kf[a] = row[(ROW_GAINS<S> + G + a) * 32];
#pragma unroll
      for (int i = 0; i < NH; ++i) g.K[a][i] = row[(ROW_GAINS<S> + a * NH + i) * 32];
    }
    T dv[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = g.K[a][0] * dx[0];
#pragma unroll
      for (int i = 1; i < NH; ++i) s = s + g.K[a][i] * dx[i];
      dv[a] = g.kf[a] + s;
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) gx[i] = gx[i] + row[(ROW_G2X<S> + i) * 32] * dx[i];
#pragma unroll
    for (int a = 0; a < M; ++a) gr[a] = gr[a] + row[(ROW_G2U<S> + a) * 32] * dv[a];
    FLin<T, S> L;
    L.gamma = gamma;
    tan_rows<false>(L, row);
    T dxn[NH];
    fhat_tan<S>(p, L, dx, dv, dxn);
#pragma unroll
    for (int i = 0; i < NH; ++i) dx[i] = dxn[i];
    if (k == N - 1) {
#pragma unroll
      for (int i = 0; i < NH; ++i) gx[i] = gx[i] + term[i * 32 + l] * dxn[i];
    }
  };
  sweep_sync();
  for (int j = 0; j < chunks; ++j) {
    const int lo = j * SWEEP_KC, hi = lo + SWEEP_KC < N ? lo + SWEEP_KC : N;
    const T* buf = rows + (j & 1) * CHUNK + l;
    if (live)
      for (int k = lo; k < hi; ++k) chain(k, buf + (k - lo) * STEP);
    sweep_sync();
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NH; ++i) gx_out[i * Bs + lane] = gx[i];
#pragma unroll
    for (int a = 0; a < M; ++a) gr_out[a * Bs + lane] = gr[a];
  }
}

template <typename T, bool GENERIC, bool EMIT, int SYS, int NOBS>
__global__ void __launch_bounds__(SWEEP_THREADS,
                                  SfwdBlocksPerSM<T, System<T, SYS, NOBS>::NH>::value)
sfwd_kernel(const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ X,
            const T* __restrict__ Xr, const T* __restrict__ U, const T* __restrict__ Ur,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            const T* __restrict__ tVx, const T* __restrict__ Vxx, const T* __restrict__ LogS,
            T* __restrict__ gx_out, T* __restrict__ gr_out, T* __restrict__ gxt_out,
            T* __restrict__ gdyn_out, T* __restrict__ gxr_out, T* __restrict__ gur_out,
            T* __restrict__ gxrN_out, int N, int B, Consts p) {
  static_assert(GENERIC || !EMIT, "the reference cotangents come with the generic sweep only");
  using S = System<T, SYS, NOBS>;
  constexpr int NH = S::NH, M = S::M;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (SFWD_WIDE<NH>) {
    sfwd_wide<S, GENERIC, EMIT>(Kg, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS, gx_out,
                                gr_out, gxt_out, gdyn_out, gxr_out, gur_out, gxrN_out, N, B,
                                p, reinterpret_cast<T*>(smem));
    return;
  }
  if constexpr (SFWD_STAGED<SYS, GENERIC>) {
    sfwd_staged<S>(Kg, kff, X, Xr, U, Ur, C, XN, XrN, gx_out, gr_out, N, B, p,
                   reinterpret_cast<T*>(smem));
    return;
  }
  const int lane = blockIdx.x * 32 + (threadIdx.x & 31);
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);

  const T alpha = live ? C[S::ROW_ALPHA * Bs + lane] : T(0);
  const T gamma = live ? C[(S::ROW_ALPHA + 1) * Bs + lane] : T(0);
  const T tight = live ? C[(S::ROW_ALPHA + 2) * Bs + lane] : T(0);

  T dx[NH], gx[NH], gr[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    dx[i] = T(0);
    gx[i] = T(0);
  }
#pragma unroll
  for (int a = 0; a < M; ++a) gr[a] = T(0);
  T gdyn[3] = {T(0), T(0), T(0)};
  Gains<T, S> next;   // step k+1's gains, loaded while step k runs
  if (live) load_gains<S>(next, Kg, kff, 0, Bs, lane);

  sweep<false, SFWD_ROWS<S, GENERIC>>(
      N, live, reinterpret_cast<T*>(smem),
      [&](int k, T* row) {
        sfwd_lin<S, GENERIC>(p, X, Xr, U, Ur, alpha, gamma, tight, k, Bs, lane, row);
      },
      [&](int k, const T* row) {
        const Gains<T, S> g = next;
        load_gains<S>(next, Kg, kff, k + 1 < N ? k + 1 : k, Bs, lane);
        T tv_k[NH], vxx_k[NH][NH], logs_k;   // the carry rows, used after the tangent
        if constexpr (GENERIC) {
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            tv_k[i] = tVx[(static_cast<size_t>(k) * NH + i) * Bs + lane];
#pragma unroll
            for (int j = 0; j < NH; ++j)
              vxx_k[i][j] = Vxx[(static_cast<size_t>(k) * (NH * NH) + i * NH + j) * Bs + lane];
          }
          logs_k = LogS[static_cast<size_t>(k) * Bs + lane];
        }
        T dv[M];
#pragma unroll
        for (int a = 0; a < M; ++a) {
          T s = g.K[a][0] * dx[0];
#pragma unroll
          for (int i = 1; i < NH; ++i) s = s + g.K[a][i] * dx[i];
          dv[a] = g.kf[a] + s;
        }
#pragma unroll
        for (int i = 0; i < NH; ++i) gx[i] = gx[i] + row[(ROW_G2X<S> + i) * 32] * dx[i];
#pragma unroll
        for (int a = 0; a < M; ++a) gr[a] = gr[a] + row[(ROW_G2U<S> + a) * 32] * dv[a];
        if constexpr (EMIT) {
          // C holds the doubled weights (2Q.., 2qb | 2R): g_Xref = -2Q dx, g_Uref = -2R dv
#pragma unroll
          for (int i = 0; i < NH; ++i)
            gxr_out[(static_cast<size_t>(k) * NH + i) * Bs + lane] = (-C[i * Bs + lane]) * dx[i];
#pragma unroll
          for (int a = 0; a < M; ++a)
            gur_out[(static_cast<size_t>(k) * M + a) * Bs + lane] =
                (-C[(NH + a) * Bs + lane]) * dv[a];
        }

        FLin<T, S> L;
        L.gamma = gamma;
        tan_rows<false>(L, row);
        T dxn[NH];
        fhat_tan<S>(p, L, dx, dv, dxn);
#pragma unroll
        for (int i = 0; i < NH; ++i) dx[i] = dxn[i];
        if (k == N - 1) {
          // Terminal term: into gx (paper), into its own rows gxt (generic).
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const T term = (T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane])) * dxn[i];
            if constexpr (GENERIC) {
              gxt_out[i * Bs + lane] = T(0) + term;
            } else {
              gx[i] = gx[i] + term;
            }
            if constexpr (EMIT) {
              gxrN_out[i * Bs + lane] = T(0) + (-C[(NH + M + i) * Bs + lane]) * dxn[i];
            }
          }
        }

        if constexpr (GENERIC) {
          const T s_k1 = m_exp(logs_k);
          T dlam[NH];
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            T s = vxx_k[i][0] * dxn[0];
#pragma unroll
            for (int j = 1; j < NH; ++j) s = s + vxx_k[i][j] * dxn[j];
            dlam[i] = s_k1 * (tv_k[i] + s);
          }
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            T fp[NH];
#pragma unroll
            for (int i = 0; i < S::NX; ++i) fp[i] = T(0);
            fp[S::NX] = row[(ROW_DP<S> + r) * 32];
            T s = dlam[0] * fp[0];
#pragma unroll
            for (int i = 1; i < NH; ++i) s = s + dlam[i] * fp[i];
            gdyn[r] = gdyn[r] + s;
          }
        }
      });

  if (live && threadIdx.x < 32) {   // warp 0 holds the sums
#pragma unroll
    for (int i = 0; i < NH; ++i) gx_out[i * Bs + lane] = gx[i];
#pragma unroll
    for (int a = 0; a < M; ++a) gr_out[a * Bs + lane] = gr[a];
    if constexpr (GENERIC) {
#pragma unroll
      for (int r = 0; r < 3; ++r) gdyn_out[r * Bs + lane] = gdyn[r];
    }
  }
}

template <typename T, bool GENERIC, bool EMIT>
int launch_sfwd(const void* K, const void* kff, const void* X, const void* Xr, const void* U,
                const void* Ur, const void* C, const void* XN, const void* XrN, const void* tVx,
                const void* Vxx, const void* LogS, void* gx, void* gr, void* gxt, void* gdyn,
                void* gxr, void* gur, void* gxrN, int N, int B, const Consts* p, void* stream) {
  const dim3 grid((B + 31) / 32);
  return with_system(*p, [&](auto nobs) {
    constexpr int NOBS = decltype(nobs)::value;
    using S = System<T, LANE_SYSTEM, NOBS>;
    constexpr int smem = SFWD_STAGED<LANE_SYSTEM, GENERIC> ? staged_smem<T, S>()
                                                           : sweep_smem<T, SFWD_ROWS<S, GENERIC>>();
    const auto kernel = sfwd_kernel<T, GENERIC, EMIT, LANE_SYSTEM, NOBS>;
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, SWEEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(X),
        static_cast<const T*>(Xr), static_cast<const T*>(U), static_cast<const T*>(Ur),
        static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
        static_cast<const T*>(tVx), static_cast<const T*>(Vxx), static_cast<const T*>(LogS),
        static_cast<T*>(gx), static_cast<T*>(gr), static_cast<T*>(gxt), static_cast<T*>(gdyn),
        static_cast<T*>(gxr), static_cast<T*>(gur), static_cast<T*>(gxrN), N, B, *p);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace lane

// C entry points, one per variant and type: the tensors in the order of the
// Python wrapper (ops/cuda/lane_sensitivity.py), then N, B, the constants and
// the stream. Each returns cudaGetLastError() after the launch.
#define LANE_SFWD_ENTRIES(T, SUFFIX)                                                          \
  int lane_sfwd_##SUFFIX(const void* K, const void* kff, const void* X, const void* Xr,       \
                         const void* U, const void* Ur, const void* C, const void* XN,        \
                         const void* XrN, void* gx, void* gr, int N, int B,                   \
                         const lane::Consts* p, void* stream) {                               \
    return lane::launch_sfwd<T, false, false>(K, kff, X, Xr, U, Ur, C, XN, XrN, nullptr,      \
                                              nullptr, nullptr, gx, gr, nullptr, nullptr,     \
                                              nullptr, nullptr, nullptr, N, B, p, stream);    \
  }
#define LANE_SFWD_GENERIC_ENTRIES(T, SUFFIX)                                                  \
  int lane_sfwd_generic_##SUFFIX(const void* K, const void* kff, const void* X,               \
                                 const void* Xr, const void* U, const void* Ur,               \
                                 const void* C, const void* XN, const void* XrN,              \
                                 const void* tVx, const void* Vxx, const void* LogS,          \
                                 void* gx, void* gr, void* gxt, void* gdyn, int N, int B,     \
                                 const lane::Consts* p, void* stream) {                       \
    return lane::launch_sfwd<T, true, false>(K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx,      \
                                             LogS, gx, gr, gxt, gdyn, nullptr, nullptr,       \
                                             nullptr, N, B, p, stream);                       \
  }                                                                                           \
  int lane_sfwd_ref_##SUFFIX(const void* K, const void* kff, const void* X, const void* Xr,   \
                             const void* U, const void* Ur, const void* C, const void* XN,    \
                             const void* XrN, const void* tVx, const void* Vxx,               \
                             const void* LogS, void* gx, void* gr, void* gxt, void* gdyn,     \
                             void* gxr, void* gur, void* gxrN, int N, int B,                  \
                             const lane::Consts* p, void* stream) {                           \
    return lane::launch_sfwd<T, true, true>(K, kff, X, Xr, U, Ur, C, XN, XrN, tVx, Vxx, LogS, \
                                            gx, gr, gxt, gdyn, gxr, gur, gxrN, N, B, p,       \
                                            stream);                                          \
  }

extern "C" {
LANE_SFWD_ENTRIES(float, f32)
LANE_SFWD_ENTRIES(double, f64)
LANE_SFWD_GENERIC_ENTRIES(float, f32)
LANE_SFWD_GENERIC_ENTRIES(double, f64)
}  // extern "C"
