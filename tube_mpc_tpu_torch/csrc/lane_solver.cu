// K1 and K2 of the lane iLQR solver on Hopper, for the system LANE_SYSTEM
// (lane_common.cuh: Dubins by default; the double integrator, the quadrotor and the
// cart-pole in libraries of their own, and each with the exact min or the log barrier
// in libraries of their own, ops/cuda/_build.py).
//
// K1 ric_kernel replaces tube_mpc_tpu/ops/pallas/lane_solver.py::_ric_kernel:
// the backward Riccati sweep with f̂'s Jacobians formed in-kernel.
// K2 fwd_kernel replaces tube_mpc_tpu/ops/pallas/lane_solver.py::_fwd_kernel:
// the line search over the alpha ladder.
//
// What bounds them on an H100 (Dubins, B=16384, N=50, f32; chip_smoke.py prints each
// system's bounds from its own shapes). Per lane and step K1 reads 12
// values and writes 10 (88 bytes): 73 MB a sweep, 22 us at 3.35 TB/s. It also does
// some 3,000 operations per lane and step, nearly all of them the linearisation
// (fhat_lin and the six tangents of fhat_jac): 2.5e9 a sweep, 37 us at the card's
// f32 peak, which pairs a multiply and an add into one FMA, and 75 us at the half
// rate this kernel can reach, built with -fmad=false to round as its plain version
// does. So K1 is bound by operations. Only the Riccati algebra, some 500 operations per
// lane and step, depends on the carry from step k+1. K2 reads 22 values per lane
// and step and writes 6 per candidate, 256 bytes with seven: 212 MB a sweep, 63 us;
// its operations take less, so K2 is bound by bytes. Both are sequential in k per
// lane, so the chain of one lane's N steps also bounds each from below.
//
// K1: linearise in parallel, recurse in one warp, the two overlapped: the chunked
// sweep of lane_common.cuh (sweep), backwards from k = N-1.
// - Phase A linearises a chunk: for each (step, lane) it writes A (n̂² rows), Bm
//   (n̂m), lx (n̂) and lu (m): 30 rows for Dubins, 72 for the quadrotor, 36 for the
//   cart-pole, 14 for the double integrator (only A's and Bm's barrier rows: LINEAR,
//   below). These rows depend on the step's X, U, Xr, Ur and C alone, so the serial
//   chain loses the linearisation, nearly all of the operations.
// - Phase B, in warp 0, runs the recursion over a chunk with its carry (V_x, V_xx,
//   LogS) in registers, and writes K and kff.
// - Without the overlap (phase A in every warp, then phase B) the blocks, which all
//   do the same work, run in lockstep: while warp 0 recurses, the other warps of
//   every block on the SM wait.
// - The obstacle count is a template parameter (lane_common.cuh, HLin), so phase A
//   is straight-line code the compiler can schedule; the launcher instantiates the
//   kernel for the problem's count. With one control (the cart-pole) Q_uu's inverse
//   is 1 / (Q_uu + reg), as the JAX kernel writes it, without resolve-or-zero.
// - Phase A takes most of the time, and the overlap hides little of phase B: the
//   warps of both share each SM's dispatch slots. The f32 register cap (SweepBlocksPerSM)
//   costs 36 bytes of spill at 5 obstacles, nearly all in phase A. tools/ric_probe.py
//   times each phase alone, other chunk sizes and caps, and places the spills.
// K1 above n̂ = 5 (the quadrotor's n̂ = 7): phase B bounds it. Its recursion is O(n̂³),
// some 2,500 operations a lane and step, and its 7x7 carry and Q blocks need 241
// registers; at two f32 blocks an SM (255 registers) B=16384 ran in two waves with one
// chain warp in four. tools/ric_probe.py --family quadrotor2d (PERF.md §6, PR 12): phase
// B alone took 0.418 ms of the kernel's 0.476 (N=50), phase A alone 0.185; four blocks an
// SM at 128 registers, with 312 bytes of spill, 0.314 ms, 1.28 ms at N=200 against 1.91.
// K3/K5's split sweep (lane_common.cuh, sweep_split: two threads share each lane's
// chain) ran K1 at 0.353 ms and 1.58 ms, slower than that, so K1 keeps this sweep with
// SweepBlocksPerSM's four f32 blocks above n̂ = 5 too.
// The cart-pole's K1 (n̂ = 5, m = 1) is bound by issue slots (tools/ric_probe.py --family
// cartpole; PERF.md §6): some 1,000 instructions a lane and step in phase A (43
// IEEE divisions) and 1,100 in phase B, and the two phases alone take 0.049 and 0.042 ms
// of the kernel's 0.085 at N=50: the chain, which sets the pace, shares its scheduler with
// phase A. More phase-A warps, other chunk sizes and caps, and the chain warp moved by its
// slot lost or gained at most 5%; what helps is fewer instructions on the chain, so its
// phase B is LEAN (ric_step): rescale_carry's maximum by max.NaN as a tree, its multiplies
// by 1 and log(1) skipped by a warp where no lane rescales, and exp(-LogS) by one where
// LogS is 0 on every lane, each with the same values.
// The double integrator's K1 (n̂ = 5, m = 2; tools/ric_probe.py --family double_integrator,
// PERF.md §6): its step is linear, so rows 0..3 of A and Bm are the constants 0, 1 and dt
// at every point (lane_common.cuh, LINEAR). Phase A stores only the barrier rows, lx and
// lu, 14 rows a step where there were 42, and phase B takes the others as literals: 28
// shared-memory loads and the products with 1 go, every other product stays in its sum
// in its order, so the values are those of the stored rows. Phase B alone fell from
// 0.069 to 0.048 ms at N=50 and phase A (0.063 alone) sets the pace, so phase A forms its
// balanced-equality factors by select (SelectFactors), and phase B is LEAN.
// The arithmetic and its order are those of the plain version
// (ops/cuda/lane_solver.py::ric_plain, whose two phases are these); only where each
// value is computed differs.
//
// K2: one thread per (lane, candidate). A block is 32 lanes by nα candidates, so a
// warp is 32 lanes of one candidate and its stores of Xn, Un and cost are
// coalesced; the per-step inputs the candidates share (Xo, Uo, K, kff, Xr, Ur) are
// read by the nα warps of a block, one from DRAM and the others from L1. With fewer
// than four candidates a block takes more lanes, so the rollout (nα = 1, two
// launches per closed-loop step) keeps one thread per lane in blocks of 128. A
// thread loads step k+1's inputs before it computes step k, so their latency
// leaves the chain. The barrier value at the next state is carried into the next
// step as the barrier at the current state (lane_common.cuh::fhat_carry), so each
// step evaluates h once, not twice. The quadrotor's candidates share their step inputs
// through shared memory instead (fwd_staged_kernel). chip_smoke.py measures each
// kernel's time beside its bound; PERF.md keeps the numbers with the card they
// came from.
#include "lane_common.cuh"

namespace lane {

template <typename S> constexpr int ROW_LX = JAC_ROWS<S>;       // rows of a step in shared
template <typename S> constexpr int ROW_LU = ROW_LX<S> + S::NH;  //   memory: A, Bm, lx, lu
template <typename S> constexpr int LIN_ROWS = ROW_LU<S> + S::M;

// Phase A for step k of one lane: f̂'s Jacobian rows and the cost gradients, at
// row[r * 32] for row r.
template <typename S, typename T>
__device__ __forceinline__ void lin_step(const Consts& p, const T* __restrict__ X,
                                         const T* __restrict__ U, const T* __restrict__ Xr,
                                         const T* __restrict__ Ur, const T c[S::NC], int k,
                                         size_t Bs, int lane, T* row) {
  constexpr int NH = S::NH, M = S::M;
  T xs[NH], xr[NH], us[M], ur[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
    xr[i] = Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane];
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
    ur[a] = Ur[(static_cast<size_t>(k) * M + a) * Bs + lane];
  }
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
  for (int i = 0; i < NH; ++i) row[(ROW_LX<S> + i) * 32] = c[i] * (xs[i] - xr[i]);
#pragma unroll
  for (int a = 0; a < M; ++a) row[(ROW_LU<S> + a) * 32] = c[NH + a] * (us[a] - ur[a]);
}

// Phase B for step k of one lane: K and kff from the step's rows (row[r * 32]) and
// the carry, which it advances to step k. Every sum over the controls runs a = 0..m-1
// left to right, as the reference's. LEAN: rescale_carry's, and exp(-LogS) = 1 not
// computed where LogS is 0 on every lane of the warp (LogS only grows from 0).
template <typename S, bool LEAN, typename T>
__device__ __forceinline__ void ric_step(const T* row, const T c[S::NC], T reg0, T dt,
                                         T vx[S::NH], T vxx[S::NH][S::NH], T& logs,
                                         T* __restrict__ Kout, T* __restrict__ kffout, int k,
                                         size_t Bs, int lane) {
  constexpr int NH = S::NH, M = S::M;
  T A[NH][NH], Bm[NH][M], lx[NH], lu[M];
  if constexpr (S::LINEAR) {
    load_jac_linear<S>(row, dt, A, Bm);
  } else {
    load_jac<S>(row, A, Bm);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) lx[i] = row[(ROW_LX<S> + i) * 32];
#pragma unroll
  for (int a = 0; a < M; ++a) lu[a] = row[(ROW_LU<S> + a) * 32];
  const T inv_s = (LEAN && !__any_sync(__activemask(), logs != T(0))) ? T(1) : m_exp(-logs);
  T Qx[NH], Qu[M], VA[NH][NH], VB[NH][M], Qxx[NH][NH], Qux[M][NH], Quu[M][M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    T s = A[0][i] * vx[0];
#pragma unroll
    for (int j = 1; j < NH; ++j) s = s + A[j][i] * vx[j];
    Qx[i] = lx[i] * inv_s + s;
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    T s = Bm[0][a] * vx[0];
#pragma unroll
    for (int j = 1; j < NH; ++j) s = s + Bm[j][a] * vx[j];
    Qu[a] = lu[a] * inv_s + s;
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = vxx[i][0] * A[0][j];
#pragma unroll
      for (int q = 1; q < NH; ++q) s = s + vxx[i][q] * A[q][j];
      VA[i][j] = s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = vxx[i][0] * Bm[0][a];
#pragma unroll
      for (int q = 1; q < NH; ++q) s = s + vxx[i][q] * Bm[q][a];
      VB[i][a] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T s = A[0][i] * VA[0][j];
#pragma unroll
      for (int q = 1; q < NH; ++q) s = s + A[q][i] * VA[q][j];
      Qxx[i][j] = (i == j) ? c[i] * inv_s + s : s;
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = Bm[0][a] * VA[0][i];
#pragma unroll
      for (int q = 1; q < NH; ++q) s = s + Bm[q][a] * VA[q][i];
      Qux[a][i] = s;
    }
#pragma unroll
    for (int b = 0; b < M; ++b) {
      T s = Bm[0][a] * VB[0][b];
#pragma unroll
      for (int q = 1; q < NH; ++q) s = s + Bm[q][a] * VB[q][b];
      Quu[a][b] = (a == b) ? c[NH + a] * inv_s + s : s;
    }
  }
  const T reg = reg0 * inv_s;

  T inv[M][M];
  if constexpr (M == 1) {
    inv[0][0] = T(1) / (Quu[0][0] + reg);
  } else {
    inv2(Quu[0][0] + reg, Quu[0][1], Quu[1][0], Quu[1][1] + reg, inv);
  }

  T K[M][NH], kf[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = inv[a][0] * Qux[0][i];
#pragma unroll
      for (int b = 1; b < M; ++b) s = s + inv[a][b] * Qux[b][i];
      K[a][i] = -s;
    }
    T s = inv[a][0] * Qu[0];
#pragma unroll
    for (int b = 1; b < M; ++b) s = s + inv[a][b] * Qu[b];
    kf[a] = -s;
    kffout[(static_cast<size_t>(k) * M + a) * Bs + lane] = kf[a];
#pragma unroll
    for (int i = 0; i < NH; ++i)
      Kout[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] = K[a][i];
  }

  T Quu_k[M], QuuK[M][NH];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    T s = Quu[a][0] * kf[0];
#pragma unroll
    for (int b = 1; b < M; ++b) s = s + Quu[a][b] * kf[b];
    Quu_k[a] = s;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T t = Quu[a][0] * K[0][j];
#pragma unroll
      for (int b = 1; b < M; ++b) t = t + Quu[a][b] * K[b][j];
      QuuK[a][j] = t;
    }
  }
  T vx_new[NH], vxx_new[NH][NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    T s1 = K[0][i] * (Quu_k[0] + Qu[0]), s2 = Qux[0][i] * kf[0];
#pragma unroll
    for (int a = 1; a < M; ++a) {
      s1 = s1 + K[a][i] * (Quu_k[a] + Qu[a]);
      s2 = s2 + Qux[a][i] * kf[a];
    }
    vx_new[i] = (Qx[i] + s1) + s2;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      T t1 = K[0][i] * QuuK[0][j], t2 = K[0][i] * Qux[0][j], t3 = Qux[0][i] * K[0][j];
#pragma unroll
      for (int a = 1; a < M; ++a) {
        t1 = t1 + K[a][i] * QuuK[a][j];
        t2 = t2 + K[a][i] * Qux[a][j];
        t3 = t3 + Qux[a][i] * K[a][j];
      }
      vxx_new[i][j] = ((Qxx[i][j] + t1) + t2) + t3;
    }
  }
  rescale_carry<NH, LEAN>(vx_new, vxx_new, vx, vxx, logs);
}

// The cart-pole's and the double integrator's K1 take ric_step's LEAN phase B (PERF.md §6).
template <int SYS> constexpr bool RIC_LEAN = SYS == CARTPOLE || SYS == DOUBLE_INTEGRATOR;

template <typename T, int SYS, int NOBS>
__global__ void __launch_bounds__(SWEEP_THREADS,
                                  SweepBlocksPerSM<T, System<T, SYS, NOBS>::NH>::value)
ric_kernel(const T* __restrict__ X, const T* __restrict__ U, const T* __restrict__ Xr,
           const T* __restrict__ Ur, const T* __restrict__ C, const T* __restrict__ phix,
           T* __restrict__ Kout, T* __restrict__ kffout, int N, int B, Consts p) {
  using S = System<T, SYS, NOBS>;
  constexpr int NH = S::NH, M = S::M;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x * 32 + (threadIdx.x & 31);
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);

  T c[S::NC];
#pragma unroll
  for (int r = 0; r < S::NC; ++r) c[r] = live ? C[r * Bs + lane] : T(0);
  T vx[NH], vxx[NH][NH];
  T logs = T(0);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    vx[i] = live ? phix[i * Bs + lane] : T(0);
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
  }
  const T reg0 = T(p.reg), dt = T(p.dt);
  sweep<true, LIN_ROWS<S>>(
      N, live, reinterpret_cast<T*>(smem),
      [&](int k, T* row) { lin_step<S>(p, X, U, Xr, Ur, c, k, Bs, lane, row); },
      [&](int k, const T* row) {
        ric_step<S, RIC_LEAN<SYS>>(row, c, reg0, dt, vx, vxx, logs, Kout, kffout, k, Bs, lane);
      });
}

// The inputs of step k that every candidate shares.
template <typename T, typename S> struct FwdStep {
  T xo[S::NH], xr[S::NH], uo[S::M], ur[S::M], kf[S::M], K[S::M][S::NH];
};

template <typename S, typename T>
__device__ __forceinline__ void fwd_load(FwdStep<T, S>& s, const T* __restrict__ Xo,
                                         const T* __restrict__ Uo, const T* __restrict__ Kg,
                                         const T* __restrict__ kff, const T* __restrict__ Xr,
                                         const T* __restrict__ Ur, int k, size_t Bs, int lane) {
  constexpr int NH = S::NH, M = S::M;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    s.xo[i] = Xo[(static_cast<size_t>(k) * NH + i) * Bs + lane];
    s.xr[i] = Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane];
  }
#pragma unroll
  for (int cc = 0; cc < M; ++cc) {
    s.uo[cc] = Uo[(static_cast<size_t>(k) * M + cc) * Bs + lane];
    s.ur[cc] = Ur[(static_cast<size_t>(k) * M + cc) * Bs + lane];
    s.kf[cc] = kff[(static_cast<size_t>(k) * M + cc) * Bs + lane];
#pragma unroll
    for (int i = 0; i < NH; ++i)
      s.K[cc][i] = Kg[(static_cast<size_t>(k) * (M * NH) + cc * NH + i) * Bs + lane];
  }
}

// threadIdx.y is the candidate. K2 has no barrier, so a thread past B returns.
template <typename T, int SYS, int NOBS>
__global__ void __launch_bounds__(32 * MAX_ALPHAS)
fwd_kernel(const T* __restrict__ x0, const T* __restrict__ Xo, const T* __restrict__ Uo,
           const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ Xr,
           const T* __restrict__ XrN, const T* __restrict__ Ur, const T* __restrict__ C,
           T* __restrict__ Xn, T* __restrict__ Un, T* __restrict__ cost, int N, int B, Consts p) {
  using S = System<T, SYS, NOBS>;
  constexpr int NH = S::NH, M = S::M;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int a = threadIdx.y;
  const int na = p.n_alphas;
  const size_t Bs = static_cast<size_t>(B);

  T c[S::NC];
#pragma unroll
  for (int r = 0; r < S::NC; ++r) c[r] = C[r * Bs + lane];
  const T alpha_b = c[S::ROW_ALPHA], gamma = c[S::ROW_ALPHA + 1], tight = c[S::ROW_ALPHA + 2];
  const T al = T(p.alphas[a]);

  T x[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) x[i] = x0[i * Bs + lane];
  T bc = barrier_at<S>(p, x, alpha_b, tight);
  T acc = T(0);

  FwdStep<T, S> s;
  fwd_load<S>(s, Xo, Uo, Kg, kff, Xr, Ur, 0, Bs, lane);
  // The quadrotor's rollout (its nα = 1: one warp a scheduler, bound by latency) with the
  // smooth-min and the inverse barrier unrolls the step loop twice, so that step k+1's
  // loads, sin and cos start while step k's barrier runs: 5.6% faster at N=50; with the
  // exact min and the log barrier it was 7.7% slower (PERF.md §6).
#if LANE_SYSTEM == 2 && LANE_AGG == 0 && LANE_BARRIER == 0   // QUADROTOR2D, SMOOTHMIN, INVERSE
#pragma unroll 2
#endif
  for (int k = 0; k < N; ++k) {
    FwdStep<T, S> next;   // step k+1's inputs (step k's again at the last step)
    fwd_load<S>(next, Xo, Uo, Kg, kff, Xr, Ur, k + 1 < N ? k + 1 : k, Bs, lane);

    T u[M];
#pragma unroll
    for (int cc = 0; cc < M; ++cc) {
      T d = s.K[cc][0] * (x[0] - s.xo[0]);
#pragma unroll
      for (int i = 1; i < NH; ++i) d = d + s.K[cc][i] * (x[i] - s.xo[i]);
      const T du = s.kf[cc] + d;
      u[cc] = jmin(T(p.u_max[cc]), jmax(T(p.u_min[cc]), s.uo[cc] + al * du));
    }
    T sx = (T(0.5) * c[0]) * ((x[0] - s.xr[0]) * (x[0] - s.xr[0]));
#pragma unroll
    for (int i = 1; i < NH; ++i)
      sx = sx + (T(0.5) * c[i]) * ((x[i] - s.xr[i]) * (x[i] - s.xr[i]));
    T su = (T(0.5) * c[NH]) * ((u[0] - s.ur[0]) * (u[0] - s.ur[0]));
#pragma unroll
    for (int cc = 1; cc < M; ++cc)
      su = su + (T(0.5) * c[NH + cc]) * ((u[cc] - s.ur[cc]) * (u[cc] - s.ur[cc]));
    acc = acc + (sx + su);

    T xn[NH];
    fhat_carry<S>(p, x, u, alpha_b, gamma, tight, bc, xn);
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      Xn[(static_cast<size_t>(k) * (na * NH) + a * NH + i) * Bs + lane] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int cc = 0; cc < M; ++cc)
      Un[(static_cast<size_t>(k) * (na * M) + a * M + cc) * Bs + lane] = u[cc];

    if (k == N - 1) {
      T term = (T(0.5) * c[NH + M]) * ((xn[0] - XrN[lane]) * (xn[0] - XrN[lane]));
#pragma unroll
      for (int i = 1; i < NH; ++i) {
        const T d = xn[i] - XrN[i * Bs + lane];
        term = term + (T(0.5) * c[NH + M + i]) * (d * d);
      }
      acc = acc + term;
    }
    s = next;
  }
  cost[a * Bs + lane] = acc;
}

// K2 for the quadrotor (n̂ = 7, m = 2) at nα >= FWD_STAGE_MIN: the step inputs that the
// candidates share (Xo, Xr, Uo, Ur, kff, K: FWD_ROWS = 34 rows a step) are copied once a
// block into shared memory, and every candidate warp reads them there.
// - fwd_kernel's candidate warps each load the 34 values through L1 (nα loads of each
//   where one is needed) and hold step k+1's in registers while they compute step k:
//   105 registers, three 192-thread blocks an SM at nα = 6, so B=16384's 512 blocks ran in
//   two waves, the second a third full, at 2.0x the byte bound (PERF.md §6).
// - Here the steps go in chunks of FWD_KC through a ring of FWD_BUFS chunks in shared
//   memory: while the block computes chunk j, the copies of chunk j+1 are in flight
//   (cp.async, which takes no registers). Warp a copies the steps a, a+nα, ... of a chunk,
//   each a row of 32 lanes at a time (coalesced). One __syncthreads a chunk, after the
//   thread's own copies of chunk j are waited for, makes all of them visible and frees the
//   buffer that chunk j+1 then refills (the one chunk j-1 was read from).
// - Without the prefetch registers the kernel takes 72 registers, four 192-thread f32
//   blocks an SM (FwdBlocksPerSM; 17,408 bytes of shared memory a block), so B=16384
//   runs in one wave. tools/ric_probe.py --family quadrotor2d times other chunks and rings:
//   larger ones were slower (four steps a chunk, three chunks: 1.13x at N=50).
// - The rollout (nα = 1, two launches a closed-loop step) keeps fwd_kernel, whose
//   one thread a lane in 128-lane blocks has no copies to share (staged, it was slower).
// The rollout of a candidate, its operations and their order are fwd_kernel's, so the
// outputs are bitwise its own and the plain version's.
constexpr int FWD_STAGE_MIN = 4;   // the least nα that takes fwd_staged_kernel
constexpr int FWD_KC = 2;          // steps a chunk
constexpr int FWD_BUFS = 2;        // chunks in the ring

template <typename S> constexpr int FWD_XR = S::NH;                 // rows of a step: Xo, Xr,
template <typename S> constexpr int FWD_UO = 2 * S::NH;             //   Uo, Ur, kff, K
template <typename S> constexpr int FWD_UR = FWD_UO<S> + S::M;
template <typename S> constexpr int FWD_KF = FWD_UR<S> + S::M;
template <typename S> constexpr int FWD_K = FWD_KF<S> + S::M;
template <typename S> constexpr int FWD_ROWS = FWD_K<S> + S::M * S::NH;

template <typename T> constexpr int fwd_smem(int rows) {
  return FWD_BUFS * FWD_KC * rows * 32 * static_cast<int>(sizeof(T));
}

// f32 blocks an SM of fwd_staged_kernel (f64 is not capped).
template <typename T> struct FwdBlocksPerSM {
  static constexpr int value = sizeof(T) == 4 ? 3 : 1;   // 3 of 256 threads: 4 of 192
};

// An asynchronous copy of one value from device memory into shared memory.
template <typename T> __device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}

// Copies step k's shared inputs of the lane into a step of the ring (row r at dst[r * 32]).
template <typename S, typename T>
__device__ __forceinline__ void fwd_stage(T* dst, const T* __restrict__ Xo,
                                          const T* __restrict__ Uo, const T* __restrict__ Kg,
                                          const T* __restrict__ kff, const T* __restrict__ Xr,
                                          const T* __restrict__ Ur, int k, size_t Bs, int lane) {
  constexpr int NH = S::NH, M = S::M;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    cp_async(dst + i * 32, Xo + (static_cast<size_t>(k) * NH + i) * Bs + lane);
    cp_async(dst + (FWD_XR<S> + i) * 32, Xr + (static_cast<size_t>(k) * NH + i) * Bs + lane);
  }
#pragma unroll
  for (int cc = 0; cc < M; ++cc) {
    cp_async(dst + (FWD_UO<S> + cc) * 32, Uo + (static_cast<size_t>(k) * M + cc) * Bs + lane);
    cp_async(dst + (FWD_UR<S> + cc) * 32, Ur + (static_cast<size_t>(k) * M + cc) * Bs + lane);
    cp_async(dst + (FWD_KF<S> + cc) * 32, kff + (static_cast<size_t>(k) * M + cc) * Bs + lane);
#pragma unroll
    for (int i = 0; i < NH; ++i)
      cp_async(dst + (FWD_K<S> + cc * NH + i) * 32,
               Kg + (static_cast<size_t>(k) * (M * NH) + cc * NH + i) * Bs + lane);
  }
}

// threadIdx.x is the lane of the block's 32, threadIdx.y the candidate. Every thread
// reaches every barrier; a lane past B copies and computes nothing.
template <typename T, int SYS, int NOBS>
__global__ void __launch_bounds__(32 * MAX_ALPHAS, FwdBlocksPerSM<T>::value)
fwd_staged_kernel(const T* __restrict__ x0, const T* __restrict__ Xo, const T* __restrict__ Uo,
                  const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ Xr,
                  const T* __restrict__ XrN, const T* __restrict__ Ur, const T* __restrict__ C,
                  T* __restrict__ Xn, T* __restrict__ Un, T* __restrict__ cost, int N, int B,
                  Consts p) {
  using S = System<T, SYS, NOBS>;
  constexpr int NH = S::NH, M = S::M, STEP = FWD_ROWS<S> * 32, CHUNK = FWD_KC * STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int l = threadIdx.x;
  const int a = threadIdx.y;
  const int na = p.n_alphas;
  const int lane = blockIdx.x * 32 + l;
  const bool live = lane < B;
  const size_t Bs = static_cast<size_t>(B);
  const int chunks = (N + FWD_KC - 1) / FWD_KC;

  // Chunk j into its buffer, one cp.async group a chunk (empty past the last).
  auto stage = [&](int j) {
    if (live && j < chunks) {
      const int k0 = j * FWD_KC, kn = N - k0 < FWD_KC ? N - k0 : FWD_KC;
      T* buf = ring + (j % FWD_BUFS) * CHUNK + l;
      for (int s = a; s < kn; s += na)
        fwd_stage<S>(buf + s * STEP, Xo, Uo, Kg, kff, Xr, Ur, k0 + s, Bs, lane);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int j = 0; j < FWD_BUFS - 1; ++j) stage(j);

  T c[NH + M + 3];   // stage diagonal, 2R, and alpha, gamma, tight; the terminal rows at the end
#pragma unroll
  for (int r = 0; r < NH + M; ++r) c[r] = live ? C[r * Bs + lane] : T(0);
#pragma unroll
  for (int r = 0; r < 3; ++r) c[NH + M + r] = live ? C[(S::ROW_ALPHA + r) * Bs + lane] : T(0);
  const T alpha_b = c[NH + M], gamma = c[NH + M + 1], tight = c[NH + M + 2];
  const T al = T(p.alphas[a]);

  T x[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) x[i] = live ? x0[i * Bs + lane] : T(0);
  T bc = barrier_at<S>(p, x, alpha_b, tight);
  T acc = T(0);

  for (int j = 0; j < chunks; ++j) {
    asm volatile("cp.async.wait_group %0;" ::"n"(FWD_BUFS - 2) : "memory");
    __syncthreads();
    stage(j + FWD_BUFS - 1);
    if (!live) continue;
    const int k0 = j * FWD_KC, kn = N - k0 < FWD_KC ? N - k0 : FWD_KC;
    const T* buf = ring + (j % FWD_BUFS) * CHUNK + l;
    for (int s = 0; s < kn; ++s) {
      const T* row = buf + s * STEP;
      const int k = k0 + s;
      T u[M];
#pragma unroll
      for (int cc = 0; cc < M; ++cc) {
        const T* Kr = row + (FWD_K<S> + cc * NH) * 32;
        T d = Kr[0] * (x[0] - row[0]);
#pragma unroll
        for (int i = 1; i < NH; ++i) d = d + Kr[i * 32] * (x[i] - row[i * 32]);
        const T du = row[(FWD_KF<S> + cc) * 32] + d;
        u[cc] = jmin(T(p.u_max[cc]), jmax(T(p.u_min[cc]), row[(FWD_UO<S> + cc) * 32] + al * du));
      }
      const T* xr = row + FWD_XR<S> * 32;
      T sx = (T(0.5) * c[0]) * ((x[0] - xr[0]) * (x[0] - xr[0]));
#pragma unroll
      for (int i = 1; i < NH; ++i)
        sx = sx + (T(0.5) * c[i]) * ((x[i] - xr[i * 32]) * (x[i] - xr[i * 32]));
      const T* ur = row + FWD_UR<S> * 32;
      T su = (T(0.5) * c[NH]) * ((u[0] - ur[0]) * (u[0] - ur[0]));
#pragma unroll
      for (int cc = 1; cc < M; ++cc)
        su = su + (T(0.5) * c[NH + cc]) * ((u[cc] - ur[cc * 32]) * (u[cc] - ur[cc * 32]));
      acc = acc + (sx + su);

      T xn[NH];
      fhat_carry<S>(p, x, u, alpha_b, gamma, tight, bc, xn);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        Xn[(static_cast<size_t>(k) * (na * NH) + a * NH + i) * Bs + lane] = xn[i];
        x[i] = xn[i];
      }
#pragma unroll
      for (int cc = 0; cc < M; ++cc)
        Un[(static_cast<size_t>(k) * (na * M) + a * M + cc) * Bs + lane] = u[cc];
    }
  }
  if (!live) return;
  const size_t term = static_cast<size_t>(NH + M) * Bs + lane;   // the terminal rows of C
  if (N > 0) {
    T t = (T(0.5) * C[term]) * ((x[0] - XrN[lane]) * (x[0] - XrN[lane]));
#pragma unroll
    for (int i = 1; i < NH; ++i) {
      const T d = x[i] - XrN[i * Bs + lane];
      t = t + (T(0.5) * C[term + i * Bs]) * (d * d);
    }
    acc = acc + t;
  }
  cost[a * Bs + lane] = acc;
}

template <typename T>
int launch_ric(const void* X, const void* U, const void* Xr, const void* Ur, const void* C,
               const void* phix, void* K, void* kff, int N, int B, const Consts* p,
               void* stream) {
  // Two buffers of LIN_ROWS rows a step: Dubins' f32 23,040 bytes and f64 46,080, within
  // the 48 KB a launch gets by default; the quadrotor's f64 110,592 (allow_smem).
  const dim3 grid((B + 31) / 32);
  return with_system(*p, [&](auto nobs) {
    constexpr int NOBS = decltype(nobs)::value;
    using S = System<T, LANE_SYSTEM, NOBS>;
    if constexpr (S::LINEAR) {
      if (!linear_dt<T>(p->dt)) return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int smem = sweep_smem<T, LIN_ROWS<S>>();
    const auto kernel = ric_kernel<T, LANE_SYSTEM, NOBS>;
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
    kernel<<<grid, SWEEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(X), static_cast<const T*>(U), static_cast<const T*>(Xr),
        static_cast<const T*>(Ur), static_cast<const T*>(C), static_cast<const T*>(phix),
        static_cast<T*>(K), static_cast<T*>(kff), N, B, *p);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_fwd(const void* x0, const void* Xo, const void* Uo, const void* K, const void* kff,
               const void* Xr, const void* XrN, const void* Ur, const void* C, void* Xn,
               void* Un, void* cost, int N, int B, const Consts* p, void* stream) {
  const int na = p->n_alphas;
  if (na < 1 || na > MAX_ALPHAS) return static_cast<int>(cudaErrorInvalidValue);
  return with_system(*p, [&](auto nobs) {
    constexpr int NOBS = decltype(nobs)::value;
    const auto s = static_cast<cudaStream_t>(stream);
    if constexpr (LANE_SYSTEM == QUADROTOR2D) {
      if (na >= FWD_STAGE_MIN) {
        constexpr int smem = fwd_smem<T>(FWD_ROWS<System<T, LANE_SYSTEM, NOBS>>);
        const auto kernel = fwd_staged_kernel<T, LANE_SYSTEM, NOBS>;
        const int err = allow_smem(kernel, smem);
        if (err != 0) return err;
        kernel<<<(B + 31) / 32, dim3(32, na), smem, s>>>(
            static_cast<const T*>(x0), static_cast<const T*>(Xo), static_cast<const T*>(Uo),
            static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(Xr),
            static_cast<const T*>(XrN), static_cast<const T*>(Ur), static_cast<const T*>(C),
            static_cast<T*>(Xn), static_cast<T*>(Un), static_cast<T*>(cost), N, B, *p);
        return static_cast<int>(cudaGetLastError());
      }
    }
    const int lanes = na >= 4 ? 32 : 32 * (4 / na);   // 32 x nα threads, at least 96
    const dim3 block(lanes, na);
    const dim3 grid((B + lanes - 1) / lanes);
    fwd_kernel<T, LANE_SYSTEM, NOBS><<<grid, block, 0, s>>>(
        static_cast<const T*>(x0), static_cast<const T*>(Xo), static_cast<const T*>(Uo),
        static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(Xr),
        static_cast<const T*>(XrN), static_cast<const T*>(Ur), static_cast<const T*>(C),
        static_cast<T*>(Xn), static_cast<T*>(Un), static_cast<T*>(cost), N, B, *p);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace lane

extern "C" {

int lane_ric_f32(const void* X, const void* U, const void* Xr, const void* Ur, const void* C,
                 const void* phix, void* K, void* kff, int N, int B, const lane::Consts* p,
                 void* stream) {
  return lane::launch_ric<float>(X, U, Xr, Ur, C, phix, K, kff, N, B, p, stream);
}

int lane_ric_f64(const void* X, const void* U, const void* Xr, const void* Ur, const void* C,
                 const void* phix, void* K, void* kff, int N, int B, const lane::Consts* p,
                 void* stream) {
  return lane::launch_ric<double>(X, U, Xr, Ur, C, phix, K, kff, N, B, p, stream);
}

int lane_fwd_f32(const void* x0, const void* Xo, const void* Uo, const void* K, const void* kff,
                 const void* Xr, const void* XrN, const void* Ur, const void* C, void* Xn,
                 void* Un, void* cost, int N, int B, const lane::Consts* p, void* stream) {
  return lane::launch_fwd<float>(x0, Xo, Uo, K, kff, Xr, XrN, Ur, C, Xn, Un, cost, N, B, p, stream);
}

int lane_fwd_f64(const void* x0, const void* Xo, const void* Uo, const void* K, const void* kff,
                 const void* Xr, const void* XrN, const void* Ur, const void* C, void* Xn,
                 void* Un, void* cost, int N, int B, const lane::Consts* p, void* stream) {
  return lane::launch_fwd<double>(x0, Xo, Uo, K, kff, Xr, XrN, Ur, C, Xn, Un, cost, N, B, p, stream);
}

}  // extern "C"
