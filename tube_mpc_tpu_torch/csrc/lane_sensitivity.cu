// The lane sensitivity on Hopper: K3/K5 (backward delta-z sweep) and K4/K6
// (forward delta rollout fused with the weight gradients), each a template over
// the static flags of its Pallas kernel.
//
// sbwd_kernel<T, GENERIC, UPPER> replaces
// tube_mpc_tpu/ops/pallas/lane_sensitivity.py::_sbwd_kernel: the backward sweep
// with active-set elimination. UPPER=false builds the tube upper gradient
// g_x = 2 (x - x_ref), g_u = 0 in-kernel; UPPER=true reads caller-supplied rows
// gX, gU (at k) and gXN (terminal) instead (custom_upper). GENERIC=true also
// writes, at each k, the carry the step starts from, i.e. the value function at
// k+1 in its scaled form: tV_x, V_xx, LogS (at k = N-1 the terminal
// initialisation). Instantiated: <false, false> (K3, paper), <true, false> (K5,
// the ancillary sweep), <true, true> (K5, the coupled nominal sweep).
//
// sfwd_kernel<T, GENERIC, EMIT> replaces lane_sensitivity.py::_sfwd_kernel: the
// forward delta rollout with the closed-form gradients gQ/gqb = sum 2 (x - x_ref) dx
// and gR = sum 2 (u - u_ref) dv. GENERIC=true adds the terminal term to gxt (not
// gx) and accumulates gdyn = sum_k dlam_{k+1} . d f̂/d(alpha, gamma, tight) with
// dlam_{k+1} = exp(LogS) (tV_x + V_xx dx+), from the rows the generic K5 wrote;
// the parameter derivatives come from the FLin the step already builds for dx+
// (lane_common.cuh::fhat_dparams). EMIT=true (emit_ref_grads) also writes the
// reference cotangents -C dx, -C dv at each k and -C_N dx_N. Instantiated:
// <false, false> (K4, paper), <true, false> (K6, the nominal sweep), <true, true>
// (K6, the ancillary sweep of the coupled chain).
//
// Design: one thread per lane with the k loop inside the thread, as in
// lane_solver.cu; the carry (tV_x, V_xx, LogS in sbwd; dx and the gradient sums
// in sfwd) stays in registers. The flags are compile-time, so the paper
// instantiations hold the same arithmetic, in the same loop, as before the
// variants existed.
//
// What bounds it on an H100: per lane and step K3 reads 10 values and writes
// 10 (80 bytes in f32), K4 reads 22 (88 bytes); K5 writes 21 more (the carry),
// 84 bytes, and with UPPER reads gX, gU in place of Xr, 2 values more; K6 reads
// those 21 and writes 6 more with EMIT. A sweep at B=16384, N=50 moves 66 MB
// (K3), 72 MB (K4), 134-141 MB (K5), 141-161 MB (K6): 20-48 us at 3.35 TB/s. K3's and K5's some 2,900
// operations per lane and step (the six Jacobian columns) take ~36 us at the f32
// peak. As in K1 and K2, one thread per lane leaves one warp per scheduler at
// B=16384, so latency, not bandwidth, sets the time (chip_smoke.py measures it;
// PERF.md keeps the numbers with the card they came from). K4 and K6 need only
// one tangent of f̂ per step, K3 and K5 six.
// A later change could spread the Jacobian columns over threads, or fuse the
// forward sweep into the backward sweep's launch to save one launch per step.
#include "lane_common.cuh"

namespace lane {

template <typename T, bool GENERIC, bool UPPER>
__global__ void __launch_bounds__(THREADS)
sbwd_kernel(const T* __restrict__ gX, const T* __restrict__ gU, const T* __restrict__ gXN,
            const T* __restrict__ U, const T* __restrict__ X, const T* __restrict__ Xr,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            T* __restrict__ Kout, T* __restrict__ kffout, T* __restrict__ tVx_out,
            T* __restrict__ Vxx_out, T* __restrict__ LogS_out, int N, int B, Consts p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  T c[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) c[r] = C[r * Bs + lane];
  const T alpha = c[ROW_ALPHA], gamma = c[ROW_ALPHA + 1], tight = c[ROW_ALPHA + 2];
  const T reg0 = T(p.reg);

  T tv[NH], vxx[NH][NH];
  T logs = T(0);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    if constexpr (UPPER) {
      tv[i] = gXN[i * Bs + lane];
    } else {
      tv[i] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
  }

  for (int k = N - 1; k >= 0; --k) {
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
    const T inv_s = m_exp(-logs);
    T xs[NH], gx[NH], us[M];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
      if constexpr (UPPER) {
        gx[i] = gX[(static_cast<size_t>(k) * NH + i) * Bs + lane] * inv_s;
      } else {
        gx[i] = (T(2) * (xs[i] - Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane])) * inv_s;
      }
    }
#pragma unroll
    for (int a = 0; a < M; ++a) us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];

    FLin<T> L;
    fhat_lin(p, xs, us, alpha, gamma, tight, L);
    T A[NH][NH], Bm[NH][M];
    fhat_jac(p, L, A, Bm);

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
        tQu[a] = gU[(static_cast<size_t>(k) * M + a) * Bs + lane] * inv_s + s;
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

    // Active set: a control within active_tol of a bound is eliminated
    // (identity row and column, zero gains).
    T am[M], act[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      am[a] = (us[a] <= T(p.act_lo[a]) || us[a] >= T(p.act_hi[a])) ? T(0) : T(1);
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
    inv2(Qm[0][0], Qm[0][1], Qm[1][0], Qm[1][1], inv);

    T K[M][NH], kf[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int i = 0; i < NH; ++i) K[a][i] = -(inv[a][0] * Qux_m[0][i] + inv[a][1] * Qux_m[1][i]);
      kf[a] = -(inv[a][0] * tQu_m[0] + inv[a][1] * tQu_m[1]);
      kffout[(static_cast<size_t>(k) * M + a) * Bs + lane] = kf[a];
#pragma unroll
      for (int i = 0; i < NH; ++i)
        Kout[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] = K[a][i];
    }

    T tv_new[NH], vxx_new[NH][NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      tv_new[i] = tQx[i] + (Qxu[i][0] * kf[0] + Qxu[i][1] * kf[1]);
#pragma unroll
      for (int j = 0; j < NH; ++j)
        vxx_new[i][j] = Qxx[i][j] + (Qxu[i][0] * K[0][j] + Qxu[i][1] * K[1][j]);
    }
    rescale_carry(tv_new, vxx_new, tv, vxx, logs);
  }
}

template <typename T, bool GENERIC, bool EMIT>
__global__ void __launch_bounds__(THREADS)
sfwd_kernel(const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ X,
            const T* __restrict__ Xr, const T* __restrict__ U, const T* __restrict__ Ur,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            const T* __restrict__ tVx, const T* __restrict__ Vxx, const T* __restrict__ LogS,
            T* __restrict__ gx_out, T* __restrict__ gr_out, T* __restrict__ gxt_out,
            T* __restrict__ gdyn_out, T* __restrict__ gxr_out, T* __restrict__ gur_out,
            T* __restrict__ gxrN_out, int N, int B, Consts p) {
  static_assert(GENERIC || !EMIT, "the reference cotangents come with the generic sweep only");
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  const T alpha = C[ROW_ALPHA * Bs + lane];
  const T gamma = C[(ROW_ALPHA + 1) * Bs + lane];
  const T tight = C[(ROW_ALPHA + 2) * Bs + lane];

  T dx[NH], gx[NH], gr[M];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    dx[i] = T(0);
    gx[i] = T(0);
  }
#pragma unroll
  for (int a = 0; a < M; ++a) gr[a] = T(0);
  T gdyn[3] = {T(0), T(0), T(0)};

  for (int k = 0; k < N; ++k) {
    T xs[NH], xr[NH], us[M], ur[M], dv[M];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
      xr[i] = Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      us[a] = U[(static_cast<size_t>(k) * M + a) * Bs + lane];
      ur[a] = Ur[(static_cast<size_t>(k) * M + a) * Bs + lane];
      T s = Kg[(static_cast<size_t>(k) * (M * NH) + a * NH) * Bs + lane] * dx[0];
#pragma unroll
      for (int i = 1; i < NH; ++i)
        s = s + Kg[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] * dx[i];
      dv[a] = kff[(static_cast<size_t>(k) * M + a) * Bs + lane] + s;
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) gx[i] = gx[i] + (T(2) * (xs[i] - xr[i])) * dx[i];
#pragma unroll
    for (int a = 0; a < M; ++a) gr[a] = gr[a] + (T(2) * (us[a] - ur[a])) * dv[a];
    if constexpr (EMIT) {
      // C holds the doubled weights (2Q.., 2qb | 2R): g_Xref = -2Q dx, g_Uref = -2R dv
#pragma unroll
      for (int i = 0; i < NH; ++i)
        gxr_out[(static_cast<size_t>(k) * NH + i) * Bs + lane] = (-C[i * Bs + lane]) * dx[i];
#pragma unroll
      for (int a = 0; a < M; ++a)
        gur_out[(static_cast<size_t>(k) * M + a) * Bs + lane] = (-C[(NH + a) * Bs + lane]) * dv[a];
    }

    FLin<T> L;
    fhat_lin(p, xs, us, alpha, gamma, tight, L);
    T dxn[NH];
    fhat_tan(p, L, dx, dv, dxn);
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
      const T s_k1 = m_exp(LogS[static_cast<size_t>(k) * Bs + lane]);
      T dlam[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        T s = Vxx[(static_cast<size_t>(k) * (NH * NH) + i * NH) * Bs + lane] * dxn[0];
#pragma unroll
        for (int j = 1; j < NH; ++j)
          s = s + Vxx[(static_cast<size_t>(k) * (NH * NH) + i * NH + j) * Bs + lane] * dxn[j];
        dlam[i] = s_k1 * (tVx[(static_cast<size_t>(k) * NH + i) * Bs + lane] + s);
      }
      T fp[3][NH];
      fhat_dparams(p, L, alpha, xs[NH - 1], fp[0], fp[1], fp[2]);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T s = dlam[0] * fp[r][0];
#pragma unroll
        for (int i = 1; i < NH; ++i) s = s + dlam[i] * fp[r][i];
        gdyn[r] = gdyn[r] + s;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NH; ++i) gx_out[i * Bs + lane] = gx[i];
#pragma unroll
  for (int a = 0; a < M; ++a) gr_out[a * Bs + lane] = gr[a];
  if constexpr (GENERIC) {
#pragma unroll
    for (int r = 0; r < 3; ++r) gdyn_out[r * Bs + lane] = gdyn[r];
  }
}

template <typename T, bool GENERIC, bool UPPER>
int launch_sbwd(const void* gX, const void* gU, const void* gXN, const void* U, const void* X,
                const void* Xr, const void* C, const void* XN, const void* XrN, void* K,
                void* kff, void* tVx, void* Vxx, void* LogS, int N, int B, const Consts* p,
                void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sbwd_kernel<T, GENERIC, UPPER><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gX), static_cast<const T*>(gU), static_cast<const T*>(gXN),
      static_cast<const T*>(U), static_cast<const T*>(X), static_cast<const T*>(Xr),
      static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
      static_cast<T*>(K), static_cast<T*>(kff), static_cast<T*>(tVx), static_cast<T*>(Vxx),
      static_cast<T*>(LogS), N, B, *p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GENERIC, bool EMIT>
int launch_sfwd(const void* K, const void* kff, const void* X, const void* Xr, const void* U,
                const void* Ur, const void* C, const void* XN, const void* XrN, const void* tVx,
                const void* Vxx, const void* LogS, void* gx, void* gr, void* gxt, void* gdyn,
                void* gxr, void* gur, void* gxrN, int N, int B, const Consts* p, void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sfwd_kernel<T, GENERIC, EMIT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(X),
      static_cast<const T*>(Xr), static_cast<const T*>(U), static_cast<const T*>(Ur),
      static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
      static_cast<const T*>(tVx), static_cast<const T*>(Vxx), static_cast<const T*>(LogS),
      static_cast<T*>(gx), static_cast<T*>(gr), static_cast<T*>(gxt), static_cast<T*>(gdyn),
      static_cast<T*>(gxr), static_cast<T*>(gur), static_cast<T*>(gxrN), N, B, *p);
  return static_cast<int>(cudaGetLastError());
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
  }                                                                                           \
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

#define LANE_SFWD_ENTRIES(T, SUFFIX)                                                          \
  int lane_sfwd_##SUFFIX(const void* K, const void* kff, const void* X, const void* Xr,       \
                         const void* U, const void* Ur, const void* C, const void* XN,        \
                         const void* XrN, void* gx, void* gr, int N, int B,                   \
                         const lane::Consts* p, void* stream) {                               \
    return lane::launch_sfwd<T, false, false>(K, kff, X, Xr, U, Ur, C, XN, XrN, nullptr,      \
                                              nullptr, nullptr, gx, gr, nullptr, nullptr,     \
                                              nullptr, nullptr, nullptr, N, B, p, stream);    \
  }                                                                                           \
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
LANE_SBWD_ENTRIES(float, f32)
LANE_SBWD_ENTRIES(double, f64)
LANE_SFWD_ENTRIES(float, f32)
LANE_SFWD_ENTRIES(double, f64)
}  // extern "C"
