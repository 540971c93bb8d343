// K3 and K4 of the lane sensitivity on Hopper (paper variants).
//
// K3 sbwd_kernel replaces tube_mpc_tpu/ops/pallas/lane_sensitivity.py::_sbwd_kernel
// with generic=False, custom_upper=False: the backward delta-z sweep with
// active-set elimination and the tube upper gradient g_x = 2 (x - x_ref),
// g_u = 0 built in-kernel.
// K4 sfwd_kernel replaces tube_mpc_tpu/ops/pallas/lane_sensitivity.py::_sfwd_kernel
// with generic=False: the forward delta rollout fused with the closed-form
// weight gradients gQ/gqb = sum 2 (x - x_ref) dx (terminal included) and
// gR = sum 2 (u - u_ref) dv.
//
// Design: one thread per lane with the k loop inside the thread, as in
// lane_solver.cu; the carry (tV_x, V_xx, LogS in K3; dx and the gradient sums
// in K4) stays in registers.
//
// What bounds it on an H100: per lane and step K3 reads 10 values and writes
// 10 (80 bytes in f32), K4 reads 22 (88 bytes), so a sweep at B=16384, N=50
// moves 67 MB (K3) and 74 MB (K4): 20 us and 22 us at 3.35 TB/s; K3's some
// 2,900 operations per lane and step (the six Jacobian columns) take 36 us at
// the f32 peak. As in K1 and K2, one thread per lane leaves one warp per
// scheduler at B=16384, so latency, not bandwidth, sets the time (chip_smoke.py
// measures it; PERF.md keeps the numbers with the card they came from). K4
// needs only one tangent of f̂ per step, K3 six.
// A later change could spread the Jacobian columns over threads, or fuse K4
// into K3's launch to save one launch per step.
#include "lane_common.cuh"

namespace lane {

template <typename T>
__global__ void __launch_bounds__(THREADS)
sbwd_kernel(const T* __restrict__ U, const T* __restrict__ X, const T* __restrict__ Xr,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            T* __restrict__ Kout, T* __restrict__ kffout, int N, int B, Consts p) {
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
    tv[i] = T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane]);
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
  }

  for (int k = N - 1; k >= 0; --k) {
    const T inv_s = m_exp(-logs);
    T xs[NH], xr[NH], us[M];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      xs[i] = X[(static_cast<size_t>(k) * NH + i) * Bs + lane];
      xr[i] = Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane];
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
      tQu[a] = s;
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = A[0][i] * tv[0];
#pragma unroll
      for (int l = 1; l < NH; ++l) s = s + A[l][i] * tv[l];
      tQx[i] = (T(2) * (xs[i] - xr[i])) * inv_s + s;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
sfwd_kernel(const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ X,
            const T* __restrict__ Xr, const T* __restrict__ U, const T* __restrict__ Ur,
            const T* __restrict__ C, const T* __restrict__ XN, const T* __restrict__ XrN,
            T* __restrict__ gx_out, T* __restrict__ gr_out, int N, int B, Consts p) {
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

    FLin<T> L;
    fhat_lin(p, xs, us, alpha, gamma, tight, L);
    T dxn[NH];
    fhat_tan(p, L, dx, dv, dxn);
#pragma unroll
    for (int i = 0; i < NH; ++i) dx[i] = dxn[i];
    if (k == N - 1) {
#pragma unroll
      for (int i = 0; i < NH; ++i)
        gx[i] = gx[i] + (T(2) * (XN[i * Bs + lane] - XrN[i * Bs + lane])) * dxn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) gx_out[i * Bs + lane] = gx[i];
#pragma unroll
  for (int a = 0; a < M; ++a) gr_out[a * Bs + lane] = gr[a];
}

template <typename T>
int launch_sbwd(const void* U, const void* X, const void* Xr, const void* C, const void* XN,
                const void* XrN, void* K, void* kff, int N, int B, const Consts* p, void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sbwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(U), static_cast<const T*>(X), static_cast<const T*>(Xr),
      static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
      static_cast<T*>(K), static_cast<T*>(kff), N, B, *p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sfwd(const void* K, const void* kff, const void* X, const void* Xr, const void* U,
                const void* Ur, const void* C, const void* XN, const void* XrN, void* gx,
                void* gr, int N, int B, const Consts* p, void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  sfwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(X),
      static_cast<const T*>(Xr), static_cast<const T*>(U), static_cast<const T*>(Ur),
      static_cast<const T*>(C), static_cast<const T*>(XN), static_cast<const T*>(XrN),
      static_cast<T*>(gx), static_cast<T*>(gr), N, B, *p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lane

extern "C" {

int lane_sbwd_f32(const void* U, const void* X, const void* Xr, const void* C, const void* XN,
                  const void* XrN, void* K, void* kff, int N, int B, const lane::Consts* p,
                  void* stream) {
  return lane::launch_sbwd<float>(U, X, Xr, C, XN, XrN, K, kff, N, B, p, stream);
}

int lane_sbwd_f64(const void* U, const void* X, const void* Xr, const void* C, const void* XN,
                  const void* XrN, void* K, void* kff, int N, int B, const lane::Consts* p,
                  void* stream) {
  return lane::launch_sbwd<double>(U, X, Xr, C, XN, XrN, K, kff, N, B, p, stream);
}

int lane_sfwd_f32(const void* K, const void* kff, const void* X, const void* Xr, const void* U,
                  const void* Ur, const void* C, const void* XN, const void* XrN, void* gx,
                  void* gr, int N, int B, const lane::Consts* p, void* stream) {
  return lane::launch_sfwd<float>(K, kff, X, Xr, U, Ur, C, XN, XrN, gx, gr, N, B, p, stream);
}

int lane_sfwd_f64(const void* K, const void* kff, const void* X, const void* Xr, const void* U,
                  const void* Ur, const void* C, const void* XN, const void* XrN, void* gx,
                  void* gr, int N, int B, const lane::Consts* p, void* stream) {
  return lane::launch_sfwd<double>(K, kff, X, Xr, U, Ur, C, XN, XrN, gx, gr, N, B, p, stream);
}

}  // extern "C"
