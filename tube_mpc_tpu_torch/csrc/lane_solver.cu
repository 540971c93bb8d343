// K1 and K2 of the lane iLQR solver on Hopper.
//
// K1 ric_kernel replaces tube_mpc_tpu/ops/pallas/lane_solver.py::_ric_kernel:
// the backward Riccati sweep with the f̂ Jacobians formed in-kernel.
// K2 fwd_kernel replaces tube_mpc_tpu/ops/pallas/lane_solver.py::_fwd_kernel:
// the line search, all alpha candidates advancing together.
//
// Design: one thread per lane; the k loop runs inside the thread in place of
// the Pallas kernels' sequential grid axis, and the carry (V_x, V_xx, LogS in
// K1; the candidate states and costs in K2) stays in registers. Neighbouring
// threads read neighbouring addresses of every [.., component, B] row.
//
// What bounds it on an H100: per lane and step K1 reads 12 values and writes
// 10 (88 bytes in f32), K2 reads 22 and writes 42 with seven candidates
// (256 bytes), so a whole sweep at B=16384, N=50 moves 73 MB (K1) and 212 MB
// (K2): 22 us and 63 us at 3.35 TB/s. K1 also does some 3,000 operations per
// lane and step (six tangents of f̂ for the Jacobian columns), 38 us at the
// f32 peak. One thread per lane gives only 128 blocks of 128 threads at
// B=16384: one warp per scheduler on 128 of the 132 SMs, so nothing hides the
// latency of each step's dependent chain of divides and transcendentals.
// chip_smoke.py measures each kernel's time beside its bound; PERF.md keeps the
// numbers with the card they came from. A later change could
// split a lane's work over several threads (one per Jacobian column in K1, one
// per alpha candidate in K2) to put more warps in flight, and keep the f̂
// linearisation of the accepted trajectory from K2 for the next K1.
#include "lane_common.cuh"

namespace lane {

template <typename T>
__global__ void __launch_bounds__(THREADS)
ric_kernel(const T* __restrict__ X, const T* __restrict__ U, const T* __restrict__ Xr,
           const T* __restrict__ Ur, const T* __restrict__ C, const T* __restrict__ phix,
           T* __restrict__ Kout, T* __restrict__ kffout, int N, int B, Consts p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);

  T c[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) c[r] = C[r * Bs + lane];
  const T alpha = c[ROW_ALPHA], gamma = c[ROW_ALPHA + 1], tight = c[ROW_ALPHA + 2];
  const T reg0 = T(p.reg);

  T vx[NH], vxx[NH][NH];
  T logs = T(0);
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    vx[i] = phix[i * Bs + lane];
#pragma unroll
    for (int j = 0; j < NH; ++j) vxx[i][j] = (i == j) ? c[NH + M + i] : T(0);
  }

  for (int k = N - 1; k >= 0; --k) {
    const T inv_s = m_exp(-logs);
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

    FLin<T> L;
    fhat_lin(p, xs, us, alpha, gamma, tight, L);
    T A[NH][NH], Bm[NH][M];
    fhat_jac(p, L, A, Bm);

    T Qx[NH], Qu[M], VA[NH][NH], VB[NH][M], Qxx[NH][NH], Qux[M][NH], Quu[M][M];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      T s = A[0][i] * vx[0];
#pragma unroll
      for (int j = 1; j < NH; ++j) s = s + A[j][i] * vx[j];
      Qx[i] = (c[i] * (xs[i] - xr[i])) * inv_s + s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      T s = Bm[0][a] * vx[0];
#pragma unroll
      for (int j = 1; j < NH; ++j) s = s + Bm[j][a] * vx[j];
      Qu[a] = (c[NH + a] * (us[a] - ur[a])) * inv_s + s;
    }
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
    }
    const T reg = reg0 * inv_s;

    T inv[M][M];
    inv2(Quu[0][0] + reg, Quu[0][1], Quu[1][0], Quu[1][1] + reg, inv);

    T K[M][NH], kf[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
#pragma unroll
      for (int i = 0; i < NH; ++i) K[a][i] = -(inv[a][0] * Qux[0][i] + inv[a][1] * Qux[1][i]);
      kf[a] = -(inv[a][0] * Qu[0] + inv[a][1] * Qu[1]);
      kffout[(static_cast<size_t>(k) * M + a) * Bs + lane] = kf[a];
#pragma unroll
      for (int i = 0; i < NH; ++i)
        Kout[(static_cast<size_t>(k) * (M * NH) + a * NH + i) * Bs + lane] = K[a][i];
    }

    T Quu_k[M], QuuK[M][NH];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      Quu_k[a] = Quu[a][0] * kf[0] + Quu[a][1] * kf[1];
#pragma unroll
      for (int j = 0; j < NH; ++j) QuuK[a][j] = Quu[a][0] * K[0][j] + Quu[a][1] * K[1][j];
    }
    T vx_new[NH], vxx_new[NH][NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      vx_new[i] = (Qx[i] + (K[0][i] * (Quu_k[0] + Qu[0]) + K[1][i] * (Quu_k[1] + Qu[1])))
                  + (Qux[0][i] * kf[0] + Qux[1][i] * kf[1]);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        vxx_new[i][j] = ((Qxx[i][j] + (K[0][i] * QuuK[0][j] + K[1][i] * QuuK[1][j]))
                         + (K[0][i] * Qux[0][j] + K[1][i] * Qux[1][j]))
                        + (Qux[0][i] * K[0][j] + Qux[1][i] * K[1][j]);
      }
    }
    rescale_carry(vx_new, vxx_new, vx, vxx, logs);
  }
}

// The alpha loop is unrolled over MAX_ALPHAS with a guard, so the candidate
// states stay in registers for any ladder of up to MAX_ALPHAS alphas.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ x0, const T* __restrict__ Xo, const T* __restrict__ Uo,
           const T* __restrict__ Kg, const T* __restrict__ kff, const T* __restrict__ Xr,
           const T* __restrict__ XrN, const T* __restrict__ Ur, const T* __restrict__ C,
           T* __restrict__ Xn, T* __restrict__ Un, T* __restrict__ cost, int N, int B, Consts p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t Bs = static_cast<size_t>(B);
  const int na = p.n_alphas;

  T c[NC];
#pragma unroll
  for (int r = 0; r < NC; ++r) c[r] = C[r * Bs + lane];
  const T alpha_b = c[ROW_ALPHA], gamma = c[ROW_ALPHA + 1], tight = c[ROW_ALPHA + 2];

  T xa[MAX_ALPHAS][NH], acc[MAX_ALPHAS];
#pragma unroll
  for (int a = 0; a < MAX_ALPHAS; ++a) {
    acc[a] = T(0);
#pragma unroll
    for (int i = 0; i < NH; ++i) xa[a][i] = x0[i * Bs + lane];
  }

  for (int k = 0; k < N; ++k) {
    T xo[NH], xr[NH], uo[M], ur[M], kf[M], K[M][NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      xo[i] = Xo[(static_cast<size_t>(k) * NH + i) * Bs + lane];
      xr[i] = Xr[(static_cast<size_t>(k) * NH + i) * Bs + lane];
    }
#pragma unroll
    for (int cc = 0; cc < M; ++cc) {
      uo[cc] = Uo[(static_cast<size_t>(k) * M + cc) * Bs + lane];
      ur[cc] = Ur[(static_cast<size_t>(k) * M + cc) * Bs + lane];
      kf[cc] = kff[(static_cast<size_t>(k) * M + cc) * Bs + lane];
#pragma unroll
      for (int i = 0; i < NH; ++i)
        K[cc][i] = Kg[(static_cast<size_t>(k) * (M * NH) + cc * NH + i) * Bs + lane];
    }

#pragma unroll
    for (int a = 0; a < MAX_ALPHAS; ++a) {
      if (a < na) {
        const T al = T(p.alphas[a]);
        T u[M];
#pragma unroll
        for (int cc = 0; cc < M; ++cc) {
          T s = K[cc][0] * (xa[a][0] - xo[0]);
#pragma unroll
          for (int i = 1; i < NH; ++i) s = s + K[cc][i] * (xa[a][i] - xo[i]);
          const T du = kf[cc] + s;
          u[cc] = jmin(T(p.u_max[cc]), jmax(T(p.u_min[cc]), uo[cc] + al * du));
        }
        T sx = (T(0.5) * c[0]) * ((xa[a][0] - xr[0]) * (xa[a][0] - xr[0]));
#pragma unroll
        for (int i = 1; i < NH; ++i)
          sx = sx + (T(0.5) * c[i]) * ((xa[a][i] - xr[i]) * (xa[a][i] - xr[i]));
        T su = (T(0.5) * c[NH]) * ((u[0] - ur[0]) * (u[0] - ur[0]));
#pragma unroll
        for (int cc = 1; cc < M; ++cc)
          su = su + (T(0.5) * c[NH + cc]) * ((u[cc] - ur[cc]) * (u[cc] - ur[cc]));
        acc[a] = acc[a] + (sx + su);

        T xn[NH];
        fhat(p, xa[a], u, alpha_b, gamma, tight, xn);
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          Xn[(static_cast<size_t>(k) * (na * NH) + a * NH + i) * Bs + lane] = xn[i];
          xa[a][i] = xn[i];
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
          acc[a] = acc[a] + term;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_ALPHAS; ++a)
    if (a < na) cost[a * Bs + lane] = acc[a];
}

template <typename T>
int launch_ric(const void* X, const void* U, const void* Xr, const void* Ur, const void* C,
               const void* phix, void* K, void* kff, int N, int B, const Consts* p,
               void* stream) {
  const dim3 grid((B + THREADS - 1) / THREADS);
  ric_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(U), static_cast<const T*>(Xr),
      static_cast<const T*>(Ur), static_cast<const T*>(C), static_cast<const T*>(phix),
      static_cast<T*>(K), static_cast<T*>(kff), N, B, *p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x0, const void* Xo, const void* Uo, const void* K, const void* kff,
               const void* Xr, const void* XrN, const void* Ur, const void* C, void* Xn,
               void* Un, void* cost, int N, int B, const Consts* p, void* stream) {
  if (p->n_alphas < 1 || p->n_alphas > MAX_ALPHAS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + THREADS - 1) / THREADS);
  fwd_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x0), static_cast<const T*>(Xo), static_cast<const T*>(Uo),
      static_cast<const T*>(K), static_cast<const T*>(kff), static_cast<const T*>(Xr),
      static_cast<const T*>(XrN), static_cast<const T*>(Ur), static_cast<const T*>(C),
      static_cast<T*>(Xn), static_cast<T*>(Un), static_cast<T*>(cost), N, B, *p);
  return static_cast<int>(cudaGetLastError());
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
