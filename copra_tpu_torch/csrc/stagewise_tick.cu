// Fixed-count stagewise Riccati-in-ADMM tick over B lanes: n_iter ADMM
// iterations, each a linear backward Riccati sweep with precomputed gains,
// a forward rollout and the relaxation, projections and dual updates.
//
// Replaces the Pallas TPU kernels copra_tpu/ops/stagewise_kernel.py::
// fused_stagewise_tick (bodies _dma_tick_kernel, _tick_compute) and
// fused_stagewise_tick_streamed (bodies _streamed_dma_kernel,
// _streamed_tick_compute).  On the TPU the lanes ride the 128-wide vector
// axis and the plan sits in VMEM (resident) or is streamed a stage at a
// time (streamed); here one kernel serves both entry points: one thread
// per lane, every tensor lane-last ([N+1, rows, B]) so a warp's 32 lanes
// read 32 consecutive words, the sweep state (v, h, kk, x_k, u_k) in
// registers, sized by the template parameters (X, U, R), and each stage's
// plan rows read from device memory (L2-resident at the served sizes:
// config 5 is 512 lanes x 301 stages x 45 words, 28 MB in f32; config 6
// 128 x 41 x 1128 words, 24 MB).
//
// What bounds it on this card: the dependent chain.  Stage k of a sweep
// needs stage k+1's (backward) or k-1's (forward) result, so a tick is
// 2 N n_iter dependent steps per lane, and 128-512 lanes fill only 4-16
// warps of the card's 132 SMs.  The design keeps the chain short (state in
// registers, fused multiply-adds, plan loads independent of the state so
// they issue ahead of the arithmetic) and leaves occupancy for later work
// (a warp per lane splitting the 12-wide products, plan tiles by TMA).
//
// Arithmetic is the plain PyTorch version's,
// copra_tpu_torch/ops/stagewise_kernel.py::stagewise_tick_plain: the same
// formulas, every sum with its index ascending.  The packed layout is that
// module's _Layout; copra_stagewise_layout reports it for the check.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libstagewise_tick.so stagewise_tick.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;

// Row offsets of plan [N+1, C, B], warm [N+1, W, B], work [N+1, Kw, B].
template <int X, int U, int R>
struct Layout {
  static constexpr int A = 0;
  static constexpr int B = A + X * X;
  static constexpr int d = B + X * U;
  static constexpr int K = d + X;
  static constexpr int nF = K + U * X;
  static constexpr int qb = nF + U * U;
  static constexpr int rb = qb + X;
  static constexpr int rhox = rb + U;
  static constexpr int rhou = rhox + X;
  static constexpr int xlb = rhou + U;
  static constexpr int xub = xlb + X;
  static constexpr int ulb = xub + X;
  static constexpr int uub = ulb + U;
  static constexpr int Cx = uub + U;
  static constexpr int Cu = Cx + R * X;
  static constexpr int slo = Cu + R * U;
  static constexpr int shi = slo + R;
  static constexpr int rhos = shi + R;
  static constexpr int C = rhos + R;
  static constexpr int zX = 0;
  static constexpr int yX = X;
  static constexpr int zU = 2 * X;
  static constexpr int yU = 2 * X + U;
  static constexpr int zS = 2 * X + 2 * U;
  static constexpr int yS = zS + R;
  static constexpr int W = yS + R;
  static constexpr int wX = 0;
  static constexpr int wU = X;
  static constexpr int wK = X + U;
  static constexpr int Kw = X + 2 * U;
};

template <typename T>
__device__ __forceinline__ T clampv(T v, T lo, T hi) {
  return fmin(fmax(v, lo), hi);
}

template <>
__device__ __forceinline__ float clampv<float>(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Relax, project and update the dual of one box coordinate (rho 0: no
// split, z follows the relaxed iterate); pin: x_0 is data.
template <typename T>
__device__ __forceinline__ void project(T v, T rho, T lb, T ub, T* z, T* y,
                                        T alpha, T oma, bool pin) {
  const T vr = alpha * v + oma * *z;
  const T yo = *y;
  T zn = rho > T(0) ? clampv(vr + yo / rho, lb, ub) : vr;
  if (pin) zn = v;
  *z = zn;
  *y = yo + rho * (vr - zn);
}

template <typename T, int X, int U, int R>
__global__ void __launch_bounds__(kThreads)
stagewise_tick_kernel(const T* __restrict__ plan, const T* __restrict__ x0,
                      T* __restrict__ warm, T* __restrict__ work, int nb,
                      int N, int n_iter, T sigma, T alpha, T oma) {
  using L = Layout<X, U, R>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nb) return;
  const size_t sB = static_cast<size_t>(nb);
  // stage k's rows, row i at [i * sB]
  auto P = [&](int k) { return plan + static_cast<size_t>(k) * L::C * sB + lane; };
  auto Wm = [&](int k) { return warm + static_cast<size_t>(k) * L::W * sB + lane; };
  auto Wk = [&](int k) { return work + static_cast<size_t>(k) * L::Kw * sB + lane; };

  // proximal centre (X, U) starts at (zX, zU); U and kk of stage N are 0
  for (int k = 0; k <= N; ++k) {
    const T* w = Wm(k);
    T* wk = Wk(k);
#pragma unroll
    for (int i = 0; i < X; ++i) wk[(L::wX + i) * sB] = w[(L::zX + i) * sB];
#pragma unroll
    for (int a = 0; a < U; ++a) {
      wk[(L::wU + a) * sB] = k < N ? w[(L::zU + a) * sB] : T(0);
      wk[(L::wK + a) * sB] = T(0);
    }
  }

  for (int it = 0; it < n_iter; ++it) {
    // ---- backward sweep: shifted costs + linear Riccati step ----
    T v[X];
    {
      const T* p = P(N);
      const T* w = Wm(N);
      const T* wk = Wk(N);
#pragma unroll
      for (int i = 0; i < X; ++i) {
        v[i] = p[(L::qb + i) * sB]
               - (p[(L::rhox + i) * sB] * w[(L::zX + i) * sB]
                  - w[(L::yX + i) * sB])
               - sigma * wk[(L::wX + i) * sB];
      }
    }
    for (int k = N - 1; k >= 0; --k) {
      const T* p = P(k);
      const T* w = Wm(k);
      T* wk = Wk(k);
      T qs[X];
      T h[U];
#pragma unroll
      for (int i = 0; i < X; ++i) {
        qs[i] = p[(L::qb + i) * sB]
                - (p[(L::rhox + i) * sB] * w[(L::zX + i) * sB]
                   - w[(L::yX + i) * sB])
                - sigma * wk[(L::wX + i) * sB];
      }
#pragma unroll
      for (int a = 0; a < U; ++a) {
        h[a] = p[(L::rb + a) * sB]
               - (p[(L::rhou + a) * sB] * w[(L::zU + a) * sB]
                  - w[(L::yU + a) * sB])
               - sigma * wk[(L::wU + a) * sB];
      }
      if constexpr (R > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const T vS = p[(L::rhos + j) * sB] * w[(L::zS + j) * sB]
                       - w[(L::yS + j) * sB];
#pragma unroll
          for (int i = 0; i < X; ++i) qs[i] -= p[(L::Cx + j * X + i) * sB] * vS;
#pragma unroll
          for (int a = 0; a < U; ++a) h[a] -= p[(L::Cu + j * U + a) * sB] * vS;
        }
      }
      // h = rb-shift + B'v
#pragma unroll
      for (int i = 0; i < X; ++i) {
#pragma unroll
        for (int a = 0; a < U; ++a) h[a] += p[(L::B + i * U + a) * sB] * v[i];
      }
      // kk = nF h
      T kk[U];
#pragma unroll
      for (int a = 0; a < U; ++a) kk[a] = p[(L::nF + a * U) * sB] * h[0];
#pragma unroll
      for (int b = 1; b < U; ++b) {
#pragma unroll
        for (int a = 0; a < U; ++a) kk[a] += p[(L::nF + a * U + b) * sB] * h[b];
      }
#pragma unroll
      for (int a = 0; a < U; ++a) wk[(L::wK + a) * sB] = kk[a];
      // v <- qs + A'v + K'h   (G'kk == K'h: G = -F K, F kk = -h)
      T vn[X];
#pragma unroll
      for (int i = 0; i < X; ++i) vn[i] = qs[i];
#pragma unroll
      for (int j = 0; j < X; ++j) {
#pragma unroll
        for (int i = 0; i < X; ++i) vn[i] += p[(L::A + j * X + i) * sB] * v[j];
      }
#pragma unroll
      for (int a = 0; a < U; ++a) {
#pragma unroll
        for (int i = 0; i < X; ++i) vn[i] += p[(L::K + a * X + i) * sB] * h[a];
      }
#pragma unroll
      for (int i = 0; i < X; ++i) v[i] = vn[i];
    }

    // ---- forward sweep: rollout + projections and dual updates ----
    T xs[X];
    {
      T* wk = Wk(0);
#pragma unroll
      for (int i = 0; i < X; ++i) {
        xs[i] = x0[i * sB + lane];
        wk[(L::wX + i) * sB] = xs[i];
      }
    }
    for (int k = 0; k < N; ++k) {
      const T* p = P(k);
      T* w = Wm(k);
      T* wk = Wk(k);
      T uk[U];
#pragma unroll
      for (int a = 0; a < U; ++a) uk[a] = wk[(L::wK + a) * sB];
#pragma unroll
      for (int i = 0; i < X; ++i) {
#pragma unroll
        for (int a = 0; a < U; ++a) uk[a] += p[(L::K + a * X + i) * sB] * xs[i];
      }
#pragma unroll
      for (int a = 0; a < U; ++a) wk[(L::wU + a) * sB] = uk[a];
#pragma unroll
      for (int i = 0; i < X; ++i) {
        project(xs[i], p[(L::rhox + i) * sB], p[(L::xlb + i) * sB],
                p[(L::xub + i) * sB], &w[(L::zX + i) * sB],
                &w[(L::yX + i) * sB], alpha, oma, k == 0);
      }
#pragma unroll
      for (int a = 0; a < U; ++a) {
        project(uk[a], p[(L::rhou + a) * sB], p[(L::ulb + a) * sB],
                p[(L::uub + a) * sB], &w[(L::zU + a) * sB],
                &w[(L::yU + a) * sB], alpha, oma, false);
      }
      if constexpr (R > 0) {
        T s[R];
#pragma unroll
        for (int j = 0; j < R; ++j) s[j] = p[(L::Cx + j * X) * sB] * xs[0];
#pragma unroll
        for (int i = 1; i < X; ++i) {
#pragma unroll
          for (int j = 0; j < R; ++j) s[j] += p[(L::Cx + j * X + i) * sB] * xs[i];
        }
#pragma unroll
        for (int a = 0; a < U; ++a) {
#pragma unroll
          for (int j = 0; j < R; ++j) s[j] += p[(L::Cu + j * U + a) * sB] * uk[a];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const T rs = p[(L::rhos + j) * sB];
          const T sr = alpha * s[j] + oma * w[(L::zS + j) * sB];
          const T yo = w[(L::yS + j) * sB];
          const T zn = clampv(sr + yo / rs, p[(L::slo + j) * sB],
                              p[(L::shi + j) * sB]);
          w[(L::zS + j) * sB] = zn;
          w[(L::yS + j) * sB] = yo + rs * (sr - zn);
        }
      }
      T xn[X];
#pragma unroll
      for (int i = 0; i < X; ++i) xn[i] = p[(L::d + i) * sB];
#pragma unroll
      for (int j = 0; j < X; ++j) {
#pragma unroll
        for (int i = 0; i < X; ++i) xn[i] += p[(L::A + i * X + j) * sB] * xs[j];
      }
#pragma unroll
      for (int a = 0; a < U; ++a) {
#pragma unroll
        for (int i = 0; i < X; ++i) xn[i] += p[(L::B + i * U + a) * sB] * uk[a];
      }
      T* wk1 = Wk(k + 1);
#pragma unroll
      for (int i = 0; i < X; ++i) {
        xs[i] = xn[i];
        wk1[(L::wX + i) * sB] = xn[i];
      }
    }
    {
      // terminal-state projection (stage N carries bounds and rho only)
      const T* p = P(N);
      T* w = Wm(N);
#pragma unroll
      for (int i = 0; i < X; ++i) {
        project(xs[i], p[(L::rhox + i) * sB], p[(L::xlb + i) * sB],
                p[(L::xub + i) * sB], &w[(L::zX + i) * sB],
                &w[(L::yX + i) * sB], alpha, oma, false);
      }
    }
  }
}

template <typename T, int X, int U, int R>
cudaError_t launch(const void* plan, const void* x0, void* warm, void* work,
                   int nb, int N, int n_iter, double sigma, double alpha,
                   cudaStream_t stream) {
  const int blocks = (nb + kThreads - 1) / kThreads;
  stagewise_tick_kernel<T, X, U, R><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(plan), static_cast<const T*>(x0),
      static_cast<T*>(warm), static_cast<T*>(work), nb, N, n_iter,
      static_cast<T>(sigma), static_cast<T>(alpha),
      static_cast<T>(1.0 - alpha));
  return cudaGetLastError();
}

// The instantiated shapes: KERNEL_SHAPES in ops/stagewise_kernel.py.
#define COPRA_STAGEWISE_SHAPES(F) F(3, 1, 2) F(3, 2, 2) F(12, 12, 12)

}  // namespace

extern "C" {

const char* copra_stagewise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes (C, W, Kw) of shape (x, u, r) to out; -1 if not instantiated.
int copra_stagewise_layout(int x, int u, int r, int* out) {
#define COPRA_LAYOUT(X_, U_, R_)                     \
  if (x == X_ && u == U_ && r == R_) {               \
    out[0] = Layout<X_, U_, R_>::C;                  \
    out[1] = Layout<X_, U_, R_>::W;                  \
    out[2] = Layout<X_, U_, R_>::Kw;                 \
    return 0;                                        \
  }
  COPRA_STAGEWISE_SHAPES(COPRA_LAYOUT)
#undef COPRA_LAYOUT
  return -1;
}

// Launches n_iter iterations on `stream` (warm is updated in place, work is
// written whole); returns cudaGetLastError() (0 = launched).
int copra_stagewise_tick(const void* plan, const void* x0, void* warm,
                         void* work, int nb, int N, int x, int u, int r,
                         int n_iter, int f64, double sigma, double alpha,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COPRA_DISPATCH(X_, U_, R_)                                         \
  if (x == X_ && u == U_ && r == R_) {                                     \
    return static_cast<int>(                                               \
        f64 ? launch<double, X_, U_, R_>(plan, x0, warm, work, nb, N,      \
                                         n_iter, sigma, alpha, st)         \
            : launch<float, X_, U_, R_>(plan, x0, warm, work, nb, N,       \
                                        n_iter, sigma, alpha, st));        \
  }
  COPRA_STAGEWISE_SHAPES(COPRA_DISPATCH)
#undef COPRA_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
