// Fixed-count stagewise Riccati-in-ADMM tick over B lanes: n_iter ADMM
// iterations, each a linear backward Riccati sweep with precomputed gains,
// a forward rollout and the relaxation, projections and dual updates.
//
// Replaces the Pallas TPU kernels copra_tpu/ops/stagewise_kernel.py::
// fused_stagewise_tick (bodies _dma_tick_kernel, _tick_compute) and
// fused_stagewise_tick_streamed (bodies _streamed_dma_kernel,
// _streamed_tick_compute).  On the TPU the lanes ride the 128-wide vector
// axis and the plan sits in VMEM (resident) or is streamed a stage at a
// time (streamed).  Here one kernel serves both entry points and every
// (x, u, r) with x + u + r <= 128 whose ring fits, given at run time:
//
// * one block per lane; each thread owns one output coordinate of each
//   product, with warps for the state coordinates (qs, v, x_k) and warps
//   for the control and row coordinates (h, kk, u_k; vS, s), so the two
//   chains of a phase run side by side (2 warps at configs 5 and 6, at
//   most 5).  The iterate vectors sit in shared memory between the phases
//   of a stage, separated by block barriers.
// * the wrapper hands it lane-first copies (plan [B, N+1, Cp] and the
//   state [B, N+1, Wp + Kwp]: per stage the warm rows, then the work rows,
//   each padded to 16 bytes), so a run of a lane's stage tiles is two
//   contiguous runs, streamed by 16-byte cp.async into a ring of 2-8 slots
//   in shared memory.  A slot holds a group of up to 4 stage tiles, so one
//   wait, barrier and copy issue serve up to 4 stage steps.  The gains'
//   offsets kk of every stage stay in shared memory where they fit.
//   Config 5 (x, u, r) = (3, 1, 2): C = 49 plan words a stage, a
//   512 x 301 x 49 x 4 B = 30.2 MB f32 plan, a 288-byte tile.  Config 6
//   (12, 12, 12): C = 1008, a 128 x 41 x 1008 x 4 B = 21.2 MB f32 plan, a
//   1116-word tile (4.5 KB f32, 8.9 KB f64).
// * the loops over x, u and r are unrolled to a bound M (4, 16 or 32, the
//   smallest that covers the shape; M = 0 keeps them rolled above 32) with
//   the tail predicated off, so a phase's operand loads issue together.
//
// What bounds it on this card: the dependent chain.  Stage k of a sweep
// needs stage k+1's (backward) or k-1's (forward) result, so a tick is
// 2 N n_iter dependent steps per lane, each a few barrier-separated FMA
// chains of length x + u + r at most.  No load sits on that chain: every
// stage's tile is in shared memory before the stage starts (the plan is
// constant; the warm and work rows a sweep reads were written by the sweep
// before it, and each sweep's first copies are issued only after the
// barrier that ends the sweep before).
//
// Arithmetic is the plain PyTorch version's,
// copra_tpu_torch/ops/stagewise_kernel.py::stagewise_tick_plain: the same
// formulas, every sum with its index ascending.  The packed layout is that
// module's _Layout; make_layout below is the one routine the kernel takes
// its offsets from, and copra_stagewise_layout reports it for the check.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstagewise_tick.so stagewise_tick.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxDepth = 8;          // ring slots, at most
constexpr int kSmemLimit = 232448;    // shared memory a block may use (227 KB)
constexpr int kMaxWidth = 128;        // x + u + r
constexpr int kMaxThreads = 192;      // threads a block, at most

// Row offsets of plan, warm and work (ops/stagewise_kernel.py::_Layout).
struct Lay {
  int A, B, d, K, nF, qb, rb, rhox, rhou, xlb, xub, ulb, uub, Cx, Cu, slo,
      shi, rhos, C;
  int zX, yX, zU, yU, zS, yS, W;
  int X, U, kk, Kw;
};

__host__ __device__ constexpr Lay make_layout(int x, int u, int r) {
  Lay L{};
  int o = 0;
  L.A = o; o += x * x;
  L.B = o; o += x * u;
  L.d = o; o += x;
  L.K = o; o += u * x;
  L.nF = o; o += u * u;
  L.qb = o; o += x;
  L.rb = o; o += u;
  L.rhox = o; o += x;
  L.rhou = o; o += u;
  L.xlb = o; o += x;
  L.xub = o; o += x;
  L.ulb = o; o += u;
  L.uub = o; o += u;
  L.Cx = o; o += r * x;
  L.Cu = o; o += r * u;
  L.slo = o; o += r;
  L.shi = o; o += r;
  L.rhos = o; o += r;
  L.C = o;
  L.zX = 0; L.yX = x; L.zU = 2 * x; L.yU = 2 * x + u;
  L.zS = 2 * x + 2 * u; L.yS = 2 * x + 2 * u + r; L.W = 2 * x + 2 * u + 2 * r;
  L.X = 0; L.U = x; L.kk = x + u; L.Kw = x + 2 * u;
  return L;
}

constexpr int kLayWords = sizeof(Lay) / sizeof(int);

// ---- cp.async ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// wait until at most `pending` (0..kMaxDepth-2) groups are in flight
__device__ __forceinline__ void cp_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    default: cp_wait<6>(); break;
  }
}

// ---- arithmetic ----------------------------------------------------------

template <typename T>
__device__ __forceinline__ T clampv(T v, T lo, T hi) {
  return fmin(fmax(v, lo), hi);
}

template <>
__device__ __forceinline__ float clampv<float>(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Relax, project and update the dual of one box coordinate (rho 0: no
// split, z follows the relaxed iterate); pin: x_0 is data.  z and y are
// read from zi, yi and written to zo, yo.
template <typename T>
__device__ __forceinline__ void project(T v, T rho, T lb, T ub, T zi, T yi,
                                        T* zo, T* yo, T alpha, T oma,
                                        bool pin) {
  const T vr = alpha * v + oma * zi;
  T zn = rho > T(0) ? clampv(vr + yi / rho, lb, ub) : vr;
  if (pin) zn = v;
  *zo = zn;
  *yo = yi + rho * (vr - zn);
}

// Relax, project and update the dual of one normalized row.
template <typename T>
__device__ __forceinline__ void project_row(T s, T rs, T lo, T hi, T zi,
                                            T yi, T* zo, T* yo, T alpha,
                                            T oma) {
  const T sr = alpha * s + oma * zi;
  const T zn = clampv(sr + yi / rs, lo, hi);
  *zo = zn;
  *yo = yi + rs * (sr - zn);
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The unroll bound of a shape: 4, 16 or 32, 0 above 32 (loops rolled).
constexpr int unroll_bound(int x, int u, int r) {
  const int w = x > u ? (x > r ? x : r) : (u > r ? u : r);
  return w <= 4 ? 4 : w <= 16 ? 16 : w <= 32 ? 32 : 0;
}

// Launch plan of a problem: padded rows, threads, and the shared memory
// of the ring, the block's vectors and, where they fit, every stage's kk.
struct RingConfig {
  int Cp, Wp, Kwp;   // padded row counts (16-byte rows)
  int threads;
  int stages;        // ring slots, 0 = not even two tiles fit
  int kk_resident;
  int bytes;
  int unroll;
  int group;         // stage tiles a slot holds
};

inline RingConfig ring_config(int N, int x, int u, int r, int itemsize) {
  const Lay L = make_layout(x, u, r);
  RingConfig c{};
  const int per16 = 16 / itemsize;
  c.Cp = round_up(L.C, per16);
  c.Wp = round_up(L.W, per16);
  c.Kwp = round_up(L.Kw, per16);
  c.threads = round_up(x, 32) + round_up(u > r ? u : r, 32);
  const long long tile = static_cast<long long>(c.Cp + c.Wp + c.Kwp) * itemsize;
  const long long vec = round_up((2 * x + 2 * u + r) * itemsize, 16);
  const long long kk = static_cast<long long>(N) * u * itemsize;
  long long tiles = (kSmemLimit - vec - kk) / tile;
  c.kk_resident = tiles >= 2;
  if (!c.kk_resident) tiles = (kSmemLimit - vec) / tile;
  if (tiles > kMaxDepth) tiles = kMaxDepth;
  c.group = tiles >= 8 ? 4 : tiles >= 4 ? 2 : 1;
  const long long slots = tiles / c.group;
  c.stages = tiles >= 2 ? static_cast<int>(slots) : 0;
  c.bytes = static_cast<int>(slots * c.group * tile + vec
                             + (c.kk_resident ? kk : 0));
  c.unroll = unroll_bound(x, u, r);
  return c;
}

// for (j = lo; j < n; ++j), unrolled to the bound M with the tail
// predicated off (M = 0: a rolled loop)
#define COPRA_FOR(j, lo, n)                                              \
  _Pragma("unroll") for (int j = (lo); j < (M > 0 ? M : (n)); ++j)      \
    if (M == 0 || j < (n))

// Thread roles: threads [0, round_up(x, 32)) own the state coordinates,
// the threads after them the control and row coordinates.
template <typename T, int M>
__global__ void __launch_bounds__(kMaxThreads)
stagewise_tick_kernel(const T* __restrict__ plan, const T* __restrict__ x0,
                      T* __restrict__ state, Lay L,
                      int x, int u, int r, int Cp, int Wp, int Kwp,
                      int stages, int group, int kk_resident, int nb, int N,
                      int n_iter, T sigma, T alpha, T oma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = Cp + Wp + Kwp;   // one stage: plan | warm | work
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* vv = ring + stages * group * tile;   // value-function term v [x]
  T* hv = vv + x;                 // h [u]
  T* vS = hv + u;                 // row shifts [r]
  T* xsv = vS + r;                // rollout state [x]
  T* ukv = xsv + x;               // rollout control [u]
  T* kks = reinterpret_cast<T*>(   // kk [N][u] if resident
      smem_raw + stages * group * tile * sizeof(T)
      + round_up((2 * x + 2 * u + r) * static_cast<int>(sizeof(T)), 16));

  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int i = t;                     // state coordinate of an x-thread
  const int a = t - round_up(x, 32);   // control / row of a u-thread
  const bool xt = i < x, ut = a >= 0 && a < u, rt = a >= 0 && a < r;
  const size_t S1 = static_cast<size_t>(N) + 1;
  const int SW = Wp + Kwp;   // a stage of the lane's state: warm | work
  const T* planb = plan + static_cast<size_t>(b) * S1 * Cp;
  T* stateb = state + static_cast<size_t>(b) * S1 * SW;
  auto warm_at = [&](int k) { return stateb + static_cast<size_t>(k) * SW; };
  auto work_at = [&](int k) { return warm_at(k) + Wp; };

  // copy stages [k0, k0 + n) into slot s, 16 bytes a copy: two
  // contiguous runs, n plan tiles to the slot's front and n state tiles
  // (warm | work) after its `group` plan tiles
  constexpr int kPer = 16 / sizeof(T);   // words per 16-byte copy
  auto issue = [&](int s, int k0, int n) {
    T* dst = ring + s * group * tile;
    const T* gp = planb + static_cast<size_t>(k0) * Cp;
    for (int c = t * kPer; c < n * Cp; c += nt * kPer)
      cp_async16(dst + c, gp + c);
    dst += group * Cp;
    const T* gs = warm_at(k0);
    for (int c = t * kPer; c < n * SW; c += nt * kPer)
      cp_async16(dst + c, gs + c);
  };

  // One sweep over the N+1 stages, `group` stages a slot: group q spans
  // stages [k0, k0 + n), taken in descending (backward) or ascending order.
  // The barrier at the top of each group publishes its slot and frees the
  // slot it refills; the barrier between two stages of a group orders the
  // vectors one stage writes and the next reads.
  auto sweep = [&](bool backward, auto&& body) {
    const int groups = (N + group) / group;
    auto span = [&](int q, int& k0, int& n) {
      if (backward) {
        const int hi = N - q * group;
        n = hi + 1 < group ? hi + 1 : group;
        k0 = hi - n + 1;
      } else {
        k0 = q * group;
        n = N + 1 - k0 < group ? N + 1 - k0 : group;
      }
    };
    int k0, n;
    for (int q = 0; q < stages - 1; ++q) {
      if (q < groups) {
        span(q, k0, n);
        issue(q, k0, n);
      }
      cp_commit();
    }
    int cur = 0, nxt = stages - 1;
    for (int q = 0; q < groups; ++q) {
      cp_wait_upto(stages - 2);
      __syncthreads();
      if (q + stages - 1 < groups) {
        span(q + stages - 1, k0, n);
        issue(nxt, k0, n);
      }
      cp_commit();
      span(q, k0, n);
      const T* sp = ring + cur * group * tile;   // plan tiles
      const T* ss = sp + group * Cp;             // state tiles
      for (int g = 0; g < n; ++g) {
        if (g > 0) __syncthreads();
        const int o = backward ? n - 1 - g : g;
        body(k0 + o, sp + o * Cp, ss + o * SW, ss + o * SW + Wp);
      }
      cur = cur + 1 == stages ? 0 : cur + 1;
      nxt = nxt + 1 == stages ? 0 : nxt + 1;
    }
    cp_wait_upto(0);
    // this sweep's global stores before the next sweep's copies
    __syncthreads();
  };

  // proximal centre (X, U) starts at (zX, zU); U and kk of stage N are 0
  for (size_t e = t; e < S1 * L.Kw; e += nt) {
    const int k = static_cast<int>(e / L.Kw), c = static_cast<int>(e % L.Kw);
    const T* w = warm_at(k);
    T val = T(0);
    if (c < L.U) val = w[L.zX + c];
    else if (c < L.kk && k < N) val = w[L.zU + c - L.U];
    work_at(k)[c] = val;
  }
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    // ---- backward sweep: shifted costs + linear Riccati step ----
    sweep(true, [&](int k, const T* p, const T* w, const T* wk) {
      if (k == N) {
        if (xt)
          vv[i] = p[L.qb + i] - (p[L.rhox + i] * w[L.zX + i] - w[L.yX + i])
                  - sigma * wk[L.X + i];
        return;
      }
      if (rt) vS[a] = p[L.rhos + a] * w[L.zS + a] - w[L.yS + a];
      __syncthreads();
      T vn = T(0);
      if (xt) {
        T qs = p[L.qb + i] - (p[L.rhox + i] * w[L.zX + i] - w[L.yX + i])
               - sigma * wk[L.X + i];
        COPRA_FOR(j, 0, r) qs -= p[L.Cx + j * x + i] * vS[j];
        vn = qs;
        COPRA_FOR(j, 0, x) vn += p[L.A + j * x + i] * vv[j];
      }
      if (ut) {
        T h = p[L.rb + a] - (p[L.rhou + a] * w[L.zU + a] - w[L.yU + a])
              - sigma * wk[L.U + a];
        COPRA_FOR(j, 0, r) h -= p[L.Cu + j * u + a] * vS[j];
        // h = rb-shift + B'v
        COPRA_FOR(j, 0, x) h += p[L.B + j * u + a] * vv[j];
        hv[a] = h;
      }
      __syncthreads();
      if (ut) {
        // kk = nF h
        T kk = p[L.nF + a * u] * hv[0];
        COPRA_FOR(c, 1, u) kk += p[L.nF + a * u + c] * hv[c];
        work_at(k)[L.kk + a] = kk;
        if (kk_resident) kks[k * u + a] = kk;
      }
      if (xt) {
        // v <- qs + A'v + K'h   (G'kk == K'h: G = -F K, F kk = -h)
        COPRA_FOR(c, 0, u) vn += p[L.K + c * x + i] * hv[c];
        vv[i] = vn;
      }
    });

    // ---- forward sweep: rollout + projections and dual updates ----
    if (xt) {
      xsv[i] = x0[static_cast<size_t>(i) * nb + b];
      work_at(0)[L.X + i] = xsv[i];
    }
    sweep(false, [&](int k, const T* p, const T* w, const T* wk) {
      T* g = warm_at(k);
      if (k == N) {
        // terminal-state projection (stage N carries bounds and rho only)
        if (xt)
          project(xsv[i], p[L.rhox + i], p[L.xlb + i], p[L.xub + i],
                  w[L.zX + i], w[L.yX + i], &g[L.zX + i], &g[L.yX + i],
                  alpha, oma, false);
        return;
      }
      T* gk = work_at(k);
      T uk = T(0);
      if (ut) {
        uk = kk_resident ? kks[k * u + a] : wk[L.kk + a];
        COPRA_FOR(j, 0, x) uk += p[L.K + a * x + j] * xsv[j];
        ukv[a] = uk;
        gk[L.U + a] = uk;
      }
      __syncthreads();
      T xn = T(0);
      if (xt) {
        project(xsv[i], p[L.rhox + i], p[L.xlb + i], p[L.xub + i],
                w[L.zX + i], w[L.yX + i], &g[L.zX + i], &g[L.yX + i], alpha,
                oma, k == 0);
        xn = p[L.d + i];
        COPRA_FOR(j, 0, x) xn += p[L.A + i * x + j] * xsv[j];
        COPRA_FOR(c, 0, u) xn += p[L.B + i * u + c] * ukv[c];
      }
      if (ut)
        project(uk, p[L.rhou + a], p[L.ulb + a], p[L.uub + a], w[L.zU + a],
                w[L.yU + a], &g[L.zU + a], &g[L.yU + a], alpha, oma, false);
      if (rt) {
        T s = p[L.Cx + a * x] * xsv[0];
        COPRA_FOR(j, 1, x) s += p[L.Cx + a * x + j] * xsv[j];
        COPRA_FOR(c, 0, u) s += p[L.Cu + a * u + c] * ukv[c];
        project_row(s, p[L.rhos + a], p[L.slo + a], p[L.shi + a],
                    w[L.zS + a], w[L.yS + a], &g[L.zS + a], &g[L.yS + a],
                    alpha, oma);
      }
      __syncthreads();
      if (xt) {
        xsv[i] = xn;
        work_at(k + 1)[L.X + i] = xn;
      }
    });
  }
}

#undef COPRA_FOR

template <typename T, int M>
cudaError_t launch(const void* plan, const void* x0, void* state, int nb,
                   int N, int x, int u, int r, int n_iter, double sigma,
                   double alpha, const RingConfig& c, cudaStream_t stream) {
  auto kern = stagewise_tick_kernel<T, M>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes);
  if (e != cudaSuccess) return e;
  kern<<<nb, c.threads, c.bytes, stream>>>(
      static_cast<const T*>(plan), static_cast<const T*>(x0),
      static_cast<T*>(state), make_layout(x, u, r), x, u, r, c.Cp, c.Wp,
      c.Kwp, c.stages, c.group, c.kk_resident, nb, N, n_iter,
      static_cast<T>(sigma), static_cast<T>(alpha),
      static_cast<T>(1.0 - alpha));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* plan, const void* x0, void* state, int nb,
                   int N, int x, int u, int r, int n_iter, double sigma,
                   double alpha, cudaStream_t stream) {
  if (x < 1 || u < 1 || r < 0 || x + u + r > kMaxWidth || nb < 1 || N < 1)
    return cudaErrorInvalidValue;
  const RingConfig c = ring_config(N, x, u, r, sizeof(T));
  if (c.stages < 2) return cudaErrorInvalidValue;
  switch (c.unroll) {
    case 4:
      return launch<T, 4>(plan, x0, state, nb, N, x, u, r, n_iter,
                          sigma, alpha, c, stream);
    case 16:
      return launch<T, 16>(plan, x0, state, nb, N, x, u, r, n_iter,
                           sigma, alpha, c, stream);
    case 32:
      return launch<T, 32>(plan, x0, state, nb, N, x, u, r, n_iter,
                           sigma, alpha, c, stream);
    default:
      return launch<T, 0>(plan, x0, state, nb, N, x, u, r, n_iter,
                          sigma, alpha, c, stream);
  }
}

}  // namespace

extern "C" {

const char* copra_stagewise_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Writes the kLayWords offsets of make_layout(x, u, r) (Lay's field order)
// to out.
void copra_stagewise_layout(int x, int u, int r, int* out) {
  const Lay L = make_layout(x, u, r);
  const int* w = reinterpret_cast<const int*>(&L);
  for (int i = 0; i < kLayWords; ++i) out[i] = w[i];
}

// Writes the launch plan (Cp, Wp, Kwp, threads, stages, kk_resident,
// bytes, unroll, group) of the problem to out (stages 0: the ring does
// not fit).
void copra_stagewise_ring_config(int N, int x, int u, int r, int f64,
                                 int* out) {
  const RingConfig c = ring_config(N, x, u, r, f64 ? 8 : 4);
  const int v[9] = {c.Cp, c.Wp, c.Kwp, c.threads, c.stages, c.kk_resident,
                    c.bytes, c.unroll, c.group};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// n_iter iterations on lane-first padded tensors, plan [B, N+1, Cp] and
// state [B, N+1, Wp + Kwp] (per stage the warm rows, then the work rows;
// x0 [x, B] lane-last) on `stream`: warm is updated in place, work is
// written whole.  Returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue outside the envelope.
int copra_stagewise_tick(const void* plan, const void* x0, void* state,
                         int nb, int N, int x, int u, int r, int n_iter,
                         int f64, double sigma, double alpha, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch<double>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                           alpha, st)
          : launch<float>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                          alpha, st));
}

}  // extern "C"
