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
// (x, u, r) with x + u + r <= 128 whose ring fits, given at run time, a
// block a lane, on lane-first copies the wrapper makes (plan [B, N+1, Cp]
// and the state [B, N+1, Wp + Kwp]: per stage the warm rows, then the work
// rows, each padded to 16 bytes), so a run of a lane's stage tiles is two
// contiguous runs streamed into a ring of slots in shared memory.  Config
// 5 (x, u, r) = (3, 1, 2): C = 49 plan words a stage, a 512 x 301 x 49 x 4
// B = 30.2 MB f32 plan, a 288-byte tile.  Config 6 (12, 12, 12): C = 1008,
// a 128 x 41 x 1008 x 4 B = 21.2 MB f32 plan, a 4.5 KB f32 tile.
//
// What bounds it on this card: the latency of the dependent chain, a stage
// step at a time.  Stage k of a sweep needs stage k+1's (backward) or
// k-1's (forward) result, so a tick is 2 N n_iter dependent steps a lane,
// and the lanes run side by side: one robot's 2 lanes take as long as 512.
// The work on the chain is small: backward v_{k+1} -> h = rb-shift + B'v,
// qs + A'v -> v = qs + A'v + K'h; forward x_k -> u = kk + K x -> x_{k+1} =
// d + A x + B u; x + u FMAs deep and two exchanges of a few values.
//
// * The warp body, for x + max(u, r) <= 24 with x, u, r <= 16 (configs 1,
//   5 and 6; the fleet-serving example): one warp a lane.  Threads [0, x)
//   own the state coordinates, [x, x + max(u, r)) the control and row
//   coordinates; every thread runs the same instructions on operands its
//   role picked, and v, h, x_k and u_k pass by __shfl_sync in registers.
//   Nothing on the chain touches shared memory or a barrier: a step's plan
//   operands are loaded a step ahead, the shifted costs of the next stage
//   and the projections, dual updates and (predicated) stores of this one
//   run beside the chain, and a zero dual is not divided (its slow path
//   takes ~270 cycles).  Two bulk copies a slot fill the ring, completing
//   on an mbarrier, 16 stages a slot; the loops unroll to 4, 8 or 16.
//   Measured on an H100 80GB HBM3 (700 W): config 5, 20 iterations, 435
//   cycles a step (the block body 1,042); config 6, 50 iterations, 1,172
//   (1,800).
// * The block body, the wider shapes (and (20, 12, 4), whose 32-wide loops
//   spill, and (16, 16, 16) in f64, where the warp body ran slower): each
//   thread owns one output coordinate of each product, with warps for the
//   state coordinates (qs, v, x_k) beside warps for the control and row
//   coordinates (h, kk, u_k; vS, s).  The iterate vectors sit in shared
//   memory between the phases of a stage, separated by block barriers; a
//   ring of 2-8 slots of up to 4 tiles is filled by 16-byte cp.async and
//   every stage's kk stays in shared memory where it fits.  The loops
//   unroll to 4, 16 or 32 (rolled above 32) with the tail predicated off.
// No load sits on the chain in either body: every stage's tile is in
// shared memory before the stage starts (the plan is constant; the warm
// and work rows a sweep reads were written by the sweep before it, and
// each sweep's first copies are issued only after the barrier, or the
// proxy fence, that ends the sweep before).
//
// The top-up of a served tick (solve_stagewise_fused) is decided on the
// device: the launch takes a pointer to an "every lane converged" flag,
// and each block reads it first and returns at once when it is set,
// leaving the state as the wrapper handed it (the first run's, bit for
// bit).  The host never waits for the decision, so a tick can be captured
// in a CUDA graph.  copra_stagewise_prepare sets the dynamic shared-memory
// attribute of every instantiation once, when the library loads, so a
// launch sets nothing.
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
#include <cstdint>

namespace {

constexpr int kMaxDepth = 8;          // ring slots, at most
constexpr int kSmemLimit = 232448;    // shared memory a block may use (227 KB)
constexpr int kMaxWidth = 128;        // x + u + r
constexpr int kMaxThreads = 192;      // threads a block, at most
constexpr int kWarpTiles = 32;        // stage tiles in the ring, warp body
constexpr int kBarBytes = 32;         // the slots' mbarriers, warp body
constexpr int kWarpGroup = 16;        // stage tiles a slot, warp body, most
constexpr unsigned kFull = 0xffffffffu;

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

// ---- bulk copies on an mbarrier (the warp body's ring) -------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// the one arrival of a slot's phase, expecting `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// waits until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one 1-D bulk copy global -> shared that completes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's global stores before the bulk copies issued after it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// a global store that only the threads with `on` make, as one predicated
// instruction (no branch around it)
__device__ __forceinline__ void store_if(bool on, float* a, float v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n"
      ::"l"(a), "f"(v), "r"(static_cast<unsigned>(on)));
}

__device__ __forceinline__ void store_if(bool on, double* a, double v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q st.global.f64 [%0], %1;\n}\n"
      ::"l"(a), "d"(v), "r"(static_cast<unsigned>(on)));
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

// Launch plan of a problem: padded rows, the body, threads, and the shared
// memory of the ring, the block body's vectors or the warp body's
// mbarriers and, where they fit, every stage's kk.
struct RingConfig {
  int Cp, Wp, Kwp;   // padded row counts (16-byte rows)
  int threads;
  int stages;        // ring slots, 0 = not even two tiles fit
  int kk_resident;
  int bytes;         // shared memory a block
  int unroll;
  int group;         // stage tiles a slot holds
  int warp;          // 1: the warp body, 0: the block body
};

// The warp body serves x + max(u, r) <= 24 with x, u, r <= 16: a lane a
// warp.  (Wider shapes ran slower than the block body on an H100: (20, 12,
// 4), whose loops unroll to 32 and spill, and (16, 16, 16) in f64.)
__host__ __device__ constexpr bool warp_body(int x, int u, int r) {
  return x + (u > r ? u : r) <= 24 && x <= 16 && u <= 16 && r <= 16;
}

// The warp body's unroll bound: 4, 8 or 16, the smallest that covers.
constexpr int warp_unroll(int x, int u, int r) {
  const int w = x > u ? (x > r ? x : r) : (u > r ? u : r);
  return w <= 4 ? 4 : w <= 8 ? 8 : 16;
}

inline RingConfig ring_config(int N, int x, int u, int r, int itemsize) {
  const Lay L = make_layout(x, u, r);
  RingConfig c{};
  const int per16 = 16 / itemsize;
  c.Cp = round_up(L.C, per16);
  c.Wp = round_up(L.W, per16);
  c.Kwp = round_up(L.Kw, per16);
  c.warp = warp_body(x, u, r);
  c.threads = c.warp ? 32 : round_up(x, 32) + round_up(u > r ? u : r, 32);
  const long long tile = static_cast<long long>(c.Cp + c.Wp + c.Kwp) * itemsize;
  // the block body's vectors; the warp body keeps them in registers and
  // has its slots' mbarriers after kk
  const long long vec =
      c.warp ? 0 : round_up((2 * x + 2 * u + r) * itemsize, 16);
  const long long bars = c.warp ? kBarBytes : 0;
  const long long budget = kSmemLimit - vec - bars;
  const long long kk = c.warp ? round_up(N * u * itemsize, 16) : N * u * itemsize;
  long long tiles = (budget - kk) / tile;
  c.kk_resident = tiles >= 2;
  if (!c.kk_resident) tiles = budget / tile;
  if (tiles > (c.warp ? kWarpTiles : kMaxDepth))
    tiles = c.warp ? kWarpTiles : kMaxDepth;
  if (c.warp) {   // the largest group of which two slots fit: 2 or 3 slots
    c.group = kWarpGroup;
    while (c.group > 1 && tiles < 2 * c.group) c.group /= 2;
  } else {
    c.group = tiles >= 8 ? 4 : tiles >= 4 ? 2 : 1;
  }
  const long long slots = tiles / c.group;
  c.stages = tiles >= 2 ? static_cast<int>(slots) : 0;
  c.bytes = static_cast<int>(slots * c.group * tile
                             + (c.kk_resident ? kk : 0) + bars + vec);
  c.unroll = c.warp ? warp_unroll(x, u, r) : unroll_bound(x, u, r);
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
                      int n_iter, T sigma, T alpha, T oma,
                      const int* __restrict__ skip, int carry) {
  // the top-up of a tick whose lanes all converged: nothing to do
  if (skip != nullptr && *skip != 0) return;
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

  // proximal centre (X, U) starts at (zX, zU); U and kk of stage N are 0.
  // With carry the work rows the wrapper handed in are the centre (the
  // last iterate of a run this one continues)
  if (!carry) {
    for (size_t e = t; e < S1 * L.Kw; e += nt) {
      const int k = static_cast<int>(e / L.Kw);
      const int c = static_cast<int>(e % L.Kw);
      const T* w = warm_at(k);
      T val = T(0);
      if (c < L.U) val = w[L.zX + c];
      else if (c < L.kk && k < N) val = w[L.zU + c - L.U];
      work_at(k)[c] = val;
    }
    __syncthreads();
  }

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

// The warp body: a lane a warp, for the shapes warp_body names.  Threads
// [0, x) of the warp own the state coordinates, threads [x, x + max(u, r))
// the control and row coordinates, the rest idle.  Every thread runs the
// same instructions: its operands' offsets and strides are chosen by its
// role once, so no branch splits the warp on the chain.  v, h, x_k and u_k
// stay in the registers of the threads that own them and reach the others
// by __shfl_sync; stage N's operands stay in the state threads' registers
// (the ring carries stages [0, N)).  A block is one warp: the ring, filled
// by two bulk copies a slot that thread 0 issues and that complete on the
// slot's mbarrier, kk and the mbarriers are its own, and the ring's and
// each stage's addresses are uniform across it.  The warp waits on the
// mbarrier and with __syncwarp only.
template <typename T, int M>
__global__ void __launch_bounds__(32)
stagewise_tick_kernel_warp(const T* __restrict__ plan,
                           const T* __restrict__ x0, T* __restrict__ state,
                           Lay L, int x, int u, int r, int Cp, int Wp,
                           int Kwp, int stages, int group, int kk_resident,
                           int nb, int N, int n_iter, T sigma, T alpha, T oma,
                           const int* __restrict__ skip, int carry) {
  // the top-up of a tick whose lanes all converged: nothing to do
  if (skip != nullptr && *skip != 0) return;
  const int b = blockIdx.x;   // the lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = Cp + Wp + Kwp;   // one stage: plan | warm | work
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* kks = ring + stages * group * tile;   // kk [N][u] if resident
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem_raw + stages * group * tile * sizeof(T)
      + (kk_resident ? round_up(N * u * static_cast<int>(sizeof(T)), 16)
                     : 0));

  const int t = threadIdx.x;
  const int a = t - x;                 // control / row of a u-thread
  const bool xt = t < x, ut = a >= 0 && a < u, rt = a >= 0 && a < r;
  // indices in range for every thread: an idle thread reads what thread 0
  // or thread x reads, and stores nothing
  const int ii = xt ? t : 0;
  const int au = a < 0 ? 0 : a < u ? a : u - 1;
  const int ar = a < 0 || r == 0 ? 0 : a < r ? a : r - 1;
  const size_t S1 = static_cast<size_t>(N) + 1;
  const int SW = Wp + Kwp;   // a stage of the lane's state: warm | work
  const T* planb = plan + static_cast<size_t>(b) * S1 * Cp;
  T* stateb = state + static_cast<size_t>(b) * S1 * SW;
  auto warm_at = [&](int k) { return stateb + static_cast<size_t>(k) * SW; };
  auto work_at = [&](int k) { return warm_at(k) + Wp; };

  // the operands of a thread's coordinate: state coordinate ii of an
  // x-thread, control coordinate au of the others
  const int cs = xt ? x : u;                            // column stride
  const int o_base = xt ? L.qb + ii : L.rb + au;
  const int o_rho = xt ? L.rhox + ii : L.rhou + au;
  const int o_lb = xt ? L.xlb + ii : L.ulb + au;
  const int o_ub = xt ? L.xub + ii : L.uub + au;
  const int o_z = xt ? L.zX + ii : L.zU + au;
  const int o_y = xt ? L.yX + ii : L.yU + au;
  const int o_var = xt ? L.X + ii : L.U + au;
  const int o_C = xt ? L.Cx + ii : L.Cu + au;           // Cx[j][i], Cu[j][a]
  const int o_col = xt ? L.A + ii : L.B + au;           // A[j][i], B[j][a]
  const int o_gain = xt ? L.K + ii : L.nF + au * u;     // K[c][i], nF[a][c]
  const int gs = xt ? x : 1;
  const int o_row = xt ? L.A + ii * x : L.K + au * x;   // A[i][j], K[a][j]
  const int o_in = xt ? L.B + ii * u : L.Cu + ar * u;   // B[i][c], Cu[a][c]
  const int o_cx = L.Cx + ar * x;                       // Cx[a][j]

  // the slots' mbarriers, and the parity each slot's next phase completes
  if (t == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncwarp();
  uint32_t phase = 0;

  // stages [k0, k0 + n) into slot s: n plan tiles to the slot's front, n
  // state tiles (warm | work) after its `group` plan tiles, two bulk copies
  auto issue = [&](int s, int k0, int n) {
    if (t == 0) {
      T* dst = ring + s * group * tile;
      const uint32_t pb = n * Cp * sizeof(T), sb = n * SW * sizeof(T);
      mbar_expect(&bars[s], pb + sb);
      bulk_copy(dst, planb + static_cast<size_t>(k0) * Cp, pb, &bars[s]);
      bulk_copy(dst + group * Cp, warm_at(k0), sb, &bars[s]);
    }
  };

  // One sweep over stages [0, N), `group` stages a slot, descending
  // (backward) or ascending; run(k0, n, plan tiles, state tiles) takes a
  // group once its slot has landed.  The __syncwarp after the wait frees
  // the slot the group refills (every thread is past the group before).
  auto sweep = [&](bool backward, auto&& run) {
    const int groups = (N + group - 1) / group;
    auto span = [&](int q, int& k0, int& n) {
      if (backward) {
        const int hi = N - 1 - q * group;
        n = hi + 1 < group ? hi + 1 : group;
        k0 = hi - n + 1;
      } else {
        k0 = q * group;
        n = N - k0 < group ? N - k0 : group;
      }
    };
    int k0, n;
    for (int q = 0; q < stages - 1 && q < groups; ++q) {
      span(q, k0, n);
      issue(q, k0, n);
    }
    int cur = 0, nxt = stages - 1;
    for (int q = 0; q < groups; ++q) {
      mbar_wait(&bars[cur], (phase >> cur) & 1u);
      phase ^= 1u << cur;
      __syncwarp();
      if (q + stages - 1 < groups) {
        span(q + stages - 1, k0, n);
        issue(nxt, k0, n);
      }
      span(q, k0, n);
      const T* sp = ring + cur * group * tile;
      run(k0, n, sp, sp + group * Cp);
      cur = cur + 1 == stages ? 0 : cur + 1;
      nxt = nxt + 1 == stages ? 0 : nxt + 1;
    }
    // this sweep's global stores before the next sweep's copies
    fence_proxy_async();
    __syncwarp();
  };

  T v = T(0);    // v_{k+1} in the state threads (backward)
  T xs = T(0);   // x_k in the state threads (forward)

  // The loops below run to the unroll bound M: every shuffle issues (its
  // source lane exists for every j < M), each load reads an operand in
  // range, and only the FMAs of j >= n are predicated off, so no branch
  // cuts a step and the shuffles overlap.  The loop over a group's stages
  // stays rolled: one stage's code, which the scheduler's instruction
  // cache holds.  Each thread's operands sit at byte offsets of a stage's
  // tiles computed here once (an index past an operand's count reads its
  // first entry), so a load is one add and the load itself.
  constexpr int E = sizeof(T);
  int b_C[M], b_col[M], b_gain[M], b_row[M], b_cx[M], b_in[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int jx = j < x ? j : 0, ju = j < u ? j : 0, jr = j < r ? j : 0;
    b_C[j] = (o_C + jr * cs) * E;       // Cx[j][i], Cu[j][a]
    b_col[j] = (o_col + jx * cs) * E;   // A[j][i], B[j][a]
    b_gain[j] = (o_gain + ju * gs) * E; // K[c][i], nF[a][c]
    b_row[j] = (o_row + jx) * E;        // A[i][j], K[a][j]
    b_cx[j] = (o_cx + jx) * E;          // Cx[a][j]
    b_in[j] = (o_in + ju) * E;          // B[i][c], Cu[a][c]
  }
  const int b_base = o_base * E, b_rho = o_rho * E, b_lb = o_lb * E,
            b_ub = o_ub * E, b_z = o_z * E, b_y = o_y * E,
            b_var = (Wp + o_var) * E, b_rhos = (L.rhos + ar) * E,
            b_slo = (L.slo + ar) * E, b_shi = (L.shi + ar) * E,
            b_zS = (L.zS + ar) * E, b_yS = (L.yS + ar) * E,
            b_d = (L.d + ii) * E;
  auto ld = [](const T* p, int off) {
    return *reinterpret_cast<const T*>(reinterpret_cast<const char*>(p)
                                       + off);
  };

  // qs (x-threads) or rb-shift (u-threads) of the stage in tiles p, w:
  // the linear cost shifted by the penalties, the proximal term and the
  // rows, before A'v or B'v; off the chain
  auto shifted = [&](const T* p, const T* w) {
    T acc = ld(p, b_base) - (ld(p, b_rho) * ld(w, b_z) - ld(w, b_y))
            - sigma * ld(w, b_var);
    const T vs = ld(p, b_rhos) * ld(w, b_zS) - ld(w, b_yS);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const T sj = __shfl_sync(kFull, vs, (x + j) & 31);
      const T cj = ld(p, b_C[j]);
      if (j < r) acc -= cj * sj;
    }
    return acc;
  };

  // backward: shifted costs + linear Riccati step, stages k0+n-1 .. k0.
  // A step loads the next stage's operands and computes its shifted costs
  // beside its own chain, whose operands are in registers when it starts
  T* const kk_row = stateb + Wp + L.kk + au;   // work's kk of stage 0
  auto backward = [&](int k0, int n, const T* sp, const T* ss) {
    T col[M], gain[M];
    auto load = [&](const T* p, T* c, T* g) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        c[j] = ld(p, b_col[j]);
        g[j] = ld(p, b_gain[j]);
      }
    };
    load(sp + (n - 1) * Cp, col, gain);
    T base = shifted(sp + (n - 1) * Cp, ss + (n - 1) * SW);
#pragma unroll 1
    for (int o = n - 1; o >= 0; --o) {
      const int on = o > 0 ? o - 1 : 0;
      T ncol[M], ngain[M];
      load(sp + on * Cp, ncol, ngain);
      const T next = shifted(sp + on * Cp, ss + on * SW);
      // x-threads: qs + A'v; u-threads: h = rb-shift + B'v
      T acc = base;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T vj = __shfl_sync(kFull, v, j);
        if (j < x) acc += col[j] * vj;
      }
      // x-threads: v <- qs + A'v + K'h; u-threads: kk = nF h
      T acc2 = xt ? acc : T(-0.0);
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const T hc = __shfl_sync(kFull, acc, (x + c) & 31);
        if (c < u) acc2 += gain[c] * hc;
      }
      const int k = k0 + o;
      store_if(ut, kk_row + static_cast<size_t>(k) * SW, acc2);
      if (ut && kk_resident) kks[k * u + a] = acc2;
      v = acc2;
      base = next;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        col[j] = ncol[j];
        gain[j] = ngain[j];
      }
    }
  };

  // forward: rollout + projections and dual updates, stages k0 .. k0+n-1.
  // A step loads the next stage's chain operands beside its own chain.
  // y / rho is divided only where the quotient is used and y is not zero
  // (y itself is then the quotient, bit for bit): a zero dividend takes
  // the division's slow path, ~270 cycles on this card, and most duals
  // are zero
  T* const u_row = stateb + Wp + L.U + au;      // work's U of stage 0
  T* const x_row = stateb + Wp + L.X + ii;      // work's X of stage 0
  auto forward = [&](int k0, int n, const T* sp, const T* ss) {
    const T* kkp = kk_resident ? kks + k0 * u + au : ss + Wp + L.kk + au;
    const int kst = kk_resident ? u : SW;
    T row[M], crow[M], in[M], first;
    auto load = [&](int g, T* rw, T* cr, T* bi, T& f) {
      const T* p = sp + g * Cp;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        rw[j] = ld(p, b_row[j]);
        cr[j] = ld(p, b_cx[j]);
        bi[j] = ld(p, b_in[j]);
      }
      const T dk = ld(p, b_d), kkv = kkp[g * kst];
      f = xt ? dk : kkv;
    };
    load(0, row, crow, in, first);
#pragma unroll 1
    for (int g = 0; g < n; ++g) {
      const int k = k0 + g;
      const T* p = sp + g * Cp;
      const T* w = ss + g * SW;
      T nrow[M], ncrow[M], nin[M], nfirst;
      load(g + 1 < n ? g + 1 : g, nrow, ncrow, nin, nfirst);
      // off the chain: the operands of the projections and dual updates
      const T rho = ld(p, b_rho), lb = ld(p, b_lb), ub = ld(p, b_ub);
      const T zi = ld(w, b_z), yi = ld(w, b_y);
      const T rs = ld(p, b_rhos), lo = ld(p, b_slo), hi = ld(p, b_shi);
      const T zs = ld(w, b_zS), ys = ld(w, b_yS);
      // u-threads: u_k = kk + K x_k; row threads: Cx x_k
      T acc = first;
      T s = T(-0.0);
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T xj = __shfl_sync(kFull, xs, j);
        if (j < x) {
          acc += row[j] * xj;
          s += crow[j] * xj;
        }
      }
      // x-threads: x_{k+1} = d + A x_k + B u_k; row threads: s
      T acc2 = xt ? acc : s;
#pragma unroll
      for (int c = 0; c < M; ++c) {
        const T uc = __shfl_sync(kFull, acc, (x + c) & 31);
        if (c < u) acc2 += in[c] * uc;
      }
      const T qb = rho > T(0) && yi != T(0) ? yi / rho : yi;
      const T qr = r > 0 && rs > T(0) && ys != T(0) ? ys / rs : ys;
      // box: x-threads x_k (x_0 is data), u-threads u_k
      const T bv = xt ? xs : acc;
      const T vr = alpha * bv + oma * zi;
      const T zc = clampv(vr + qb, lb, ub);
      T zn = rho > T(0) ? zc : vr;
      zn = xt && k == 0 ? bv : zn;
      const T yn = yi + rho * (vr - zn);
      // rows
      const T sr = alpha * acc2 + oma * zs;
      const T zr = clampv(sr + qr, lo, hi);
      const T yr = ys + rs * (sr - zr);
      T* gw = stateb + static_cast<size_t>(k) * SW;
      store_if(xt || ut, gw + o_z, zn);
      store_if(xt || ut, gw + o_y, yn);
      store_if(rt, gw + L.zS + ar, zr);
      store_if(rt, gw + L.yS + ar, yr);
      store_if(ut, u_row + static_cast<size_t>(k) * SW, acc);
      store_if(xt, x_row + static_cast<size_t>(k + 1) * SW, acc2);
      xs = acc2;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        row[j] = nrow[j];
        crow[j] = ncrow[j];
        in[j] = nin[j];
      }
      first = nfirst;
    }
  };

  // proximal centre (X, U) starts at (zX, zU); U and kk of stage N are 0.
  // With carry the work rows the wrapper handed in are the centre
  if (!carry) {
    for (size_t e = t; e < S1 * L.Kw; e += 32) {
      const int k = static_cast<int>(e / L.Kw);
      const int c = static_cast<int>(e % L.Kw);
      const T* w = warm_at(k);
      T val = T(0);
      if (c < L.U) val = w[L.zX + c];
      else if (c < L.kk && k < N) val = w[L.zU + c - L.U];
      work_at(k)[c] = val;
    }
    fence_proxy_async();
    __syncwarp();
  }
  // stage N in the state threads' registers: its plan rows, its warm rows
  // and X, and x0
  const T* pN = planb + static_cast<size_t>(N) * Cp;
  const T qbN = pN[L.qb + ii], rhoN = pN[L.rhox + ii];
  const T lbN = pN[L.xlb + ii], ubN = pN[L.xub + ii];
  T zN = warm_at(N)[L.zX + ii], yN = warm_at(N)[L.yX + ii];
  T XN = work_at(N)[L.X + ii];
  const T x0i = x0[static_cast<size_t>(ii) * nb + b];

  for (int it = 0; it < n_iter; ++it) {
    v = qbN - (rhoN * zN - yN) - sigma * XN;
    sweep(true, backward);
    xs = x0i;
    if (xt) work_at(0)[L.X + t] = xs;
    sweep(false, forward);
    // terminal-state projection (stage N carries bounds and rho only)
    T zn, yn;
    project(xs, rhoN, lbN, ubN, zN, yN, &zn, &yn, alpha, oma, false);
    zN = zn;
    yN = yn;
    XN = xs;
    if (xt) {
      warm_at(N)[L.zX + t] = zn;
      warm_at(N)[L.yX + t] = yn;
    }
  }
}

#undef COPRA_FOR

// Opts one instantiation into all the dynamic shared memory a block may
// use on the current device, beside its static shared memory.
cudaError_t allow_max_smem(const void* fn, int optin) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - static_cast<int>(a.sharedSizeBytes));
}

template <typename T>
cudaError_t allow_max_smem_all(int optin) {
  const void* fns[] = {
      reinterpret_cast<const void*>(stagewise_tick_kernel<T, 4>),
      reinterpret_cast<const void*>(stagewise_tick_kernel<T, 16>),
      reinterpret_cast<const void*>(stagewise_tick_kernel<T, 32>),
      reinterpret_cast<const void*>(stagewise_tick_kernel<T, 0>),
      reinterpret_cast<const void*>(stagewise_tick_kernel_warp<T, 4>),
      reinterpret_cast<const void*>(stagewise_tick_kernel_warp<T, 8>),
      reinterpret_cast<const void*>(stagewise_tick_kernel_warp<T, 16>)};
  cudaError_t e = cudaSuccess;
  for (const void* fn : fns)
    if (e == cudaSuccess) e = allow_max_smem(fn, optin);
  return e;
}

template <typename T, int M>
cudaError_t launch(const void* plan, const void* x0, void* state, int nb,
                   int N, int x, int u, int r, int n_iter, double sigma,
                   double alpha, const int* skip, int carry,
                   const RingConfig& c, cudaStream_t stream) {
  const Lay L = make_layout(x, u, r);
  const T* p = static_cast<const T*>(plan);
  const T* x0t = static_cast<const T*>(x0);
  T* st = static_cast<T*>(state);
  const T sg = static_cast<T>(sigma), al = static_cast<T>(alpha),
          om = static_cast<T>(1.0 - alpha);
  // the instantiations: the warp body at 4, 8 and 16, the block body at 4,
  // 16, 32 and 0
  if (c.warp) {
    if constexpr (M == 4 || M == 8 || M == 16) {
      stagewise_tick_kernel_warp<T, M><<<nb, c.threads, c.bytes, stream>>>(
          p, x0t, st, L, x, u, r, c.Cp, c.Wp, c.Kwp, c.stages, c.group,
          c.kk_resident, nb, N, n_iter, sg, al, om, skip, carry);
      return cudaGetLastError();
    }
  } else {
    if constexpr (M != 8) {
      stagewise_tick_kernel<T, M><<<nb, c.threads, c.bytes, stream>>>(
          p, x0t, st, L, x, u, r, c.Cp, c.Wp, c.Kwp, c.stages, c.group,
          c.kk_resident, nb, N, n_iter, sg, al, om, skip, carry);
      return cudaGetLastError();
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* plan, const void* x0, void* state, int nb,
                   int N, int x, int u, int r, int n_iter, double sigma,
                   double alpha, const int* skip, int carry,
                   cudaStream_t stream) {
  if (x < 1 || u < 1 || r < 0 || x + u + r > kMaxWidth || nb < 1 || N < 1)
    return cudaErrorInvalidValue;
  const RingConfig c = ring_config(N, x, u, r, sizeof(T));
  if (c.stages < 2) return cudaErrorInvalidValue;
  switch (c.unroll) {
    case 4:
      return launch<T, 4>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                          alpha, skip, carry, c, stream);
    case 8:
      return launch<T, 8>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                          alpha, skip, carry, c, stream);
    case 16:
      return launch<T, 16>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                           alpha, skip, carry, c, stream);
    case 32:
      return launch<T, 32>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                           alpha, skip, carry, c, stream);
    default:
      return launch<T, 0>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                          alpha, skip, carry, c, stream);
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
// bytes, unroll, group, warp) of the problem to out (stages 0: the ring
// does not fit).
void copra_stagewise_ring_config(int N, int x, int u, int r, int f64,
                                 int* out) {
  const RingConfig c = ring_config(N, x, u, r, f64 ? 8 : 4);
  const int v[10] = {c.Cp, c.Wp, c.Kwp, c.threads, c.stages, c.kk_resident,
                     c.bytes, c.unroll, c.group, c.warp};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

// Sets the dynamic shared-memory attribute of every instantiation on the
// current device (call once a device, before the first launch).  Returns
// 0 or a CUDA error.
int copra_stagewise_prepare() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = allow_max_smem_all<float>(optin);
  if (e == cudaSuccess) e = allow_max_smem_all<double>(optin);
  return static_cast<int>(e);
}

// n_iter iterations on lane-first padded tensors, plan [B, N+1, Cp] and
// state [B, N+1, Wp + Kwp] (per stage the warm rows, then the work rows;
// x0 [x, B] lane-last) on `stream`: warm is updated in place, work is
// written whole.  skip (null: never) points to an int on the device; when
// it is non-zero every block returns at its entry and the state stays as
// it was.  carry non-zero: the work rows as given are the proximal centre
// of the first iteration (a run that continues the one that wrote them);
// zero: the centre starts at the warm rows' zX, zU.  Returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue outside the
// envelope.
int copra_stagewise_tick(const void* plan, const void* x0, void* state,
                         int nb, int N, int x, int u, int r, int n_iter,
                         int f64, double sigma, double alpha,
                         const void* skip, int carry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sk = static_cast<const int*>(skip);
  return static_cast<int>(
      f64 ? launch<double>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                           alpha, sk, carry, st)
          : launch<float>(plan, x0, state, nb, N, x, u, r, n_iter, sigma,
                          alpha, sk, carry, st));
}

}  // extern "C"
