// The quadratic Riccati recursion of a batch of stagewise problems, one lane
// a block, written straight into the stagewise tick's packed plan: per
// stage k = N-1 .. 0, with V = V_{k+1} (V_N = Qx_N),
//
//   F = Ru_k + B'V B,   G = S_k' + B'V A,   K = -F^-1 G,   nF = -F^-1,
//   bvd = B'V d,        avd = A'V d,
//   V <- sym(Qx_k + A'V A + G'K)
//
// (ops/stagewise_kernel.precompute_lqr_gains, the plain route and the test
// oracle, in the same order), and per stage the plan's data-dependent
// columns: A, B, d, K, nF, qb = qx + avd (qb_N = qx_N) and rb = ru + bvd.
// The plan's other columns (penalties, bounds, rows) are left as they are.
// G is not a column of the plan (the tick forms K'h for G'kk) and is not
// written.  F is inverted by Gauss-Jordan elimination without pivoting (F
// is symmetric positive definite: Ru_k carries the ADMM ridge) on [F | I]
// in shared memory, one block barrier a pivot, the rows double-buffered so
// that no entry is read after it is overwritten.
//
// What bounds it: the chain of N dependent stages, each a few small matrix
// products and u pivots separated by block barriers; at the quadruped's
// (N, x, u) = (40, 12, 12) 16 barriers a stage.  One block a lane, every
// stage's matrices in shared memory (at most 157 KB at x = u = 32 in
// float64), the products one output entry a thread.  A stage's operands
// (A, B, S, Ru, d, Qx, qx, ru) come in by cp.async a stage ahead, into the
// other half of a double buffer, so that no global load waits on the
// chain; V's symmetric part is formed where V is, one thread an entry
// pair.
//
// The output's place is given by strides (lane, stage, column) in elements,
// so that the kernel writes the plan as the tick kernel reads it
// (lane-first, ops/stagewise_kernel.lane_first_plan) or the lane-last plan
// [N+1, C, B]; the column offsets are ops/stagewise_kernel._Layout's.  The
// inputs are lane-first and contiguous: A [B, N, x, x], B [B, N, x, u], d
// [B, N, x], Qx [B, N+1, x, x] and Ru [B, N, u, u] ridged, S [B, N, x, u]
// (or null: no cross term), qx [B, N+1, x], ru [B, N, u].
//
// A launch allocates nothing and does not synchronise with the host, so it
// can be captured in a CUDA graph; the shared-memory attribute is set once
// per device by copra_riccati_gains_prepare.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libriccati_gains.so riccati_gains.cu

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 32;
constexpr int kMaxThreads = 256;

struct Out {
  long long lane, stage, col;   // strides, in elements
  int A, B, d, K, nF, qb, rb;   // column offsets
};

// One stage's operands as they sit in a half of the double buffer: A, B,
// S, Ru, d, then Qx, qx of the same stage and ru.
struct Seg {
  int A, B, S, R, d, Q, q, r, P;
  __host__ __device__ Seg(int x, int u)
      : A(0), B(x * x), S(B + x * u), R(S + x * u), d(R + u * u), Q(d + x),
        q(Q + x * x), r(q + x), P(r + u) {}
};

// Shared-memory values of one lane's block: V, A'V (x*x each); B'V, G, K
// (x*u each); [F | I] twice (2 u*u each); avd (x), bvd (u); two stages'
// operands (Seg::P each).
__host__ __device__ inline int smem_values(int x, int u) {
  return 2 * x * x + 3 * x * u + 4 * u * u + x + u + 2 * Seg(x, u).P;
}

inline int threads_for(int x, int u) {
  int t = ((x * x + x * u + 31) / 32) * 32;
  return t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
}

template <typename T>
__device__ inline void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
  }
}

__device__ inline void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) riccati_gains_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ dv, const T* __restrict__ Qr,
    const T* __restrict__ Rr, const T* __restrict__ S,
    const T* __restrict__ qx, const T* __restrict__ ru, T* __restrict__ plan,
    int N, int x, int u, Out o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xx = x * x, xu = x * u, uu = u * u, w2 = 2 * u;
  const Seg sg(x, u);
  T* V = reinterpret_cast<T*>(smem_raw);
  T* AtV = V + xx;
  T* BtV = AtV + xx;    // [u][x]
  T* G = BtV + xu;      // [u][x]
  T* Kk = G + xu;       // [u][x]
  T* Fa = Kk + xu;      // [u][2u]
  T* Fb = Fa + 2 * uu;  // [u][2u]
  T* avd = Fb + 2 * uu;
  T* bvd = avd + x;
  T* buf[2] = {bvd + u, bvd + u + sg.P};

  const long long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  T* out = plan + lane * o.lane;
  auto put = [&](int k, int c, T v) {
    out[k * o.stage + static_cast<long long>(c) * o.col] = v;
  };
  // stage k's operands into `blk`, by cp.async; S's part is zero without
  // a cross term (written once, never copied over)
  auto fetch = [&](T* blk, int k) {
    const long long s = lane * N + k, sq = lane * (N + 1) + k;
    for (int e = tid; e < sg.P; e += nt) {
      const T* src;
      if (e < sg.B) src = A + s * xx + e;
      else if (e < sg.S) src = Bm + s * xu + (e - sg.B);
      else if (e < sg.R) {
        if (S == nullptr) continue;
        src = S + s * xu + (e - sg.S);
      } else if (e < sg.d) src = Rr + s * uu + (e - sg.R);
      else if (e < sg.Q) src = dv + s * x + (e - sg.d);
      else if (e < sg.q) src = Qr + sq * xx + (e - sg.Q);
      else if (e < sg.r) src = qx + sq * x + (e - sg.q);
      else src = ru + s * u + (e - sg.r);
      copy_async(blk + e, src);
    }
    copies_commit();
  };

  if (S == nullptr) {
    for (int e = tid; e < xu; e += nt) {
      buf[0][sg.S + e] = T(0);
      buf[1][sg.S + e] = T(0);
    }
  }
  const T* QN = Qr + (lane * (N + 1) + N) * xx;
  for (int e = tid; e < xx; e += nt) V[e] = QN[e];
  const T* qN = qx + (lane * (N + 1) + N) * x;
  for (int i = tid; i < x; i += nt) put(N, o.qb + i, qN[i]);
  fetch(buf[0], N - 1);
  copies_wait();
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    const T* cur = buf[(N - 1 - k) & 1];
    if (k > 0) fetch(buf[(N - k) & 1], k - 1);
    const T* Ak = cur + sg.A;
    const T* Bk = cur + sg.B;
    const T* Sk = cur + sg.S;
    const T* Rk = cur + sg.R;
    const T* dk = cur + sg.d;
    const T* Qk = cur + sg.Q;
    const T* qk = cur + sg.q;
    const T* rk = cur + sg.r;

    // B'V [u][x] and A'V [x][x]
    for (int e = tid; e < xu + xx; e += nt) {
      T acc = T(0);
      if (e < xu) {
        const int c = e / x, j = e % x;
        for (int i = 0; i < x; ++i) acc += Bk[i * u + c] * V[i * x + j];
        BtV[e] = acc;
      } else {
        const int f = e - xu, i = f / x, j = f % x;
        for (int l = 0; l < x; ++l) acc += Ak[l * x + i] * V[l * x + j];
        AtV[f] = acc;
      }
    }
    __syncthreads();

    // [F | I], G, bvd, avd
    for (int e = tid; e < uu + xu + u + x; e += nt) {
      T acc = T(0);
      if (e < uu) {
        const int c = e / u, c2 = e % u;
        for (int j = 0; j < x; ++j) acc += BtV[c * x + j] * Bk[j * u + c2];
        Fa[c * w2 + c2] = Rk[e] + acc;
        Fa[c * w2 + u + c2] = c == c2 ? T(1) : T(0);
      } else if (e < uu + xu) {
        const int f = e - uu, c = f / x, j = f % x;
        for (int l = 0; l < x; ++l) acc += BtV[c * x + l] * Ak[l * x + j];
        G[f] = Sk[j * u + c] + acc;
      } else if (e < uu + xu + u) {
        const int c = e - uu - xu;
        for (int j = 0; j < x; ++j) acc += BtV[c * x + j] * dk[j];
        bvd[c] = acc;
      } else {
        const int i = e - uu - xu - u;
        for (int j = 0; j < x; ++j) acc += AtV[i * x + j] * dk[j];
        avd[i] = acc;
      }
    }
    __syncthreads();

    // Gauss-Jordan on [F | I]: pivot p read from one buffer, written to
    // the other
    T* fc = Fa;
    T* fn = Fb;
    for (int p = 0; p < u; ++p) {
      const T piv = fc[p * w2 + p];
      for (int e = tid; e < u * w2; e += nt) {
        const int row = e / w2, c = e % w2;
        const T scaled = fc[p * w2 + c] / piv;
        fn[e] = row == p ? scaled : fc[e] - fc[row * w2 + p] * scaled;
      }
      __syncthreads();
      T* t = fc;
      fc = fn;
      fn = t;
    }
    // fc[a][u + b] = F^-1

    // K = -F^-1 G, and the stage's columns
    for (int e = tid; e < xu; e += nt) {
      const int c = e / x, j = e % x;
      T acc = T(0);
      for (int b2 = 0; b2 < u; ++b2) acc += fc[c * w2 + u + b2] * G[b2 * x + j];
      Kk[e] = -acc;
      put(k, o.K + e, -acc);
      put(k, o.B + e, Bk[e]);
    }
    for (int e = tid; e < uu; e += nt) {
      put(k, o.nF + e, -fc[(e / u) * w2 + u + e % u]);
    }
    for (int e = tid; e < xx; e += nt) put(k, o.A + e, Ak[e]);
    for (int i = tid; i < x; i += nt) {
      put(k, o.d + i, dk[i]);
      put(k, o.qb + i, qk[i] + avd[i]);
    }
    for (int c = tid; c < u; c += nt) put(k, o.rb + c, rk[c] + bvd[c]);
    __syncthreads();

    // V <- sym(Qx_k + A'V A + G'K), an entry pair a thread (V itself was
    // last read before the F phase's barrier)
    for (int e = tid; e < xx; e += nt) {
      const int i = e / x, j = e % x;
      if (j < i) continue;
      T a1 = T(0), a2 = T(0), b1 = T(0), b2 = T(0);
      for (int l = 0; l < x; ++l) {
        a1 += AtV[i * x + l] * Ak[l * x + j];
        b1 += AtV[j * x + l] * Ak[l * x + i];
      }
      for (int c = 0; c < u; ++c) {
        a2 += G[c * x + i] * Kk[c * x + j];
        b2 += G[c * x + j] * Kk[c * x + i];
      }
      const T v = T(0.5) * ((Qk[i * x + j] + a1 + a2)
                            + (Qk[j * x + i] + b1 + b2));
      V[i * x + j] = v;
      V[j * x + i] = v;
    }
    copies_wait();     // the next stage's operands have landed
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of a lane's block at (x, u) in float64 (`is_double`)
// or float32.
int copra_riccati_gains_smem(int x, int u, int is_double) {
  return smem_values(x, u) * (is_double ? 8 : 4);
}

// Opts both instantiations into the shared memory of the widest shape,
// x = u = kMaxDim, on the current device.  Returns a CUDA error (0 = set).
int copra_riccati_gains_prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      riccati_gains_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      copra_riccati_gains_smem(kMaxDim, kMaxDim, 0));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        riccati_gains_kernel<double>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        copra_riccati_gains_smem(kMaxDim, kMaxDim, 1));
  }
  return static_cast<int>(err);
}

const char* copra_riccati_gains_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the recursion of `batch` lanes on `stream`.  `offsets` holds the
// column offsets of A, B, d, K, nF, qb, rb; `strides` the output's lane,
// stage and column strides.  Returns the launch's error (0 = launched).
int copra_riccati_gains(const void* A, const void* B, const void* d,
                        const void* Qr, const void* Rr, const void* S,
                        const void* qx, const void* ru, void* plan, int batch,
                        int N, int x, int u, int is_double,
                        const int* offsets, const long long* strides,
                        void* stream) {
  if (batch < 1 || N < 1 || x < 1 || u < 1 || x > kMaxDim || u > kMaxDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Out o;
  o.lane = strides[0];
  o.stage = strides[1];
  o.col = strides[2];
  o.A = offsets[0];
  o.B = offsets[1];
  o.d = offsets[2];
  o.K = offsets[3];
  o.nF = offsets[4];
  o.qb = offsets[5];
  o.rb = offsets[6];
  const int smem = copra_riccati_gains_smem(x, u, is_double);
  void* args[] = {&A, &B, &d, &Qr, &Rr, &S, &qx, &ru, &plan, &N, &x, &u, &o};
  const void* fn = is_double
      ? reinterpret_cast<const void*>(riccati_gains_kernel<double>)
      : reinterpret_cast<const void*>(riccati_gains_kernel<float>);
  return static_cast<int>(cudaLaunchKernel(
      fn, dim3(batch), dim3(threads_for(x, u)), args, smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
