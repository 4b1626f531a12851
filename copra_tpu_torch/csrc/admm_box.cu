// Fixed-count box-only ADMM over B lanes, each lane with its own n x n
// operators Kinv = (Q + (sigma+rho) I)^-1 and K = Q + (sigma+rho) I.
//
// Replaces the Pallas TPU kernels copra_tpu/ops/admm_kernel.py::
// fused_admm_box_lanes (bodies _lanes_box_kernel_z0, _lanes_qx_kernel,
// _lanes_box_kernel) and fused_admm_box (same math, per-lane layout).
// The TPU version packs the operators lane-major [nc, n8, n8, 128] so a
// matvec runs as n VPU FMAs across 128 lanes; on Hopper the operators stay
// in the plain [B, n, n] layout and one thread block serves one lane.
//
// What bounds it on this card: the operator bytes.  At the main-path shape
// (B = 4096, n = 100) Kinv is 164 MB, three times the 50 MB L2, and an
// iteration needs all of it, so a loop that re-reads it per iteration (the
// plain PyTorch version) streams 30 x 164 MB from device memory per call.
// Read once, it takes 0.05 ms at 3.35 TB/s; the call's 1.2e9 FMAs take
// ~0.04 ms at the f32 peak.  A design that re-reads the operator from
// shared memory every iteration moves 30 x 164 MB through it, ~0.15 ms at
// the 128 B/clk of every SM, so the operator has to sit in registers.
//
// Bodies, chosen by n and the mode (make_config below, mirrored by
// ops/admm_kernel.box_lanes_config and checked against it when the
// library is loaded):
//
// * Register body (n <= 128).  A block of n rounded to 32 threads (a warp
//   per 32 columns) serves one lane.  Thread (warp w, lane t) owns the
//   column quad col = 32 w + 4 (t % 8) .. col + 3 and the row chunks q =
//   4 c + t / 8 (rows 4q..4q+3), c < CH = ceil(n / 16): its 16 CH Kinv
//   entries (112 at n = 100) are loaded once from device memory into
//   registers (a quarter warp reads 128 contiguous bytes of a row) and
//   serve every iteration.  A product reads the iterate as one 16-byte
//   shared-memory load per 4 rows, 16 FMAs: a shared-memory pipe that
//   delivers one word a lane a clock then keeps pace with the FMA pipe
//   (with a column pair a thread it set the pace).  Two
//   accumulator sets (even and odd c) per column; the four row slices'
//   partial sums meet in three __shfl_xor_sync, which leave each column's
//   sum with one lane, and that lane carries the column's x, z, y, w.  The
//   iterate goes through a double-buffered vector in shared memory: one
//   block barrier a product.  K: mode 3 with refine >= 1 stages it once in
//   shared memory by cp.async, every 16-byte piece in flight at once (a
//   plain load loop waits on each load in turn and, measured, cost more
//   than the refinement's products); a quarter warp reads 128 contiguous
//   bytes of a row, so no bank conflict.  With refine = 0 the closing g =
//   x K - (sigma + rho) x is one streaming pass over K from device memory.
//
// * Streamed body (128 < n <= 1024).  A lane's operator no longer fits on
//   chip beside enough resident lanes, so each product re-reads it: 256
//   threads a block, one lane; the same thread layout in passes of 256
//   columns, operator quads loaded straight from device memory (16-byte
//   loads where n is a multiple of 4), two accumulator sets in flight, so
//   the body is bound by the operator bytes of each product.  Each
//   operator word is used by exactly one thread once per product, so
//   staging it through shared memory would buy no reuse.  The lane's
//   vectors live in registers (at most 4 coordinates a thread), the
//   product's input and output in shared memory; two block barriers a
//   product.
//
// * The Q x pass (mode 2): one thread per coordinate, K read straight from
//   device memory, the vector in shared memory (unchanged from the first
//   design: it runs at two thirds of its bound).
//
// Arithmetic follows the row-vector form of the reference twin
// xla_admm_box: out[i] = sum_j M[j, i] v[j] (Kinv from the
// Jacobi-preconditioned inverse is symmetric only up to rounding, so the
// orientation is kept), the sum split over row slices and accumulators.
//
// Modes (chosen by the Python wrapper, copra_tpu_torch/ops/admm_kernel.py):
//   1  x0 = 0, refine = 0, n_iter > 0: K is never read; g comes from the
//      recurrence w <- alpha rhs + (1 - alpha) w, w0 = 0 (K x_t = rhs).
//   2  n_iter = 0: g = x0 K - (sigma + rho) x0; Kinv is never read and K is
//      read straight from device memory (one pass, nothing to reuse).
//   3  general form with `refine` refinement steps against K; takes y0 as
//      y0 and z0 as z0.
//
// A launch allocates nothing and does not synchronise with the host, so it
// can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_box.so admm_box.cu

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kModeX0Zero = 1;
constexpr int kModeQx = 2;
constexpr int kModeGeneral = 3;
constexpr int kBodyRegister = 1;
constexpr int kBodyStreamed = 2;
constexpr int kBodyQx = 3;
constexpr int kMaxN = 1024;
constexpr int kRegMaxChunks = 8;       // register body: n <= 16 x 8
constexpr int kStreamThreads = 256;
constexpr int kStreamSlots = kMaxN / kStreamThreads;  // coordinates a thread
constexpr unsigned kFull = 0xffffffffu;

struct Scalars {
  float sigma;
  float alpha;
  float oma;      // 1 - alpha
  float rho;
  float rho_inv;  // 1 / rho
  float spr;      // sigma + rho
};

// The launch plan of a width and mode: mirrored by box_lanes_config in
// ops/admm_kernel.py and checked against it when the library is loaded.
struct Config {
  int body;     // 1 register, 2 streamed, 3 the Q x pass
  int chunks;   // row chunks of 4 a thread holds per column quad (CH)
  int threads;  // threads per block (one block per lane)
  int smem;     // dynamic shared memory bytes per block
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// body: 0 the default for (n, mode), else 1, 2 or 3.  Returns false for a
// width, mode or forced body the kernel does not take.
bool make_config(int n, int mode, int refine, int body, Config* c) {
  if (n < 1 || n > kMaxN) return false;
  if (mode == kModeQx) {
    if (body != 0 && body != kBodyQx) return false;
    *c = Config{kBodyQx, 0, round_up(n, 32), 4 * n};
    return true;
  }
  if (mode != kModeX0Zero && mode != kModeGeneral) return false;
  const int chunks = (n + 15) / 16;
  if (body == 0) {
    body = chunks <= kRegMaxChunks ? kBodyRegister : kBodyStreamed;
  }
  const int vectors = 4 * 2 * 16 * chunks;  // two [16 CH] vectors
  if (body == kBodyRegister) {
    if (chunks > kRegMaxChunks) return false;
    const int threads = round_up(n, 32);  // a warp per 32 columns
    const bool staged = mode == kModeGeneral && refine > 0;
    *c = Config{kBodyRegister, chunks, threads,
                vectors + (staged ? 4 * 16 * chunks * threads : 0)};
    return true;
  }
  if (body != kBodyStreamed) return false;
  *c = Config{kBodyStreamed, chunks, kStreamThreads, vectors};
  return true;
}

// ---------------------------------------------------------------------------
// Products: out[col + p] = sum_j M[j, col + p] v[j] for the thread's column
// quad col..col+3 (col = 32 w + 4 (t % 8)), summed over its row chunks q =
// 4 c + t / 8 (rows 4q..4q+3) and then over the warp's four row slices.
// The reduction leaves column col + own(t) with lane t, one column a lane
// (own(t) = 2 (slice & 1) + (slice >> 1)).  Every lane of the warp takes
// part (the shuffles).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int own_column(int slice) {
  return 2 * (slice & 1) + (slice >> 1);
}

// Sums the two accumulator sets and the four slices of the warp: slices s
// and s ^ 1 swap column pairs (xor 8), then s and s ^ 2 single columns
// (xor 16), so each column's sum ends with one lane.
__device__ __forceinline__ float reduce(const float (&acc)[2][4],
                                        int slice) {
  float o[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) o[p] = acc[0][p] + acc[1][p];
  const bool b = slice & 1;
  const float r0 = __shfl_xor_sync(kFull, b ? o[0] : o[2], 8);
  const float r1 = __shfl_xor_sync(kFull, b ? o[1] : o[3], 8);
  const float k0 = (b ? o[2] : o[0]) + r0;
  const float k1 = (b ? o[3] : o[1]) + r1;
  const bool h = slice & 2;
  const float r = __shfl_xor_sync(kFull, h ? k0 : k1, 16);
  return (h ? k1 : k0) + r;
}

__device__ __forceinline__ void fma4(float (&a)[4], const float4& v,
                                     const float4& m0, const float4& m1,
                                     const float4& m2, const float4& m3) {
  const float vv[4] = {v.x, v.y, v.z, v.w};
  const float4 m[4] = {m0, m1, m2, m3};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[0] = fmaf(m[r].x, vv[r], a[0]);
    a[1] = fmaf(m[r].y, vv[r], a[1]);
    a[2] = fmaf(m[r].z, vv[r], a[2]);
    a[3] = fmaf(m[r].w, vv[r], a[3]);
  }
}

// The operator quad M[row, col..col+3] from device memory, zero past n.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ M,
                                            int n, int row, int col,
                                            bool vec4) {
  if (row >= n || col >= n) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float* p = M + static_cast<size_t>(row) * n + col;
  if (vec4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), col + 1 < n ? __ldg(p + 1) : 0.0f,
                     col + 2 < n ? __ldg(p + 2) : 0.0f,
                     col + 3 < n ? __ldg(p + 3) : 0.0f);
}

__device__ __forceinline__ float4 chunk(const float* v, int q) {
  return *reinterpret_cast<const float4*>(v + 4 * q);
}

// Register operand: m[c][r] = M[4 (4 c + slice) + r, col..col+3].
template <int CH>
__device__ __forceinline__ float product_regs(const float4 (&m)[CH][4],
                                              const float* v, int slice) {
  float acc[2][4] = {};
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    fma4(acc[c & 1], chunk(v, 4 * c + slice), m[c][0], m[c][1], m[c][2],
         m[c][3]);
  }
  return reduce(acc, slice);
}

// Shared-memory operand: K staged with row stride kst (zero-padded); a
// quarter warp reads 128 contiguous bytes of one row.
template <int CH>
__device__ __forceinline__ float product_smem(const float* ks, int kst,
                                              const float* v, int slice,
                                              int col) {
  float acc[2][4] = {};
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float* k = ks + 4 * (4 * c + slice) * kst + col;
    fma4(acc[c & 1], chunk(v, 4 * c + slice),
         *reinterpret_cast<const float4*>(k),
         *reinterpret_cast<const float4*>(k + kst),
         *reinterpret_cast<const float4*>(k + 2 * kst),
         *reinterpret_cast<const float4*>(k + 3 * kst));
  }
  return reduce(acc, slice);
}

// Device-memory operand, `chunks` row chunks a slice (v holds 16 chunks
// floats, zero past n).
__device__ __forceinline__ float product_global(const float* __restrict__ M,
                                                int n, bool vec4, int chunks,
                                                const float* v, int slice,
                                                int col) {
  float acc[2][4] = {};
#pragma unroll 2
  for (int c = 0; c < chunks; c += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c + h < chunks) {
        const int q = 4 * (c + h) + slice;
        const float4 m0 = load_quad(M, n, 4 * q, col, vec4);
        const float4 m1 = load_quad(M, n, 4 * q + 1, col, vec4);
        const float4 m2 = load_quad(M, n, 4 * q + 2, col, vec4);
        const float4 m3 = load_quad(M, n, 4 * q + 3, col, vec4);
        fma4(acc[h], chunk(v, q), m0, m1, m2, m3);
      }
    }
  }
  return reduce(acc, slice);
}

// ---------------------------------------------------------------------------
// Register body
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (0..size) of `src` into `dst`, zero-filling the rest.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Starts the copy of the n x n operator M into `ks` ([rows][kst], zero past
// n) by cp.async, every piece of 16 bytes in flight at once (a load loop
// would wait on each load in turn); cp.async.wait_all completes it.
__device__ __forceinline__ void stage_operator(float* ks, int kst, int rows,
                                               const float* __restrict__ M,
                                               int n, bool vec4) {
  const int per_row = kst / 4;
  for (int t = threadIdx.x; t < rows * per_row; t += blockDim.x) {
    const int r = t / per_row;
    const int k = 4 * (t - r * per_row);
    float* dst = ks + r * kst + k;
    const int left = r < n ? n - k : 0;  // words of the row from k on
    const float* src = M + static_cast<size_t>(r < n ? r : 0) * n;
    if (vec4) {
      copy16(dst, src + (left > 0 ? k : 0), 4 * max(0, min(4, left)));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        copy4(dst + e, src + (e < left ? k + e : 0), e < left ? 4 : 0);
      }
    }
  }
}

template <int MODE, int CH>
__global__ void __launch_bounds__(32 * ((16 * CH + 31) / 32))
    box_register_kernel(
        const float* __restrict__ kinv, const float* __restrict__ kmat,
        const float* __restrict__ c, const float* __restrict__ l,
        const float* __restrict__ u, const float* __restrict__ x0,
        const float* __restrict__ y0, const float* __restrict__ z0,
        float* __restrict__ xo, float* __restrict__ yo,
        float* __restrict__ zo, float* __restrict__ go, int n, int chunks,
        int n_iter, int refine, int vec4, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVec = 16 * CH;  // floats of one product input
  float* vbuf = smem;            // two product inputs
  float* ks = smem + 2 * kVec;   // K [16 CH][kst] (mode 3, refine >= 1)
  const int kst = blockDim.x;    // the columns the warps cover
  const int lane = threadIdx.x & 31;
  const int slice = lane >> 3;
  const int col = 32 * (threadIdx.x >> 5) + 4 * (lane & 7);
  const int j = col + own_column(slice);  // the lane's own column
  const size_t nn = static_cast<size_t>(n) * n;
  const float* Mi = kinv + blockIdx.x * nn;
  const float* Mk = kmat + blockIdx.x * nn;
  const bool staged = MODE == kModeGeneral && refine > 0;
  const bool v4 = vec4 != 0;

  for (int t = threadIdx.x; t < 2 * kVec; t += blockDim.x) vbuf[t] = 0.0f;
  if (staged) stage_operator(ks, kst, kVec, Mk, n, v4);
  float4 m[CH][4];
#pragma unroll
  for (int q = 0; q < CH; ++q) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[q][r] = load_quad(Mi, n, 4 * (4 * q + slice) + r, col, v4);
    }
  }
  // K has landed (the first product's barrier publishes it)
  if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");

  const bool own = j < n;
  const size_t vo = blockIdx.x * static_cast<size_t>(n) + j;
  const float cv = own ? c[vo] : 0.0f;
  const float lv = own ? l[vo] : 0.0f;
  const float uv = own ? u[vo] : 0.0f;
  float z = own ? z0[vo] : 0.0f;
  float y = own ? y0[vo] : 0.0f;
  float x = (MODE == kModeGeneral && own) ? x0[vo] : 0.0f;
  float w = 0.0f;

  // A product's input goes to the buffer the product before the last one
  // read, behind the barrier that started the product in between.
  int cur = 0;
  auto put = [&](float a) {
    float* v = vbuf + (cur ^ 1) * kVec;
    if (own) v[j] = a;
    cur ^= 1;
    __syncthreads();
    return static_cast<const float*>(vbuf + cur * kVec);
  };

  for (int it = 0; it < n_iter; ++it) {
    const float rhs = s.sigma * x - cv + s.rho * z - y;
    float xt = product_regs<CH>(m, put(rhs), slice);
    if (MODE == kModeGeneral) {
      for (int rf = 0; rf < refine; ++rf) {
        const float t = product_smem<CH>(ks, kst, put(xt), slice, col);
        xt += product_regs<CH>(m, put(rhs - t), slice);
      }
    }
    const float xn = s.alpha * xt + s.oma * x;
    const float zrel = s.alpha * xt + s.oma * z;
    const float zn = fminf(fmaxf(zrel + s.rho_inv * y, lv), uv);
    y = y + s.rho * (zrel - zn);
    if (MODE == kModeX0Zero) w = s.alpha * rhs + s.oma * w;
    x = xn;
    z = zn;
  }

  float g;
  if (MODE == kModeX0Zero) {
    g = w - s.spr * x;
  } else {
    const float* v = put(x);
    g = (staged ? product_smem<CH>(ks, kst, v, slice, col)
                : product_global(Mk, n, v4, CH, v, slice, col)) -
        s.spr * x;
  }
  if (own) {
    xo[vo] = x;
    yo[vo] = y;
    zo[vo] = z;
    go[vo] = g;
  }
}

// ---------------------------------------------------------------------------
// Streamed body
// ---------------------------------------------------------------------------

// out[j] = sum_k vin[k] M[k, j] for every j < n, in passes of 256 columns
// (a warp's 32 columns a pass; a warp past n skips the pass).
__device__ __forceinline__ void product_stream(const float* __restrict__ M,
                                               int n, bool vec4, int chunks,
                                               const float* vin, float* vout) {
  const int lane = threadIdx.x & 31;
  const int slice = lane >> 3;
  const int warp = threadIdx.x >> 5;
  for (int base = 32 * warp; base < n; base += 32 * (kStreamThreads / 32)) {
    const int col = base + 4 * (lane & 7);
    const float o = product_global(M, n, vec4, chunks, vin, slice, col);
    const int j = col + own_column(slice);
    if (j < n) vout[j] = o;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kStreamThreads) box_streamed_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int n, int chunks, int n_iter, int refine,
    int vec4, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  float* vin = smem;                // [16 chunks], zero past n
  float* vout = smem + 16 * chunks;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* Mi = kinv + blockIdx.x * nn;
  const float* Mk = kmat + blockIdx.x * nn;
  const bool v4 = vec4 != 0;
  for (int t = threadIdx.x; t < 32 * chunks; t += kStreamThreads) {
    smem[t] = 0.0f;
  }

  // coordinates i = threadIdx.x + 256 k
  const size_t vo = blockIdx.x * static_cast<size_t>(n);
  float cv[kStreamSlots], lv[kStreamSlots], uv[kStreamSlots];
  float x[kStreamSlots], z[kStreamSlots], y[kStreamSlots];
  float w[kStreamSlots], rhs[kStreamSlots], xt[kStreamSlots];
#pragma unroll
  for (int k = 0; k < kStreamSlots; ++k) {
    const int i = threadIdx.x + kStreamThreads * k;
    const bool ok = i < n;
    cv[k] = ok ? c[vo + i] : 0.0f;
    lv[k] = ok ? l[vo + i] : 0.0f;
    uv[k] = ok ? u[vo + i] : 0.0f;
    z[k] = ok ? z0[vo + i] : 0.0f;
    y[k] = ok ? y0[vo + i] : 0.0f;
    x[k] = (MODE == kModeGeneral && ok) ? x0[vo + i] : 0.0f;
    w[k] = 0.0f;
  }
  // vin <- a (per coordinate), then the product into vout, then back
  auto product = [&](const float* M, const float (&a)[kStreamSlots],
                     float (&out)[kStreamSlots]) {
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      const int i = threadIdx.x + kStreamThreads * k;
      if (i < n) vin[i] = a[k];
    }
    __syncthreads();
    product_stream(M, n, v4, chunks, vin, vout);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      const int i = threadIdx.x + kStreamThreads * k;
      out[k] = i < n ? vout[i] : 0.0f;
    }
  };

  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      rhs[k] = s.sigma * x[k] - cv[k] + s.rho * z[k] - y[k];
    }
    product(Mi, rhs, xt);
    if (MODE == kModeGeneral) {
      for (int rf = 0; rf < refine; ++rf) {
        float t[kStreamSlots], d[kStreamSlots];
        product(Mk, xt, t);
#pragma unroll
        for (int k = 0; k < kStreamSlots; ++k) t[k] = rhs[k] - t[k];
        product(Mi, t, d);
#pragma unroll
        for (int k = 0; k < kStreamSlots; ++k) xt[k] += d[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) {
      const float xn = s.alpha * xt[k] + s.oma * x[k];
      const float zrel = s.alpha * xt[k] + s.oma * z[k];
      const float zn = fminf(fmaxf(zrel + s.rho_inv * y[k], lv[k]), uv[k]);
      y[k] = y[k] + s.rho * (zrel - zn);
      if (MODE == kModeX0Zero) w[k] = s.alpha * rhs[k] + s.oma * w[k];
      x[k] = xn;
      z[k] = zn;
    }
  }

  float g[kStreamSlots];
  if (MODE == kModeGeneral) {
    product(Mk, x, g);
  } else {
#pragma unroll
    for (int k = 0; k < kStreamSlots; ++k) g[k] = w[k];
  }
#pragma unroll
  for (int k = 0; k < kStreamSlots; ++k) {
    const int i = threadIdx.x + kStreamThreads * k;
    if (i < n) {
      xo[vo + i] = x[k];
      yo[vo + i] = y[k];
      zo[vo + i] = z[k];
      go[vo + i] = g[k] - s.spr * x[k];
    }
  }
}

// ---------------------------------------------------------------------------
// The Q x pass: g = x0 K - (sigma + rho) x0, one thread per coordinate.
// ---------------------------------------------------------------------------

// out[i] = sum_j M[j * n + i] * v[j], summed in ascending j.
__device__ __forceinline__ float column_dot(const float* __restrict__ M,
                                           const float* __restrict__ v,
                                           int n, int i) {
  float acc = 0.0f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    acc = fmaf(M[static_cast<size_t>(j) * n + i], v[j], acc);
  }
  return acc;
}

__global__ void box_qx_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int n, int chunks, int n_iter, int refine,
    int vec4, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t lane = blockIdx.x;
  const size_t vo = lane * n + i;
  float* sv = smem;  // [n]
  const float xv = active ? x0[vo] : 0.0f;
  if (active) sv[i] = xv;
  __syncthreads();
  if (active) {
    go[vo] = column_dot(kmat + lane * nn, sv, n, i) - s.spr * xv;
    xo[vo] = xv;
    yo[vo] = y0[vo];
    zo[vo] = z0[vo];
  }
}

// ---------------------------------------------------------------------------
// Launch: every body takes the same parameters (the Q x pass ignores the
// iteration's, the register body the chunk count it is instantiated for).
// ---------------------------------------------------------------------------

template <int MODE>
const void* register_kernel(int chunks) {
  switch (chunks) {
    case 1: return reinterpret_cast<const void*>(box_register_kernel<MODE, 1>);
    case 2: return reinterpret_cast<const void*>(box_register_kernel<MODE, 2>);
    case 3: return reinterpret_cast<const void*>(box_register_kernel<MODE, 3>);
    case 4: return reinterpret_cast<const void*>(box_register_kernel<MODE, 4>);
    case 5: return reinterpret_cast<const void*>(box_register_kernel<MODE, 5>);
    case 6: return reinterpret_cast<const void*>(box_register_kernel<MODE, 6>);
    case 7: return reinterpret_cast<const void*>(box_register_kernel<MODE, 7>);
    case 8: return reinterpret_cast<const void*>(box_register_kernel<MODE, 8>);
    default: return nullptr;
  }
}

// The kernel of a launch plan in `mode`.
const void* kernel_of(const Config& cfg, int mode) {
  if (cfg.body == kBodyQx) return reinterpret_cast<const void*>(box_qx_kernel);
  const bool x0z = mode == kModeX0Zero;
  if (cfg.body == kBodyStreamed) {
    return x0z ? reinterpret_cast<const void*>(box_streamed_kernel<kModeX0Zero>)
               : reinterpret_cast<const void*>(
                     box_streamed_kernel<kModeGeneral>);
  }
  return x0z ? register_kernel<kModeX0Zero>(cfg.chunks)
             : register_kernel<kModeGeneral>(cfg.chunks);
}

// Opts the kernel into its dynamic shared memory above the default 48 KB.
cudaError_t allow_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// The launch plan of (n, mode, refine) with body `body` (0: the default;
// 1 register; 2 streamed; 3 the Q x pass) as 4 ints: body, row chunks per
// thread, threads per block, shared-memory bytes.  Returns 0, or -1 for a
// width, mode or body the kernel does not take.
int copra_admm_box_config(int n, int mode, int refine, int body, int* out) {
  Config c;
  if (!make_config(n, mode, refine, body, &c)) return -1;
  out[0] = c.body;
  out[1] = c.chunks;
  out[2] = c.threads;
  out[3] = c.smem;
  return 0;
}

// Largest dynamic shared memory a block may opt into on `device`.
int copra_admm_box_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

const char* copra_admm_box_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Registers a thread, local-memory (spill) bytes a thread, the largest
// block and the blocks an SM holds (shared memory and registers) of the
// kernel that serves (n, mode, refine, body), as 4 ints; returns 0, -1 for
// a plan the kernel does not take, or a CUDA error.
int copra_admm_box_attributes(int n, int mode, int refine, int body,
                              int* out) {
  Config cfg;
  if (!make_config(n, mode, refine, body, &cfg)) return -1;
  const void* fn = kernel_of(cfg, mode);
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = allow_smem(fn, cfg.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        cfg.threads, cfg.smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}

// Launches the kernel on `stream` with the body `body` (0: the default);
// returns cudaGetLastError() (0 = launched).
int copra_admm_box(const float* kinv, const float* kmat, const float* c,
                   const float* l, const float* u, const float* x0,
                   const float* y0, const float* z0, float* xo, float* yo,
                   float* zo, float* go, int batch, int n, int n_iter,
                   int refine, int mode, int body, float sigma, float alpha,
                   float oma, float rho, float rho_inv, float spr,
                   void* stream) {
  Config cfg;
  if (batch < 1 || n_iter < 0 || refine < 0 ||
      !make_config(n, mode, refine, body, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scalars s{sigma, alpha, oma, rho, rho_inv, spr};
  // 16-byte operator loads: n a multiple of 4, both operators aligned
  int vec4 = (n % 4 == 0 && reinterpret_cast<uintptr_t>(kinv) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(kmat) % 16 == 0)
                 ? 1
                 : 0;
  const void* fn = kernel_of(cfg, mode);
  {
    const cudaError_t err = allow_smem(fn, cfg.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int chunks = cfg.chunks;
  void* args[] = {&kinv, &kmat, &c,  &l,  &u,      &x0,     &y0,
                  &z0,   &xo,   &yo, &zo, &go,     &n,      &chunks,
                  &n_iter, &refine, &vec4, &s};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(batch),
                                           dim3(cfg.threads), args,
                                           cfg.smem,
                                           static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
