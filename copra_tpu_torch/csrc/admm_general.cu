// Fixed-count general-constraint ADMM over B lanes, each with its own dense
// constraint matrix C [m, n], its own penalties rho [m] and its own KKT
// inverse Kinv = (Q + sigma I + C' diag(rho) C)^-1 [n, n]: the iteration of
// the general QP solver (qp/admm.solve_qp with kkt_solve = "inverse" and no
// refinement) run a fixed number of times per lane, in x-space.
//
// Replaces the Pallas TPU kernel copra_tpu/ops/admm_kernel.py::
// fused_admm_general (body _general_kernel).  The TPU version walks
// `sub_batch` scenarios per grid step with their operators resident in VMEM;
// that blocking is a TPU layout choice and is not carried over.
//
// One iteration per lane, in the reference's order:
//   w   = rho . z - y                      [m]
//   rhs = sigma x - c + w C                [n]   (C' w)
//   x_t = rhs Kinv                         [n]   (contracts Kinv's FIRST axis)
//   z_t = C x_t                            [m]
//   x   = alpha x_t + (1 - alpha) x
//   z_r = alpha z_t + (1 - alpha) z
//   z   = clip(z_r + y / rho, l, u);  y += rho . (z_r - z)
// Lower bounds of inequality rows are -inf and box rows may be +-inf: the
// clip is fmaxf/fminf and no difference of two bounds is ever formed.  1/rho
// is formed once per lane.  Sums are plain f32 FMA chains, as the plain
// version's f32 products.
//
// What bounds it on this card: a dependent chain, then instruction issue.
// At B = 4096, n = 10, m = 85 and 400 iterations the arithmetic is ~8e9
// FLOP (0.12 ms at the 67 TFLOP/s f32 peak) and the operators are 16 MB,
// read once, but each lane's iterations run one after another, each three
// small products deep.  So the design keeps a lane's operators and state in
// registers, lets many lanes share an SM, and spends as few instructions
// as it can on moving partial sums between threads.
//
// Two bodies (make_config, mirrored in ops/admm_kernel.general_lanes_config
// and checked against it when the library is loaded):
//
// * Register (n <= 16, m <= 96: config 2's class).  A lane belongs to a
//   group of 16 threads, 8 lanes a 128-thread block.  Thread g owns rows
//   g + 16 r (r < RS): their entries of C (RS x CN registers, CN = n rounded
//   to 2, the padding 0), z, y, l, u, rho and 1/rho; and column g of Kinv,
//   x_g and c_g.  All of it is loaded once.  w C: each thread sums its rows
//   into CN partial sums; a reduce-scatter of 15 shuffles over the group
//   (halving the slots at each of 4 levels) leaves column g's sum on thread
//   g.  rhs_g is formed there, gathered by CN shuffles, and thread g sums
//   x_t,g = rhs Kinv[:, g] from its registers; x_t is gathered by CN more
//   shuffles, and each thread computes its rows of C x_t and their updates.
//   No shared memory and no barrier: lanes are independent, and a group
//   whose lane lies past B runs on zeros so that the warp's shuffles stay
//   whole.
// * Wide (n <= 256, m <= 1024 otherwise).  A warp per lane, one a block,
//   the lane's vectors in the block's shared memory (7 m + 4 n floats,
//   32 KB at the widest, under the 48 KB a block may take without opting
//   in), the operators read from device memory (L1/L2) in every product.
//   Right, not fast: no served configuration runs it.
//
// A launch allocates nothing, sets no attribute and does not synchronise
// with the host, so it can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_general.so admm_general.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBodyRegister = 1;
constexpr int kBodyWide = 2;
constexpr int kGroup = 16;          // threads per lane, register body
constexpr int kRegThreads = 128;    // 8 lanes a block
constexpr int kRegMaxN = 16;
constexpr int kRegMaxM = 96;        // 6 rows a thread, at most
constexpr int kMaxN = 256;
constexpr int kMaxM = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Scalars {
  float sigma;
  float alpha;
  float oma;  // 1 - alpha
};

// The launch plan of a shape: mirrored by general_lanes_config in
// ops/admm_kernel.py and checked against it when the library is loaded.
struct Config {
  int body;     // 1 register, 2 wide
  int rs;       // row slots a thread (register: m <= 16 rs; wide: 0)
  int cs;       // column slots (register: n rounded to 2; wide: 0)
  int lanes;    // lanes a block
  int threads;  // threads a block
  int smem;     // dynamic shared memory bytes a block
};

// body: 0 the default for (n, m), 1 register, 2 wide.  Returns false for a
// shape (or a forced body) the kernel does not take.
bool make_config(int n, int m, int body, Config* c) {
  if (n < 1 || m < 1 || n > kMaxN || m > kMaxM || body < 0 || body > 2) {
    return false;
  }
  const bool reg = n <= kRegMaxN && m <= kRegMaxM;
  if (body == 0) body = reg ? kBodyRegister : kBodyWide;
  if (body == kBodyRegister) {
    if (!reg) return false;
    const int rs = (m + 2 * kGroup - 1) / (2 * kGroup) * 2;
    *c = Config{kBodyRegister, rs, (n + 1) / 2 * 2, kRegThreads / kGroup,
                kRegThreads, 0};
    return true;
  }
  // w z y l u rho 1/rho [m], rhs x_t x c [n]
  *c = Config{kBodyWide, 0, 0, 1, 32, (4 * (7 * m + 4 * n) + 15) / 16 * 16};
  return true;
}

// ---------------------------------------------------------------------------
// Register body
// ---------------------------------------------------------------------------

// One level of the group's reduce-scatter, half-width H: slot k stands for
// column k + (a multiple of 2H) and its partner slot k + H for the column H
// above; the thread whose bit H is set keeps the upper one and sends the
// lower.  A slot k >= CN is 0 on every thread and is skipped.  H is a
// template argument so that the slot loop unrolls and every slot stays in
// a register.
template <int CN, int H>
__device__ __forceinline__ void scatter_level(float (&v)[kGroup], int g) {
  const bool upper = (g & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    if (k < CN) {
      const float send = upper ? v[k] : v[k + H];
      const float keep = upper ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, H, kGroup);
    }
  }
}

static_assert(kGroup == 16, "group_column_sum runs 4 levels");

// The group's sum of each column: on entry v[j] is this thread's partial
// sum of column j (v[j] = 0 for j >= CN); on return v[0] holds the group's
// sum of column g, after 4 levels and at most 15 shuffles.
template <int CN>
__device__ __forceinline__ float group_column_sum(float (&v)[kGroup], int g) {
  scatter_level<CN, 8>(v, g);
  scatter_level<CN, 4>(v, g);
  scatter_level<CN, 2>(v, g);
  scatter_level<CN, 1>(v, g);
  return v[0];
}

// RS row slots a thread (m <= 16 RS), CN columns (n <= CN <= 16).
template <int RS, int CN>
__global__ void __launch_bounds__(kRegThreads) general_register_kernel(
    const float* __restrict__ kinv, const float* __restrict__ cmat,
    const float* __restrict__ cvec, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, Scalars s) {
  const int g = threadIdx.x % kGroup;
  const size_t lane =
      static_cast<size_t>(blockIdx.x) * (kRegThreads / kGroup) +
      threadIdx.x / kGroup;
  const bool live = lane < static_cast<size_t>(batch);
  const float* C = cmat + lane * m * n;
  const size_t rb = lane * m;

  float cr[RS][CN], z[RS], y[RS], lo[RS], hi[RS], rh[RS], ri[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = g + kGroup * r;
    const bool ok = live && i < m;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      cr[r][j] = ok && j < n ? C[i * n + j] : 0.0f;
    }
    z[r] = ok ? z0[rb + i] : 0.0f;
    y[r] = ok ? y0[rb + i] : 0.0f;
    lo[r] = ok ? l[rb + i] : 0.0f;
    hi[r] = ok ? u[rb + i] : 0.0f;
    rh[r] = ok ? rho[rb + i] : 1.0f;
    ri[r] = 1.0f / rh[r];
  }
  const bool col = live && g < n;
  const float* Ki = kinv + lane * n * n;
  float kc[CN];  // Kinv[:, g]
#pragma unroll
  for (int k = 0; k < CN; ++k) kc[k] = col && k < n ? Ki[k * n + g] : 0.0f;
  float x = col ? x0[lane * n + g] : 0.0f;
  const float c = col ? cvec[lane * n + g] : 0.0f;

  for (int it = 0; it < n_iter; ++it) {
    float v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const float w = rh[r] * z[r] - y[r];
#pragma unroll
      for (int j = 0; j < CN; ++j) v[j] = fmaf(w, cr[r][j], v[j]);
    }
    const float rhs = s.sigma * x - c + group_column_sum<CN>(v, g);
    float xt = 0.0f;
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      xt = fmaf(__shfl_sync(kFull, rhs, k, kGroup), kc[k], xt);
    }
    float xv[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) xv[j] = __shfl_sync(kFull, xt, j, kGroup);
    x = s.alpha * xt + s.oma * x;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      float zt = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) zt = fmaf(cr[r][j], xv[j], zt);
      const float zrel = s.alpha * zt + s.oma * z[r];
      const float zn = fminf(fmaxf(zrel + ri[r] * y[r], lo[r]), hi[r]);
      y[r] = y[r] + rh[r] * (zrel - zn);
      z[r] = zn;
    }
  }

#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = g + kGroup * r;
    if (live && i < m) {
      yo[rb + i] = y[r];
      zo[rb + i] = z[r];
    }
  }
  if (col) xo[lane * n + g] = x;
}

// ---------------------------------------------------------------------------
// Wide body
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32) general_wide_kernel(
    const float* __restrict__ kinv, const float* __restrict__ cmat,
    const float* __restrict__ cvec, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, Scalars s) {
  extern __shared__ __align__(16) float wsm[];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  float* w = wsm;  // the row vector the warp reads
  float* z = w + m;
  float* y = z + m;
  float* lo = y + m;
  float* hi = lo + m;
  float* rh = hi + m;
  float* ri = rh + m;
  float* rhs = ri + m;  // the column vectors the warp reads
  float* xt = rhs + n;
  float* x = xt + n;
  float* c = x + n;
  const float* C = cmat + b * m * n;
  const float* Ki = kinv + b * n * n;
  for (int i = t; i < m; i += 32) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    lo[i] = l[b * m + i];
    hi[i] = u[b * m + i];
    rh[i] = rho[b * m + i];
    ri[i] = 1.0f / rh[i];
  }
  for (int j = t; j < n; j += 32) {
    x[j] = x0[b * n + j];
    c[j] = cvec[b * n + j];
  }

  // Each thread writes only its own rows (i) and columns (j); a product's
  // left operand is written before the __syncwarp that precedes its reads,
  // and rewritten only after the __syncwarp that follows them.
  for (int it = 0; it < n_iter; ++it) {
    for (int i = t; i < m; i += 32) w[i] = rh[i] * z[i] - y[i];
    __syncwarp();
    for (int j = t; j < n; j += 32) {  // w C: neighbouring threads, columns
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) {
        acc = fmaf(w[i], __ldg(C + static_cast<size_t>(i) * n + j), acc);
      }
      rhs[j] = s.sigma * x[j] - c[j] + acc;
    }
    __syncwarp();
    for (int j = t; j < n; j += 32) {  // rhs Kinv
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) {
        acc = fmaf(rhs[k], __ldg(Ki + static_cast<size_t>(k) * n + j), acc);
      }
      xt[j] = acc;
    }
    __syncwarp();
    for (int i = t; i < m; i += 32) {  // C x_t and the row updates
      const float* row = C + static_cast<size_t>(i) * n;
      float zt = 0.0f;
      for (int j = 0; j < n; ++j) zt = fmaf(__ldg(row + j), xt[j], zt);
      const float zrel = s.alpha * zt + s.oma * z[i];
      const float zn = fminf(fmaxf(zrel + ri[i] * y[i], lo[i]), hi[i]);
      y[i] = y[i] + rh[i] * (zrel - zn);
      z[i] = zn;
    }
    for (int j = t; j < n; j += 32) x[j] = s.alpha * xt[j] + s.oma * x[j];
    __syncwarp();
  }

  for (int i = t; i < m; i += 32) {
    yo[b * m + i] = y[i];
    zo[b * m + i] = z[i];
  }
  for (int j = t; j < n; j += 32) xo[b * n + j] = x[j];
}

// ---------------------------------------------------------------------------
// Launch: both bodies take the same parameters.
// ---------------------------------------------------------------------------

template <int RS>
const void* register_kernel(int cs) {
  switch (cs) {
    case 2: return reinterpret_cast<const void*>(general_register_kernel<RS, 2>);
    case 4: return reinterpret_cast<const void*>(general_register_kernel<RS, 4>);
    case 6: return reinterpret_cast<const void*>(general_register_kernel<RS, 6>);
    case 8: return reinterpret_cast<const void*>(general_register_kernel<RS, 8>);
    case 10:
      return reinterpret_cast<const void*>(general_register_kernel<RS, 10>);
    case 12:
      return reinterpret_cast<const void*>(general_register_kernel<RS, 12>);
    case 14:
      return reinterpret_cast<const void*>(general_register_kernel<RS, 14>);
    case 16:
      return reinterpret_cast<const void*>(general_register_kernel<RS, 16>);
    default: return nullptr;
  }
}

// The kernel of a launch plan.
const void* kernel_of(const Config& cfg) {
  if (cfg.body == kBodyWide) {
    return reinterpret_cast<const void*>(general_wide_kernel);
  }
  switch (cfg.rs) {
    case 2: return register_kernel<2>(cfg.cs);
    case 4: return register_kernel<4>(cfg.cs);
    case 6: return register_kernel<6>(cfg.cs);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The launch plan of (n, m) with body `body` (0: the default; 1 register,
// 2 wide) as 6 ints: body, row slots, column slots, lanes a block, threads
// a block, shared-memory bytes.  Returns 0, or -1 for a shape (or a forced
// body) the kernel does not take.
int copra_admm_general_config(int n, int m, int body, int* out) {
  Config c;
  if (!make_config(n, m, body, &c)) return -1;
  out[0] = c.body;
  out[1] = c.rs;
  out[2] = c.cs;
  out[3] = c.lanes;
  out[4] = c.threads;
  out[5] = c.smem;
  return 0;
}

const char* copra_admm_general_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Registers a thread, local-memory (spill) bytes a thread, the largest
// block and the blocks an SM holds (shared memory and registers) of the
// kernel that serves (n, m, body), as 4 ints; returns 0, -1 for a plan the
// kernel does not take, or a CUDA error.
int copra_admm_general_attributes(int n, int m, int body, int* out) {
  Config cfg;
  if (!make_config(n, m, body, &cfg)) return -1;
  const void* fn = kernel_of(cfg);
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
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

// Launches the kernel on `stream` with the body `body` (0: the default for
// (n, m)); returns the launch's error (0 = launched).
int copra_admm_general(const float* kinv, const float* cmat,
                       const float* cvec, const float* l, const float* u,
                       const float* rho, const float* x0, const float* y0,
                       const float* z0, float* xo, float* yo, float* zo,
                       int batch, int n, int m, int n_iter, int body,
                       float sigma, float alpha, float oma, void* stream) {
  Config cfg;
  if (batch < 1 || n_iter < 0 || !make_config(n, m, body, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scalars s{sigma, alpha, oma};
  void* args[] = {&kinv, &cmat, &cvec, &l,  &u, &rho, &x0, &y0, &z0,
                  &xo,   &yo,   &zo,   &batch, &n, &m, &n_iter, &s};
  const int blocks = (batch + cfg.lanes - 1) / cfg.lanes;
  return static_cast<int>(cudaLaunchKernel(
      kernel_of(cfg), dim3(blocks), dim3(cfg.threads), args, cfg.smem,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
