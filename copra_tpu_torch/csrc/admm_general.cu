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
// What bounds it on this card: a dependent chain, not bytes or arithmetic.
// At B = 4096, n = 10, m = 85 and 400 iterations the arithmetic is ~8e9
// FLOP (0.12 ms at the 67 TFLOP/s f32 peak) and the operators are 16 MB,
// but each lane's iterations run one after another, each three small
// products deep.  A lane's state (~6m + 4n floats) is beyond one thread's
// registers, so a lane gets a warp: its row vectors (z, y, l, u, rho) are
// spread over the 32 threads (row i on thread i mod 32), its column vectors
// (x, rhs, x_t, c) likewise, and each product's left operand goes through a
// small per-warp buffer in shared memory, synchronised by __syncwarp only
// (no block barrier: warps are independent).  Where a lane's C and Kinv fit
// the block's shared memory beside its seven neighbours' (3.8 KB per lane at
// n = 10, m = 85) each warp stages its own pair once, with an odd leading
// dimension so that both the column products (w C, rhs Kinv: threads on
// neighbouring columns) and the row product (C x_t: threads on neighbouring
// rows) read without bank conflicts; otherwise the operators are read from
// global memory (L1/L2) in every iteration.  A column product over n <= 16
// columns splits its row sum over floor(32 / n) thread groups.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_general.so admm_general.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;  // lanes per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxN = 128;
constexpr int kMaxM = 384;

struct Scalars {
  float sigma;
  float alpha;
  float oma;  // 1 - alpha
};

// Writes the warp's distributed vector (index lane + 32 q) into v.
template <int SLOTS>
__device__ __forceinline__ void put(float* v, const float (&a)[SLOTS],
                                    int count, int lane) {
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const int i = lane + 32 * q;
    if (i < count) v[i] = a[q];
  }
  __syncwarp();
}

// Column product: out[q] = sum_i v[i] M[i * ld + j] for j = lane + 32 q <
// cols (0 past cols), i < rows.  For cols <= 16 the row sum is split over
// floor(32 / cols) groups (group g sums rows g, g + G, ...) whose partial
// sums meet in `part`.  Every thread of the warp calls this; on return every
// read of v and part is done.
template <int SLOTS>
__device__ __forceinline__ void vec_mat(const float* v, const float* M,
                                        int ld, int rows, int cols,
                                        float* part, int lane,
                                        float (&out)[SLOTS]) {
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) out[q] = 0.0f;
  const int groups = cols <= 16 ? 32 / cols : 1;
  if (groups > 1) {
    const int g = lane / cols;
    const int j = lane - g * cols;
    float s = 0.0f;
    if (g < groups) {
      for (int i = g; i < rows; i += groups) s = fmaf(v[i], M[i * ld + j], s);
    }
    part[lane] = s;
    __syncwarp();
    if (lane < cols) {
      float sum = 0.0f;
      for (int gg = 0; gg < groups; ++gg) sum += part[gg * cols + lane];
      out[0] = sum;
    }
  } else {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const int j = lane + 32 * q;
      if (j < cols) {
        float s = 0.0f;
        for (int i = 0; i < rows; ++i) s = fmaf(v[i], M[i * ld + j], s);
        out[q] = s;
      }
    }
  }
  __syncwarp();
}

// Row product: out[r] = sum_j v[j] M[i * ld + j] for i = lane + 32 r < rows
// (0 past rows), j < cols.  On return every read of v is done.
template <int SLOTS>
__device__ __forceinline__ void mat_vec(const float* v, const float* M,
                                        int ld, int rows, int cols, int lane,
                                        float (&out)[SLOTS]) {
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int i = lane + 32 * r;
    float s = 0.0f;
    if (i < rows) {
      const float* row = M + static_cast<size_t>(i) * ld;
      for (int j = 0; j < cols; ++j) s = fmaf(v[j], row[j], s);
    }
    out[r] = s;
  }
  __syncwarp();
}

// RS row slots (m <= 32 RS) and CS column slots (n <= 32 CS) per thread.
template <int RS, int CS>
__global__ void __launch_bounds__(kThreads) admm_general_kernel(
    const float* __restrict__ kinv, const float* __restrict__ cmat,
    const float* __restrict__ cvec, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, int staged, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t b = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (b >= static_cast<size_t>(batch)) return;  // whole warps, no block barrier

  const int vlen = (m > n ? m : n) + 32;
  const int ld = staged ? (n | 1) : n;
  const size_t per_warp =
      static_cast<size_t>(vlen) + (staged ? static_cast<size_t>(m + n) * ld : 0);
  float* v = smem + warp * per_warp;  // the warp's vector buffer
  float* part = v + vlen - 32;        // and its partial sums
  const float* C = cmat + b * m * n;
  const float* Ki = kinv + b * n * n;
  if (staged) {
    float* sc = v + vlen;
    float* sk = sc + static_cast<size_t>(m) * ld;
    for (int t = lane; t < m * n; t += 32) {
      const int i = t / n;
      sc[i * ld + (t - i * n)] = C[t];
    }
    for (int t = lane; t < n * n; t += 32) {
      const int i = t / n;
      sk[i * ld + (t - i * n)] = Ki[t];
    }
    __syncwarp();
    C = sc;
    Ki = sk;
  }

  float z[RS], y[RS], lo[RS], hi[RS], rh[RS], ri[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = lane + 32 * r;
    const bool ok = i < m;
    const size_t idx = b * m + i;
    z[r] = ok ? z0[idx] : 0.0f;
    y[r] = ok ? y0[idx] : 0.0f;
    lo[r] = ok ? l[idx] : 0.0f;
    hi[r] = ok ? u[idx] : 0.0f;
    rh[r] = ok ? rho[idx] : 1.0f;
    ri[r] = 1.0f / rh[r];
  }
  float x[CS], c[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    const int j = lane + 32 * q;
    x[q] = j < n ? x0[b * n + j] : 0.0f;
    c[q] = j < n ? cvec[b * n + j] : 0.0f;
  }

  float w[RS], zt[RS], rhs[CS], xt[CS];
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int r = 0; r < RS; ++r) w[r] = rh[r] * z[r] - y[r];
    put(v, w, m, lane);
    vec_mat(v, C, ld, m, n, part, lane, rhs);  // w C
#pragma unroll
    for (int q = 0; q < CS; ++q) rhs[q] = s.sigma * x[q] - c[q] + rhs[q];
    put(v, rhs, n, lane);
    vec_mat(v, Ki, ld, n, n, part, lane, xt);  // rhs Kinv
    put(v, xt, n, lane);
    mat_vec(v, C, ld, m, n, lane, zt);  // C x_t
#pragma unroll
    for (int q = 0; q < CS; ++q) x[q] = s.alpha * xt[q] + s.oma * x[q];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const float zrel = s.alpha * zt[r] + s.oma * z[r];
      const float zn = fminf(fmaxf(zrel + ri[r] * y[r], lo[r]), hi[r]);
      y[r] = y[r] + rh[r] * (zrel - zn);
      z[r] = zn;
    }
  }

#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = lane + 32 * r;
    if (i < m) {
      yo[b * m + i] = y[r];
      zo[b * m + i] = z[r];
    }
  }
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    const int j = lane + 32 * q;
    if (j < n) xo[b * n + j] = x[q];
  }
}

// Bytes of dynamic shared memory one block needs for widths (n, m), with the
// lanes' operators staged or not.
size_t smem_bytes(int n, int m, bool staged) {
  const size_t nn = static_cast<size_t>(n), mm = static_cast<size_t>(m);
  size_t per_warp = (mm > nn ? mm : nn) + 32;
  if (staged) per_warp += (mm + nn) * (nn | 1);
  return kWarps * per_warp * sizeof(float);
}

// Whether a block of lanes of widths (n, m) can keep its operators in the
// shared memory a block may opt into on `device`; otherwise it reads them
// from global memory.
bool staged_fits(int n, int m, int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return false;
  }
  return limit > 0 && smem_bytes(n, m, true) <= static_cast<size_t>(limit);
}

template <int RS, int CS>
cudaError_t launch(const float* kinv, const float* cmat, const float* cvec,
                   const float* l, const float* u, const float* rho,
                   const float* x0, const float* y0, const float* z0,
                   float* xo, float* yo, float* zo, int batch, int n, int m,
                   int n_iter, bool staged, Scalars s, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_general_kernel<RS, CS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + kWarps - 1) / kWarps;
  admm_general_kernel<RS, CS><<<blocks, kThreads, smem, stream>>>(
      kinv, cmat, cvec, l, u, rho, x0, y0, z0, xo, yo, zo, batch, n, m,
      n_iter, staged ? 1 : 0, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest (n, m) the kernel takes.
int copra_admm_general_max_n() { return kMaxN; }
int copra_admm_general_max_m() { return kMaxM; }

const char* copra_admm_general_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream` of `device`; returns cudaGetLastError()
// (0 = launched).
int copra_admm_general(const float* kinv, const float* cmat,
                       const float* cvec, const float* l, const float* u,
                       const float* rho, const float* x0, const float* y0,
                       const float* z0, float* xo, float* yo, float* zo,
                       int batch, int n, int m, int n_iter, float sigma,
                       float alpha, float oma, int device, void* stream) {
  if (n < 1 || m < 1 || batch < 1 || n > kMaxN || m > kMaxM || n_iter < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scalars s{sigma, alpha, oma};
  const bool staged = staged_fits(n, m, device);
  const size_t smem = smem_bytes(n, m, staged);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n <= 32 && m <= 128) {
    err = launch<4, 1>(kinv, cmat, cvec, l, u, rho, x0, y0, z0, xo, yo, zo,
                       batch, n, m, n_iter, staged, s, smem, st);
  } else {
    err = launch<12, 4>(kinv, cmat, cvec, l, u, rho, x0, y0, z0, xo, yo, zo,
                        batch, n, m, n_iter, staged, s, smem, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
