// Fixed-count general-constraint ADMM over B lanes that share one dense
// constraint matrix C [m, n] (rows normalised), one penalty per row rho [m]
// and one operator pair Kinv = K^-1, K = Q + sigma I + C' diag(rho) C: the
// correction-space body of the general plan path for a fleet of states
// served by one plan.
//
// Replaces the Pallas TPU kernel copra_tpu/ops/admm_kernel.py::
// fused_admm_general_shared (body _general_kernel_shared).  The TPU version
// keeps Kinv, K, C and rho resident in VMEM per lane block and runs every
// product as a lane-blocked MXU GEMM in two interleaved half-streams; the
// half-streams, the lane-block budget and the padding of B with copies of
// lane 0 are TPU layout choices and are not carried over.
//
// One iteration per lane, in the reference's order:
//   w   = rho . z - y                      [m]
//   rhs = sigma e + w C                    [n]
//   e_t = rhs Kinv, then `refine` steps e_t += (rhs - e_t K) Kinv
//   z_t = e_t C'                           [m]
//   e   = alpha e_t + (1 - alpha) e
//   z_r = alpha z_t + (1 - alpha) z
//   z   = clip(z_r + y / rho, l, u);  y += rho . (z_r - z)
// Lower bounds of inequality rows are -inf: the clip is fmaxf/fminf and no
// difference of two bounds is ever formed.
//
// Every product is summed with compensation (Dot2: TwoProd by FMA and
// TwoSum, still f32 arithmetic) and rounded once.  With plain f32 sums the
// iteration's rounding sets a floor: on config 2 (400 iterations at the
// serving rho) 6% of lanes stay unconverged and the worst sit ~5e-5 from
// the exact solution, against the library's 1e-5 contract; with products
// rounded once every lane converges (measured with the plain version on
// the CPU).  The plain version rounds each product of f64 sums once.
//
// What bounds it on this card: a dependent chain.  At config 2's shapes
// (n = 10, m ~ 95, B = 4096, 400 iterations) the arithmetic is ~7e9 FLOP,
// 0.11 ms at the 67 TFLOP/s f32 peak, but each lane's 400 iterations run
// one after another, each a few hundred dependent FMAs and warp barriers
// deep.  A lane carries ~4m + 2n floats, far beyond a thread's 255
// registers, so a lane gets a warp: its row vectors (z, y, l, u, rho) are
// spread over the 32 threads (row i on thread i mod 32), its column
// vectors (e, rhs, e_t) likewise, and each product goes through a small
// per-warp buffer in shared memory, synchronised by __syncwarp only.  The
// shared operators (C, C', Kinv, K: ~8 KB at config 2) are staged in
// shared memory once per block; a product over n columns with n <= 16
// splits its row sum over floor(32 / n) thread groups, so that a warp's
// reads of C are 32 neighbouring words.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_general_shared.so admm_general_shared.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;  // lanes per block
constexpr int kThreads = 32 * kWarps;

struct Scalars {
  float sigma;
  float alpha;
  float oma;  // 1 - alpha
};

// Compensated accumulation (Ogita, Rump and Oishi's Dot2) in f32 FMA
// arithmetic: s + c carries the running sum to about twice the working
// precision.  TwoProd splits a b = p + pe exactly with one FMA; TwoSum
// splits s + p = t + se exactly.  The _rn intrinsics keep the compiler
// from contracting the error terms into FMAs, which would break them.
__device__ __forceinline__ void two_sum_add(float x, float& s, float& c) {
  const float t = __fadd_rn(s, x);
  const float bp = __fsub_rn(t, s);
  const float se = __fadd_rn(__fsub_rn(s, __fsub_rn(t, bp)), __fsub_rn(x, bp));
  s = t;
  c = __fadd_rn(c, se);
}

__device__ __forceinline__ void dot2_add(float a, float b, float& s,
                                         float& c) {
  const float p = __fmul_rn(a, b);
  c = __fadd_rn(c, fmaf(a, b, -p));
  two_sum_add(p, s, c);
}

// out[q] = sum_i v[i] M[i * cols + j] for j = lane + 32 q < cols (0 past
// cols), i < rows, summed with compensation and rounded once.  For cols <=
// 16 the row sum is split over floor(32 / cols) groups (group g sums rows
// g, g + G, ...) whose compensated partial sums meet in `part` (sums) and
// `part + 32` (compensations).  v is the warp's buffer; every thread of the
// warp calls this, and on return every read of v and part is done.
template <int SLOTS>
__device__ __forceinline__ void warp_vecmat(const float* v, const float* M,
                                            int rows, int cols, float* part,
                                            int lane, float (&out)[SLOTS]) {
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) out[q] = 0.0f;
  const int groups = cols <= 16 ? 32 / cols : 1;
  if (groups > 1) {
    const int g = lane / cols;
    const int j = lane - g * cols;
    float s = 0.0f, c = 0.0f;
    if (g < groups) {
      for (int i = g; i < rows; i += groups) dot2_add(v[i], M[i * cols + j], s, c);
    }
    part[lane] = s;
    part[32 + lane] = c;
    __syncwarp();
    if (lane < cols) {
      float sum = 0.0f, comp = 0.0f;
      for (int gg = 0; gg < groups; ++gg) {
        two_sum_add(part[gg * cols + lane], sum, comp);
        comp = __fadd_rn(comp, part[32 + gg * cols + lane]);
      }
      out[0] = __fadd_rn(sum, comp);
    }
  } else {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const int j = lane + 32 * q;
      if (j < cols) {
        float s = 0.0f, c = 0.0f;
        for (int i = 0; i < rows; ++i) dot2_add(v[i], M[i * cols + j], s, c);
        out[q] = __fadd_rn(s, c);
      }
    }
  }
  __syncwarp();
}

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

// RS row slots (m <= 32 RS) and CS column slots (n <= 32 CS) per thread.
template <int RS, int CS>
__global__ void __launch_bounds__(kThreads) admm_general_shared_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ cmat, const float* __restrict__ rho,
    const float* __restrict__ l, const float* __restrict__ u,
    const float* __restrict__ e0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ eo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, int refine, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;              // C  [m][n]
  float* sct = sc + m * n;       // C' [n][m]
  float* skinv = sct + m * n;    // Kinv [n][n]
  float* sk = skinv + n * n;     // K [n][n]
  const int vlen = (m > n ? m : n) + 64;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* v = sk + n * n + warp * vlen;  // the warp's vector buffer
  float* part = v + vlen - 64;          // and its partial sums

  for (int t = threadIdx.x; t < m * n; t += kThreads) {
    const float cv = cmat[t];
    const int i = t / n;
    const int j = t - i * n;
    sc[t] = cv;
    sct[j * m + i] = cv;
  }
  for (int t = threadIdx.x; t < n * n; t += kThreads) {
    skinv[t] = kinv[t];
    sk[t] = kmat[t];
  }
  __syncthreads();

  const size_t b = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (b >= static_cast<size_t>(batch)) return;  // whole warps only

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
    rh[r] = ok ? rho[i] : 1.0f;
    ri[r] = 1.0f / rh[r];
  }
  float e[CS];
#pragma unroll
  for (int q = 0; q < CS; ++q) {
    const int j = lane + 32 * q;
    e[q] = j < n ? e0[b * n + j] : 0.0f;
  }

  float w[RS], rhs[CS], et[CS], t[CS], zt[RS];
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int r = 0; r < RS; ++r) w[r] = rh[r] * z[r] - y[r];
    put(v, w, m, lane);
    warp_vecmat(v, sc, m, n, part, lane, t);  // w C
#pragma unroll
    for (int q = 0; q < CS; ++q) rhs[q] = s.sigma * e[q] + t[q];
    put(v, rhs, n, lane);
    warp_vecmat(v, skinv, n, n, part, lane, et);
    for (int rf = 0; rf < refine; ++rf) {
      put(v, et, n, lane);
      warp_vecmat(v, sk, n, n, part, lane, t);
#pragma unroll
      for (int q = 0; q < CS; ++q) t[q] = rhs[q] - t[q];
      put(v, t, n, lane);
      warp_vecmat(v, skinv, n, n, part, lane, t);
#pragma unroll
      for (int q = 0; q < CS; ++q) et[q] += t[q];
    }
    put(v, et, n, lane);
    warp_vecmat(v, sct, n, m, part, lane, zt);  // e_t C'
#pragma unroll
    for (int q = 0; q < CS; ++q) e[q] = s.alpha * et[q] + s.oma * e[q];
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
    if (j < n) eo[b * n + j] = e[q];
  }
}

template <int RS, int CS>
cudaError_t launch(const float* kinv, const float* kmat, const float* cmat,
                   const float* rho, const float* l, const float* u,
                   const float* e0, const float* y0, const float* z0,
                   float* eo, float* yo, float* zo, int batch, int n, int m,
                   int n_iter, int refine, Scalars s, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_general_shared_kernel<RS, CS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (batch + kWarps - 1) / kWarps;
  admm_general_shared_kernel<RS, CS><<<blocks, kThreads, smem, stream>>>(
      kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo, batch, n, m,
      n_iter, refine, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for widths (n, m).
size_t copra_admm_general_shared_smem_bytes(int n, int m) {
  const size_t nn = static_cast<size_t>(n), mm = static_cast<size_t>(m);
  const size_t vlen = (mm > nn ? mm : nn) + 64;
  return (2 * mm * nn + 2 * nn * nn + kWarps * vlen) * sizeof(float);
}

// Widest (n, m) the kernel takes.
int copra_admm_general_shared_max_n() { return 64; }
int copra_admm_general_shared_max_m() { return 256; }

// Largest dynamic shared memory a block may opt into on `device`.
int copra_admm_general_shared_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

const char* copra_admm_general_shared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int copra_admm_general_shared(const float* kinv, const float* kmat,
                              const float* cmat, const float* rho,
                              const float* l, const float* u, const float* e0,
                              const float* y0, const float* z0, float* eo,
                              float* yo, float* zo, int batch, int n, int m,
                              int n_iter, int refine, float sigma,
                              float alpha, float oma, void* stream) {
  const Scalars s{sigma, alpha, oma};
  const size_t smem = copra_admm_general_shared_smem_bytes(n, m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || batch < 1 || n > 64 || m > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (n <= 32 && m <= 128) {
    err = launch<4, 1>(kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo,
                       batch, n, m, n_iter, refine, s, smem, st);
  } else {
    err = launch<8, 2>(kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo,
                       batch, n, m, n_iter, refine, s, smem, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
