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
// plain PyTorch version) streams 30 x 164 MB from device memory per tick.
// This kernel stages each lane's operator into shared memory once (40 KB
// at n = 100; 80 KB with K in the general mode) and runs every iteration
// against the staged copy, so device memory sees each operator once per
// tick.  After that the bound is shared-memory traffic: every FMA reads
// one operator word (conflict-free: thread i reads column i of row j, so
// neighbouring threads read neighbouring words) and one broadcast word of
// the vector.
//
// Arithmetic follows the row-vector form of the reference twin
// xla_admm_box: out[i] = sum_j M[j, i] v[j], j ascending.  Kinv from the
// Jacobi-preconditioned inverse is symmetric only up to rounding, so the
// orientation is kept.
//
// Modes (chosen by the Python wrapper, copra_tpu_torch/ops/admm_kernel.py):
//   1  x0 = 0, refine = 0, n_iter > 0: K is never read; g comes from the
//      recurrence w <- alpha rhs + (1 - alpha) w, w0 = 0 (K x_t = rhs).
//   2  n_iter = 0: g = x0 K - (sigma + rho) x0; Kinv is never read and K is
//      read straight from device memory (one pass, nothing to reuse).
//   3  general form with `refine` refinement steps against K; takes y0 as
//      y0 and z0 as z0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_box.so admm_box.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kModeX0Zero = 1;
constexpr int kModeQx = 2;
constexpr int kModeGeneral = 3;

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

struct Scalars {
  float sigma;
  float alpha;
  float oma;      // 1 - alpha
  float rho;
  float rho_inv;  // 1 / rho
  float spr;      // sigma + rho
};

template <int MODE>
__global__ void admm_box_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int n, int n_iter, int refine, Scalars s) {
  extern __shared__ __align__(16) float smem[];
  const int i = threadIdx.x;
  const bool active = i < n;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t lane = blockIdx.x;
  const size_t vo = lane * n + i;

  if (MODE == kModeQx) {
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
    return;
  }

  // Shared memory: Kinv [n*n], K [n*n] (general mode only), two [n] vectors.
  float* s_kinv = smem;
  float* s_k = smem + nn;
  float* sv = smem + (MODE == kModeGeneral ? 2 * nn : nn);
  float* sv2 = sv + n;

  const float* g_kinv = kinv + lane * nn;
  for (size_t t = i; t < nn; t += blockDim.x) s_kinv[t] = g_kinv[t];
  if (MODE == kModeGeneral) {
    const float* g_k = kmat + lane * nn;
    for (size_t t = i; t < nn; t += blockDim.x) s_k[t] = g_k[t];
  }

  float cv = 0.0f, lv = 0.0f, uv = 0.0f;
  float x = 0.0f, z = 0.0f, y = 0.0f, w = 0.0f;
  if (active) {
    cv = c[vo];
    lv = l[vo];
    uv = u[vo];
    z = z0[vo];
    y = y0[vo];
    x = (MODE == kModeX0Zero) ? 0.0f : x0[vo];
  }

  for (int it = 0; it < n_iter; ++it) {
    const float rhs = s.sigma * x - cv + s.rho * z - y;
    __syncthreads();  // every reader of sv (last iteration) is done
    if (active) sv[i] = rhs;
    __syncthreads();  // sv complete (and, first time, the operators)
    float xt = active ? column_dot(s_kinv, sv, n, i) : 0.0f;
    if (MODE == kModeGeneral) {
      for (int r = 0; r < refine; ++r) {
        if (active) sv2[i] = xt;
        __syncthreads();  // sv2 complete; every reader of sv is done
        const float res = active ? rhs - column_dot(s_k, sv2, n, i) : 0.0f;
        if (active) sv[i] = res;
        __syncthreads();  // sv complete; every reader of sv2 is done
        if (active) xt += column_dot(s_kinv, sv, n, i);
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
    __syncthreads();
    if (active) sv[i] = x;
    __syncthreads();
    g = active ? column_dot(s_k, sv, n, i) - s.spr * x : 0.0f;
  }
  if (active) {
    xo[vo] = x;
    yo[vo] = y;
    zo[vo] = z;
    go[vo] = g;
  }
}

template <int MODE>
cudaError_t launch(const float* kinv, const float* kmat, const float* c,
                   const float* l, const float* u, const float* x0,
                   const float* y0, const float* z0, float* xo, float* yo,
                   float* zo, float* go, int batch, int n, int n_iter,
                   int refine, Scalars s, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        admm_box_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = ((n + 31) / 32) * 32;
  admm_box_kernel<MODE><<<batch, threads, smem, stream>>>(
      kinv, kmat, c, l, u, x0, y0, z0, xo, yo, zo, go, n, n_iter, refine, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `mode` needs at width n.
size_t copra_admm_box_smem_bytes(int n, int mode) {
  const size_t nn = static_cast<size_t>(n) * n;
  switch (mode) {
    case kModeX0Zero: return (nn + 2 * static_cast<size_t>(n)) * sizeof(float);
    case kModeQx: return static_cast<size_t>(n) * sizeof(float);
    default: return (2 * nn + 2 * static_cast<size_t>(n)) * sizeof(float);
  }
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

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int copra_admm_box(const float* kinv, const float* kmat, const float* c,
                   const float* l, const float* u, const float* x0,
                   const float* y0, const float* z0, float* xo, float* yo,
                   float* zo, float* go, int batch, int n, int n_iter,
                   int refine, int mode, float sigma, float alpha, float oma,
                   float rho, float rho_inv, float spr, void* stream) {
  const Scalars s{sigma, alpha, oma, rho, rho_inv, spr};
  const size_t smem = copra_admm_box_smem_bytes(n, mode);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kModeX0Zero:
      err = launch<kModeX0Zero>(kinv, kmat, c, l, u, x0, y0, z0, xo, yo, zo,
                                go, batch, n, n_iter, refine, s, smem, st);
      break;
    case kModeQx:
      err = launch<kModeQx>(kinv, kmat, c, l, u, x0, y0, z0, xo, yo, zo, go,
                            batch, n, n_iter, refine, s, smem, st);
      break;
    case kModeGeneral:
      err = launch<kModeGeneral>(kinv, kmat, c, l, u, x0, y0, z0, xo, yo, zo,
                                 go, batch, n, n_iter, refine, s, smem, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
