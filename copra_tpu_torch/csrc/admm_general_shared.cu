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
// Every product is summed in f64 and rounded once to f32: each f32 operand
// widens exactly, so each term is exact and the sum carries 53 bits, as
// the plain version computes it ((a.double() @ b.double()).float()).  With
// plain f32 sums the iteration's rounding sets a floor: on config 2 (400
// iterations at the serving rho) 6% of lanes stay unconverged and the
// worst sit ~5e-5 from the exact solution, against the library's 1e-5
// contract.  Compensated f32 sums (Dot2) would keep ~48 bits at ~10 f32
// instructions a term; the H100's DFMA, at half the f32 rate, keeps 53 in
// one.
//
// What bounds it on this card: a dependent chain, then f64 arithmetic and
// shared-memory reads.  At config 2's shapes (n = 10, m ~ 85, B = 4096,
// 400 iterations, refine 1) the sums are ~3.3e9 DFMA, 0.19 ms at the 34
// TFLOP/s f64 peak, but each lane's 400 iterations run one after another.
//
// Two bodies (general_shared_config, mirrored in
// ops/admm_kernel.general_shared_config):
//
// * Group (n <= 16, m <= 96: config 2).  A lane belongs to a group of 8
//   threads, 16 lanes a block; thread g owns rows g + 8 r (z, y, l, u in
//   registers) and holds the lane's column vectors (e, rhs, e_t) whole.
//   w C is each thread's rows, then a butterfly of shuffles over the
//   group (the f64 partial sums, so every thread gets the same sums);
//   the n x n products split their columns over the group and exchange
//   the results by shuffles; a row's z_t = e_t C_i' and the next
//   iteration's w_i C_i read the row once.  C (f64, rows padded to even
//   length for 16-byte reads), Kinv and K are staged in shared memory
//   once a block and read as broadcasts; no barrier after that.
// * Wide (n <= 256, m <= 1024 otherwise): a warp per lane, the lane's
//   vectors in the warp's slice of shared memory, the operators read from
//   device memory (L2-resident) in f32 and widened in the sum.  Right,
//   not fast: no served configuration runs it.
//
// A launch allocates nothing and does not synchronise with the host, so it
// can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_general_shared.so admm_general_shared.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWideWarps = 4;   // lanes per block, wide body
constexpr int kGroup = 8;       // threads per lane, group body
constexpr int kGroupThreads = 128;
constexpr int kGroupCols = 16;  // widest n of the group body
constexpr int kGroupMaxRows = 12;  // rows a thread, at most: m <= 96
constexpr int kMaxN = 256;
constexpr int kMaxM = 1024;

struct Scalars {
  float sigma;
  float alpha;
  float oma;  // 1 - alpha
};

// The launch plan of a shape: mirrored by general_shared_config in
// ops/admm_kernel.py and checked against it when the library is loaded.
struct Config {
  int body;     // 1 group, 2 wide
  int rs;       // row slots per thread (group: m <= 8 rs; wide: 0)
  int cs;       // column slots per thread (group: n rounded to 4; wide: 0)
  int warps;    // lanes per block
  int smem;     // dynamic shared memory bytes per block
};

// body: 0 the default for (n, m), 1 group, 2 wide.  Returns false for a
// shape (or a forced body) the kernel does not take.
bool make_config(int n, int m, int body, Config* c) {
  if (n < 1 || m < 1 || n > kMaxN || m > kMaxM || body < 0 || body > 2) {
    return false;
  }
  const bool group = n <= kGroupCols && m <= kGroup * kGroupMaxRows;
  if (body == 0) body = group ? 1 : 2;
  if (body == 1) {
    if (!group) return false;
    int rs = 4;
    while (m > kGroup * rs) rs += 4;
    const int np2 = (n + 1) / 2 * 2;
    const int smem = 8 * (m * np2 + 2 * n * n) + 8 * m;  // and rho, 1 / rho
    *c = Config{1, rs, (n + 3) / 4 * 4, kGroupThreads / kGroup, smem};
    return true;
  }
  // per warp: the f64 vector buffer, z y l u z_t [m] and e rhs e_t t [n]
  const int big = m > n ? m : n;
  const int per_warp = 8 * big + 4 * (5 * m + 4 * n);
  *c = Config{2, 0, 0, kWideWarps, kWideWarps * ((per_warp + 15) / 16 * 16)};
  return true;
}

// a x + b y with each product and the sum rounded, as the plain version's
// separate tensor operations round them (no FMA contraction), so that
// kernel and plain version take the same f32 steps between the products.
__device__ __forceinline__ float axpby(float a, float x, float b, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

// ---------------------------------------------------------------------------
// Group body
// ---------------------------------------------------------------------------

// out[j] = round(sum_k v[k] M[k * n + j]) for the group's j < n: thread g
// sums j = g, g + 8 (k ascending, f64) and the group exchanges the
// results, so every thread of the group returns the whole vector.
template <int CN>
__device__ __forceinline__ void group_product(const float (&v)[CN],
                                              const double* M, int n, int g,
                                              float (&out)[CN]) {
  constexpr int kSlots = (CN + kGroup - 1) / kGroup;
  double vd[CN];
#pragma unroll
  for (int k = 0; k < CN; ++k) vd[k] = static_cast<double>(v[k]);
  float mine[kSlots];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int j = min(g + kGroup * sl, n - 1);  // past n: never used
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < CN; ++k) {
      if (k < n) acc = fma(vd[k], M[k * n + j], acc);
    }
    mine[sl] = __double2float_rn(acc);
  }
#pragma unroll
  for (int j = 0; j < CN; ++j) {
    out[j] = __shfl_sync(0xffffffffu, mine[j / kGroup], j % kGroup, kGroup);
  }
}

// RS rows per thread (m <= 8 RS), CN columns (n <= CN <= 16).  A lane
// belongs to a group of 8 threads: thread g owns rows i = g + 8 r and
// holds the column vectors (e, rhs, e_t) whole.  w C sums each thread's
// rows and then the group's partial sums (a butterfly of shuffles); the
// n x n products split their columns over the group; z_t = e_t C' of a
// row and the next iteration's w_i C_i read the row of C once.  No
// barrier after the operators are staged: lanes are independent.
template <int RS, int CN>
__global__ void __launch_bounds__(kGroupThreads) general_group_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ cmat, const float* __restrict__ rho,
    const float* __restrict__ l, const float* __restrict__ u,
    const float* __restrict__ e0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ eo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, int refine, Scalars s) {
  extern __shared__ __align__(16) double gsm[];
  const int np2 = (n + 1) / 2 * 2;  // row stride of C: rows 16-byte aligned
  double* sc = gsm;                 // C [m][np2], the pad column 0
  double* skinv = sc + m * np2;     // Kinv [n][n]
  double* sk = skinv + n * n;       // K [n][n]
  float* srho = reinterpret_cast<float*>(sk + n * n);  // rho, 1 / rho
  float* sri = srho + m;
  for (int t = threadIdx.x; t < m * np2; t += kGroupThreads) {
    const int i = t / np2;
    const int j = t - i * np2;
    sc[t] = j < n ? static_cast<double>(cmat[i * n + j]) : 0.0;
  }
  for (int t = threadIdx.x; t < n * n; t += kGroupThreads) {
    skinv[t] = static_cast<double>(kinv[t]);
    sk[t] = static_cast<double>(kmat[t]);
  }
  for (int i = threadIdx.x; i < m; i += kGroupThreads) {
    srho[i] = rho[i];
    sri[i] = 1.0f / rho[i];
  }
  __syncthreads();  // the only block barrier

  const int g = threadIdx.x % kGroup;
  const int lane = blockIdx.x * (kGroupThreads / kGroup) + threadIdx.x / kGroup;
  const bool live = lane < batch;
  const size_t rb = static_cast<size_t>(lane) * m;
  float z[RS], y[RS], lo[RS], hi[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = g + kGroup * r;
    const bool ok = live && i < m;
    z[r] = ok ? z0[rb + i] : 0.0f;
    y[r] = ok ? y0[rb + i] : 0.0f;
    lo[r] = ok ? l[rb + i] : 0.0f;
    hi[r] = ok ? u[rb + i] : 0.0f;
  }
  float e[CN], rhs[CN], et[CN], t[CN];
#pragma unroll
  for (int j = 0; j < CN; ++j) {
    e[j] = live && j < n ? e0[static_cast<size_t>(lane) * n + j] : 0.0f;
  }

  // acc = w C over the thread's rows, for the first iteration
  double acc[CN];
#pragma unroll
  for (int j = 0; j < CN; ++j) acc[j] = 0.0;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = g + kGroup * r;
    if (i < m) {
      const double w = static_cast<double>(
          __fsub_rn(__fmul_rn(srho[i], z[r]), y[r]));
      const double* row = sc + i * np2;
#pragma unroll
      for (int j = 0; j < CN; j += 2) {
        if (j < n) {
          const double2 cv = *reinterpret_cast<const double2*>(row + j);
          acc[j] = fma(w, cv.x, acc[j]);
          acc[j + 1] = fma(w, cv.y, acc[j + 1]);
        }
      }
    }
  }

  for (int it = 0; it < n_iter; ++it) {
    // the group's sum of acc: every thread gets the same f64 sums
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off, kGroup);
      }
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      rhs[j] = __fadd_rn(__fmul_rn(s.sigma, e[j]), __double2float_rn(acc[j]));
    }
    group_product<CN>(rhs, skinv, n, g, et);
    for (int rf = 0; rf < refine; ++rf) {
      group_product<CN>(et, sk, n, g, t);
#pragma unroll
      for (int j = 0; j < CN; ++j) t[j] = rhs[j] - t[j];
      group_product<CN>(t, skinv, n, g, t);
#pragma unroll
      for (int j = 0; j < CN; ++j) et[j] += t[j];
    }
    double etd[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      etd[j] = static_cast<double>(et[j]);
      e[j] = axpby(s.alpha, et[j], s.oma, e[j]);
      acc[j] = 0.0;
    }
    // per row: z_t = e_t C_i', the updates, and the next w_i C_i
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int i = g + kGroup * r;
      if (i < m) {
        const double* row = sc + i * np2;
        double cr[CN];
        double zs = 0.0;
#pragma unroll
        for (int j = 0; j < CN; j += 2) {
          if (j < n) {
            const double2 cv = *reinterpret_cast<const double2*>(row + j);
            cr[j] = cv.x;
            cr[j + 1] = cv.y;
            zs = fma(etd[j], cv.x, zs);
            if (j + 1 < n) zs = fma(etd[j + 1], cv.y, zs);
          }
        }
        const float rh = srho[i];
        const float zt = __double2float_rn(zs);
        const float zrel = axpby(s.alpha, zt, s.oma, z[r]);
        const float zn = fminf(
            fmaxf(__fadd_rn(zrel, __fmul_rn(sri[i], y[r])), lo[r]), hi[r]);
        y[r] = __fadd_rn(y[r], __fmul_rn(rh, zrel - zn));
        z[r] = zn;
        const double w =
            static_cast<double>(__fsub_rn(__fmul_rn(rh, z[r]), y[r]));
#pragma unroll
        for (int j = 0; j < CN; j += 2) {
          if (j < n) {
            acc[j] = fma(w, cr[j], acc[j]);
            acc[j + 1] = fma(w, cr[j + 1], acc[j + 1]);
          }
        }
      }
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
  if (live && g == 0) {
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      if (j < n) eo[static_cast<size_t>(lane) * n + j] = e[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Wide body
// ---------------------------------------------------------------------------

// out[j] = sum_i v[i] M[i * cols + j] (M in device memory, f32, widened),
// for the warp's j = lane, lane + 32, ...; rounded once.
__device__ __forceinline__ void wide_vecmat(const double* v,
                                            const float* __restrict__ M,
                                            int rows, int cols, int lane,
                                            float* out) {
  for (int j = lane; j < cols; j += 32) {
    double s = 0.0;
    for (int i = 0; i < rows; ++i) {
      s = fma(v[i], static_cast<double>(__ldg(M + static_cast<size_t>(i) *
                                                      cols + j)), s);
    }
    out[j] = __double2float_rn(s);
  }
  __syncwarp();
}

// out[i] = sum_j v[j] C[i * n + j] (that is v C'), for i = lane, ...
__device__ __forceinline__ void wide_vecmat_t(const double* v,
                                              const float* __restrict__ C,
                                              int m, int n, int lane,
                                              float* out) {
  for (int i = lane; i < m; i += 32) {
    double s = 0.0;
    const float* row = C + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j) {
      s = fma(v[j], static_cast<double>(__ldg(row + j)), s);
    }
    out[i] = __double2float_rn(s);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kWideWarps) general_wide_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ cmat, const float* __restrict__ rho,
    const float* __restrict__ l, const float* __restrict__ u,
    const float* __restrict__ e0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ eo,
    float* __restrict__ yo, float* __restrict__ zo, int batch, int n, int m,
    int n_iter, int refine, Scalars s, int per_warp_bytes) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t b = static_cast<size_t>(blockIdx.x) * kWideWarps + warp;
  if (b >= static_cast<size_t>(batch)) return;  // whole warps only
  double* v = reinterpret_cast<double*>(wide_smem + warp * per_warp_bytes);
  float* z = reinterpret_cast<float*>(v + (m > n ? m : n));
  float* y = z + m;
  float* lo = y + m;
  float* hi = lo + m;
  float* zt = hi + m;
  float* e = zt + m;
  float* rhs = e + n;
  float* et = rhs + n;
  float* t = et + n;

  for (int i = lane; i < m; i += 32) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    lo[i] = l[b * m + i];
    hi[i] = u[b * m + i];
  }
  for (int j = lane; j < n; j += 32) e[j] = e0[b * n + j];
  __syncwarp();

  // Each thread reads and writes only its own entries of the row (i) and
  // column (j) vectors; v is the one vector the whole warp reads.
  for (int it = 0; it < n_iter; ++it) {
    for (int i = lane; i < m; i += 32) {
      v[i] = static_cast<double>(__fsub_rn(__fmul_rn(rho[i], z[i]), y[i]));
    }
    __syncwarp();
    wide_vecmat(v, cmat, m, n, lane, t);  // w C
    for (int j = lane; j < n; j += 32) {
      rhs[j] = __fadd_rn(__fmul_rn(s.sigma, e[j]), t[j]);
      v[j] = static_cast<double>(rhs[j]);
    }
    __syncwarp();
    wide_vecmat(v, kinv, n, n, lane, et);
    for (int rf = 0; rf < refine; ++rf) {
      for (int j = lane; j < n; j += 32) v[j] = static_cast<double>(et[j]);
      __syncwarp();
      wide_vecmat(v, kmat, n, n, lane, t);
      for (int j = lane; j < n; j += 32) {
        v[j] = static_cast<double>(rhs[j] - t[j]);
      }
      __syncwarp();
      wide_vecmat(v, kinv, n, n, lane, t);
      for (int j = lane; j < n; j += 32) et[j] += t[j];
    }
    for (int j = lane; j < n; j += 32) v[j] = static_cast<double>(et[j]);
    __syncwarp();
    wide_vecmat_t(v, cmat, m, n, lane, zt);  // e_t C'
    for (int j = lane; j < n; j += 32) {
      e[j] = axpby(s.alpha, et[j], s.oma, e[j]);
    }
    for (int i = lane; i < m; i += 32) {
      const float ri = 1.0f / rho[i];
      const float zrel = axpby(s.alpha, zt[i], s.oma, z[i]);
      const float zn =
          fminf(fmaxf(__fadd_rn(zrel, __fmul_rn(ri, y[i])), lo[i]), hi[i]);
      y[i] = __fadd_rn(y[i], __fmul_rn(rho[i], zrel - zn));
      z[i] = zn;
    }
    __syncwarp();
  }

  for (int i = lane; i < m; i += 32) {
    yo[b * m + i] = y[i];
    zo[b * m + i] = z[i];
  }
  for (int j = lane; j < n; j += 32) eo[b * n + j] = e[j];
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int RS, int CN>
cudaError_t launch_group(const float* kinv, const float* kmat,
                         const float* cmat, const float* rho, const float* l,
                         const float* u, const float* e0, const float* y0,
                         const float* z0, float* eo, float* yo, float* zo,
                         int batch, int n, int m, int n_iter, int refine,
                         Scalars s, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(general_group_kernel<RS, CN>, smem);
  if (err != cudaSuccess) return err;
  const int lanes = kGroupThreads / kGroup;
  const int blocks = (batch + lanes - 1) / lanes;
  general_group_kernel<RS, CN><<<blocks, kGroupThreads, smem, stream>>>(
      kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo, batch, n, m,
      n_iter, refine, s);
  return cudaGetLastError();
}

template <int RS>
cudaError_t launch_group_rs(int cn, const float* kinv, const float* kmat,
                            const float* cmat, const float* rho,
                            const float* l, const float* u, const float* e0,
                            const float* y0, const float* z0, float* eo,
                            float* yo, float* zo, int batch, int n, int m,
                            int n_iter, int refine, Scalars s, int smem,
                            cudaStream_t st) {
  switch (cn) {
    case 4: return launch_group<RS, 4>(kinv, kmat, cmat, rho, l, u, e0, y0,
                                       z0, eo, yo, zo, batch, n, m, n_iter,
                                       refine, s, smem, st);
    case 8: return launch_group<RS, 8>(kinv, kmat, cmat, rho, l, u, e0, y0,
                                       z0, eo, yo, zo, batch, n, m, n_iter,
                                       refine, s, smem, st);
    case 12: return launch_group<RS, 12>(kinv, kmat, cmat, rho, l, u, e0, y0,
                                         z0, eo, yo, zo, batch, n, m, n_iter,
                                         refine, s, smem, st);
    default: return launch_group<RS, 16>(kinv, kmat, cmat, rho, l, u, e0, y0,
                                         z0, eo, yo, zo, batch, n, m, n_iter,
                                         refine, s, smem, st);
  }
}

}  // namespace

extern "C" {

// The launch plan of (n, m) (body 0: the default; 1 group, 2 wide) as 5
// ints: body, row slots, column slots, lanes per block, shared-memory
// bytes.  Returns 0, or -1 for a shape (or a forced body) the kernel does
// not take.
int copra_admm_general_shared_config(int n, int m, int body, int* out) {
  Config c;
  if (!make_config(n, m, body, &c)) return -1;
  out[0] = c.body;
  out[1] = c.rs;
  out[2] = c.cs;
  out[3] = c.warps;
  out[4] = c.smem;
  return 0;
}

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

// Launches the kernel on `stream` with the body `body` (0: the default for
// (n, m)); returns cudaGetLastError() (0 = launched).
int copra_admm_general_shared(const float* kinv, const float* kmat,
                              const float* cmat, const float* rho,
                              const float* l, const float* u, const float* e0,
                              const float* y0, const float* z0, float* eo,
                              float* yo, float* zo, int batch, int n, int m,
                              int n_iter, int refine, float sigma,
                              float alpha, float oma, int body,
                              void* stream) {
  Config cfg;
  if (batch < 1 || n_iter < 0 || refine < 0 ||
      !make_config(n, m, body, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scalars s{sigma, alpha, oma};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cfg.body == 1) {
    auto group = cfg.rs == 4   ? launch_group_rs<4>
                 : cfg.rs == 8 ? launch_group_rs<8>
                               : launch_group_rs<12>;
    err = group(cfg.cs, kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo,
                batch, n, m, n_iter, refine, s, cfg.smem, st);
  } else {
    err = allow_smem(general_wide_kernel, cfg.smem);
    if (err == cudaSuccess) {
      const int blocks = (batch + kWideWarps - 1) / kWideWarps;
      general_wide_kernel<<<blocks, 32 * kWideWarps, cfg.smem, st>>>(
          kinv, kmat, cmat, rho, l, u, e0, y0, z0, eo, yo, zo, batch, n, m,
          n_iter, refine, s, cfg.smem / kWideWarps);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}

}  // extern "C"
