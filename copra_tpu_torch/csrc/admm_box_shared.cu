// Fixed-count box-only ADMM over B lanes that share one n x n operator
// pair Kinv = (Q + (sigma+rho) I)^-1 and K = Q + (sigma+rho) I: a fleet of
// states served by one plan.
//
// Replaces the Pallas TPU kernel copra_tpu/ops/admm_kernel.py::
// fused_admm_box_shared (body _box_kernel_shared).  The TPU version keeps
// the operator pair resident in VMEM per lane block and runs each x-update
// as a [lb, n] x [n, n] MXU product in two interleaved half-streams (an
// MXU/VPU overlap); the half-streams, the lane-block budget and the padding
// of B with copies of lane 0 are TPU layout choices and are not carried
// over: this kernel masks its ragged lane tile instead.
//
// What bounds it on this card: f32 arithmetic.  One iteration is a
// [B, n] x [n, n] product (plus two more per refinement step), and at the
// shared-plan roofline shape (B = 4096, n = 256) a call of 30 iterations is
// 31 products, 1.7e10 FLOP against ~42 MB of lane vectors: ~0.25 ms at the
// 67 TFLOP/s f32 peak (no tensor cores: the reference's products are
// f32-exact, so TF32 is out) against 13 us of device memory.
//
// Design.  One block of 256 threads serves a tile of 32 lanes for all
// iterations.  Each thread owns a 4-lane x 8-column register tile of the
// product (columns cx + 32 q, so a warp reads 32 neighbouring operator
// words and broadcasts one lane-row float4): 32 FMAs per 9 shared loads.
// The lanes' x, z and y stay in registers; c, l, u and the product's left
// operand live in shared memory as [n][36] tiles (k-major, four padding
// words so that the float4 stores of a warp do not collide).  The operator
// pair (512 KB at n = 256, more than a block's 227 KB) is not staged whole:
// 16-row slices of Kinv (and of K for refinement and the final g = Q x)
// are streamed through a double buffer with cp.async while the previous
// slice is multiplied; both operators stay in the 50 MB L2 for every
// block.  Up to n = 16 both operators fit in the two buffers and are
// loaded once per call.
//
// Arithmetic follows the reference twin xla_admm_box in its row-vector
// form: out[b, j] = sum_k v[b, k] M[k, j], k ascending.  g = x K -
// (sigma + rho) x is always computed from K (the reference body has no
// K-free recurrence).  y0 is taken as y0 and z0 as z0.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_box_shared.so admm_box_shared.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                       // lanes per thread
constexpr int kTile = kRows * (kThreads / 32);  // lanes per block (32)
constexpr int kMaxQ = 8;                       // column slots per thread
constexpr int kMaxN = 32 * kMaxQ;              // widest n (256)
constexpr int kLd = kTile + 4;                 // row stride of a vector tile
constexpr int kSlice = 16;                     // operator rows per slice
constexpr int kPad = 32;                       // slack after each slice

struct Scalars {
  float sigma;
  float alpha;
  float oma;      // 1 - alpha
  float rho;
  float rho_inv;  // 1 / rho
  float spr;      // sigma + rho
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies operator rows [k0, k0 + rows) of M (row-major, n wide: one
// contiguous run of rows * n words) into dst; one commit group per call.
__device__ __forceinline__ void load_rows(float* dst, const float* M, int k0,
                                          int rows, int n) {
  const int count = rows * n;
  const float* src = M + static_cast<size_t>(k0) * n;
  for (int t = threadIdx.x; t < count; t += kThreads) {
    cp_async4(dst + t, src + t);
  }
  cp_async_commit();
}

// acc[r][q] = sum_k a[k][row0 + r] * M[k][cx + 32 q], k ascending, for the
// block's lane tile.  `a` is a [n][kLd] tile written by every thread before
// the call.  With `resident` set, M is already whole in shared memory
// (n <= kSlice); otherwise its slices are streamed through `buf`.  Starts
// and ends with a block barrier, so `a` may be rewritten on return.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ M, const float* resident, float* buf,
    const float* a, int n, int nq, int row0, int cx,
    float (&acc)[kRows][kMaxQ]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[r][q] = 0.0f;
  }
  const int stage = kSlice * n + kPad;
  const int slices = resident ? 1 : (n + kSlice - 1) / kSlice;
  if (!resident) load_rows(buf, M, 0, min(kSlice, n), n);
  for (int s = 0; s < slices; ++s) {
    const int k0 = s * kSlice;
    const int rows = resident ? n : min(kSlice, n - k0);
    const float* b = resident;
    if (!resident) {
      if (s + 1 < slices) {
        load_rows(buf + ((s + 1) & 1) * stage, M, k0 + kSlice,
                  min(kSlice, n - k0 - kSlice), n);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      b = buf + (s & 1) * stage;
    }
    __syncthreads();  // slice s (and, first time, the tile `a`) complete
    for (int kk = 0; kk < rows; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(
          a + static_cast<size_t>(k0 + kk) * kLd + row0);
      const float* brow = b + kk * n + cx;
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (q < nq) {
          // columns past n read slack words; their sums are never used
          const float bv = brow[32 * q];
          acc[0][q] = fmaf(av.x, bv, acc[0][q]);
          acc[1][q] = fmaf(av.y, bv, acc[1][q]);
          acc[2][q] = fmaf(av.z, bv, acc[2][q]);
          acc[3][q] = fmaf(av.w, bv, acc[3][q]);
        }
      }
    }
    __syncthreads();  // every reader of this slice and of `a` is done
  }
}

// Writes the thread's [kRows] x [kMaxQ] values v into the tile t.
__device__ __forceinline__ void store_tile(float* t, const float (&v)[kRows][kMaxQ],
                                           int n, int nq, int row0, int cx) {
#pragma unroll
  for (int q = 0; q < kMaxQ; ++q) {
    const int j = cx + 32 * q;
    if (q < nq && j < n) {
      *reinterpret_cast<float4*>(t + static_cast<size_t>(j) * kLd + row0) =
          make_float4(v[0][q], v[1][q], v[2][q], v[3][q]);
    }
  }
}

__device__ __forceinline__ float4 tile_at(const float* t, int j, int row0) {
  return *reinterpret_cast<const float4*>(t + static_cast<size_t>(j) * kLd +
                                          row0);
}

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 1) admm_box_shared_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int batch, int n, int n_iter, int refine,
    Scalars s) {
  extern __shared__ __align__(16) float smem[];
  const size_t tile = static_cast<size_t>(n) * kLd;
  float* a0 = smem;         // the product's left operand
  float* a1 = a0 + tile;    // refinement operand
  float* cs = a1 + tile;    // c
  float* ls = cs + tile;    // l
  float* us = ls + tile;    // u
  float* buf = us + tile;   // two operator slices (or Kinv and K whole)
  const int stage = kSlice * n + kPad;
  const bool whole = n <= kSlice;
  const float* r_kinv = whole ? buf : nullptr;
  const float* r_k = whole ? buf + stage : nullptr;

  const int cx = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * kRows;
  const int nq = (n + 31) / 32;
  const int lane0 = blockIdx.x * kTile + row0;

  if (whole) {
    load_rows(buf, kinv, 0, n, n);
    load_rows(buf + stage, kmat, 0, n, n);
    cp_async_wait<0>();  // made visible by tile_product's first barrier
  }

  // x, z, y to registers; c, l, u to the tiles, each entry read back only
  // by the thread that wrote it
  float x[kRows][kMaxQ], z[kRows][kMaxQ], y[kRows][kMaxQ];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int j = cx + 32 * q;
      const bool ok = q < nq && j < n && lane0 + r < batch;
      const size_t idx = static_cast<size_t>(lane0 + r) * n + j;
      x[r][q] = ok ? x0[idx] : 0.0f;
      y[r][q] = ok ? y0[idx] : 0.0f;
      z[r][q] = ok ? z0[idx] : 0.0f;
      if (q < nq && j < n) {
        const size_t at = static_cast<size_t>(j) * kLd + row0 + r;
        cs[at] = ok ? c[idx] : 0.0f;
        ls[at] = ok ? l[idx] : 0.0f;
        us[at] = ok ? u[idx] : 0.0f;
      }
    }
  }

  float acc[kRows][kMaxQ], t[kRows][kMaxQ];
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int j = min(cx + 32 * q, n - 1);
      const float4 c4 = tile_at(cs, j, row0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        t[r][q] = s.sigma * x[r][q] - comp(c4, r) + s.rho * z[r][q] -
                  y[r][q];
      }
    }
    store_tile(a0, t, n, nq, row0, cx);  // rhs
    tile_product(kinv, r_kinv, buf, a0, n, nq, row0, cx, acc);
    for (int rf = 0; rf < refine; ++rf) {
      store_tile(a1, acc, n, nq, row0, cx);
      tile_product(kmat, r_k, buf, a1, n, nq, row0, cx, t);
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        const int j = min(cx + 32 * q, n - 1);
        const float4 rhs = tile_at(a0, j, row0);
#pragma unroll
        for (int r = 0; r < kRows; ++r) t[r][q] = comp(rhs, r) - t[r][q];
      }
      store_tile(a1, t, n, nq, row0, cx);  // rhs - K x_t
      tile_product(kinv, r_kinv, buf, a1, n, nq, row0, cx, t);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < kMaxQ; ++q) acc[r][q] += t[r][q];
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int j = min(cx + 32 * q, n - 1);
      const float4 l4 = tile_at(ls, j, row0);
      const float4 u4 = tile_at(us, j, row0);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xt = acc[r][q];
        const float zrel = s.alpha * xt + s.oma * z[r][q];
        const float zn =
            fminf(fmaxf(zrel + s.rho_inv * y[r][q], comp(l4, r)), comp(u4, r));
        y[r][q] = y[r][q] + s.rho * (zrel - zn);
        x[r][q] = s.alpha * xt + s.oma * x[r][q];
        z[r][q] = zn;
      }
    }
  }

  // g = x K - (sigma + rho) x
  store_tile(a0, x, n, nq, row0, cx);
  tile_product(kmat, r_k, buf, a0, n, nq, row0, cx, acc);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int j = cx + 32 * q;
      if (q < nq && j < n && lane0 + r < batch) {
        const size_t idx = static_cast<size_t>(lane0 + r) * n + j;
        xo[idx] = x[r][q];
        yo[idx] = y[r][q];
        zo[idx] = z[r][q];
        go[idx] = acc[r][q] - s.spr * x[r][q];
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at width n.
size_t copra_admm_box_shared_smem_bytes(int n) {
  return (5 * static_cast<size_t>(n) * kLd +
          2 * (static_cast<size_t>(kSlice) * n + kPad)) *
         sizeof(float);
}

// Widest n the kernel takes, and the lanes one block serves.
int copra_admm_box_shared_max_n() { return kMaxN; }
int copra_admm_box_shared_lane_tile() { return kTile; }

// Largest dynamic shared memory a block may opt into on `device`.
int copra_admm_box_shared_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

const char* copra_admm_box_shared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int copra_admm_box_shared(const float* kinv, const float* kmat,
                          const float* c, const float* l, const float* u,
                          const float* x0, const float* y0, const float* z0,
                          float* xo, float* yo, float* zo, float* go,
                          int batch, int n, int n_iter, int refine,
                          float sigma, float alpha, float oma, float rho,
                          float rho_inv, float spr, void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scalars s{sigma, alpha, oma, rho, rho_inv, spr};
  const size_t smem = copra_admm_box_shared_smem_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        admm_box_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + kTile - 1) / kTile;
  admm_box_shared_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      kinv, kmat, c, l, u, x0, y0, z0, xo, yo, zo, go, batch, n, n_iter,
      refine, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
