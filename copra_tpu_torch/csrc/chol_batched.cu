// Lower Cholesky factors of B small symmetric positive-definite matrices
// K [B, n, n] -> L [B, n, n] with L L' = K, n <= 128, float32 or float64, by
// the right-looking (outer-product) recursion of the reference
//   for j in 0..n-1:  dinv = 1 / sqrt(a_jj);  c_i = a_ij dinv (i >= j);
//                     a_ik -= c_i c_k  (i >= k > j)
// in ascending j.  Only the lower triangle of K is read.  Above the diagonal
// L holds 0 * L_kk in column k: zero for a matrix that factors, NaN from the
// first failed pivot's column on, as the reference's `L * tril` gives.  A
// matrix that is not positive definite gives NaN from its first
// non-positive pivot on (no error code); a finished column is never
// downdated again, so the columns before it stay finite.  dinv is the IEEE
// square root and division (no rsqrt approximation): the float64 factor
// reconstructs K to ~1e-16 relative on spectra spread over ten decades.
//
// Replaces the Pallas TPU kernel copra_tpu/ops/cholesky_kernel.py::
// chol_batched (bodies _chol_kernel, _chol_lanes).  The TPU version rides
// the batch on the 128-wide vector lane axis ([n, n, 128] blocks, the batch
// padded with identities to a multiple of 128, a VMEM size rule); none of
// that layout is carried over.
//
// What bounds it on this card: the bytes in principle (at B = 4096, n =
// 100, f32 the lower triangle read and L written are 247 MB, 0.074 ms at
// 3.35 TB/s, against 0.021 ms of f32 operations), in practice the dependent
// chain of n columns a matrix, each column a square root, a division and
// their broadcast that all later columns wait on (on an H100, ~585 cycles
// a column for one matrix alone on an SM at n = 100).  The design keeps
// the chain short (one block barrier a column, no shared-memory access per
// FMA) and lets several matrices share an SM to overlap their chains.
//
// Two bodies (make_config, mirrored in ops/cholesky_kernel.chol_config and
// checked against it when the library is loaded):
//
// * Small (n <= 32).  A matrix belongs to a group of G = 8, 16 or 32
//   threads (n rounded up), 32 / G matrices a warp, 4 warps a block.
//   Thread i of a group owns row i, its entries a_ik (k <= i) in registers.
//   Column j: the pivot comes from thread j by a shuffle, every thread
//   forms c_i, and each c_k (k > j) comes from thread k by a shuffle.  No
//   shared memory inside the recursion and no barrier: the warp's matrices
//   (contiguous in K) are read and written by coalesced loads and stores
//   through a per-warp shared stage, separated by __syncwarp.
// * Block (any n <= 128, the default above 32).  A block of 256 threads
//   holds one matrix: a 16 x 16 grid, thread (r, c) = (tid % 16, tid / 16)
//   owning the entries (r + 16a, c + 16b), a >= b, a, b < T = ceil(n / 16),
//   in registers (28 at n = 100, 36 at n = 128; the cyclic layout keeps
//   every thread busy while the trailing matrix shrinks).  The 16 owners
//   of a column sit in one half-warp: at column j they take the pivot from
//   thread (j % 16, j % 16) by a shuffle, scale their entries and write c
//   into a double-buffered shared vector; after one block barrier every
//   thread reads its <= T row values and <= T column values of c and
//   downdates its entries with register FMAs.  One barrier a column.  The
//   lower triangle is loaded with every load of the block issued at once
//   (coalesced, one row segment a warp) and turned into the register layout
//   through a 16-row shared band, and L leaves the same way.  T is a
//   template argument and every loop over tiles unrolls, so no entry falls
//   to local memory.
//
// Shared memory is static and under 48 KB in every plan (36 KB at n = 128
// in f64), so a launch sets no attribute; it allocates nothing and does not
// synchronise with the host, so it can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libchol_batched.so chol_batched.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBodySmall = 1;
constexpr int kBodyBlock = 2;
constexpr int kMaxN = 128;
constexpr int kSmallMaxN = 32;
constexpr int kSmallWarps = 4;       // warps a block, small body
constexpr int kBlockThreads = 256;   // block body: a 16 x 16 grid
constexpr int kTile = 16;
constexpr unsigned kFull = 0xffffffffu;

// The launch plan of a shape: mirrored by chol_config in
// ops/cholesky_kernel.py and checked against it when the library is loaded.
struct Config {
  int body;     // 1 small, 2 block
  int width;    // small: threads a matrix (8, 16, 32); block: tiles T
  int threads;  // threads a block
  int mats;     // matrices a block
  int smem;     // static shared-memory bytes a block
};

// Leading dimension of the block body's shared band: 16 T + 2 floats keeps
// the register-layout reads free of bank conflicts (r * ld + c distinct
// mod 32 over a warp), 16 T + 1 doubles likewise over each half-warp.
__host__ __device__ constexpr int band_ld(int tiles, int size) {
  return kTile * tiles + (size == 4 ? 2 : 1);
}

// body: 0 the default for n, 1 small, 2 block.  Returns false for a shape
// (or a forced body) the kernel does not take.
bool make_config(int n, int is_double, int body, Config* c) {
  if (n < 1 || n > kMaxN || body < 0 || body > 2 || is_double < 0 ||
      is_double > 1) {
    return false;
  }
  const int size = is_double ? 8 : 4;
  if (body == 0) body = n <= kSmallMaxN ? kBodySmall : kBodyBlock;
  if (body == kBodySmall) {
    if (n > kSmallMaxN) return false;
    const int g = n <= 8 ? 8 : n <= 16 ? 16 : 32;
    *c = Config{kBodySmall, g, 32 * kSmallWarps, kSmallWarps * (32 / g),
                size * kSmallWarps * 32 * (g + 1)};
    return true;
  }
  const int t = (n + kTile - 1) / kTile;
  // band[2][16][ld], c[2][16 T], diag[16 T]
  *c = Config{kBodyBlock, t, kBlockThreads, 1,
              size * (2 * kTile * band_ld(t, size) + 3 * kTile * t)};
  return true;
}

// ---------------------------------------------------------------------------
// Small body
// ---------------------------------------------------------------------------

// floor(e / n) for 0 <= e < 4096, 1 <= n <= 32, from inv = 1 / n:
// (e + 0.5) / n lies at least 1 / 64 from an integer, far beyond the float
// error.
__device__ __forceinline__ int small_div(int e, float inv) {
  return __float2int_rz((static_cast<float>(e) + 0.5f) * inv);
}

// The first matrix of this warp.  %ctaid.x is read anew (volatile) at each
// use, so that the offset is not held in registers across the recursion:
// held, it spilled at G = 32.
template <int M>
__device__ __forceinline__ long long warp_first_matrix(int warp) {
  unsigned block;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
  return (static_cast<long long>(block) * kSmallWarps + warp) * M;
}

template <typename T, int G>
__global__ void __launch_bounds__(32 * kSmallWarps) chol_small_kernel(
    const T* __restrict__ K, T* __restrict__ L, int batch, int n) {
  constexpr int M = 32 / G;   // matrices a warp
  constexpr int LD = G + 1;   // odd: a row a lane, conflict-free
  __shared__ T stage[kSmallWarps][32 * LD];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int i = lane % G;  // the row this thread owns
  long long b0 = warp_first_matrix<M>(warp);
  if (b0 >= batch) return;  // whole warps; the kernel has no block barrier
  int mats = batch - b0 < M ? static_cast<int>(batch - b0) : M;
  const bool live = i < n && lane / G < mats;
  T* S = stage[warp];
  const int nn = n * n;
  const float inv = 1.0f / static_cast<float>(n);

  // the lower triangles of the warp's matrices, one contiguous run of K
  const T* src = K + static_cast<size_t>(b0) * nn;
  for (int e = lane; e < mats * nn; e += 32) {
    const int row = small_div(e, inv);  // m n + i
    const int m = small_div(row, inv);
    const int ii = row - m * n;
    const int k = e - row * n;
    if (k <= ii) S[(m * G + ii) * LD + k] = src[e];
  }
  __syncwarp();
  T A[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    A[k] = live && k <= i ? S[lane * LD + k] : T(0);
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= n) break;  // uniform
    const T piv = __shfl_sync(kFull, A[j], j, G);
    const T dinv = T(1) / sqrt(piv);
    const T ci = A[j] * dinv;  // L_ij for i >= j
    A[j] = ci;
#pragma unroll
    for (int k = j + 1; k < G; ++k) {
      if (k >= n) break;
      const T ck = __shfl_sync(kFull, ci, k, G);
      if (k <= i) A[k] = fma(-ci, ck, A[k]);
    }
  }

  // L through the stage: the upper entries of column k are 0 * L_kk
  __syncwarp();
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const T dk = __shfl_sync(kFull, A[k], k, G);
    if (k < n && i < n) S[lane * LD + k] = k <= i ? A[k] : T(0) * dk;
  }
  __syncwarp();
  b0 = warp_first_matrix<M>(warp);
  mats = batch - b0 < M ? static_cast<int>(batch - b0) : M;
  T* dst = L + static_cast<size_t>(b0) * nn;
  for (int e = lane; e < mats * nn; e += 32) {
    const int row = small_div(e, inv);
    const int m = small_div(row, inv);
    dst[e] = S[(m * G + row - m * n) * LD + e - row * n];
  }
}

// ---------------------------------------------------------------------------
// Block body
// ---------------------------------------------------------------------------

// Columns 16 BJ .. 16 BJ + 15 of the recursion (tile column BJ), then the
// tile columns after it.  A[a][b] is entry (r + 16a, c + 16b) for a >= b.
template <typename T, int NT, int BJ>
__device__ __forceinline__ void factor_tiles(T (&A)[NT][NT],
                                             T (*cbuf)[kTile * NT], T* diag,
                                             int r, int c, int warp, int n) {
  if constexpr (BJ < NT) {
#pragma unroll 1
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = kTile * BJ + jj;
      if (j >= n) break;  // uniform
      T* cb = cbuf[jj & 1];
      // the half-warp that owns column j scales it and publishes c; the
      // buffer it writes was last read before the previous barrier
      if (warp == (jj >> 1)) {
        const T piv = __shfl_sync(kFull, A[BJ][BJ], jj, kTile);
        const T dinv = T(1) / sqrt(piv);
        if (c == jj) {
#pragma unroll
          for (int a = BJ; a < NT; ++a) {
            A[a][BJ] *= dinv;
            cb[r + kTile * a] = A[a][BJ];
          }
          if (r == jj) diag[j] = A[BJ][BJ];
        }
      }
      __syncthreads();
      T rc[NT], cc[NT];
#pragma unroll
      for (int a = BJ; a < NT; ++a) rc[a] = cb[r + kTile * a];
#pragma unroll
      for (int b = BJ; b < NT; ++b) cc[b] = cb[c + kTile * b];
      // downdate the columns after j: tile column BJ only where c > jj
      const bool later = c > jj;
#pragma unroll
      for (int b = BJ; b < NT; ++b) {
#pragma unroll
        for (int a = b; a < NT; ++a) {
          const T upd = fma(-rc[a], cc[b], A[a][b]);
          if (b > BJ || later) A[a][b] = upd;
        }
      }
    }
    factor_tiles<T, NT, BJ + 1>(A, cbuf, diag, r, c, warp, n);
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kBlockThreads) chol_block_kernel(
    const T* __restrict__ K, T* __restrict__ L, int n) {
  constexpr int LD = band_ld(NT, sizeof(T));
  constexpr int kLoads = NT * (NT + 1) / 2;  // = entries a thread owns
  __shared__ T band[2][kTile][LD];
  __shared__ T cbuf[2][kTile * NT];
  __shared__ T diag[kTile * NT];
  const int tid = static_cast<int>(threadIdx.x);
  const int r = tid & (kTile - 1);
  const int c = tid >> 4;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const T* src = K + base;

  // every load of the lower triangle at once: band a is rows 16a..16a+15,
  // columns 0..16a+15, 256 (a + 1) elements, a + 1 a thread, a warp on one
  // row segment; entries above the diagonal or past n are not read (0)
  T P[kLoads];  // band a's q-th load is P[a (a + 1) / 2 + q]
#pragma unroll
  for (int a = 0; a < NT; ++a) {
#pragma unroll
    for (int q = 0; q <= a; ++q) {
      const int e = tid + kBlockThreads * q;
      const int rr = e / (kTile * (a + 1));
      const int col = e - rr * kTile * (a + 1);
      const int row = kTile * a + rr;
      P[a * (a + 1) / 2 + q] =
          col <= row && row < n ? src[row * n + col] : T(0);
    }
  }
  // ... and into the register layout, band by band (double-buffered: the
  // buffer written was last read before the previous barrier)
  T A[NT][NT];
#pragma unroll
  for (int a = 0; a < NT; ++a) {
#pragma unroll
    for (int q = 0; q <= a; ++q) {
      const int e = tid + kBlockThreads * q;
      const int rr = e / (kTile * (a + 1));
      band[a & 1][rr][e - rr * kTile * (a + 1)] = P[a * (a + 1) / 2 + q];
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b <= a; ++b) A[a][b] = band[a & 1][r][c + kTile * b];
  }

  factor_tiles<T, NT, 0>(A, cbuf, diag, r, c, warp, n);

  // L, band by band: the lower entries from the registers, the upper ones
  // 0 * L_kk; a warp writes 32 consecutive columns of a row
  T* dst = L + base;
  const int col = tid & 127;
#pragma unroll
  for (int a = 0; a < NT; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) band[a & 1][r][c + kTile * b] = A[a][b];
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kTile / 2; ++s) {
      const int rr = (tid >> 7) + 2 * s;
      const int row = kTile * a + rr;
      if (row < n && col < n) {
        dst[row * n + col] = col <= row ? band[a & 1][rr][col]
                                        : T(0) * diag[col];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

template <typename T>
const void* small_kernel(int g) {
  switch (g) {
    case 8: return reinterpret_cast<const void*>(chol_small_kernel<T, 8>);
    case 16: return reinterpret_cast<const void*>(chol_small_kernel<T, 16>);
    case 32: return reinterpret_cast<const void*>(chol_small_kernel<T, 32>);
    default: return nullptr;
  }
}

template <typename T>
const void* block_kernel(int tiles) {
  switch (tiles) {
    case 1: return reinterpret_cast<const void*>(chol_block_kernel<T, 1>);
    case 2: return reinterpret_cast<const void*>(chol_block_kernel<T, 2>);
    case 3: return reinterpret_cast<const void*>(chol_block_kernel<T, 3>);
    case 4: return reinterpret_cast<const void*>(chol_block_kernel<T, 4>);
    case 5: return reinterpret_cast<const void*>(chol_block_kernel<T, 5>);
    case 6: return reinterpret_cast<const void*>(chol_block_kernel<T, 6>);
    case 7: return reinterpret_cast<const void*>(chol_block_kernel<T, 7>);
    case 8: return reinterpret_cast<const void*>(chol_block_kernel<T, 8>);
    default: return nullptr;
  }
}

// The kernel of a launch plan.
const void* kernel_of(const Config& cfg, int is_double) {
  if (cfg.body == kBodySmall) {
    return is_double ? small_kernel<double>(cfg.width)
                     : small_kernel<float>(cfg.width);
  }
  return is_double ? block_kernel<double>(cfg.width)
                   : block_kernel<float>(cfg.width);
}

}  // namespace

extern "C" {

// The launch plan of n in float64 (`is_double`) or float32 with body `body`
// (0: the default; 1 small, 2 block) as 5 ints: body, width (threads a
// matrix, or tiles), threads a block, matrices a block, static shared-memory
// bytes.  Returns 0, or -1 for a shape (or a forced body) the kernel does
// not take.
int copra_chol_batched_config(int n, int is_double, int body, int* out) {
  Config c;
  if (!make_config(n, is_double, body, &c)) return -1;
  out[0] = c.body;
  out[1] = c.width;
  out[2] = c.threads;
  out[3] = c.mats;
  out[4] = c.smem;
  return 0;
}

const char* copra_chol_batched_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Registers a thread, local-memory (spill) bytes a thread, the largest
// block, the blocks an SM holds and the static shared-memory bytes of the
// kernel that serves (n, is_double, body), as 5 ints; returns 0, -1 for a
// plan the kernel does not take, or a CUDA error.
int copra_chol_batched_attributes(int n, int is_double, int body, int* out) {
  Config cfg;
  if (!make_config(n, is_double, body, &cfg)) return -1;
  const void* fn = kernel_of(cfg, is_double);
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        cfg.threads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  out[4] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

// Launches the kernel on `stream` with the body `body` (0: the default for
// n); `is_double` selects float64.  Returns the launch's error (0 =
// launched).
int copra_chol_batched(const void* K, void* L, int batch, int n,
                       int is_double, int body, void* stream) {
  Config cfg;
  if (batch < 1 || !make_config(n, is_double, body, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (batch + cfg.mats - 1) / cfg.mats;
  if (cfg.body == kBodySmall) {
    void* args[] = {&K, &L, &batch, &n};
    return static_cast<int>(cudaLaunchKernel(
        kernel_of(cfg, is_double), dim3(blocks), dim3(cfg.threads), args, 0,
        static_cast<cudaStream_t>(stream)));
  }
  void* args[] = {&K, &L, &n};
  return static_cast<int>(cudaLaunchKernel(
      kernel_of(cfg, is_double), dim3(blocks), dim3(cfg.threads), args, 0,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
