// Lower Cholesky factors of B small symmetric positive-definite matrices
// K [B, n, n] -> L [B, n, n] with L L' = K, n <= 128, float32 or float64, by
// the right-looking (outer-product) recursion
//   for j in 0..n-1:  c = K[:, j] / sqrt(K[j, j]);  L[:, j] = c;  K -= c c'
// on the lower triangle; the strict upper triangle of L is written as zero.
// A matrix that is not positive definite gives NaN from its first
// non-positive pivot on (no error code), as the reference does.
//
// Replaces the Pallas TPU kernel copra_tpu/ops/cholesky_kernel.py::
// chol_batched (bodies _chol_kernel, _chol_lanes).  The TPU version rides
// the batch on the 128-wide vector lane axis ([n, n, 128] blocks, the batch
// padded with identities to a multiple of 128, a VMEM size rule); none of
// that layout is carried over.
//
// What bounds it on this card: bytes at the served shapes (B = 4096: every
// matrix read once and every factor written once, 328 MB at n = 100 in f32,
// against n^3 / 3 operations per matrix), with a dependent chain of n
// columns per matrix on top.  A matrix lives in shared memory with an odd
// leading dimension (n + 1).  For n <= 32 a warp owns a matrix, thread i
// owns row i and the columns are separated by __syncwarp only, four matrices
// per block.  For 32 < n <= 128 a block of 8 warps owns a matrix: the column
// is scaled by all threads, then warp w updates rows j + 1 + w, j + 1 + w +
// 8, ... with its threads on neighbouring columns, three block barriers per
// column; the matrix takes up to 129 KB (n = 128, f64), so the kernel asks
// for the opt-in shared-memory size.  1 / sqrt is the IEEE division and
// square root (no rsqrt approximation): the float64 factor reconstructs K to
// ~1e-16 relative on spectra spread over ten decades.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libchol_batched.so chol_batched.cu

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarpMats = 4;  // matrices per block, one per warp (n <= 32)
constexpr int kBlockWarps = 8;
constexpr int kBlockThreads = 32 * kBlockWarps;

// Copies matrix b of K into shared memory (leading dimension ld), `stride`
// threads of index `t` sharing the work.
template <typename T>
__device__ __forceinline__ void load_matrix(const T* __restrict__ K, T* A,
                                            size_t b, int n, int ld, int t,
                                            int stride) {
  const T* src = K + b * n * n;
  for (int e = t; e < n * n; e += stride) {
    const int i = e / n;
    A[i * ld + (e - i * n)] = src[e];
  }
}

// Writes the lower triangle of A as matrix b of L, zeros above it.
template <typename T>
__device__ __forceinline__ void store_factor(const T* A, T* __restrict__ L,
                                             size_t b, int n, int ld, int t,
                                             int stride) {
  T* dst = L + b * n * n;
  for (int e = t; e < n * n; e += stride) {
    const int i = e / n;
    const int k = e - i * n;
    dst[e] = k <= i ? A[i * ld + k] : T(0);
  }
}

// n <= 32: one warp per matrix, thread i owns row i.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpMats) chol_warp_kernel(
    const T* __restrict__ K, T* __restrict__ L, int batch, int n) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t b = static_cast<size_t>(blockIdx.x) * kWarpMats + warp;
  if (b >= static_cast<size_t>(batch)) return;  // whole warps, no block barrier
  const int ld = n + 1;
  T* A = reinterpret_cast<T*>(raw) + static_cast<size_t>(warp) * n * ld;
  load_matrix(K, A, b, n, ld, lane, 32);
  __syncwarp();
  for (int j = 0; j < n; ++j) {
    const T dinv = T(1) / sqrt(A[j * ld + j]);
    __syncwarp();  // every thread has the pivot before row j rescales it
    T ci = T(0);
    if (lane >= j && lane < n) {
      ci = A[lane * ld + j] * dinv;
      A[lane * ld + j] = ci;
    }
    __syncwarp();
    if (lane > j && lane < n) {
      for (int k = j + 1; k <= lane; ++k) A[lane * ld + k] -= ci * A[k * ld + j];
    }
    __syncwarp();
  }
  store_factor(A, L, b, n, ld, lane, 32);
}

// 32 < n <= 128: one block per matrix.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) chol_block_kernel(
    const T* __restrict__ K, T* __restrict__ L, int n) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* A = reinterpret_cast<T*>(raw);
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t b = blockIdx.x;
  const int ld = n + 1;
  load_matrix(K, A, b, n, ld, tid, kBlockThreads);
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const T dinv = T(1) / sqrt(A[j * ld + j]);
    __syncthreads();  // every thread has the pivot before it is rescaled
    for (int i = j + tid; i < n; i += kBlockThreads) A[i * ld + j] *= dinv;
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += kBlockWarps) {
      const T ci = A[i * ld + j];
      for (int k = j + 1 + lane; k <= i; k += 32) A[i * ld + k] -= ci * A[k * ld + j];
    }
    __syncthreads();
  }
  store_factor(A, L, b, n, ld, tid, kBlockThreads);
}

template <typename T>
cudaError_t launch(const T* K, T* L, int batch, int n, cudaStream_t stream) {
  if (n <= 32) {
    const size_t smem = sizeof(T) * kWarpMats * n * (n + 1);
    const int blocks = (batch + kWarpMats - 1) / kWarpMats;
    chol_warp_kernel<T><<<blocks, 32 * kWarpMats, smem, stream>>>(K, L, batch, n);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(T) * n * (n + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_block_kernel<T><<<batch, kBlockThreads, smem, stream>>>(K, L, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* copra_chol_batched_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream`; `is_double` selects float64.  Returns
// cudaGetLastError() (0 = launched).
int copra_chol_batched(const void* K, void* L, int batch, int n,
                       int is_double, void* stream) {
  if (n < 1 || batch < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_double ? launch(static_cast<const double*>(K), static_cast<double*>(L),
                         batch, n, st)
                : launch(static_cast<const float*>(K), static_cast<float*>(L),
                         batch, n, st);
  return static_cast<int>(err);
}

}  // extern "C"
