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
// What bounds it on this card: f32 arithmetic at large n, the dependent
// chain of iterations at small n.  One iteration is a [B, n] x [n, n]
// product (plus two more per refinement step); at the shared-plan roofline
// shape (B = 4096, n = 256) a call of 30 iterations is 31 products, 1.7e10
// FLOP against ~42 MB of lane vectors: ~0.25 ms at the 67 TFLOP/s f32 peak
// (no tensor cores: the reference's products are f32-exact, so TF32 is
// out).  At config 1's n = 10 the work is 0.006 ms and what is left is the
// chain: 300 iterations of a 10-deep sum each.
//
// Two bodies, chosen by n (box_shared_config, mirrored in
// ops/admm_kernel.box_shared_config):
//
// * Small body (n <= 32).  Lanes are independent, so the iteration has no
//   block barrier.  A lane belongs to a group of G threads (G = 1, 2, 4, 8
//   or 16, the least that gives a thread P <= 4 coordinates and n P <= 64
//   Kinv entries); its x, z, y, c, l, u live in the group's registers, and
//   the rhs coordinates a thread needs come from its group by __shfl_sync.
//   Each thread keeps the Kinv columns of its coordinates in registers; K
//   (refinement and the final g only) is read from shared memory, staged
//   once per block.
//
// * Tile body (n > 32).  A block of up to 8 warps serves a tile of T
//   lanes (32, 16 or 8 as n grows) for all iterations.  Each thread owns a
//   4-lane x 8-column register tile (two float4 column groups: a k step is
//   3 LDS.128 for 32 FMAs; a warp covers 16 lanes x 64 columns).  The
//   lanes' x, z, y stay in registers, c, l, u in shared memory, and the
//   product's left operand is a k-major [n][T] tile, double-buffered so
//   that one block barrier per product is enough.  The operator (256 KB at
//   n = 256, more than a block's 227 KB) streams through a ring of R-row
//   slices (R up to 32, 2 to 4 stages): each slice arrives by one 1-D
//   bulk TMA copy (a slice is rows x n contiguous words) that completes on
//   the stage's "full" mbarrier, every warp releases a stage on its
//   "empty" mbarrier, and the warps take turns to refill it with the slice
//   a ring ahead; no block barrier in the loop.  Where n is not a multiple
//   of 4 (or an operator is not 16-byte aligned) the refilling warp copies
//   the slice with plain loads into rows padded to 4 words instead.  The
//   threads use at most 255 registers and the bound is shared-memory
//   bandwidth: 48 bytes requested per 32 FMAs a thread, ~2/3 of the f32
//   peak at best.
//
// Arithmetic follows the reference twin xla_admm_box in its row-vector
// form: out[b, j] = sum_k v[b, k] M[k, j] in f32 FMAs, k ascending.
// g = x K - (sigma + rho) x is always computed from K (the reference body
// has no K-free recurrence).  y0 is taken as y0 and z0 as z0.
//
// A launch allocates nothing and does not synchronise with the host, so it
// can be captured in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libadmm_box_shared.so admm_box_shared.cu

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxN = 1024;         // widest n
constexpr int kSmallMaxN = 32;      // widest n of the small body
constexpr int kSmallThreads = 64;   // threads per block, small body
constexpr int kMaxStages = 4;       // ring stages, tile body, at most
constexpr int kMaxRows = 32;        // operator rows per slice, at most
constexpr int kSmemLimit = 232448;  // shared memory one H100 block may use
constexpr int kMaxTileThreads = 256;

struct Scalars {
  float sigma;
  float alpha;
  float oma;      // 1 - alpha
  float rho;
  float rho_inv;  // 1 / rho
  float spr;      // sigma + rho
};

// The launch plan of a width: mirrored by box_shared_config in
// ops/admm_kernel.py and checked against it when the library is loaded.
struct Config {
  int body;          // 1 small, 2 tile
  int g_or_lw;       // small: threads per lane G; tile: lane groups a warp
  int p_or_cw;       // small: coordinates per thread P; tile: column groups
  int lanes;         // lanes per block
  int threads;       // threads per block
  int rows;          // tile: operator rows per slice
  int stages;        // tile: ring stages
  int stage_words;   // tile: floats per ring stage
  int smem;          // dynamic shared memory bytes per block
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// body: 0 the default for n, 1 small, 2 tile.  Returns false for a width
// (or a forced body) the kernel does not take.
bool make_config(int n, int body, Config* c) {
  if (n < 1 || n > kMaxN) return false;
  if (body == 0) body = n <= kSmallMaxN ? 1 : 2;
  if (body == 1) {
    if (n > kSmallMaxN) return false;
    int g = 1;  // the least G with P <= 4 and n P <= 64
    while ((n + g - 1) / g > 4 || n * ((n + g - 1) / g) > 64) g *= 2;
    const int p = (n + g - 1) / g;
    *c = Config{1, g, p, kSmallThreads / g, kSmallThreads, 0, 0, 0,
                8 * n * n};
    return true;
  }
  if (body != 2) return false;
  const int np64 = round_up(n, 64);
  const int lanes = np64 <= 256 ? 32 : np64 <= 512 ? 16 : 8;
  const int lg = lanes / 4;                 // lane groups of 4
  const int lw = lg < 4 ? lg : 4;           // lane groups a warp covers
  const int cw = 32 / lw;                   // column groups a warp covers
  const int np = round_up(n, 8 * cw);       // columns the threads cover
  const int threads = lg * (np / 8);
  const int sp = round_up(n, 4);            // row stride of a ring stage
  const int slack = np - sp;                // words read past the last row
  const int budget = kSmemLimit - 4 * (2 * n * lanes + 96 * threads);
  // the most rows (a multiple of 4, at most 32) for which two stages fit,
  // then as many stages of them as fit, at most 4
  int rows = kMaxRows < sp ? kMaxRows : sp;
  while (rows > 4 && 2 * (4 * (rows * sp + slack) + 16) > budget) rows -= 4;
  const int stage_words = rows * sp + slack;
  if (2 * (4 * stage_words + 16) > budget) return false;
  int stages = budget / (4 * stage_words + 16);
  if (stages > kMaxStages) stages = kMaxStages;
  *c = Config{2, lw, cw, lanes, threads, rows, stages, stage_words,
              kSmemLimit - budget + stages * (4 * stage_words + 16)};
  return true;
}

// ---------------------------------------------------------------------------
// Small body
// ---------------------------------------------------------------------------

// out[q] = sum_k v_k M[k][g P + q], k ascending, where v_k is coordinate
// k of the lane, held by thread k / P of its group in slot k % P.  M is
// read from `regs` (REG) or from the row-major n x n `shared` copy.
template <int G, int P, bool REG>
__device__ __forceinline__ void small_product(const float (&v)[P],
                                              const float (&regs)[G * P][P],
                                              const float* shared, int n,
                                              int g, float (&out)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) out[q] = 0.0f;
#pragma unroll
  for (int src = 0; src < G; ++src) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int k = src * P + p;
      const float vk = G == 1 ? v[p] : __shfl_sync(0xffffffffu, v[p], src, G);
      if (k < n) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          float m;
          if (REG) {
            m = regs[k][q];
          } else {
            const int j = min(g * P + q, n - 1);  // past n: never stored
            m = shared[k * n + j];
          }
          out[q] = fmaf(vk, m, out[q]);
        }
      }
    }
  }
}

template <int G, int P>
__global__ void __launch_bounds__(kSmallThreads) box_small_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int batch, int n, int n_iter, int refine,
    Scalars s) {
  extern __shared__ __align__(16) float smem[];
  float* skinv = smem;
  float* sk = smem + n * n;
  for (int t = threadIdx.x; t < n * n; t += kSmallThreads) {
    skinv[t] = kinv[t];
    sk[t] = kmat[t];
  }
  __syncthreads();  // the only block barrier

  const int g = threadIdx.x % G;
  const int lane = blockIdx.x * (kSmallThreads / G) + threadIdx.x / G;
  const bool live = lane < batch;
  float x[P], z[P], y[P], cc[P], lo[P], hi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g * P + p;
    const bool ok = live && j < n;
    const size_t idx = static_cast<size_t>(lane) * n + j;
    x[p] = ok ? x0[idx] : 0.0f;
    y[p] = ok ? y0[idx] : 0.0f;
    z[p] = ok ? z0[idx] : 0.0f;
    cc[p] = ok ? c[idx] : 0.0f;
    lo[p] = ok ? l[idx] : 0.0f;
    hi[p] = ok ? u[idx] : 0.0f;
  }
  float kr[G * P][P];
#pragma unroll
  for (int k = 0; k < G * P; ++k) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int j = g * P + q;
      kr[k][q] = (k < n && j < n) ? skinv[k * n + j] : 0.0f;
    }
  }

  float rhs[P], xt[P], t[P];
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      rhs[p] = s.sigma * x[p] - cc[p] + s.rho * z[p] - y[p];
    }
    small_product<G, P, true>(rhs, kr, skinv, n, g, xt);
    for (int rf = 0; rf < refine; ++rf) {
      small_product<G, P, false>(xt, kr, sk, n, g, t);
#pragma unroll
      for (int p = 0; p < P; ++p) t[p] = rhs[p] - t[p];
      float d[P];
      small_product<G, P, true>(t, kr, skinv, n, g, d);
#pragma unroll
      for (int p = 0; p < P; ++p) xt[p] += d[p];
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float zrel = s.alpha * xt[p] + s.oma * z[p];
      const float zn = fminf(fmaxf(zrel + s.rho_inv * y[p], lo[p]), hi[p]);
      y[p] = y[p] + s.rho * (zrel - zn);
      x[p] = s.alpha * xt[p] + s.oma * x[p];
      z[p] = zn;
    }
  }

  // g = x K - (sigma + rho) x
  small_product<G, P, false>(x, kr, sk, n, g, t);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = g * P + p;
    if (live && j < n) {
      const size_t idx = static_cast<size_t>(lane) * n + j;
      xo[idx] = x[p];
      yo[idx] = y[p];
      zo[idx] = z[p];
      go[idx] = t[p] - s.spr * x[p];
    }
  }
}

// ---------------------------------------------------------------------------
// Tile body
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy global -> shared that completes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Tile {
  int n, lanes, threads, rows, stages, stage_words, sp, tma;
};

// The operator ring: the call's products run Kinv, then K and Kinv per
// refinement step, for each iteration, and K (for g) last; slice s of the
// call is slice s % slices of product s / slices.
struct Ring {
  const float* kinv;
  const float* kmat;
  float* stage;      // stages x stage_words floats
  uint64_t* full;    // a stage's slice has arrived
  uint64_t* empty;   // every warp is done with a stage
  int slices;        // slices per product
  int per;           // products per iteration, 1 + 2 refine
  int total;         // slices of the call
};

// A warp copies slice s into its stage: one 1-D bulk copy by lane 0 that
// completes on the stage's full barrier, or (n not a multiple of 4, or an
// operator not 16-byte aligned) plain copies by all 32 lanes, each of
// which then arrives on it.
__device__ __forceinline__ void fill(Tile t, const Ring& ring, int s,
                                     int lane) {
  const int p = s / ring.slices;
  const int k0 = (s - p * ring.slices) * t.rows;
  const bool last = s >= ring.total - ring.slices;
  const float* M = (last || (p % ring.per) % 2 == 1) ? ring.kmat : ring.kinv;
  const int rows = min(t.rows, t.n - k0);
  const int st = s % t.stages;
  float* dst = ring.stage + st * t.stage_words;
  const float* src = M + static_cast<size_t>(k0) * t.n;
  if (t.tma) {
    if (lane == 0) {
      const uint32_t bytes = static_cast<uint32_t>(rows * t.n) * 4u;
      mbar_arrive_expect_tx(&ring.full[st], bytes);
      bulk_copy(dst, src, bytes, &ring.full[st]);
    }
  } else {
    for (int i = lane; i < rows * t.n; i += 32) {
      const int r = i / t.n;
      dst[r * t.sp + (i - r * t.n)] = __ldg(src + i);
    }
    mbar_arrive(&ring.full[st]);
  }
  __syncwarp();
}

// One k step of a thread's product: acc[r][q] += a[r] b[q].
__device__ __forceinline__ void fma_step(const float4& av, const float4& b0,
                                         const float4& b1,
                                         float (&acc)[4][8]) {
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    acc[0][q] = fmaf(av.x, bv[q], acc[0][q]);
    acc[1][q] = fmaf(av.y, bv[q], acc[1][q]);
    acc[2][q] = fmaf(av.z, bv[q], acc[2][q]);
    acc[3][q] = fmaf(av.w, bv[q], acc[3][q]);
  }
}

// acc[r][q] = sum_k a[k][l0 + r] M[k][col(q)], k ascending, for the
// thread's 4 lanes x 8 columns; `a` is a k-major [n][lanes] tile that
// every thread wrote before the call.  M comes slice by slice from the
// ring.
__device__ __forceinline__ void tile_product(Tile t, const float* a,
                                             const Ring& ring, int& seq,
                                             int l0, int col0, int col1,
                                             int warp, int lane,
                                             float (&acc)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
  }
  __syncthreads();  // `a` is written
  for (int k0 = 0; k0 < t.n; k0 += t.rows, ++seq) {
    const int rows = min(t.rows, t.n - k0);
    const int st = seq % t.stages;
    const uint32_t use = (seq / t.stages) & 1;
    mbar_wait(&ring.full[st], use);
    const float* b = ring.stage + st * t.stage_words;
    const float* ak = a + static_cast<size_t>(k0) * t.lanes + l0;
    // the next k's fragments are loaded ahead of this k's FMAs
    float4 an = *reinterpret_cast<const float4*>(ak);
    float4 bn0 = *reinterpret_cast<const float4*>(b + col0);
    float4 bn1 = *reinterpret_cast<const float4*>(b + col1);
#pragma unroll 4
    for (int kk = 0; kk < rows; ++kk) {
      const float4 av = an, b0 = bn0, b1 = bn1;
      const int kn = min(kk + 1, rows - 1);
      an = *reinterpret_cast<const float4*>(ak + kn * t.lanes);
      bn0 = *reinterpret_cast<const float4*>(b + kn * t.sp + col0);
      bn1 = *reinterpret_cast<const float4*>(b + kn * t.sp + col1);
      fma_step(av, b0, b1, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[st]);
    if (warp == seq % (t.threads / 32) && seq + t.stages < ring.total) {
      // the warps take turns to refill the stage with the slice `stages`
      // ahead once every warp has left it
      mbar_wait(&ring.empty[st], use);
      fill(t, ring, seq + t.stages, lane);
    }
  }
}

__device__ __forceinline__ int col_of(int q, int col0, int col1) {
  return q < 4 ? col0 + q : col1 + q - 4;
}

// Writes the thread's 4 x 8 values into the k-major tile w (columns past
// n have no row there).
__device__ __forceinline__ void put_tile(float* w, const float (&v)[4][8],
                                         Tile t, int l0, int col0,
                                         int col1) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = col_of(q, col0, col1);
    if (j < t.n) {
      *reinterpret_cast<float4*>(w + static_cast<size_t>(j) * t.lanes + l0) =
          make_float4(v[0][q], v[1][q], v[2][q], v[3][q]);
    }
  }
}

__device__ __forceinline__ float4 own(const float* w, Tile t, int j,
                                      int l0) {
  return *reinterpret_cast<const float4*>(w + static_cast<size_t>(j) *
                                                  t.lanes + l0);
}

__device__ __forceinline__ float comp(const float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kMaxTileThreads, 1) box_tile_kernel(
    const float* __restrict__ kinv, const float* __restrict__ kmat,
    const float* __restrict__ c, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ x0,
    const float* __restrict__ y0, const float* __restrict__ z0,
    float* __restrict__ xo, float* __restrict__ yo, float* __restrict__ zo,
    float* __restrict__ go, int batch, int n_iter, int refine, Scalars s,
    Tile t, int lw, int cw) {
  extern __shared__ __align__(16) float smem[];
  const size_t tile = static_cast<size_t>(t.n) * t.lanes;
  // smem, smem + tile: the product's left operand, two k-major tiles
  float* cs = smem + 2 * tile;              // c, l, u: [32][threads]
  float* ls = cs + 32 * t.threads;
  float* us = ls + 32 * t.threads;
  float* stage = us + 32 * t.threads;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stage + t.stages * t.stage_words);
  const int slices = (t.n + t.rows - 1) / t.rows;
  const Ring ring{kinv, kmat, stage, full, full + t.stages, slices,
                  1 + 2 * refine, slices * (n_iter * (1 + 2 * refine) + 1)};

  if (threadIdx.x == 0) {
    for (int i = 0; i < t.stages; ++i) {
      mbar_init(&ring.full[i], t.tma ? 1 : 32);
      mbar_init(&ring.empty[i], t.threads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {  // the first slices, into the empty ring
    for (int s = 0; s < t.stages && s < ring.total; ++s) {
      fill(t, ring, s, lane);
    }
  }
  int seq = 0;

  // the thread's place: 4 lanes (l0..l0+3) x columns col0..col0+3 and
  // col1..col1+3; a warp covers lw lane groups x cw column groups
  const int lane_blocks = t.lanes / (4 * lw);
  const int l0 = 4 * ((warp % lane_blocks) * lw + lane / cw);
  const int base = (warp / lane_blocks) * 8 * cw;
  const int col0 = base + 4 * (lane % cw);
  const int col1 = col0 + 4 * cw;
  const int lane0 = blockIdx.x * t.lanes + l0;
  const int me = threadIdx.x;

  float x[4][8], z[4][8], y[4][8], acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = col_of(q, col0, col1);
      const bool ok = j < t.n && lane0 + r < batch;
      const size_t idx = static_cast<size_t>(lane0 + r) * t.n + j;
      x[r][q] = ok ? x0[idx] : 0.0f;
      y[r][q] = ok ? y0[idx] : 0.0f;
      z[r][q] = ok ? z0[idx] : 0.0f;
      const int e = (r * 8 + q) * t.threads + me;  // read back by me only
      cs[e] = ok ? c[idx] : 0.0f;
      ls[e] = ok ? l[idx] : 0.0f;
      us[e] = ok ? u[idx] : 0.0f;
    }
  }

  // The operand tiles alternate: a product reads tile cur, a write goes to
  // tile cur ^ 1, whose last reader (two products back) is behind the
  // barrier that starts the product in between.
  int cur = 0;
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = (r * 8 + q) * t.threads + me;
        acc[r][q] = s.sigma * x[r][q] - cs[e] + s.rho * z[r][q] - y[r][q];
      }
    }
    put_tile(smem + (cur ^ 1) * tile, acc, t, l0, col0, col1);  // rhs
    cur ^= 1;
    // x_t = rhs Kinv
    tile_product(t, smem + cur * tile, ring, seq, l0, col0, col1, warp,
                 lane, acc);
    for (int rf = 0; rf < refine; ++rf) {
      put_tile(smem + (cur ^ 1) * tile, acc, t, l0, col0, col1);  // x_t
      cur ^= 1;
      // x_t K
      tile_product(t, smem + cur * tile, ring, seq, l0, col0, col1, warp,
                   lane, acc);
      float* rb = smem + (cur ^ 1) * tile;  // rhs, overwritten by rhs - x_t K
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = col_of(q, col0, col1);
        if (j < t.n) {
          const float4 rv = own(rb, t, j, l0);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] = comp(rv, r) - acc[r][q];
        }
      }
      put_tile(rb, acc, t, l0, col0, col1);
      cur ^= 1;
      // the correction (rhs - x_t K) Kinv
      tile_product(t, smem + cur * tile, ring, seq, l0, col0, col1, warp,
                   lane, acc);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = col_of(q, col0, col1);
        if (j < t.n) {
          const float4 xv = own(smem + (cur ^ 1) * tile, t, j, l0);
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][q] += comp(xv, r);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int e = (r * 8 + q) * t.threads + me;
        const float xt = acc[r][q];
        const float zrel = s.alpha * xt + s.oma * z[r][q];
        const float zn =
            fminf(fmaxf(zrel + s.rho_inv * y[r][q], ls[e]), us[e]);
        y[r][q] = y[r][q] + s.rho * (zrel - zn);
        x[r][q] = s.alpha * xt + s.oma * x[r][q];
        z[r][q] = zn;
      }
    }
  }

  // g = x K - (sigma + rho) x
  put_tile(smem + (cur ^ 1) * tile, x, t, l0, col0, col1);
  cur ^= 1;
  tile_product(t, smem + cur * tile, ring, seq, l0, col0, col1, warp, lane,
               acc);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = col_of(q, col0, col1);
      if (j < t.n && lane0 + r < batch) {
        const size_t idx = static_cast<size_t>(lane0 + r) * t.n + j;
        xo[idx] = x[r][q];
        yo[idx] = y[r][q];
        zo[idx] = z[r][q];
        go[idx] = acc[r][q] - s.spr * x[r][q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Opts a kernel into all the dynamic shared memory a block may use on the
// current device, beside its static shared memory (once, at load: see
// the library's prepare function, so that a launch sets nothing).
cudaError_t allow_max_smem(const void* fn) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - static_cast<int>(a.sharedSizeBytes));
}

struct Args {
  const float *kinv, *kmat, *c, *l, *u, *x0, *y0, *z0;
  float *xo, *yo, *zo, *go;
  int batch, n, n_iter, refine;
  Scalars s;
};

template <int G, int P>
cudaError_t launch_small(const Args& a, const Config& cfg,
                         cudaStream_t stream) {
  const int blocks = (a.batch + cfg.lanes - 1) / cfg.lanes;
  box_small_kernel<G, P><<<blocks, kSmallThreads, cfg.smem, stream>>>(
      a.kinv, a.kmat, a.c, a.l, a.u, a.x0, a.y0, a.z0, a.xo, a.yo, a.zo,
      a.go, a.batch, a.n, a.n_iter, a.refine, a.s);
  return cudaGetLastError();
}

cudaError_t dispatch_small(const Args& a, const Config& cfg,
                           cudaStream_t stream) {
  const int g = cfg.g_or_lw, p = cfg.p_or_cw;
  switch (g * 16 + p) {
    case 1 * 16 + 1: return launch_small<1, 1>(a, cfg, stream);
    case 1 * 16 + 2: return launch_small<1, 2>(a, cfg, stream);
    case 1 * 16 + 3: return launch_small<1, 3>(a, cfg, stream);
    case 1 * 16 + 4: return launch_small<1, 4>(a, cfg, stream);
    case 2 * 16 + 3: return launch_small<2, 3>(a, cfg, stream);
    case 2 * 16 + 4: return launch_small<2, 4>(a, cfg, stream);
    case 4 * 16 + 3: return launch_small<4, 3>(a, cfg, stream);
    case 4 * 16 + 4: return launch_small<4, 4>(a, cfg, stream);
    case 8 * 16 + 3: return launch_small<8, 3>(a, cfg, stream);
    case 16 * 16 + 2: return launch_small<16, 2>(a, cfg, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tile(const Args& a, const Config& cfg,
                        cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a.kinv) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(a.kmat) % 16 == 0);
  const Tile t{a.n, cfg.lanes, cfg.threads, cfg.rows, cfg.stages,
               cfg.stage_words, round_up(a.n, 4),
               (a.n % 4 == 0 && aligned) ? 1 : 0};
  const int blocks = (a.batch + cfg.lanes - 1) / cfg.lanes;
  box_tile_kernel<<<blocks, cfg.threads, cfg.smem, stream>>>(
      a.kinv, a.kmat, a.c, a.l, a.u, a.x0, a.y0, a.z0, a.xo, a.yo, a.zo,
      a.go, a.batch, a.n_iter, a.refine, a.s, t, cfg.g_or_lw, cfg.p_or_cw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan of width n (body 0: the default; 1 small; 2 tile) as 9
// ints: body, G or lane groups a warp, P or column groups a warp, lanes per
// block, threads per block, rows per slice, stages, floats per stage,
// shared-memory bytes.  Returns 0, or -1 for a width the kernel does not
// take.
int copra_admm_box_shared_config(int n, int body, int* out) {
  Config c;
  if (!make_config(n, body, &c)) return -1;
  const int v[9] = {c.body,    c.g_or_lw, c.p_or_cw,     c.lanes, c.threads,
                    c.rows,    c.stages,  c.stage_words, c.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Largest dynamic shared memory a block may opt into on `device`.
int copra_admm_box_shared_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

// Sets the dynamic shared-memory attribute of every kernel of the library
// on the current device (once a device, before the first launch).
// Returns 0 or a CUDA error.
int copra_admm_box_shared_prepare() {
  const void* fns[] = {
      reinterpret_cast<const void*>(box_small_kernel<1, 1>),
      reinterpret_cast<const void*>(box_small_kernel<1, 2>),
      reinterpret_cast<const void*>(box_small_kernel<1, 3>),
      reinterpret_cast<const void*>(box_small_kernel<1, 4>),
      reinterpret_cast<const void*>(box_small_kernel<2, 3>),
      reinterpret_cast<const void*>(box_small_kernel<2, 4>),
      reinterpret_cast<const void*>(box_small_kernel<4, 3>),
      reinterpret_cast<const void*>(box_small_kernel<4, 4>),
      reinterpret_cast<const void*>(box_small_kernel<8, 3>),
      reinterpret_cast<const void*>(box_small_kernel<16, 2>),
      reinterpret_cast<const void*>(box_tile_kernel)};
  for (const void* fn : fns) {
    const cudaError_t e = allow_max_smem(fn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* copra_admm_box_shared_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the kernel on `stream` with the body `body` (0: the default for
// n); returns cudaGetLastError() (0 = launched).
int copra_admm_box_shared(const float* kinv, const float* kmat,
                          const float* c, const float* l, const float* u,
                          const float* x0, const float* y0, const float* z0,
                          float* xo, float* yo, float* zo, float* go,
                          int batch, int n, int n_iter, int refine,
                          float sigma, float alpha, float oma, float rho,
                          float rho_inv, float spr, int body, void* stream) {
  Config cfg;
  if (batch < 1 || n_iter < 0 || refine < 0 || !make_config(n, body, &cfg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{kinv, kmat, c,  l,  u,     x0, y0,     z0,     xo,
               yo,   zo,   go, batch, n, n_iter, refine,
               Scalars{sigma, alpha, oma, rho, rho_inv, spr}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cfg.body == 1 ? dispatch_small(a, cfg, st) : launch_tile(a, cfg, st);
  return static_cast<int>(err);
}

}  // extern "C"
