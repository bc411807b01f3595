// Full logistic-regression gradient for Hopper (sm_90a), for C weight rows at once:
//
//     z[c, r] = X[r, :] . W[c, :]
//     s[c, r] = -y[r] * sigmoid(-y[r] * z[c, r]) / n
//     G[c, :] = sum_r s[c, r] * X[r, :] + R'(W[c, :])
//
// with R' the gradient of the penalty (kernels/regularizer.py): L2, l2 * w; or the clipped
// penalty of NonconvexLogistic, (c * w) / (den * den) with c = (2 lam) alpha and
// den = 1 + (alpha w) w, in explicitly rounded float32 steps in that order (~5 flops per
// coordinate, no extra bytes).
//
// Replaces the two TPU kernels of src/repro/kernels/logreg_grad/kernel.py:
// `_margin_kernel` (launched by `margins`) and `_grad_kernel` (launched by
// `grad_accum`). In the engine it is the snapshot gradient mu = grad f(w) of
// every AsySVRG epoch, for all rows of a sweep group in one call.
//
// Bound on this card: bytes. X (n x p float32, 166 MB at the rcv1 width) is
// the only large operand, and each of its elements meets 4 flops per weight
// row (one product for the margin, one for the gradient): at C <= 8 that is
// <= 1.3 GFLOP, ~0.02 ms at 67 TFLOP/s, against ~0.05 ms for one read of X at
// 3.35 TB/s. So no tensor cores (TF32 would break the tolerance): the design
// reads X once per chunk of kChunk weight rows, where the two TPU kernels
// read it twice, once for the margins and once for the gradient.
//
// Design (rows of at most kMaxWidth floats), deterministic by construction:
// no float atomics, and every sum runs in an order fixed by n and p alone,
// never by C or by the SM count, so a row's gradient is bit-equal whether it
// is computed alone or in its group.
//   * Stripes. The n sample rows are cut statically into at most kBlocks
//     contiguous ranges, one per block (one block per SM). A block streams
//     its range in stripes of R consecutive rows (R from p alone, a stripe
//     at most 32 KB). A stripe of full rows is one contiguous span of X, so
//     thread 0 brings it into a ring of S stages in shared memory with one
//     bulk copy (cp.async.bulk) that completes on the stage's mbarrier (the
//     helpers of bulk_copy.cuh, shared with sweep_epoch.cu). A span that is
//     not 16-byte aligned (p % 4 != 0) is copied as its aligned cover, as
//     sweep_epoch.cu copies a row, and read at its offset. A stage is refilled
//     after the block's barrier at the end of its stripe, S - 1 stripes ahead.
//   * Margins from shared memory. The chunk of weight rows sits in shared
//     memory. Thread t owns columns j = t + 512 k (k < VPT, the power of two
//     >= p / 512); it forms its partial dot product of every row of the
//     stripe with every weight row of the chunk, over its columns in order.
//     A warp reduce-scatter (R - 1 + 5 - log2 R shuffles for R values where
//     a shuffle tree per value takes 5 R) leaves each value's sum, by the same
//     fixed xor tree, in one lane; the 16 warp sums are added in warp order,
//     and R x kChunk threads form s[c, r].
//   * Gradient in registers. From the same stripe, still in shared memory,
//     each thread accumulates G[c, j] += s[c, r] X[r, j] for its columns in
//     registers, row by row across all of its block's stripes, and writes
//     one partial [C, p] per block at the end of each chunk.
//   * More weight rows than kChunk: the block loops over chunks, one pass
//     over X each; the copies of the next chunk's stripes start during the
//     last stripes of the one before.
//   * A second, small launch sums the blocks' partials in a fixed order and
//     adds the penalty's gradient. So two launches, and one pass over X per chunk.
// Rows wider than kMaxWidth (no dataset of the port has them: rcv1 2048,
// news20 4096) do not fit on chip: they take two passes over X (a warp per
// row for the margins, then partial column sums of kWideRows rows), then
// the same sum of partials.
// Not yet: the margins' reduction overlapped with the next stripe's products
// (a producer warp, as in sweep_epoch.cu); the sum of partials inside the main
// launch.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;  // the one-pass kernel's block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;      // weight rows per pass over X
constexpr int kBlocks = 132;   // at most: one per SM of an H100 SXM
constexpr int kMaxStages = 4;
constexpr int kMaxVpt = 16;    // columns per thread
constexpr long long kMaxWidth = (long long)kMaxVpt * kThreads;
constexpr long long kSmemLimit = 232448;  // dynamic shared memory of one block on sm_90
// shared memory ahead of the weight rows: S mbarriers (128 bytes), the warp
// sums [kChunk][kWarps][R <= 8] and s [kChunk][R]
constexpr long long kFixedBytes = 128 + 4 * kChunk * kWarps * 8 + 4 * kChunk * 8;
// the sum of partials: a block of 32 columns x 16 lanes over the blocks
constexpr int kSumCols = 32, kSumLanes = 16;
// the two passes, for rows wider than kMaxWidth
constexpr int kWideRows = 128;
constexpr int kWideThreads = 256;

__host__ __device__ constexpr int rows_per_stripe(int vpt) { return 16 / vpt < 8 ? 16 / vpt : 8; }

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

// The one-pass kernel's layout, from n and p alone.
struct Plan {
  int vpt, rows;           // columns per thread, sample rows per stripe
  int blocks, block_rows;  // blocks, sample rows per block (the last may hold fewer)
  long long w_bytes;       // the chunk of weight rows in shared memory
  long long stage_bytes;   // one stage: a stripe's aligned cover, a multiple of 128
  int stages;
  long long smem;
};

Plan make_plan(long long n, long long p) {
  Plan pl;
  pl.vpt = 1;
  while ((long long)pl.vpt * kThreads < p) pl.vpt *= 2;
  pl.rows = rows_per_stripe(pl.vpt);
  const long long first = (n + pl.rows - 1) / pl.rows;
  const long long b0 = first < kBlocks ? first : kBlocks;
  pl.block_rows = (int)((n + b0 - 1) / b0);
  pl.blocks = (int)((n + pl.block_rows - 1) / pl.block_rows);
  pl.w_bytes = round_up(4 * kChunk * p, 128);
  pl.stage_bytes = round_up(4 * pl.rows * p + 32, 128);
  const long long fit = (kSmemLimit - kFixedBytes - pl.w_bytes) / pl.stage_bytes;
  pl.stages = (int)(fit < kMaxStages ? fit : kMaxStages);
  pl.smem = kFixedBytes + pl.w_bytes + pl.stages * pl.stage_bytes;
  return pl;
}

struct Params {
  const float* X;
  const float* y;
  const float* W;
  float* partial;  // [blocks, C, p]
  int n, p, C, block_rows, stages;
  long long w_bytes, stage_bytes;
};

// Warp sums of N values (N a power of two <= 32) in N - 1 + 5 - log2 N
// shuffles: each step halves the values a lane holds. Afterwards lane l holds
// the sum of value l / (32 / N), and each value's sum is that of the plain
// xor tree (16, 8, 4, 2, 1), whatever N is.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int bit = 16 >> step;
    const int half = N >> (step + 1);
    if (half >= 1) {
      const bool upper = (lane & bit) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, bit);
      }
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], bit);
    }
  }
  return v[0];
}

// The span of stripe q of this block: (16-byte-aligned start, bytes, rows).
struct Span {
  uint64_t start;
  uint32_t bytes;
  int rows, r0;
};

template <int R>
__device__ __forceinline__ Span stripe_span(const Params& a, int q) {
  const int r_begin = blockIdx.x * a.block_rows;
  const int r_end = min(a.n, r_begin + a.block_rows);
  Span sp;
  sp.r0 = r_begin + q * R;
  sp.rows = min(R, r_end - sp.r0);
  const uint64_t first = reinterpret_cast<uint64_t>(a.X + (size_t)sp.r0 * a.p);
  sp.start = first & ~15ull;
  sp.bytes = (uint32_t)(((first + 4ull * sp.rows * a.p + 15ull) & ~15ull) - sp.start);
  return sp;
}

// One pass over the block's stripes for weight rows c0 .. c0 + KC - 1;
// `it` counts the stripes consumed, across passes.
template <int VPT, int KC>
__device__ __forceinline__ void one_pass(const Params& a, unsigned char* smem, int c0, int stripes,
                                         int total, int& it) {
  constexpr int R = rows_per_stripe(VPT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, p = a.p;
  const uint32_t bar0 = smem_addr(smem);
  float* red = reinterpret_cast<float*>(smem + 128);  // [KC][kWarps][R]
  float* sv = red + kChunk * kWarps * 8;               // [KC][R]
  float* wch = reinterpret_cast<float*>(smem + kFixedBytes);
  unsigned char* stage0 = smem + kFixedBytes + a.w_bytes;

  for (int i = tid; i < KC * p; i += kThreads) wch[i] = a.W[(size_t)c0 * p + i];
  __syncthreads();
  float acc[KC][VPT];
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int k = 0; k < VPT; ++k) acc[c][k] = 0.0f;

  for (int q = 0; q < stripes; ++q, ++it) {
    const int s = it % a.stages;
    const Span sp = stripe_span<R>(a, q);
    mbar_wait(bar0 + 8 * s, (uint32_t)((it / a.stages) & 1));
    const float* xs = reinterpret_cast<const float*>(stage0 + (size_t)s * a.stage_bytes) +
                      ((reinterpret_cast<uint64_t>(a.X + (size_t)sp.r0 * p) - sp.start) >> 2);

    // margins: this thread's columns, then the warp, then the warps in order
    float part[KC][R];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) part[c][r] = 0.0f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = tid + k * kThreads;
      if (j < p) {
        float wv[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) wv[c] = wch[c * p + j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < sp.rows) {
            const float x = xs[r * p + j];
#pragma unroll
            for (int c = 0; c < KC; ++c) part[c][r] = fmaf(x, wv[c], part[c][r]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const float v = reduce_scatter<R>(part[c], lane);
      if ((lane & (32 / R - 1)) == 0) red[(c * kWarps + warp) * R + lane / (32 / R)] = v;
    }
    __syncthreads();
    if (tid < KC * R) {
      const int c = tid / R, r = tid % R;
      float z = 0.0f;
      for (int w = 0; w < kWarps; ++w) z += red[(c * kWarps + w) * R + r];
      float sres = 0.0f;
      if (r < sp.rows) {
        const float yr = __ldg(a.y + sp.r0 + r);
        const float sig = 1.0f / (1.0f + expf(yr * z));  // sigmoid(-y z)
        sres = (-yr * sig) / (float)a.n;
      }
      sv[c * R + r] = sres;
    }
    __syncthreads();

    // gradient: the same stripe, this thread's columns, in registers
    float sr[KC][R];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) sr[c][r] = sv[c * R + r];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = tid + k * kThreads;
      if (j < p) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < sp.rows) {
            const float x = xs[r * p + j];
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c][k] = fmaf(sr[c][r], x, acc[c][k]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the stage, the warp sums and s
    if (tid == 0 && it + a.stages < total) {
      const int next = it + a.stages;
      const Span nx = stripe_span<R>(a, next % stripes);
      mbar_expect_tx(bar0 + 8 * s, nx.bytes);
      bulk_copy(smem_addr(stage0 + (size_t)s * a.stage_bytes), nx.start, nx.bytes, bar0 + 8 * s);
    }
  }
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = tid + k * kThreads;
      if (j < p) a.partial[((size_t)blockIdx.x * a.C + c0 + c) * p + j] = acc[c][k];
    }
}

template <int VPT>
__global__ void __launch_bounds__(kThreads, 1) one_pass_kernel(Params a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = rows_per_stripe(VPT);
  const int r_begin = blockIdx.x * a.block_rows;
  const int stripes = (min(a.n, r_begin + a.block_rows) - r_begin + R - 1) / R;
  const int total = stripes * ((a.C + kChunk - 1) / kChunk);
  unsigned char* stage0 = smem + kFixedBytes + a.w_bytes;
  const uint32_t bar0 = smem_addr(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < a.stages && it < total; ++it) {
      const Span sp = stripe_span<R>(a, it % stripes);
      mbar_expect_tx(bar0 + 8 * it, sp.bytes);
      bulk_copy(smem_addr(stage0 + (size_t)it * a.stage_bytes), sp.start, sp.bytes, bar0 + 8 * it);
    }
  }
  __syncthreads();
  int it = 0;
  for (int c0 = 0; c0 < a.C; c0 += kChunk) {
    switch (min(kChunk, a.C - c0)) {
      case 1: one_pass<VPT, 1>(a, smem, c0, stripes, total, it); break;
      case 2: one_pass<VPT, 2>(a, smem, c0, stripes, total, it); break;
      case 3: one_pass<VPT, 3>(a, smem, c0, stripes, total, it); break;
      default: one_pass<VPT, 4>(a, smem, c0, stripes, total, it); break;
    }
    __syncthreads();  // the next chunk overwrites the weight rows
  }
}

// G[c, j] = sum over blocks b of partial[b, c, j] (lanes of 16 blocks in
// order, then the 16 lanes in order) + the penalty's gradient at W[c, j]: l2 * W[c, j]
// (reg 0), or the clipped penalty's (reg 1) with lam and alpha
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ W, float* __restrict__ G,
                                    int blocks, int p, int C, int reg, float lam,
                                    float alpha) {
  __shared__ float lanes[kSumLanes][kSumCols + 1];
  const int jl = threadIdx.x % kSumCols, bl = threadIdx.x / kSumCols;
  const int c = blockIdx.y, j = blockIdx.x * kSumCols + jl;
  const size_t cp = (size_t)C * p, at = (size_t)c * p + j;
  float acc = 0.0f;
  if (j < p) {
    for (int b = bl; b < blocks; b += kSumLanes) acc += partial[(size_t)b * cp + at];
  }
  lanes[bl][jl] = acc;
  __syncthreads();
  if (bl == 0 && j < p) {
    float sum = 0.0f;
    for (int q = 0; q < kSumLanes; ++q) sum += lanes[q][jl];
    const float w = W[at];
    if (reg == 0) {
      G[at] = sum + lam * w;
    } else {
      const float coef = __fmul_rn(__fmul_rn(2.0f, lam), alpha);
      const float den = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(alpha, w), w));
      G[at] = __fadd_rn(sum, __fdiv_rn(__fmul_rn(coef, w), __fmul_rn(den, den)));
    }
  }
}

// ---- rows wider than kMaxWidth: two passes over X -----------------------------

__global__ void wide_margins_kernel(const float* __restrict__ X, const float* __restrict__ y,
                                    const float* __restrict__ W, float* __restrict__ s,
                                    int n, int p, int C) {
  const int row = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = X + (size_t)row * p;
  const float yr = y[row];
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) acc[q] = 0.0f;
    for (int j = lane; j < p; j += 32) {
      const float x = xr[j];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (c0 + q < C) acc[q] = fmaf(x, W[(size_t)(c0 + q) * p + j], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[q] += __shfl_xor_sync(kFull, acc[q], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (c0 + q < C) {
          const float sig = 1.0f / (1.0f + expf(yr * acc[q]));  // sigmoid(-y z)
          s[(size_t)(c0 + q) * n + row] = (-yr * sig) / (float)n;
        }
      }
    }
  }
}

__global__ void wide_partial_kernel(const float* __restrict__ X, const float* __restrict__ s,
                                    float* __restrict__ partial, int n, int p, int C) {
  __shared__ float ss[kChunk][kWideRows];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int block = blockIdx.y;
  const int r0 = block * kWideRows;
  const int r1 = min(n, r0 + kWideRows);
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();
    for (int t = threadIdx.x; t < kChunk * kWideRows; t += blockDim.x) {
      const int q = t / kWideRows;
      const int r = r0 + t % kWideRows;
      ss[q][t % kWideRows] = (c0 + q < C && r < n) ? s[(size_t)(c0 + q) * n + r] : 0.0f;
    }
    __syncthreads();
    if (j < p) {
      float acc[kChunk];
#pragma unroll
      for (int q = 0; q < kChunk; ++q) acc[q] = 0.0f;
      for (int r = r0; r < r1; ++r) {
        const float x = X[(size_t)r * p + j];
#pragma unroll
        for (int q = 0; q < kChunk; ++q) acc[q] = fmaf(ss[q][r - r0], x, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (c0 + q < C) partial[((size_t)block * C + c0 + q) * p + j] = acc[q];
      }
    }
  }
}

long long wide_blocks(long long n) { return (n + kWideRows - 1) / kWideRows; }

using Kernel = void (*)(Params);

Kernel one_pass_for(int vpt) {
  switch (vpt) {
    case 1: return one_pass_kernel<1>;
    case 2: return one_pass_kernel<2>;
    case 4: return one_pass_kernel<4>;
    case 8: return one_pass_kernel<8>;
    default: return one_pass_kernel<16>;
  }
}

}  // namespace

// Float32 scratch the caller allocates for one call: the blocks' partials
// [blocks, C, p] (rows wider than kMaxWidth: s [C, n] first).
extern "C" long long logreg_grad_scratch_floats(long long n, long long p, long long C) {
  if (p > kMaxWidth) return C * n + wide_blocks(n) * C * p;
  return make_plan(n, p).blocks * C * p;
}

// X [n, p], y [n], W [C, p], G [C, p]: contiguous float32 on one device. reg 0: the L2
// penalty with weight lam (alpha unused); reg 1: the clipped penalty with lam and alpha.
// Returns the first CUDA error code of the launches (0 = success).
extern "C" int logreg_grad_launch(const float* X, const float* y, const float* W,
                                  float* scratch, float* G, long long n, long long p,
                                  long long C, int reg, float lam, float alpha, void* stream) {
  if (n <= 0 || p <= 0 || C <= 0 || n > 2147483647LL || p > 2147483647LL ||
      C > 65535 || reg < 0 || reg > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = scratch;
  int blocks;
  int err;
  if (p > kMaxWidth) {
    float* s = scratch;
    partial = scratch + C * n;
    blocks = (int)wide_blocks(n);
    const int warps_per_block = kWideThreads / 32;
    wide_margins_kernel<<<(unsigned)((n + warps_per_block - 1) / warps_per_block), kWideThreads,
                          0, st>>>(X, y, W, s, (int)n, (int)p, (int)C);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    dim3 grid((unsigned)((p + kWideThreads - 1) / kWideThreads), (unsigned)blocks);
    wide_partial_kernel<<<grid, kWideThreads, 0, st>>>(X, s, partial, (int)n, (int)p, (int)C);
  } else {
    const Plan pl = make_plan(n, p);
    blocks = pl.blocks;
    const Kernel kern = one_pass_for(pl.vpt);
    err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)pl.smem);
    if (err != 0) {
      cudaGetLastError();  // a refused attribute must not fail the next launch as well
      return err;
    }
    Params a{X, y, W, partial, (int)n, (int)p, (int)C, pl.block_rows, pl.stages, pl.w_bytes,
             pl.stage_bytes};
    kern<<<(unsigned)blocks, kThreads, (size_t)pl.smem, st>>>(a);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 grid((unsigned)((p + kSumCols - 1) / kSumCols), (unsigned)C);
  sum_partials_kernel<<<grid, kSumCols * kSumLanes, 0, st>>>(partial, W, G, blocks, (int)p,
                                                             (int)C, reg, lam, alpha);
  return (int)cudaGetLastError();
}
