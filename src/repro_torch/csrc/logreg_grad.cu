// Full logistic-regression gradient for Hopper (sm_90a), for C weight rows at once:
//
//     z[c, r] = X[r, :] . W[c, :]
//     s[c, r] = -y[r] * sigmoid(-y[r] * z[c, r]) / n
//     G[c, :] = sum_r s[c, r] * X[r, :] + l2 * W[c, :]
//
// Replaces the two TPU kernels of src/repro/kernels/logreg_grad/kernel.py:
// `_margin_kernel` (launched by `margins`) and `_grad_kernel` (launched by
// `grad_accum`). In the engine it is the snapshot gradient mu = grad f(w) of
// every AsySVRG epoch, for all rows of a sweep group in one call.
//
// Bound on this card: bytes. X (n x p float32, 166 MB at the rcv1 width) is
// the only large operand and each element meets 2 flops per weight row per
// pass, so the kernel is far below the flop/byte balance point. The floor is
// one read of X (~50 us at 3.35 TB/s); this design reads X twice, once per
// pass, as the TPU kernel did, so its own floor is ~99 us. Fusing the passes
// is later work.
//
// Design, deterministic by construction (no float atomics; each sum runs in
// an order fixed by n and p alone, never by C, so a row's gradient does not
// depend on which rows share its call):
//   pass 1  one warp per sample row r. Lanes read the row coalesced (lane l
//           takes columns l, l+32, ...), accumulate up to 4 weight rows at a
//           time, and combine with a fixed xor-shuffle tree; lane 0 applies
//           the sigmoid and writes s[c, r].
//   pass 2  one thread per column j and block of kRows sample rows; s for the
//           block is staged in shared memory, rows are read coalesced across
//           threads, and each block writes its partial column sums.
//   pass 3  one thread per (c, j) sums the partials in block order and adds
//           l2 * W[c, j].
// A simple tiled design; wgmma/TMA and a single fused pass are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWeightRows = 4;   // weight rows accumulated per sweep over X
constexpr int kRows = 128;       // sample rows per pass-2 partial
constexpr int kThreads = 256;

__global__ void margins_kernel(const float* __restrict__ X, const float* __restrict__ y,
                               const float* __restrict__ W, float* __restrict__ s,
                               int n, int p, int C) {
  const int row = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* xr = X + (size_t)row * p;
  const float yr = y[row];
  for (int c0 = 0; c0 < C; c0 += kWeightRows) {
    float acc[kWeightRows];
#pragma unroll
    for (int q = 0; q < kWeightRows; ++q) acc[q] = 0.0f;
    for (int j = lane; j < p; j += 32) {
      const float x = xr[j];
#pragma unroll
      for (int q = 0; q < kWeightRows; ++q) {
        if (c0 + q < C) acc[q] = fmaf(x, W[(size_t)(c0 + q) * p + j], acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kWeightRows; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kWeightRows; ++q) {
        if (c0 + q < C) {
          const float sig = 1.0f / (1.0f + expf(yr * acc[q]));   // sigmoid(-y z)
          s[(size_t)(c0 + q) * n + row] = (-yr * sig) / (float)n;
        }
      }
    }
  }
}

__global__ void grad_partial_kernel(const float* __restrict__ X, const float* __restrict__ s,
                                    float* __restrict__ partial, int n, int p, int C) {
  __shared__ float ss[kWeightRows][kRows];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int block = blockIdx.y;
  const int r0 = block * kRows;
  const int r1 = min(n, r0 + kRows);
  for (int c0 = 0; c0 < C; c0 += kWeightRows) {
    __syncthreads();
    for (int t = threadIdx.x; t < kWeightRows * kRows; t += blockDim.x) {
      const int q = t / kRows;
      const int r = r0 + t % kRows;
      ss[q][t % kRows] = (c0 + q < C && r < n) ? s[(size_t)(c0 + q) * n + r] : 0.0f;
    }
    __syncthreads();
    if (j < p) {
      float acc[kWeightRows];
#pragma unroll
      for (int q = 0; q < kWeightRows; ++q) acc[q] = 0.0f;
      for (int r = r0; r < r1; ++r) {
        const float x = X[(size_t)r * p + j];
#pragma unroll
        for (int q = 0; q < kWeightRows; ++q) acc[q] = fmaf(ss[q][r - r0], x, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kWeightRows; ++q) {
        if (c0 + q < C) partial[((size_t)block * C + c0 + q) * p + j] = acc[q];
      }
    }
  }
}

__global__ void grad_reduce_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ W, float* __restrict__ G,
                                   int blocks, int p, int C, float l2) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t cp = (size_t)C * p;
  if (k >= cp) return;
  float acc = 0.0f;
  for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * cp + k];
  G[k] = acc + l2 * W[k];
}

long long partial_blocks(long long n) { return (n + kRows - 1) / kRows; }

}  // namespace

// Float32 scratch the caller allocates for one call: s [C, n] then the
// pass-2 partials [blocks, C, p].
extern "C" long long logreg_grad_scratch_floats(long long n, long long p, long long C) {
  return C * n + partial_blocks(n) * C * p;
}

// X [n, p], y [n], W [C, p], G [C, p]: contiguous float32 on one device.
// Returns the first CUDA error code of the three launches (0 = success).
extern "C" int logreg_grad_launch(const float* X, const float* y, const float* W,
                                  float* scratch, float* G, long long n, long long p,
                                  long long C, float l2, void* stream) {
  if (n <= 0 || p <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = scratch;
  float* partial = scratch + C * n;
  const int blocks = (int)partial_blocks(n);
  const int warps_per_block = kThreads / 32;
  margins_kernel<<<(unsigned)((n + warps_per_block - 1) / warps_per_block), kThreads, 0,
                   st>>>(X, y, W, s, (int)n, (int)p, (int)C);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dim3 grid2((unsigned)((p + kThreads - 1) / kThreads), (unsigned)blocks);
  grad_partial_kernel<<<grid2, kThreads, 0, st>>>(X, s, partial, (int)n, (int)p, (int)C);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long cp = C * p;
  grad_reduce_kernel<<<(unsigned)((cp + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      partial, W, G, blocks, (int)p, (int)C, l2);
  return (int)cudaGetLastError();
}
