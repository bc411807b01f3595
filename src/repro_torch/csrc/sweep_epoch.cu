// One epoch's inner loop of a sweep group, every row in one launch, for Hopper (sm_90a).
//
// Replaces the TPU megakernel src/repro/kernels/sweep_epoch/kernel.py (`sweep_epoch_call`,
// body `kernel`), which put the group's rows on the Pallas grid and ran each row's whole
// multi-epoch scan (`_asysvrg_epochs_core` / `_hogwild_epochs_core`) in VMEM. Here one launch
// runs the M-tilde = `total` inner updates of one epoch for every row: `_epoch_core`
// (src/repro/core/asysvrg.py) or `_hogwild_epoch_core` (src/repro/core/hogwild.py), then the
// loss at every row's new iterate, the epoch's entry of the loss history. The snapshot gradient
// mu stays outside, between epochs (the logreg_grad kernel, which reads X once for all rows):
// summing mu across rows' blocks would need a grid-wide barrier. The loss of the starting
// iterate, once per run, is computed by the caller.
//
// Per row and step m, exactly as the JAX engine draws and computes it:
//   k_idx, k_delay, k_scan = split(key, 3)
//   i_m = randint(k_idx)[m]; d_m from uniform(k_delay)[m]; a = max(m - d_m, 0)
//   k_read, k_drop = split(split(k_scan, total)[m])
//   u_read[j] = ring[slot_j][j], slot_j from the row's reader (consistent / inconsistent /
//               unlock) with the row's own tau: slot = age mod (tau + 1)
//   g = grad f_i(u_read); AsySVRG: v = (g - g0) + mu with g0 = grad f_i(u0); Hogwild!: v = g
//   grad f_i(w) = -y_i sigmoid(-y_i x_i . w) x_i + R'(w), R' the penalty's gradient
//   (kernels/regularizer.py): L2, l2 * w; clipped (NonconvexLogistic), (c w) / (den den) with
//   c = (2 lam) alpha, den = 1 + (alpha w) w
//   unlock rows with drop_prob > 0: g, g0 and mu masked by bernoulli(k_drop, 1 - drop_prob)
//   u_{m+1} = u_m - step * v, written to ring slot (m + 1) mod (tau + 1); acc += u_{m+1}
// and the row's result w' is u_total (option 1, Hogwild!) or acc / total (option 2), and its
// loss f(w') = (1/n) sum_r log(1 + exp(-y_r x_r . w')) + R(w'), R = (l2 / 2) ||w'||^2 or
// lam sum_j aw2_j / (1 + aw2_j) with aw2 = (alpha w') w'.
// Randomness is threefry2x32 in JAX's partitionable mode, bit-equal to
// src/repro_torch/prng.py, so a seed draws the same samples here, in the batched engine and
// in the JAX package; the draws and the readers' slots are csrc/jax_prng.cuh's, shared with
// the MLP objective's epoch kernel (csrc/sweep_epoch_mlp.cu). This kernel computes the
// logistic sample gradient only.
//
// Bound on this card: operations, for one launch. Each input read once (X, y, every row's w
// and mu) and each output written once: at rcv1 (n = 20242, d = 2048) with 4 rows ~166 MB,
// ~0.05 ms at 3.35 TB/s; ~15 d float32 operations per row and update plus ~2 n d per row for
// the loss, ~5.3 GFLOP, ~0.08 ms at 67 TFLOP/s; the clipped penalty adds ~5 d per gradient,
// two gradients per AsySVRG update, and no bytes. The kernel sits far above both: it is a chain
// of `total` dependent updates per row, each ending in two block-wide float64 dot products
// and a barrier, on C of the 132 SMs. What the design takes off that chain is everything that
// does not depend on the previous update.
//
// Design: a warp-specialised pipeline, one CTA per row.
//   * Consumers: T threads, fixed by d alone (a multiple of 32, at most 512). Thread t owns
//     coordinates j = t, t + T, ...: u, the ring, u0, mu, acc and the read iterate of those
//     coordinates are touched by that thread only, so only the dot products synchronise, on a
//     named barrier of the T consumers (bar.sync 1, T), once per step (double-buffered scratch).
//   * Producer: one more warp, which never joins that barrier. It draws step m's scalars
//     lane-parallel (lanes hash the two index words, the delay and the step key at once, then
//     the step key's two children, and share them by shuffles) up to S - 1 steps before the
//     consumers reach step m, and writes them into entry m mod S of a queue in shared memory:
//     the sample index i_m, y[i_m], the read slots age mod (tau + 1) and, for the inconsistent
//     reader, min(age + 1, m) mod (tau + 1), the unlock reader's range m - age + 1, and the
//     step's read and drop keys. Each entry has a full and an empty mbarrier: the consumers
//     wait on full, and consumer 0 arrives on empty once every consumer is past the step's
//     second pass (at the next step's barrier). No threefry of the step draws, no integer
//     division and no `% (tau + 1)` per coordinate is left on the chain: the unlock reader's
//     slot is age mod (tau + 1) plus an offset of at most tau, wrapped by one subtraction.
//     Each thread still hashes its own coordinates' read and drop draws.
//   * Staged placements: the producer also copies x_{i_m} into stage m mod S in shared memory,
//     a 1-D bulk copy (cp.async.bulk ... mbarrier::complete_tx::bytes) that completes on the
//     entry's full barrier, so the random row's device-memory latency is paid off the chain and
//     both passes read x from shared memory. A bulk copy needs 16-byte-aligned addresses and a
//     size in 16-byte units, and rows of X are 16-byte aligned only when d % 4 == 0: the copy
//     takes the aligned span that covers the row, and the consumers read the row at its offset
//     (0-3 floats) in the span. The span reaches at most 12 bytes past either end of the row,
//     inside the 16-byte granules that hold the row's first and last bytes, so it never leaves
//     mapped memory; those bytes are never read.
//   * The L2 placement, where not even the stages fit beside the state with the ring in device
//     memory: the producer prefetches the same span into L2 (cp.async.bulk.prefetch.L2)
//     instead, and the consumers read x from device memory.
//   * The ring of buf_len iterates (u_m is slot m mod (tau + 1)) lives in shared memory, or
//     in a [C, buf_len, d] device buffer that the wrapper passes when it does not fit. The
//     wrapper picks one of three placements by size (kernels/sweep_epoch/ops.py) and passes
//     the bytes; the launch fails with cudaErrorInvalidValue where they disagree with this
//     layout of the dynamic shared memory:
//       reduction scratch (512) | S full and S empty mbarriers, S queue entries (64 S) |
//       S stages (16 ceil(d / 4) + 16 each; staged only) | u0, mu, acc (AsySVRG only) and the
//       read iterate (4 d each) | the ring (4 d buf_len; ring in shared memory only)
//   * A mbarrier wait that outlasts 2^24 tries traps, so a broken pipeline fails its launch
//     instead of hanging the card.
//   * x_i . u_read and x_i . u0: float32 products summed in float64, per thread over its
//     coordinates in order, then a fixed xor-shuffle tree, then the warps in order. The
//     sigmoid is float64, rounded once to float32, as objective.sample_grad_stable does. The
//     order depends on d alone, so a row's result never depends on its group (bit-equal alone
//     and in a group, by construction), nor on the placement.
//   * Elementwise float32 math with explicit round-to-nearest intrinsics, no fused
//     multiply-add, in the order of the plain version (kernels/sweep_epoch/ref.py), for the
//     penalty too: its kind is a launch argument, one branch uniform over the block.
//   * The loss, in two more kernels of the same launch call, over every SM: one SM streams X
//     at only ~27 GB/s (6 ms at rcv1), so the row's own block does not take it. A warp per
//     sample writes log(1 + exp(-y_r x_r . w'_c)) for every row c (float32 products, float64
//     sums, a shuffle tree) into a [C, n] float64 buffer; a block per row adds its n terms and
//     ||w'||^2 in a fixed order and rounds once, as objective.loss_fixed_order does. The order
//     is set by n and d alone, so the loss too is bit-equal alone and in a group.
// Not yet: a cluster per row, the per-coordinate read and drop hashes off the chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "jax_prng.cuh"

namespace {

constexpr int kMaxThreads = 512;  // consumers; the producer warp comes on top
constexpr int kMaxWarps = kMaxThreads / 32;
// Queue depth S: steps drawn, and rows staged, ahead of the consumers. S = 2, 3 and 4 ran within 1%
// on 1 to 4 rows of an H100; S = 2 lets two rcv1 blocks share an SM (PERF.md, K3). To measure
// another depth, change it here and run `tools/profile_port.py sweep_epoch`.
constexpr int kStages = 2;
constexpr long long kScratchBytes = 2LL * 2 * kMaxWarps * sizeof(double);
constexpr long long kStepBytes = 64;  // per stage: two mbarriers and one queue entry
constexpr int kLossThreads = 256;     // the loss kernels' block size, part of their sum order

// One step as the producer hands it to the consumers.
struct Entry {
  int idx;     // sample index i_m
  float yi;    // y[i_m]
  int slot;    // age mod (tau + 1)
  int slot_b;  // min(age + 1, m) mod (tau + 1)
  float span;  // m - age + 1
  int off;     // the row's offset in its stage, in floats
  Key read;    // per-coordinate reader draws
  Key drop;    // per-coordinate drop draws
};
static_assert(sizeof(Entry) + 2 * sizeof(uint64_t) <= kStepBytes, "queue entry too large");

// Slot of coordinate j in the ring for the row's reader (jax_prng.cuh `reader_slot`).
__device__ __forceinline__ int read_slot(int scheme, const Entry& e, int slots, int j) {
  return reader_slot(scheme, e.slot, e.slot_b, e.span, e.read, slots, j);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// log(1 + e^v) in float64, as torch.logaddexp(0, v) computes it
__device__ __forceinline__ double log1pexp(double v) { return fmax(v, 0.0) + log1p(exp(-fabs(v))); }

// -y * sigmoid(-y z), the sigmoid in float64 rounded once to float32
__device__ __forceinline__ float residual(float yi, double z) {
  const double t = (double)(-yi) * z;
  const float s = (float)(1.0 / (1.0 + exp(-t)));
  return __fmul_rn(-yi, s);
}

// the consumers' barrier: named barrier 1 over the first `threads` threads
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__host__ __device__ __forceinline__ long long stage_bytes(long long d) {
  return (4 * d + 15) / 16 * 16 + 16;
}

struct Params {
  const float* X;
  const float* y;
  const float* w;
  const float* mu;
  const long long* keys;
  const float* step;
  const int* row_ints;  // [3, C]: tau, scheme id, delay id
  float* ring;          // [C, buf_len, d] in device memory, or null: the ring in shared memory
  float* out;
  int d, C, total, buf_len, option, drop;
  uint32_t span, mult;
  int reg;           // 0: L2 with weight lam; 1: clipped with lam and alpha
  float lam, alpha;  // the penalty's float32 constants
  float coef;        // (2 lam) alpha, the clipped gradient's constant
  float keep_p;
};

// The penalty's gradient at w, as kernels/regularizer.py's `grad` computes it.
__device__ __forceinline__ float penalty_grad(const Params& p, float w) {
  if (p.reg == 0) return __fmul_rn(p.lam, w);
  const float den = __fadd_rn(1.0f, __fmul_rn(__fmul_rn(p.alpha, w), w));
  return __fdiv_rn(__fmul_rn(p.coef, w), __fmul_rn(den, den));
}

// The producer warp: steps 0 .. total - 1 into the queue, and with kStaged their rows of X into
// the stages.
template <bool kStaged>
__device__ __forceinline__ void produce(const Params& p, Entry* queue, float* stages,
                                        uint32_t full0, uint32_t empty0, int tau, int delay_id,
                                        int lane) {
  const int c = blockIdx.x, d = p.d, slots = tau + 1;
  const long long stride = stage_bytes(d) / 4;
  const RowKeys rk = row_keys({(uint32_t)p.keys[2 * c], (uint32_t)p.keys[2 * c + 1]});
  for (int m = 0, s = 0, round = 0; m < p.total; ++m) {
    const Step st = draw_step(rk, m, p.span, p.mult, tau, delay_id, lane);
    if (lane == 0) {
      const float yi = __ldg(p.y + st.idx);
      const uint64_t row = reinterpret_cast<uint64_t>(p.X + (size_t)st.idx * d);
      const uint64_t start = row & ~15ull;
      const uint32_t bytes = (uint32_t)(((row + 4ull * d + 15ull) & ~15ull) - start);
      mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);  // round 0 passes: the stage starts empty
      Entry& e = queue[s];
      e.idx = st.idx;
      e.yi = yi;
      e.slot = st.age % slots;
      e.slot_b = min(st.age + 1, m) % slots;
      e.span = (float)(m - st.age + 1);
      e.off = (int)(row - start) >> 2;
      e.read = st.read;
      e.drop = st.drop;
      if (kStaged) {
        mbar_expect_tx(full0 + 8 * s, bytes);
        bulk_copy(smem_addr(stages + s * stride), start, bytes, full0 + 8 * s);
      } else {
        prefetch_l2(start, bytes);
        mbar_arrive(full0 + 8 * s);
      }
    }
    __syncwarp();
    if (++s == kStages) {
      s = 0;
      ++round;
    }
  }
}

template <bool kSvrg, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads + 32) sweep_epoch_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  const int T = blockDim.x - 32;  // consumers; the last warp is the producer
  double* scratch = reinterpret_cast<double*>(smem);  // [2 steps][2 sums][kMaxWarps]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kScratchBytes);  // full[S], empty[S]
  Entry* queue = reinterpret_cast<Entry*>(bars + 2 * kStages);
  float* stages = reinterpret_cast<float*>(smem + kScratchBytes + kStages * kStepBytes);
  const long long stride = kStaged ? stage_bytes(d) / 4 : 0;
  float* u0 = stages + kStages * stride;  // u0, mu and acc: AsySVRG only
  float* mu = u0 + d;
  float* acc = mu + d;
  float* ur = kSvrg ? acc + d : u0;  // the read iterate
  const int c = blockIdx.x;
  float* ring = p.ring ? p.ring + (size_t)c * p.buf_len * d : ur + d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = T >> 5;
  const int tau = p.row_ints[c], scheme = p.row_ints[p.C + c], delay_id = p.row_ints[2 * p.C + c];
  const int slots = tau + 1;
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);

  if (tid == T) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < T) {
    for (int j = tid; j < d; j += T) {
      const float wj = p.w[(size_t)c * d + j];
      for (int s = 0; s < slots; ++s) ring[(size_t)s * d + j] = wj;
      if (kSvrg) {
        u0[j] = wj;
        mu[j] = p.mu[(size_t)c * d + j];
        acc[j] = 0.0f;
      }
    }
  }
  __syncthreads();  // the last barrier of the whole block: the producer leaves after its loop
  if (tid >= T) {
    produce<kStaged>(p, queue, stages, full0, empty0, tau, delay_id, lane);
    return;
  }

  const bool masked = p.drop && scheme == 2;
  const float step = p.step[c];
  int cur = 0;  // m mod (tau + 1): the ring slot of u_m
  for (int m = 0, s = 0, round = 0; m < p.total; ++m) {
    mbar_wait(full0 + 8 * s, round & 1);
    const Entry e = queue[s];
    const float* x = kStaged ? stages + s * stride + e.off : p.X + (size_t)e.idx * d;
    double part = 0.0, part0 = 0.0;
    for (int j = tid; j < d; j += T) {
      const float xj = kStaged ? x[j] : __ldg(x + j);
      const float r = ring[(size_t)read_slot(scheme, e, slots, j) * d + j];
      ur[j] = r;
      part += (double)__fmul_rn(xj, r);
      if (kSvrg) part0 += (double)__fmul_rn(xj, u0[j]);
    }
    double* sc = scratch + (m & 1) * 2 * kMaxWarps;
    part = warp_sum(part);
    if (kSvrg) part0 = warp_sum(part0);
    if (lane == 0) {
      sc[warp] = part;
      sc[kMaxWarps + warp] = part0;
    }
    consumer_sync(T);
    // every consumer is past step m - 1's second pass: its entry and stage may be refilled
    if (tid == 0 && m > 0) mbar_arrive(empty0 + 8 * (s == 0 ? kStages - 1 : s - 1));
    double z = 0.0, z0 = 0.0;
    for (int q = 0; q < warps; ++q) {
      z += sc[q];
      if (kSvrg) z0 += sc[kMaxWarps + q];
    }
    const float coef = residual(e.yi, z);
    const float coef0 = kSvrg ? residual(e.yi, z0) : 0.0f;
    const int next = cur + 1 == slots ? 0 : cur + 1;
    for (int j = tid; j < d; j += T) {
      const float xj = kStaged ? x[j] : __ldg(x + j);
      const float u = ring[(size_t)cur * d + j];
      float g = __fadd_rn(__fmul_rn(coef, xj), penalty_grad(p, ur[j]));
      const float keep = masked && !(uniform_at(e.drop, (uint32_t)j) < p.keep_p) ? 0.0f : 1.0f;
      float un;
      if (kSvrg) {
        float g0 = __fadd_rn(__fmul_rn(coef0, xj), penalty_grad(p, u0[j]));
        float gf = mu[j];
        if (masked) {
          g = __fmul_rn(g, keep);
          g0 = __fmul_rn(g0, keep);
          gf = __fmul_rn(gf, keep);
        }
        un = __fsub_rn(u, __fmul_rn(step, __fadd_rn(__fsub_rn(g, g0), gf)));
        acc[j] = __fadd_rn(acc[j], un);
      } else {
        if (masked) g = __fmul_rn(g, keep);
        un = __fsub_rn(u, __fmul_rn(step, g));
      }
      ring[(size_t)next * d + j] = un;
    }
    cur = next;
    if (++s == kStages) {
      s = 0;
      ++round;
    }
  }

  for (int j = tid; j < d; j += T) {  // cur = total mod (tau + 1)
    p.out[(size_t)c * d + j] = kSvrg && p.option == 2 ? __fdiv_rn(acc[j], (float)p.total)
                                                      : ring[(size_t)cur * d + j];
  }
}

// Loss, pass 1: one warp per sample row r writes t[c, r] = log(1 + exp(-y_r x_r . W[c])) for
// every row c, the margin as float32 products summed in float64 in lane order, then a fixed
// shuffle tree.
__global__ void __launch_bounds__(kLossThreads)
    loss_terms_kernel(const float* __restrict__ X, const float* __restrict__ y,
                      const float* __restrict__ W, double* __restrict__ t, int n, int d, int C) {
  const int r = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const float* xr = X + (size_t)r * d;
  const double yr = (double)y[r];
  for (int c = 0; c < C; ++c) {
    const float* wc = W + (size_t)c * d;
    double z = 0.0;
    for (int j = lane; j < d; j += 32) z += (double)__fmul_rn(__ldg(xr + j), __ldg(wc + j));
    z = warp_sum(z);
    if (lane == 0) t[(size_t)c * n + r] = log1pexp(-(yr * z));
  }
}

// Loss, pass 2: one block per row sums its n terms and the penalty's terms (w^2 for L2,
// aw2 / (1 + aw2) for the clipped penalty) in float64 (threads in stride order, then warps
// in order) and rounds once, as objective.loss_fixed_order does.
__global__ void __launch_bounds__(kLossThreads)
    loss_sum_kernel(const double* __restrict__ t, const float* __restrict__ W,
                    float* __restrict__ loss, int n, int d, int reg, float lam, float alpha) {
  __shared__ double part[2][kLossThreads / 32];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double s = 0.0, q = 0.0;
  for (int r = tid; r < n; r += kLossThreads) s += t[(size_t)c * n + r];
  for (int j = tid; j < d; j += kLossThreads) {
    const float wj = W[(size_t)c * d + j];
    if (reg == 0) {
      q += (double)__fmul_rn(wj, wj);
    } else {
      const float aw2 = __fmul_rn(__fmul_rn(alpha, wj), wj);
      q += (double)__fdiv_rn(aw2, __fadd_rn(1.0f, aw2));
    }
  }
  s = warp_sum(s);
  q = warp_sum(q);
  if (lane == 0) {
    part[0][warp] = s;
    part[1][warp] = q;
  }
  __syncthreads();
  if (tid == 0) {
    double sum = 0.0, sumsq = 0.0;
    for (int k = 0; k < kLossThreads / 32; ++k) {
      sum += part[0][k];
      sumsq += part[1][k];
    }
    const float scale = reg == 0 ? 0.5f * lam : lam;
    loss[c] = __fadd_rn((float)(sum / (double)n), __fmul_rn(scale, (float)sumsq));
  }
}

// The draws of one key's first `steps` steps, for the tests: sample index, read age, and the
// per-coordinate reader and drop uniforms.
__global__ void sweep_epoch_draws_kernel(const long long* key, uint32_t span, uint32_t mult,
                                         int tau, int delay_id, int steps, int d, int* idx,
                                         int* age, float* read_u, float* drop_u) {
  const int lane = threadIdx.x & 31;
  const RowKeys rk = row_keys({(uint32_t)key[0], (uint32_t)key[1]});
  for (int m = 0; m < steps; ++m) {
    const Step st = draw_step(rk, m, span, mult, tau, delay_id, lane);
    if (threadIdx.x == 0) {
      idx[m] = st.idx;
      age[m] = st.age;
    }
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      read_u[(size_t)m * d + j] = uniform_at(st.read, (uint32_t)j);
      drop_u[(size_t)m * d + j] = uniform_at(st.drop, (uint32_t)j);
    }
  }
}

int threads_for(long long d) {
  long long t = (d + 31) / 32 * 32;
  return (int)(t < kMaxThreads ? t : kMaxThreads);
}

// Dynamic shared memory of one block: the layout in the design notes above.
long long layout_bytes(long long d, long long buf_len, bool svrg, bool ring_shared, bool staged) {
  const long long vectors = (svrg ? 4 : 1) + (ring_shared ? buf_len : 0);
  return kScratchBytes + kStages * (kStepBytes + (staged ? stage_bytes(d) : 0)) + vectors * d * 4;
}

template <bool kSvrg, bool kStaged>
int launch_rows(const Params& p, long long bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(sweep_epoch_kernel<kSvrg, kStaged>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size is reported here, not to the next caller
    return (int)err;
  }
  sweep_epoch_kernel<kSvrg, kStaged><<<(unsigned)p.C, threads_for(p.d) + 32, (size_t)bytes, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The most dynamic shared memory a block may opt in to on `device` (232,448 on an H100).
extern "C" long long sweep_epoch_max_shared_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != 0) {
    return -1;
  }
  return bytes;
}

// X [n, d], y [n], w [C, d], mu [C, d] (ignored by Hogwild!, may be null), keys [C, 2] int64
// holding uint32 words, step [C] float32, row_ints [3, C] int32 (tau, scheme, delay id),
// ring [C, buf_len, d] or null, out [C, d], terms [C, n] float64 scratch, loss [C]:
// contiguous, on one device. engine: 0 = AsySVRG, 1 = Hogwild!; staged: 1 = rows of X through
// shared-memory stages, 0 = through L2 prefetches; smem_bytes: the caller's size of the dynamic
// shared memory, which must equal this file's layout; reg 0: the L2 penalty with weight lam
// (alpha unused), reg 1: the clipped penalty with lam and alpha. Returns the first CUDA error
// code of the three launches (0 = success).
extern "C" int sweep_epoch_launch(const float* X, const float* y, const float* w, const float* mu,
                                  const long long* keys, const float* step, const int* row_ints,
                                  float* ring, float* out, double* terms, float* loss, long long n,
                                  long long d, long long C, long long total, long long buf_len,
                                  int engine, int option, int drop, int staged,
                                  long long smem_bytes, int reg, float lam, float alpha,
                                  float keep_p, void* stream) {
  if (n <= 0 || d <= 0 || C <= 0 || total <= 0 || buf_len <= 0 || engine < 0 || engine > 1 ||
      reg < 0 || reg > 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes =
      layout_bytes(d, buf_len, engine == 0, ring == nullptr, staged != 0);
  if (bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  const float coef = 2.0f * lam * alpha;  // float32 steps, as regularizer.clip_coef
  Params p{X, y, w, mu, keys, step, row_ints, ring, out, (int)d, (int)C, (int)total,
           (int)buf_len, option, drop, (uint32_t)n, fold_multiplier((uint32_t)n), reg, lam,
           alpha, coef, keep_p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = engine == 0 ? (staged ? launch_rows<true, true>(p, bytes, st)
                                  : launch_rows<true, false>(p, bytes, st))
                        : (staged ? launch_rows<false, true>(p, bytes, st)
                                  : launch_rows<false, false>(p, bytes, st));
  if (err != 0) return err;
  const long long warps = kLossThreads / 32;
  loss_terms_kernel<<<(unsigned)((n + warps - 1) / warps), kLossThreads, 0, st>>>(
      X, y, out, terms, (int)n, (int)d, (int)C);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  loss_sum_kernel<<<(unsigned)C, kLossThreads, 0, st>>>(terms, out, loss, (int)n, (int)d, reg, lam,
                                                       alpha);
  return (int)cudaGetLastError();
}

// key [2] int64; idx, age [steps] int32; read_u, drop_u [steps, d] float32.
extern "C" int sweep_epoch_draws(const long long* key, long long n, long long d, int tau,
                                 int delay_id, long long steps, int* idx, int* age, float* read_u,
                                 float* drop_u, void* stream) {
  if (n <= 0 || d <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  sweep_epoch_draws_kernel<<<1, threads_for(d), 0, static_cast<cudaStream_t>(stream)>>>(
      key, (uint32_t)n, fold_multiplier((uint32_t)n), tau, delay_id, (int)steps, (int)d, idx, age,
      read_u, drop_u);
  return (int)cudaGetLastError();
}
