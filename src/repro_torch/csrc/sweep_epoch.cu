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
//   unlock rows with drop_prob > 0: g, g0 and mu masked by bernoulli(k_drop, 1 - drop_prob)
//   u_{m+1} = u_m - step * v, written to ring slot (m + 1) mod (tau + 1); acc += u_{m+1}
// and the row's result w' is u_total (option 1, Hogwild!) or acc / total (option 2), and its
// loss f(w') = (1/n) sum_r log(1 + exp(-y_r x_r . w')) + (l2 / 2) ||w'||^2.
// Randomness is threefry2x32 in JAX's partitionable mode, bit-equal to
// src/repro_torch/prng.py, so a seed draws the same samples here, in the batched engine and
// in the JAX package.
//
// Bound on this card: bytes, for one launch. Each input read once (X, y, every row's w and
// mu) and each output written once: at rcv1 (n = 20242, d = 2048) with 4 rows ~166 MB, ~0.05
// ms at 3.35 TB/s; ~12 d float32 operations per row and update, ~4 GFLOP, ~0.06 ms at 67
// TFLOP/s (the loss adds ~2 n d per row). The kernel sits far above both: it is a chain of
// `total` dependent updates per row, each waiting on a random row of X and on two block-wide
// dot products, on C of the 132 SMs.
//
// Design (simple and right first):
//   * One CTA per row, threads fixed by d alone (a multiple of 32, at most 512). Thread t owns
//     coordinates j = t, t + T, ...: u, the ring, u0, mu, acc and the read iterate of those
//     coordinates are touched by that thread only, so only the dot products synchronise.
//   * State in shared memory: u0, mu and acc (AsySVRG only), the read iterate and the ring
//     (buf_len d floats; the current iterate u_m is ring slot m mod (tau + 1)), plus the
//     reduction scratch: (buf_len + 4) d 4 bytes + 512 for AsySVRG, (buf_len + 1) d 4 bytes +
//     512 for Hogwild!. Above the card's per-block limit the wrapper passes a [C, buf_len, d]
//     device buffer and the ring lives there instead.
//   * Step draws lane-parallel: in every warp, lanes hash the step's four independent counters
//     (two index words, the delay, the step key) at once, then the step key's two children,
//     and share them by shuffles; each thread hashes its own coordinates' read and drop draws.
//   * x_i . u_read and x_i . u0: float32 products summed in float64, per thread over its
//     coordinates in order, then a fixed xor-shuffle tree, then the warps in order. The
//     sigmoid is float64, rounded once to float32, as objective.sample_grad_stable does. The
//     order depends on d alone, so a row's result never depends on its group (bit-equal alone
//     and in a group, by construction). One __syncthreads per step (double-buffered scratch).
//   * Elementwise float32 math with explicit round-to-nearest intrinsics, no fused
//     multiply-add, in the order of the plain version (kernels/sweep_epoch/ref.py).
//   * The loss, in two more kernels of the same launch call, over every SM: one SM streams X
//     at only ~27 GB/s (6 ms at rcv1), so the row's own block does not take it. A warp per
//     sample writes log(1 + exp(-y_r x_r . w'_c)) for every row c (float32 products, float64
//     sums, a shuffle tree) into a [C, n] float64 buffer; a block per row adds its n terms and
//     ||w'||^2 in a fixed order and rounds once, as objective.loss_fixed_order does. The order
//     is set by n and d alone, so the loss too is bit-equal alone and in a group.
// Not yet: TMA, wgmma, clusters, prefetch of the next sampled row (indices are known ahead).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kScratchBytes = 2LL * 2 * kMaxWarps * sizeof(double);
constexpr int kLossThreads = 256;  // the loss kernels' block size, part of their sum order

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// threefry2x32 (20 rounds) of the counter words (x0, x1) under key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_MIX(r)   \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
#define TF_ROUNDS_A TF_MIX(13) TF_MIX(15) TF_MIX(26) TF_MIX(6)
#define TF_ROUNDS_B TF_MIX(17) TF_MIX(29) TF_MIX(16) TF_MIX(24)
  x0 += k0;
  x1 += k1;
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_MIX
}

// split(key, n)[i]
__device__ __forceinline__ Key child(Key k, uint32_t i) {
  uint32_t a = 0u, b = i;
  threefry(k.k0, k.k1, a, b);
  return {a, b};
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// uniform(key, shape)[j]: the 32 bits at flat position j, as a float in [0, 1)
__device__ __forceinline__ float uniform_at(Key k, uint32_t j) {
  uint32_t a = 0u, b = j;
  threefry(k.k0, k.k1, a, b);
  return bits_to_uniform(a ^ b);
}

struct RowKeys {
  Key hi, lo, delay, scan;  // randint's two words, the delay stream, the per-step keys
};

__device__ __forceinline__ RowKeys row_keys(Key key) {
  const Key k_idx = child(key, 0), k_delay = child(key, 1), k_scan = child(key, 2);
  return {child(k_idx, 0), child(k_idx, 1), k_delay, k_scan};
}

struct Step {
  int idx;   // sample index i_m
  int age;   // read age a = max(m - d_m, 0)
  Key read;  // per-coordinate reader draws
  Key drop;  // per-coordinate drop draws
};

// The draws of step m. Every lane of the warp must call it: lanes hash in parallel and share
// the words by shuffles.
__device__ __forceinline__ Step draw_step(const RowKeys& rk, int m, uint32_t span, uint32_t mult,
                                          int tau, int delay_id, int lane) {
  const int which = lane & 3;
  const Key k = which == 0 ? rk.hi : which == 1 ? rk.lo : which == 2 ? rk.delay : rk.scan;
  uint32_t a = 0u, b = (uint32_t)m;
  threefry(k.k0, k.k1, a, b);
  const uint32_t hi = __shfl_sync(kFull, a ^ b, 0);
  const uint32_t lo = __shfl_sync(kFull, a ^ b, 1);
  const uint32_t delay_bits = __shfl_sync(kFull, a ^ b, 2);
  const Key km = {__shfl_sync(kFull, a, 3), __shfl_sync(kFull, b, 3)};
  uint32_t c = 0u, e = (uint32_t)(lane & 1);
  threefry(km.k0, km.k1, c, e);
  Step s;
  s.read = {__shfl_sync(kFull, c, 0), __shfl_sync(kFull, e, 0)};
  s.drop = {__shfl_sync(kFull, c, 1), __shfl_sync(kFull, e, 1)};
  s.idx = (int)(((hi % span) * mult + lo % span) % span);  // uint32 arithmetic wraps as JAX's
  const int cap = min(m, tau);
  int delay = 0;
  if (delay_id == 1) {
    delay = cap;
  } else if (delay_id == 2) {
    delay = (int)floorf(__fmul_rn(bits_to_uniform(delay_bits), (float)(cap + 1)));
  }
  s.age = max(m - delay, 0);
  return s;
}

__device__ __forceinline__ int read_slot(int scheme, const Step& st, int m, int slots, int j) {
  if (scheme == 0) return st.age % slots;
  const float u = uniform_at(st.read, (uint32_t)j);
  if (scheme == 1) return (u < 0.5f ? st.age : min(st.age + 1, m)) % slots;
  return (st.age + (int)floorf(__fmul_rn(u, (float)(m - st.age + 1)))) % slots;
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
  float l2, keep_p;
};

template <bool kSvrg>
__global__ void __launch_bounds__(kMaxThreads) sweep_epoch_kernel(Params p) {
  extern __shared__ double smem[];
  double* scratch = smem;  // [2 steps][2 sums][kMaxWarps]
  const int d = p.d;
  float* state = reinterpret_cast<float*>(smem + 4 * kMaxWarps);
  float* u0 = state;  // u0, mu and acc: AsySVRG only
  float* mu = u0 + d;
  float* acc = mu + d;
  float* ur = kSvrg ? acc + d : state;  // the read iterate
  const int c = blockIdx.x;
  float* ring = p.ring ? p.ring + (size_t)c * p.buf_len * d : ur + d;
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int warps = T >> 5;
  const int tau = p.row_ints[c], scheme = p.row_ints[p.C + c], delay_id = p.row_ints[2 * p.C + c];
  const int slots = tau + 1;
  const bool masked = p.drop && scheme == 2;
  const float step = p.step[c];
  const RowKeys rk = row_keys({(uint32_t)p.keys[2 * c], (uint32_t)p.keys[2 * c + 1]});

  for (int j = tid; j < d; j += T) {
    const float wj = p.w[(size_t)c * d + j];
    for (int s = 0; s < slots; ++s) ring[(size_t)s * d + j] = wj;
    if (kSvrg) {
      u0[j] = wj;
      mu[j] = p.mu[(size_t)c * d + j];
      acc[j] = 0.0f;
    }
  }

  for (int m = 0; m < p.total; ++m) {
    const Step st = draw_step(rk, m, p.span, p.mult, tau, delay_id, lane);
    const float* x = p.X + (size_t)st.idx * d;
    const float yi = __ldg(p.y + st.idx);
    double part = 0.0, part0 = 0.0;
    for (int j = tid; j < d; j += T) {
      const float xj = __ldg(x + j);
      const float r = ring[(size_t)read_slot(scheme, st, m, slots, j) * d + j];
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
    __syncthreads();
    double z = 0.0, z0 = 0.0;
    for (int q = 0; q < warps; ++q) {
      z += sc[q];
      if (kSvrg) z0 += sc[kMaxWarps + q];
    }
    const float coef = residual(yi, z);
    const float coef0 = kSvrg ? residual(yi, z0) : 0.0f;
    const int cur = m % slots, next = (m + 1) % slots;
    for (int j = tid; j < d; j += T) {
      const float xj = __ldg(x + j);
      const float u = ring[(size_t)cur * d + j];
      float g = __fadd_rn(__fmul_rn(coef, xj), __fmul_rn(p.l2, ur[j]));
      const float keep = masked && !(uniform_at(st.drop, (uint32_t)j) < p.keep_p) ? 0.0f : 1.0f;
      float un;
      if (kSvrg) {
        float g0 = __fadd_rn(__fmul_rn(coef0, xj), __fmul_rn(p.l2, u0[j]));
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
  }

  const int last = p.total % slots;
  for (int j = tid; j < d; j += T) {
    p.out[(size_t)c * d + j] = kSvrg && p.option == 2 ? __fdiv_rn(acc[j], (float)p.total)
                                                      : ring[(size_t)last * d + j];
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

// Loss, pass 2: one block per row sums its n terms and ||W[c]||^2 in float64 (threads in
// stride order, then warps in order) and rounds once, as objective.loss_fixed_order does.
__global__ void __launch_bounds__(kLossThreads)
    loss_sum_kernel(const double* __restrict__ t, const float* __restrict__ W,
                    float* __restrict__ loss, int n, int d, float l2) {
  __shared__ double part[2][kLossThreads / 32];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double s = 0.0, q = 0.0;
  for (int r = tid; r < n; r += kLossThreads) s += t[(size_t)c * n + r];
  for (int j = tid; j < d; j += kLossThreads) {
    const float wj = W[(size_t)c * d + j];
    q += (double)__fmul_rn(wj, wj);
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
    loss[c] = __fadd_rn((float)(sum / (double)n), __fmul_rn(0.5f * l2, (float)sumsq));
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

// randint's fold multiplier, 2^32 mod span, as JAX computes it: (2^16 mod span)^2 mod span
uint32_t fold_multiplier(uint32_t span) {
  const uint32_t r = 65536u % span;
  return (r * r) % span;
}

}  // namespace

// Dynamic shared memory of one block of `engine` (0 = AsySVRG, 1 = Hogwild!), with the ring in
// shared memory or not.
extern "C" long long sweep_epoch_shared_bytes(long long d, long long buf_len, int engine,
                                              int ring_shared) {
  const long long vectors = (engine == 0 ? 4 : 1) + (ring_shared ? buf_len : 0);
  return kScratchBytes + vectors * d * 4;
}

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
// contiguous, on one device. engine: 0 = AsySVRG, 1 = Hogwild!. Returns the first CUDA error
// code of the three launches (0 = success).
extern "C" int sweep_epoch_launch(const float* X, const float* y, const float* w, const float* mu,
                                  const long long* keys, const float* step, const int* row_ints,
                                  float* ring, float* out, double* terms, float* loss, long long n,
                                  long long d, long long C, long long total, long long buf_len,
                                  int engine, int option, int drop, float l2, float keep_p,
                                  void* stream) {
  if (n <= 0 || d <= 0 || C <= 0 || total <= 0 || buf_len <= 0) return (int)cudaErrorInvalidValue;
  Params p{X, y, w, mu, keys, step, row_ints, ring, out, (int)d, (int)C, (int)total,
           (int)buf_len, option, drop, (uint32_t)n, fold_multiplier((uint32_t)n), l2, keep_p};
  const long long bytes = sweep_epoch_shared_bytes(d, buf_len, engine, ring == nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d);
  if (engine == 0) {
    cudaError_t err = cudaFuncSetAttribute(sweep_epoch_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sweep_epoch_kernel<true><<<(unsigned)C, threads, (size_t)bytes, st>>>(p);
  } else if (engine == 1) {
    cudaError_t err = cudaFuncSetAttribute(sweep_epoch_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    sweep_epoch_kernel<false><<<(unsigned)C, threads, (size_t)bytes, st>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long warps = kLossThreads / 32;
  loss_terms_kernel<<<(unsigned)((n + warps - 1) / warps), kLossThreads, 0, st>>>(
      X, y, out, terms, (int)n, (int)d, (int)C);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  loss_sum_kernel<<<(unsigned)C, kLossThreads, 0, st>>>(terms, out, loss, (int)n, (int)d, l2);
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
