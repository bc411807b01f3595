// JAX's random draws inside a kernel: threefry2x32 in JAX's partitionable mode, bit-equal to
// src/repro_torch/prng.py, and the per-step draws of the asynchronous engines
// (src/repro_torch/kernels/sweep_epoch/ref.py `epoch_streams`), shared by the sweep kernels
// (sweep_epoch.cu, sweep_epoch_mlp.cu), so a seed draws the same samples, read ages and
// per-coordinate uniforms in each of them, in the batched engine and in the JAX package.
//
// Per row and step m:
//   k_idx, k_delay, k_scan = split(key, 3)
//   i_m = randint(k_idx)[m]; d_m from uniform(k_delay)[m]; a = max(m - d_m, 0)
//   k_read, k_drop = split(split(k_scan, total)[m])
// and the ring slot of coordinate j for the row's reader (consistent / inconsistent / unlock)
// with the row's own tau: slot = age mod (tau + 1).
#pragma once

#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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
// the words by shuffles. `span` is n, `mult` its `fold_multiplier`; delay_id 0 = zero, 1 = fixed,
// 2 = uniform.
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

// Slot of coordinate j in the ring for the row's reader (0 consistent, 1 inconsistent, 2
// unlock), from the step's slot = age mod (tau + 1), slot_b = min(age + 1, m) mod (tau + 1),
// span = m - age + 1 and read key. Equal to (a + k) mod (tau + 1) for the read age a and the
// reader's offset k in [0, tau + 1], as the plain version computes it.
__device__ __forceinline__ int reader_slot(int scheme, int slot, int slot_b, float span, Key read,
                                           int slots, int j) {
  if (scheme == 0) return slot;
  const float u = uniform_at(read, (uint32_t)j);
  if (scheme == 1) return u < 0.5f ? slot : slot_b;
  const int s = slot + (int)floorf(__fmul_rn(u, span));
  return s >= slots ? s - slots : s;
}

// randint's fold multiplier, 2^32 mod span, as JAX computes it: (2^16 mod span)^2 mod span
__host__ __device__ __forceinline__ uint32_t fold_multiplier(uint32_t span) {
  const uint32_t r = 65536u % span;
  return (r * r) % span;
}

}  // namespace
