// Causal / sliding-window prefill attention with an online softmax, for
// Hopper (sm_90a), on the tensor cores: bf16 in and out, float32 sums,
//
//     o[b, s, n, :] = softmax_j(q[b, s, n, :] . k[b, j, n / G, :] / sqrt(h)
//                               over the allowed j) @ v[b, j, n / G, :]
//
// for the Sq queries s and Sk keys j, with key j allowed for query s when
// j < Sk, (not causal or s >= j) and (window == 0 or s - j < window); G =
// N / K query heads share a kv head. A key length of its own (Sk != Sq) is
// for non-causal attention without a window (an encoder over its valid
// frames, a cross-attention); the wrapper refuses it otherwise.
// The same function as flash_attention.cu (the CUDA-core kernel, which
// keeps float32 and the bf16 head widths that are not a multiple of 16).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_flash_kernel`, launched by `flash_attention`), which ran one
// (query tile, kv tile) pair per sequential grid step with the running max,
// normaliser and accumulator in VMEM scratch, skipping fully masked kv
// tiles, over a [B*H, S, d] layout after a kv-head repeat.
//
// Bound on this card: operations. 4 h flops per unmasked (query, key) pair
// against one read of q, k, v and one write of o; at the serve path's shape
// (B 4, S 2048, N 8, K 4, h 256) that is ~1000 flops per byte, above the
// ~295 at which the tensor cores' 989 TFLOP/s (bf16) and not HBM set the
// limit. Both products therefore run as wgmma.
//
// Design:
// * One block of one warpgroup (128 threads) per (b, n, tile of 64 query
//   rows); the tiles that reach furthest along the sequence are numbered
//   first. The block walks the kv tiles from the first one the window
//   reaches to the last one the causal diagonal reaches.
// * Loads are TMA copies of 4-D tensor maps over the model layout, dims
//   (h, heads, S, B) with the caller's element strides, so q [B, Sq, N, h]
//   and k/v [B, Sk, K, h] are read in place (kv head n / G, no repeat) and
//   rows at or past Sq (q) or Sk (k, v), and columns at or past h, arrive
//   as zeros: keys padded at the end of a longer buffer are cut off by
//   passing Sk, with the buffer's strides. A row of
//   h is cut into boxes of 64 bf16 (128 bytes, the widest box the 128-byte
//   swizzle takes); h is padded to HP, a multiple of 64.
// * Q is loaded once per block. K and V tiles of BK keys go through a ring
//   of 2 stages, each with a full barrier for K, one for V (TMA
//   transaction counts) and an empty barrier (128 consumer arrivals).
//   Thread 0 keeps the next tile in flight: after tile j it waits for the
//   stage to be released and loads tile j + 2 into it, so tile j + 1 loads
//   while tile j computes.
// * S = Q K^T: wgmma m64nBKk16, Q and K from shared memory (K-major,
//   128-byte swizzle), float32 accumulators in registers.
// * Online softmax in float32 registers, in log2 units: a thread holds two
//   rows (lane / 4 and lane / 4 + 8 of its warp's 16), spread over the
//   four threads of a quad, so a row max is two shuffles; the row sum stays
//   per thread until the end. The mask is applied element by element only
//   on the tiles that cut the causal diagonal or the window's edge, or
//   hold keys past Sk (zero-filled, so their score is 0, not -inf). A
//   masked entry gets the score -inf, so its weight exp2(-inf - m) is
//   exactly 0 (m is finite: it starts at -1e30), and a row with every key
//   of a tile masked keeps m, l and acc; the output is acc / max(l, 1e-30).
// * O += P V: wgmma m64n64k16 per 64 columns of h, P (the probabilities
//   rounded to bf16, as ref.py rounds them before its product with v) fed
//   from registers as the A operand in the accumulator's own layout, V from
//   shared memory in its key-major layout with the transpose bit (MN-major).
//   No round trip of P through shared memory.
// * Epilogue: acc / l rounded to bf16 into the (free) Q buffer with the
//   same swizzle, then 16-byte coalesced stores of the rows below Sq.
// * Shared memory: Q 64 x HP, 2 stages of K and V BK x HP, all bf16. At
//   h = 256 BK = 32: 96 KB + alignment, two blocks per SM, whose softmax
//   and wgmma interleave; at h <= 128 BK = 64.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block (one wgmma M)
constexpr int kThreads = 128;   // one warpgroup
constexpr int kStages = 2;
constexpr float kNegBig = -1e30f;

template <int HP>
struct Cfg {
  static constexpr int BK = HP >= 192 ? 32 : 64;        // keys per kv tile
  static constexpr int kChunks = HP / 64;                // 128-byte boxes per row
  static constexpr int kQBytes = kBQ * HP * 2;
  static constexpr int kTileBytes = BK * HP * 2;         // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 64;   // + alignment slack
};

struct Params {
  void* o;
  long long o_sb, o_ss, o_sn;
  int Sq, Sk, N, K, h, BN, nq, causal, window;
  float scale_log2;  // log2(e) / sqrt(h)
};

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the completion of the phase with parity `parity`. A wait that
// outlasts 2^24 tries (seconds) traps, so a broken pipeline fails its
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. The 8-row group
// stride (SBO) is 1024 bytes for every operand here; the other stride (LBO)
// is unused by these shapes (a K-major k16 slice, or an MN-major slice
// exactly one 64-element swizzle atom wide) and set to the same 1024.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of a register across the
// asynchronous wgmma that reads or writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n32_ss(float (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A bf16 in registers (the
// accumulator layout), B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (BK == 32) wgmma_m64n32_ss(d, da, db, accumulate);
  else wgmma_m64n64_ss(d, da, db, accumulate);
}

__device__ __forceinline__ float exp2_approx(float x) {  // ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the kernel ---------------------------------------------------------------

template <int HP>
__global__ void __launch_bounds__(kThreads) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, Params p) {
  using C = Cfg<HP>;
  constexpr int BK = C::BK;
  constexpr int NC = C::kChunks;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* smem = smem_raw + pad;  // 1024-aligned: the swizzle atom
  const uint32_t sQ = raw + pad;
  const uint32_t sK0 = sQ + C::kQBytes;                  // stage s at + s * kTileBytes
  const uint32_t sV0 = sK0 + kStages * C::kTileBytes;
  const uint32_t bar = sQ + C::kBarOffset;
  const uint32_t full_q = bar;
  auto full_k = [&](int s) { return bar + 8 + 8 * s; };
  auto full_v = [&](int s) { return bar + 24 + 8 * s; };
  auto empty = [&](int s) { return bar + 40 + 8 * s; };

  const float kNegInf = -__int_as_float(0x7f800000);
  const CUtensorMap* map_k = &tk;
  const CUtensorMap* map_v = &tv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = p.nq - 1 - (int)(blockIdx.x / p.BN);  // furthest tiles first
  const int bh = (int)(blockIdx.x % p.BN);
  const int b = bh / p.N;
  const int n = bh - b * p.N;
  const int kv = n / (p.N / p.K);
  const int q0 = qt * kBQ;

  // kv tiles: from the first key the earliest row's window reaches to the
  // last key the latest row's causal diagonal reaches
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / BK * BK : 0;
  const int k_end = p.causal ? q_last + 1 : p.Sk;
  const int nt = (k_end - k_begin + BK - 1) / BK;

  auto load_kv = [&](int j) {  // thread 0 only
    const int s = j % kStages;
    const int k0 = k_begin + j * BK;
    mbar_expect_tx(full_k(s), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_4d(sK0 + s * C::kTileBytes + c * BK * 128, map_k, full_k(s), c * 64, kv, k0, b);
    mbar_expect_tx(full_v(s), C::kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_load_4d(sV0 + s * C::kTileBytes + c * BK * 128, map_v, full_v(s), c * 64, kv, k0, b);
  };

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(full_q, C::kQBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_load_4d(sQ + c * kBQ * 128, &tq, full_q, c * 64, n, q0, b);
    for (int j = 0; j < min(nt, kStages); ++j) load_kv(j);
  }

  // this thread's rows (tile-relative) and its first key column in a group of 8
  const int row0 = warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the running sum

  mbar_wait(full_q, 0);
  for (int j = 0; j < nt; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (uint32_t)(j / kStages) & 1u;
    const int k0 = k_begin + j * BK;
    const uint32_t sK = sK0 + s * C::kTileBytes;
    const uint32_t sV = sV0 + s * C::kTileBytes;

    // S = Q K^T over h in steps of 16 (32 bytes inside a 128-byte row)
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    mbar_wait(full_k(s), parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < HP / 16; ++t) {
      const uint32_t off = (t % 4) * 32;
      wgmma_scores<BK>(sc, sw128_desc(sQ + (t / 4) * kBQ * 128 + off),
                       sw128_desc(sK + (t / 4) * BK * 128 + off), t > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax; sc[4 g + e] is row row0 + 8 (e / 2), key 8 g + col0 + e % 2
    const bool masked = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > q0) ||
                        (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int g = 0; g < BK / 8; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * g + e] * p.scale_log2;
        if (masked) {
          const int qpos = q0 + row0 + 8 * (e >> 1);
          const int kpos = k0 + 8 * g + col0 + (e & 1);
          const bool ok = kpos < p.Sk && (!p.causal || qpos >= kpos) &&
                          (p.window <= 0 || qpos - kpos < p.window);
          x = ok ? x : kNegInf;
        }
        sc[4 * g + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pk[BK / 4];  // P in bf16 pairs, the A fragments of the k16 steps
#pragma unroll
    for (int g = 0; g < BK / 8; ++g) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float p0 = exp2_approx(sc[4 * g + e] - m[e >> 1]);
        const float p1 = exp2_approx(sc[4 * g + e + 1] - m[e >> 1]);
        l[e >> 1] += p0 + p1;
        pk[2 * g + (e >> 1)] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];

    // O += P V, one k16 step of keys at a time, 64 columns of h per wgmma
    mbar_wait(full_v(s), parity);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {pk[4 * t], pk[4 * t + 1], pk[4 * t + 2], pk[4 * t + 3]};
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_m64n64_rs(acc[c], a, sw128_desc(sV + c * BK * 128 + t * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);

    // release the stage; thread 0 refills it with tile j + 2
    mbar_arrive(empty(s));
    if (tid == 0 && j + kStages < nt) {
      mbar_wait(empty(s), parity);
      load_kv(j + kStages);
    }
  }

  // epilogue: acc / l in bf16 into the Q buffer (same swizzle), then rows < Sq out
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __syncthreads();  // every wgmma of the block has read Q
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const uint32_t word = pack_bf16(acc[c][4 * g + 2 * r] * inv[r],
                                        acc[c][4 * g + 2 * r + 1] * inv[r]);
        *reinterpret_cast<uint32_t*>(smem + c * kBQ * 128 + row * 128 +
                                     ((g ^ (row & 7)) << 4) + col0 * 2) = word;
      }
    }
  }
  __syncthreads();
  const int per_row = p.h / 8;  // 16-byte pieces of a row of o
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + n * p.o_sn;
  for (int i = tid; i < kBQ * per_row; i += kThreads) {
    const int row = i / per_row;
    const int piece = i - row * per_row;
    if (q0 + row >= p.Sq) break;
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem + (piece >> 3) * kBQ * 128 + row * 128 + (((piece & 7) ^ (row & 7)) << 4));
    *reinterpret_cast<uint4*>(o + (long long)(q0 + row) * p.o_ss + piece * 8) = val;
  }
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library needs no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (h, heads, S, B) over bf16 with element strides (sn, ss, sb),
// boxes of 64 x 1 x rows x 1, 128-byte swizzle, out-of-bounds zeros.
int make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int h, int heads, int S,
             int B, long long sb, long long ss, long long sn, int rows) {
  cuuint64_t dims[4] = {(cuuint64_t)h, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HP>
int launch(const void* q, const void* k, const void* v, long long q_sb, long long q_ss,
           long long q_sn, long long k_sb, long long k_ss, long long k_sn, long long v_sb,
           long long v_ss, long long v_sn, int B, Params p, cudaStream_t stream) {
  using C = Cfg<HP>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, encode, q, p.h, p.N, p.Sq, B, q_sb, q_ss, q_sn, kBQ);
  if (rc == 0) rc = make_map(&tk, encode, k, p.h, p.K, p.Sk, B, k_sb, k_ss, k_sn, C::BK);
  if (rc == 0) rc = make_map(&tv, encode, v, p.h, p.K, p.Sk, B, v_sb, v_ss, v_sn, C::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.BN * p.nq;
  flash_wgmma_kernel<HP><<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, Sq, N, h], k/v [B, Sk, K, h], o [B, Sq, N, h]; h a multiple of 16
// up to 256. Strides are in elements, in the order (batch, sequence, head);
// the head dimension is contiguous, rows and bases 16-byte aligned. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                            long long q_sb, long long q_ss, long long q_sn,
                                            long long k_sb, long long k_ss, long long k_sn,
                                            long long v_sb, long long v_ss, long long v_sn,
                                            long long o_sb, long long o_ss, long long o_sn,
                                            int B, int Sq, int Sk, int N, int K, int h,
                                            int causal, int window, float scale, void* stream) {
  if (h <= 0 || h > 256 || h % 16 != 0 || K <= 0 || N % K != 0) return (int)cudaErrorInvalidValue;
  if (Sk != Sq && (causal || window)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || N <= 0) return 0;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sn = o_sn;
  p.Sq = Sq; p.Sk = Sk; p.N = N; p.K = K; p.h = h; p.BN = B * N;
  p.nq = (Sq + kBQ - 1) / kBQ;
  p.causal = causal; p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn, B, p, s
  switch ((h + 63) / 64) {
    case 1: return launch<64>(FLASH_ARGS);
    case 2: return launch<128>(FLASH_ARGS);
    case 3: return launch<192>(FLASH_ARGS);
    case 4: return launch<256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
