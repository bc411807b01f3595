// Causal / sliding-window prefill attention with an online softmax, for
// Hopper (sm_90a), CUDA cores only:
//
//     o[b, s, n, :] = softmax_j(q[b, s, n, :] . k[b, j, n / G, :] / sqrt(h)
//                               over the allowed j) @ v[b, j, n / G, :]
//
// for the Sq queries s and Sk keys j, with key j allowed for query s when
// j < Sk, (not causal or s >= j) and (window == 0 or s - j < window); G =
// N / K query heads share a kv head. A key length of its own (Sk != Sq) is
// for non-causal attention without a window; the wrapper refuses it
// otherwise.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`_flash_kernel`, launched by `flash_attention`), which ran one
// (query tile, kv tile) pair per sequential grid step with the running max,
// normaliser and accumulator in VMEM scratch, skipping fully masked kv
// tiles, over a [B*H, S, d] layout after a kv-head repeat.
//
// Bound on this card: operations. 4 h flops per unmasked (query, key) pair
// against one read of q, k, v and one write of o; at the serve path's shape
// (B 4, S 2048, N 8, h 256) that is ~1000 flops per byte. This first kernel
// runs on the CUDA cores in float32 (67 TFLOP/s), not the tensor cores
// (989 TFLOP/s in bf16): wgmma, TMA and a pipeline are later work.
//
// Design:
// * The model layout is read through strides: q [B, Sq, N, h], k/v
//   [B, Sk, K, h], o [B, Sq, N, h]; kv head n / G serves query head n, so
//   there is no repeat or transpose copy. Keys padded at the end of a longer
//   buffer are cut off by passing Sk, with the buffer's strides.
// * One block of 256 threads per (b, n, tile of 64 query rows); the tiles
//   that reach furthest along the sequence (most kv tiles under the causal
//   mask) are numbered first. The block walks the kv tiles of 32 keys from
//   the first one the window reaches to the last one the causal diagonal
//   reaches, as the TPU kernel skips tiles. Inside a tile, and at the
//   ragged end of either length, it masks key by key, so any Sq and Sk
//   work.
// * q, k and v tiles are widened to float32 in shared memory (rows padded
//   by 4 floats against bank conflicts): (64 + 2 * 32) * (h + 4) * 4 bytes,
//   133,120 at h = 256, plus the 64 x 32 probability tile. Above 48 KB the
//   launch opts in to the larger dynamic shared memory.
// * Thread (tx, ty) of a 16 x 16 grid owns query rows 4 ty .. 4 ty + 3: for
//   the scores keys tx and tx + 16 of the tile, for the output the float4
//   column chunks tx, tx + 16, ... of h. A row's 16 threads sit in one half
//   warp, so its max and sum are shuffles, and every thread of the row holds
//   the row's running max m and normaliser l.
// * Running max, normaliser and accumulator are float32. A masked entry
//   contributes exactly 0 (it is never exponentiated), so a row whose keys
//   in a tile are all masked keeps m at the floor -1e30, l = 0 and acc = 0,
//   and nothing leaks into it (the TPU kernel relied on the next rescale to
//   wipe such terms). The output is acc / max(l, 1e-30), cast to q's dtype.
// * Inputs float32 or bfloat16 (16-byte loads), every h up to 256 that is a
//   multiple of 8; the output chunks per thread (h / 64, rounded up) are a
//   template parameter.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLdP = kBK + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sn;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  int B, Sq, Sk, N, K, h, nq, causal, window;
  float scale;
};

// 16 bytes of input widened to float32.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(pairs[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

template <typename T>
struct Elems {  // elements in 16 bytes
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// rows [row0, row0 + rows) of one head's [S, h] slice into shared memory as
// float32 with row stride ld; rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int rows, int S, int h, int ld) {
  constexpr int E = Elems<T>::n;
  const int per_row = h / E;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * E;
    float vals[E];
    if (row0 + r < S) {
      load16(src + (long long)(row0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      store4(dst + r * ld + c + e, make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]));
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t shared_bytes(int h) {
  return (size_t)((kBQ + 2 * kBK) * (h + 4) + kBQ * kLdP) * sizeof(float);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int h = p.h;
  const int ld = h + 4;
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][ld]
  float* sK = sQ + kBQ * ld;                     // [kBK][ld]
  float* sV = sK + kBK * ld;                     // [kBK][ld]
  float* sP = sV + kBK * ld;                     // [kBQ][kLdP]

  const int BN = p.B * p.N;
  const int qt = p.nq - 1 - (int)(blockIdx.x / BN);  // furthest tiles first
  const int bh = (int)(blockIdx.x % BN);
  const int b = bh / p.N;
  const int n = bh - b * p.N;
  const int kv = n / (p.N / p.K);
  const int q0 = qt * kBQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kv * p.k_sn;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kv * p.v_sn;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + n * p.o_sn;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int r0 = ty * 4;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  load_tile<T>(sQ, q, p.q_ss, q0, kBQ, p.Sq, h, ld);

  // kv tiles: from the first key the earliest row's window reaches to the
  // last key the latest row's causal diagonal reaches
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / kBK * kBK : 0;
  const int k_end = p.causal ? q_last + 1 : p.Sk;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_tile<T>(sK, k, p.k_ss, k0, kBK, p.Sk, h, ld);
    load_tile<T>(sV, v, p.v_ss, k0, kBK, p.Sk, h, ld);
    __syncthreads();

    // scores of rows r0 .. r0 + 3 against keys tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < h; d += 4) {
      float4 qv[4], kk[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (r0 + i) * ld + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) kk[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kk[j].x, a);
          a = fmaf(qv[i].y, kk[j].y, a);
          a = fmaf(qv[i].z, kk[j].z, a);
          a = fmaf(qv[i].w, kk[j].w, a);
          s[i][j] = a;
        }
      }
    }

    // online softmax, row by row; masked entries weigh exactly 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < p.Sk && (!p.causal || qpos >= kpos) &&
                (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(r0 + i) * kLdP + tx + 16 * j] = pr;
        rs += pr;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
    __syncthreads();

    // acc += P V over the tile's keys
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(sP + (r0 + i) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = (tx + 16 * c) * 4;
          if (col < h) {
            const float4 vv = *reinterpret_cast<const float4*>(sV + (j + jj) * ld + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float w = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
              acc[i][c].x = fmaf(w, vv.x, acc[i][c].x);
              acc[i][c].y = fmaf(w, vv.y, acc[i][c].y);
              acc[i][c].z = fmaf(w, vv.z, acc[i][c].z);
              acc[i][c].w = fmaf(w, vv.w, acc[i][c].w);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (tx + 16 * c) * 4;
      if (col < h) {
        const float4 a = acc[i][c];
        store4(o + (long long)row * p.o_ss + col,
               make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
      }
    }
  }
}

template <typename T, int NC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = shared_bytes(p.h);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, NC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)p.B * p.N * p.nq;
  flash_kernel<T, NC><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(const Params& p, cudaStream_t stream) {
  switch ((p.h + 63) / 64) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16. Strides are in elements, in the order
// (batch, sequence, head) for q, k, v and o; the head dimension is
// contiguous. Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* o, long long q_sb, long long q_ss, long long q_sn,
                                      long long k_sb, long long k_ss, long long k_sn,
                                      long long v_sb, long long v_ss, long long v_sn,
                                      long long o_sb, long long o_ss, long long o_sn, int B,
                                      int Sq, int Sk, int N, int K, int h, int causal,
                                      int window, float scale, void* stream) {
  if (h <= 0 || h > 256 || h % 8 != 0 || K <= 0 || N % K != 0) return (int)cudaErrorInvalidValue;
  if (Sk != Sq && (causal || window)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || N <= 0) return 0;
  if (Sk <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sn = o_sn;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.N = N; p.K = K; p.h = h;
  p.nq = (Sq + kBQ - 1) / kBQ;
  p.causal = causal; p.window = window; p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(p, s);
  if (dtype == 1) return dispatch_width<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
