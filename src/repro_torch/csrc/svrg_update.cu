// Fused SVRG control-variate update for Hopper (sm_90a):
//
//     out[c, j] = u[c, j] - lr[c] * (g[c, j] - g0[c, j] + gf[c, j] + wd * u[c, j])
//
// Replaces the TPU kernel src/repro/kernels/svrg_update/kernel.py
// (`_update_kernel`, launched by `svrg_update_2d`), which ran one (64, 128)
// VMEM tile per grid step. The launch also takes, as its epilogue, two
// optional stores of the engine's inner step:
//
//     ring[c, slot[c], j] = out[c, j]       (the iterate into its ring-buffer slot)
//     acc[c, j]          += out[c, j]       (the running sum of option 2)
//
// Bound on this card: bytes. Each element is read from 4 inputs (5 with acc)
// and written once (3 times with both stores) for 4-6 flops, far below the
// H100's ~20 flop/byte balance point. At the engine's shape (C rows of
// d = 2048) that is 40-64 KB per row, 12-20 ns at 3.35 TB/s, so one call is
// bound by the launch itself and the host's path to it, not by the memory.
// The design therefore does more per launch: the engine's ring store and
// running sum, two more launches per inner step before, are this launch's
// epilogue, and the host path (kernels/svrg_update/ops.py) is kept lean.
//
// Design: one block per row (d = 2048 in float32 is 512 threads of one
// float4 each), a grid-stride loop over the rows past kMaxBlocks and over the
// columns past kMaxThreads accesses. When d % 4 == 0 and every pointer is
// aligned, each thread moves 4 elements per access (16-byte loads in
// float32, 8-byte in bfloat16); otherwise it takes scalar accesses. The
// (64, 128) tile padding of the TPU kernel is dropped: any [C, d] shape is
// taken as it is. Math is float32 with explicit round-to-nearest intrinsics
// (no fused multiply-add), so the result equals the plain torch version
// element for element; bfloat16 inputs are widened with the conversion
// intrinsics and the result is rounded back, and acc's add is one float32 add
// rounded to acc's type, as torch's `acc += out`. lr is a per-row device
// array and slot a per-row device int64 array, so one launch updates every row
// of a sweep group with its own step size and ring slot, and nothing waits
// for the host. A slot outside [0, ring_len) traps (the launch fails), as an
// index out of range fails in torch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float update_one(float u, float g, float g0, float gf,
                                            float lr, float wd, bool use_wd) {
  float v = __fadd_rn(__fsub_rn(g, g0), gf);
  if (use_wd) v = __fadd_rn(v, __fmul_rn(wd, u));
  return __fsub_rn(u, __fmul_rn(lr, v));
}

struct Args {
  const void* u;
  const void* g;
  const void* g0;
  const void* gf;
  const float* lr;
  void* out;
  void* ring;              // [rows, ring_len, d] or null
  const long long* slot;   // [rows], with ring
  void* acc;               // [rows, d] or null
  long long rows, d, ring_len;
  float wd;
};

template <typename T, int VEC>
__global__ void svrg_update_kernel(Args a) {
  using P = Pack<T, VEC>;
  const P* u = static_cast<const P*>(a.u);
  const P* g = static_cast<const P*>(a.g);
  const P* g0 = static_cast<const P*>(a.g0);
  const P* gf = static_cast<const P*>(a.gf);
  P* out = static_cast<P*>(a.out);
  P* acc = static_cast<P*>(a.acc);
  const long long row_vecs = a.d / VEC;
  const bool use_wd = a.wd != 0.0f;
  for (long long c = blockIdx.x; c < a.rows; c += gridDim.x) {
    const float rate = a.lr[c];
    P* ring = nullptr;
    if (a.ring) {
      const long long slot = a.slot[c];
      if (slot < 0 || slot >= a.ring_len) __trap();
      ring = static_cast<P*>(a.ring) + (c * a.ring_len + slot) * row_vecs;
    }
    const long long base = c * row_vecs;
    for (long long k = threadIdx.x; k < row_vecs; k += blockDim.x) {
      const P pu = u[base + k], pg = g[base + k], pg0 = g0[base + k], pgf = gf[base + k];
      P po;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        po.v[e] = narrow<T>(update_one(widen(pu.v[e]), widen(pg.v[e]), widen(pg0.v[e]),
                                       widen(pgf.v[e]), rate, a.wd, use_wd));
      }
      out[base + k] = po;
      if (ring) ring[k] = po;
      if (acc) {
        P pa = acc[base + k];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          pa.v[e] = narrow<T>(__fadd_rn(widen(pa.v[e]), widen(po.v[e])));
        }
        acc[base + k] = pa;
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const uintptr_t vec_bytes = sizeof(T) * 4;
  const bool vec = a.d % 4 == 0 && aligned(a.u, vec_bytes) && aligned(a.g, vec_bytes) &&
                   aligned(a.g0, vec_bytes) && aligned(a.gf, vec_bytes) &&
                   aligned(a.out, vec_bytes) && aligned(a.ring, vec_bytes) &&
                   aligned(a.acc, vec_bytes);
  const long long row_vecs = a.d / (vec ? 4 : 1);
  long long threads = (row_vecs + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const unsigned blocks = (unsigned)(a.rows < kMaxBlocks ? a.rows : kMaxBlocks);
  if (vec) {
    svrg_update_kernel<T, 4><<<blocks, (unsigned)threads, 0, stream>>>(a);
  } else {
    svrg_update_kernel<T, 1><<<blocks, (unsigned)threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments, as one array of int64 a[15]: dtype (0 = float32, 1 =
// bfloat16); the pointers u, g, g0, gf, lr, out, ring, slot, acc; rows, d,
// ring_len; wd as the bits of a float32; the stream. u, g, g0, gf, out and
// acc: [rows, d] contiguous; lr: [rows] float32; ring: [rows, ring_len, d]
// contiguous with slot [rows] int64, or both null; acc may be null. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int svrg_update_launch(const long long* a) {
  const long long rows = a[10], d = a[11], ring_len = a[12];
  if (rows <= 0 || d <= 0) return 0;
  void* ring = reinterpret_cast<void*>(a[7]);
  const void* slot = reinterpret_cast<const void*>(a[8]);
  if (ring != nullptr && (slot == nullptr || ring_len <= 0)) return (int)cudaErrorInvalidValue;
  const int bits = (int)a[13];
  float wd;
  memcpy(&wd, &bits, sizeof(wd));
  const Args args{reinterpret_cast<const void*>(a[1]), reinterpret_cast<const void*>(a[2]),
                  reinterpret_cast<const void*>(a[3]), reinterpret_cast<const void*>(a[4]),
                  reinterpret_cast<const float*>(a[5]), reinterpret_cast<void*>(a[6]), ring,
                  static_cast<const long long*>(slot), reinterpret_cast<void*>(a[9]), rows, d,
                  ring_len, wd};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[14]);
  if (a[0] == 0) return launch<float>(args, s);
  if (a[0] == 1) return launch<__nv_bfloat16>(args, s);
  return (int)cudaErrorInvalidValue;
}
