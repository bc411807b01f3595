// Fused SVRG control-variate update for Hopper (sm_90a):
//
//     out[c, j] = u[c, j] - lr[c] * (g[c, j] - g0[c, j] + gf[c, j] + wd * u[c, j])
//
// Replaces the TPU kernel src/repro/kernels/svrg_update/kernel.py
// (`_update_kernel`, launched by `svrg_update_2d`), which ran one (64, 128)
// VMEM tile per grid step.
//
// Bound on this card: bytes. Each element is read from 4 inputs and written
// once (5 * 4 bytes in float32) for 4-6 flops, far below the H100's
// ~20 flop/byte balance point. At the engine's shape (C rows of d = 2048)
// that is 40 KB per row, ~12 ns at 3.35 TB/s, so one call is bound by the
// launch itself, not by the memory. Removing launches (the K3 megakernel)
// is the remedy, not this kernel.
//
// Design: one elementwise pass with a grid-stride loop. When d % 4 == 0 and
// every pointer is aligned, each thread moves 4 elements per access (16-byte
// float4-sized loads in float32, 8-byte loads in bfloat16); otherwise it
// falls back to scalar accesses. The (64, 128) tile padding of the TPU
// kernel is dropped: any [C, d] shape is taken as it is. Math is float32
// with explicit round-to-nearest intrinsics (no fused multiply-add), so the
// result equals the plain torch version element for element; bfloat16
// inputs are widened with the conversion intrinsics and the result is
// rounded back. lr is a per-row device array, so one launch updates every
// row of a sweep group with its own step size.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
__global__ void svrg_update_kernel(const T* __restrict__ u, const T* __restrict__ g,
                                   const T* __restrict__ g0, const T* __restrict__ gf,
                                   const float* __restrict__ lr, T* __restrict__ out,
                                   long long rows, long long d, float wd, int use_wd) {
  using P = Pack<T, VEC>;
  const long long row_vecs = d / VEC;
  const long long total = rows * row_vecs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += stride) {
    const float rate = lr[k / row_vecs];
    const P pu = reinterpret_cast<const P*>(u)[k];
    const P pg = reinterpret_cast<const P*>(g)[k];
    const P pg0 = reinterpret_cast<const P*>(g0)[k];
    const P pgf = reinterpret_cast<const P*>(gf)[k];
    P po;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      po.v[e] = narrow<T>(update_one(widen(pu.v[e]), widen(pg.v[e]), widen(pg0.v[e]),
                                     widen(pgf.v[e]), rate, wd, use_wd != 0));
    }
    reinterpret_cast<P*>(out)[k] = po;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename T>
int launch(const void* u, const void* g, const void* g0, const void* gf, const void* lr,
           void* out, long long rows, long long d, float wd, cudaStream_t stream) {
  constexpr int kThreads = 256;
  constexpr long long kMaxBlocks = 132 * 16;
  const uintptr_t vec_bytes = sizeof(T) * 4;
  const bool vec = d % 4 == 0 && aligned(u, vec_bytes) && aligned(g, vec_bytes) &&
                   aligned(g0, vec_bytes) && aligned(gf, vec_bytes) &&
                   aligned(out, vec_bytes);
  const long long work = rows * d / (vec ? 4 : 1);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  const int use_wd = wd != 0.0f;
  const T* tu = static_cast<const T*>(u);
  const T* tg = static_cast<const T*>(g);
  const T* tg0 = static_cast<const T*>(g0);
  const T* tgf = static_cast<const T*>(gf);
  const float* tlr = static_cast<const float*>(lr);
  T* tout = static_cast<T*>(out);
  if (vec) {
    svrg_update_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tu, tg, tg0, tgf, tlr, tout, rows, d, wd, use_wd);
  } else {
    svrg_update_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        tu, tg, tg0, tgf, tlr, tout, rows, d, wd, use_wd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. u, g, g0, gf, out: [rows, d] contiguous;
// lr: [rows] float32. Returns the CUDA error code of the launch (0 = success).
extern "C" int svrg_update_launch(int dtype, const void* u, const void* g, const void* g0,
                                  const void* gf, const void* lr, void* out, long long rows,
                                  long long d, float wd, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(u, g, g0, gf, lr, out, rows, d, wd, s);
  if (dtype == 1) return launch<__nv_bfloat16>(u, g, g0, gf, lr, out, rows, d, wd, s);
  return (int)cudaErrorInvalidValue;
}
