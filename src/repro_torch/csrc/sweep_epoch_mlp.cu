// One epoch's inner loop of a sweep group for the MLP language-model objective, every row in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU megakernel src/repro/kernels/sweep_epoch/kernel.py (`sweep_epoch_call`,
// body `kernel`) where its `row_fn` runs the MLP objective (`MLPObjective`,
// src/repro/core/objectives.py): the grid's rows each ran `_asysvrg_epochs_core` /
// `_hogwild_epochs_core` with the objective's per-sample gradient inside the update chain.
// csrc/sweep_epoch.cu is the logistic objectives' counterpart; this file computes
//
//   f_i(w) = (1/S) sum_s [logsumexp(l_s) - l_s[t_s]],  l_s = act(x_s w1 + b1) w2,
//   x_s = e_s rsqrt(mean(e_s^2) + 1e-6) (1 + norm),   e_s = embed[tok_s]
//
// for a sequence i of S tokens, the flat row laid out in the param tree's order (b1, embed,
// norm, w1, w2), the activation relu, gelu (tanh form) or silu. Three entry points:
//   * sweep_epoch_mlp_launch: per row and step m the draws of K3 (csrc/jax_prng.cuh: sample
//     index, read age, per-coordinate reader and drop uniforms), the read iterate u_read from
//     the ring, g = grad f_i(u_read) and for AsySVRG g0 = grad f_i(u0), v = (g - g0) + mu
//     (Hogwild!: v = g), unlock rows with drop_prob > 0 masked by bernoulli(k_drop,
//     1 - drop_prob), u_{m+1} = u_m - step v into ring slot (m + 1) mod (tau + 1), acc +=
//     u_{m+1}; the row's result (u_total, or acc / total for option 2) and the loss f there,
//     (1/n) sum_i f_i, in the same kernel;
//   * sweep_epoch_mlp_full: the snapshot gradient mu = (1/n) sum_i grad f_i(w) and f(w) for C
//     rows, or f(w) alone (mu null);
//   * sweep_epoch_mlp_sample_grad: grad f_i(w) of one sample and one row, for the tests.
//
// Numbers: the forward and the hand-written backward run in float64 from the float32 params
// and each gradient coordinate is rounded to float32 once, as MLPObjective computes it, so the
// card and the CPU agree to float64 rounding; the full gradient sums the samples' float64
// gradients in sample order and rounds once. The update is float32 with explicit
// round-to-nearest intrinsics in the batched engine's order (kernels/svrg_update).
//
// Bound on this card: operations, float64 ones (~34 TFLOP/s on an H100 SXM, outside the tensor
// cores). Per gradient ~2 S (D H + H V) multiply-adds forward, as many backward and ~2 S d for
// the per-coordinate sums; two gradients per AsySVRG update. The kernel sits far above that
// bound: each row is a chain of `total` dependent updates, each of ~10 block-wide barriers, on C
// of the 132 SMs.
//
// Design, simple first: one CTA of kThreads threads per row.
//   * One sample's activations and their gradients live in shared memory as float64, one set per
//     gradient (two for AsySVRG: at u_read and at u0): e (then its gradient), the normalised e,
//     x, dx [S, D]; h and act' (then the pre-activation's gradient) [S, H]; the logits (then
//     their gradient) [S, V]; four [S] scalars. The products are CUDA-core float64 loops, one
//     output per thread in turn. A gradient coordinate is then a sum over the S positions of
//     two of those arrays, computed where the update needs it: the gradient is never stored.
//   * The read iterate, the ring of buf_len iterates, u0, mu and acc (AsySVRG) live in shared
//     memory, or all in a [C, vectors, d] device buffer that the wrapper passes where they do
//     not fit (kernels/sweep_epoch_mlp/ops.py picks by size; the launch fails with
//     cudaErrorInvalidValue where its bytes disagree with this file's layout):
//       activations (8 sets S (4 D + 2 H + V + 4)) | step header (64 + 8 S) |
//       read iterate, ring, u0, mu, acc (4 d each; shared placement only)
//   * Warp 0 draws step m at the step's start and hands it over through the header.
//   * A row's result never depends on the other rows of its launch: no sum crosses rows.
// Not yet: the tensor cores, the draws off the chain, several CTAs per row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jax_prng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kRmsEps = 1e-6;  // models.layers.rmsnorm's
constexpr long long kHeaderBase = 64;

// The objective's widths and where each leaf starts in the flat row (tree order).
struct Net {
  int S, V, D, H, act;  // act: 0 relu, 1 gelu (tanh form), 2 silu
  int o_emb, o_norm, o_w1, o_w2, d;
};

Net make_net(int S, int V, int D, int H, int act) {
  Net nt{S, V, D, H, act, 0, 0, 0, 0, 0};
  nt.o_emb = H;
  nt.o_norm = nt.o_emb + V * D;
  nt.o_w1 = nt.o_norm + D;
  nt.o_w2 = nt.o_w1 + D * H;
  nt.d = nt.o_w2 + H * V;
  return nt;
}

__host__ __device__ __forceinline__ long long acts_doubles(const Net& nt) {
  return (long long)nt.S * (4LL * nt.D + 2LL * nt.H + nt.V + 4);
}

__host__ __device__ __forceinline__ long long header_bytes(const Net& nt) {
  return (kHeaderBase + 8LL * nt.S + 15) / 16 * 16;
}

// One sample's activations and their gradients (float64, shared memory).
struct Acts {
  double *e, *nh, *x, *dx, *h, *ad, *lg, *r, *ls, *cc;
};

__device__ __forceinline__ Acts carve(double* base, const Net& nt) {
  const int SD = nt.S * nt.D, SH = nt.S * nt.H;
  Acts a;
  a.e = base;
  a.nh = a.e + SD;
  a.x = a.nh + SD;
  a.dx = a.x + SD;
  a.h = a.dx + SD;
  a.ad = a.h + SH;
  a.lg = a.ad + SH;
  a.r = a.lg + nt.S * nt.V;
  a.ls = a.r + nt.S;
  a.cc = a.ls + nt.S;
  return a;
}

// The step warp 0 hands to the block, then the sample's tokens and targets.
struct Header {
  int idx, slot, slot_b;
  float span;
  Key read, drop;
};
static_assert(sizeof(Header) <= kHeaderBase, "step header too large");

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// act(a) and act'(a), in float64 as torch computes them and their backward.
__device__ __forceinline__ double activate(int act, double a, double* deriv) {
  if (act == 0) {
    const double y = a > 0.0 ? a : 0.0;
    *deriv = y > 0.0 ? 1.0 : 0.0;
    return y;
  }
  if (act == 1) {
    const double beta = 0.7978845608028654;  // sqrt(2 / pi)
    const double kappa = 0.044715;
    const double a2 = a * a;
    const double t = tanh(beta * (a + kappa * a2 * a));
    *deriv = 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * beta * (1.0 + 3.0 * kappa * a2);
    return 0.5 * a * (1.0 + t);
  }
  const double s = 1.0 / (1.0 + exp(-a));
  *deriv = s * (1.0 + a * (1.0 - s));
  return a * s;
}

// One sample through the network at the flat row w (float32, shared or device memory): the
// forward into A, the sample's loss terms lse - gold into A.ls; with `grad` also the backward
// (A.lg becomes dl, A.ad da, A.e de, A.dx dx). Every thread of the block calls it; it ends on a
// barrier.
__device__ void sample_pass(const float* w, const int* tok, const int* tgt, const Acts& A,
                            const Net& nt, bool grad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = nt.S, V = nt.V, D = nt.D, H = nt.H;
  const float* b1 = w;
  const float* emb = w + nt.o_emb;
  const float* nrm = w + nt.o_norm;
  const float* w1 = w + nt.o_w1;
  const float* w2 = w + nt.o_w2;
  for (int q = tid; q < S * D; q += kThreads) {
    const int s = q / D, i = q - s * D;
    A.e[q] = (double)emb[(size_t)tok[s] * D + i];
  }
  __syncthreads();
  for (int s = warp; s < S; s += kWarps) {
    double ss = 0.0;
    for (int i = lane; i < D; i += 32) ss += A.e[s * D + i] * A.e[s * D + i];
    ss = warp_sum(ss);
    if (lane == 0) A.r[s] = 1.0 / sqrt(ss / (double)D + kRmsEps);
  }
  __syncthreads();
  for (int q = tid; q < S * D; q += kThreads) {
    const int s = q / D, i = q - s * D;
    const double nh = A.e[q] * A.r[s];
    A.nh[q] = nh;
    A.x[q] = nh * (1.0 + (double)nrm[i]);
  }
  __syncthreads();
  for (int q = tid; q < S * H; q += kThreads) {
    const int s = q / H, k = q - s * H;
    double z = 0.0;
    for (int i = 0; i < D; ++i) z += A.x[s * D + i] * (double)w1[(size_t)i * H + k];
    double deriv;
    A.h[q] = activate(nt.act, z + (double)b1[k], &deriv);
    A.ad[q] = deriv;
  }
  __syncthreads();
  for (int q = tid; q < S * V; q += kThreads) {
    const int s = q / V, v = q - s * V;
    double z = 0.0;
    for (int k = 0; k < H; ++k) z += A.h[s * H + k] * (double)w2[(size_t)k * V + v];
    A.lg[q] = z;
  }
  __syncthreads();
  // log-sum-exp per position, one warp each; with `grad` the logits become
  // dl = (softmax - onehot(target)) / S
  for (int s = warp; s < S; s += kWarps) {
    double* row = A.lg + s * V;
    double mx = -INFINITY;
    for (int v = lane; v < V; v += 32) mx = fmax(mx, row[v]);
    mx = warp_max(mx);
    double se = 0.0;
    for (int v = lane; v < V; v += 32) se += exp(row[v] - mx);
    se = warp_sum(se);
    const double lse = mx + log(se);
    const int t = tgt[s];
    if (lane == 0) A.ls[s] = lse - row[t];
    __syncwarp();
    if (grad) {
      for (int v = lane; v < V; v += 32) row[v] = (exp(row[v] - lse) - (v == t ? 1.0 : 0.0)) / S;
    }
  }
  __syncthreads();
  if (!grad) return;
  for (int q = tid; q < S * H; q += kThreads) {  // da = (dl w2^T) act'(a)
    const int s = q / H, k = q - s * H;
    double z = 0.0;
    for (int v = 0; v < V; ++v) z += A.lg[s * V + v] * (double)w2[(size_t)k * V + v];
    A.ad[q] = z * A.ad[q];
  }
  __syncthreads();
  for (int q = tid; q < S * D; q += kThreads) {  // dx = da w1^T
    const int s = q / D, i = q - s * D;
    double z = 0.0;
    for (int k = 0; k < H; ++k) z += A.ad[s * H + k] * (double)w1[(size_t)i * H + k];
    A.dx[q] = z;
  }
  __syncthreads();
  for (int s = warp; s < S; s += kWarps) {  // c_s = sum_i dnh_i e_i, dnh = dx (1 + norm)
    double c = 0.0;
    for (int i = lane; i < D; i += 32) {
      c += A.dx[s * D + i] * (1.0 + (double)nrm[i]) * A.e[s * D + i];
    }
    c = warp_sum(c);
    if (lane == 0) A.cc[s] = c;
  }
  __syncthreads();
  for (int q = tid; q < S * D; q += kThreads) {  // de = r dnh - r^3 e c / D, into e
    const int s = q / D, i = q - s * D;
    const double r = A.r[s];
    const double dnh = A.dx[q] * (1.0 + (double)nrm[i]);
    A.e[q] = r * dnh - r * r * r * A.e[q] * A.cc[s] / (double)D;
  }
  __syncthreads();
}

// The sample's loss f_i from A.ls, in position order.
__device__ __forceinline__ double sample_loss(const Acts& A, const Net& nt) {
  double s = 0.0;
  for (int p = 0; p < nt.S; ++p) s += A.ls[p];
  return s / nt.S;
}

// Coordinate j of the gradient after a `sample_pass` with `grad`: a sum over the positions.
__device__ __forceinline__ double grad_coord(const Acts& A, const int* tok, const Net& nt, int j) {
  const int S = nt.S, V = nt.V, D = nt.D, H = nt.H;
  double g = 0.0;
  if (j < nt.o_emb) {  // b1[k]
    for (int s = 0; s < S; ++s) g += A.ad[s * H + j];
  } else if (j < nt.o_norm) {  // embed[t, i]: the positions holding token t
    const int q = j - nt.o_emb, t = q / D, i = q - t * D;
    for (int s = 0; s < S; ++s) {
      if (tok[s] == t) g += A.e[s * D + i];
    }
  } else if (j < nt.o_w1) {  // norm[i]
    const int i = j - nt.o_norm;
    for (int s = 0; s < S; ++s) g += A.dx[s * D + i] * A.nh[s * D + i];
  } else if (j < nt.o_w2) {  // w1[i, k]
    const int q = j - nt.o_w1, i = q / H, k = q - i * H;
    for (int s = 0; s < S; ++s) g += A.x[s * D + i] * A.ad[s * H + k];
  } else {  // w2[k, v]
    const int q = j - nt.o_w2, k = q / V, v = q - k * V;
    for (int s = 0; s < S; ++s) g += A.h[s * H + k] * A.lg[s * V + v];
  }
  return g;
}

// tokens and targets of sample i into the header's arrays (threads 0 .. S - 1)
__device__ __forceinline__ void load_sample(const int* tokens, const int* targets, int i,
                                            const Net& nt, int* tok, int* tgt) {
  const int tid = threadIdx.x;
  if (tid < nt.S) {
    tok[tid] = tokens[(size_t)i * nt.S + tid];
    tgt[tid] = targets[(size_t)i * nt.S + tid];
  }
}

struct EpochParams {
  const int* tokens;
  const int* targets;
  const float* w;
  const float* mu;
  const long long* keys;
  const float* step;
  const int* row_ints;  // [3, C]: tau, scheme id, delay id
  float* vecs;          // [C, vectors, d] in device memory, or null: the vectors in shared memory
  float* out;
  float* loss;
  Net nt;
  int n, C, total, buf_len, option, drop;
  uint32_t mult;
  float keep_p;
};

__host__ __device__ __forceinline__ long long vectors(bool svrg, long long buf_len) {
  return (svrg ? 4 : 1) + buf_len;  // read iterate, (u0, mu, acc,) ring
}

template <bool kSvrg>
__global__ void __launch_bounds__(kThreads) epoch_kernel(EpochParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Net nt = p.nt;
  const int d = nt.d, c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long na = acts_doubles(nt);
  double* base = reinterpret_cast<double*>(smem);
  const Acts A = carve(base, nt);                       // at the read iterate
  const Acts B = carve(base + (kSvrg ? na : 0), nt);    // at u0 (AsySVRG)
  unsigned char* hdr = smem + 8 * na * (kSvrg ? 2 : 1);
  Header* head = reinterpret_cast<Header*>(hdr);
  int* tok = reinterpret_cast<int*>(hdr + kHeaderBase);
  int* tgt = tok + nt.S;
  float* vbase = p.vecs ? p.vecs + (size_t)c * vectors(kSvrg, p.buf_len) * d
                        : reinterpret_cast<float*>(hdr + header_bytes(nt));
  float* ur = vbase;
  float* ring = ur + d;
  float* u0 = ring + (size_t)p.buf_len * d;  // u0, mu, acc: AsySVRG only
  float* mu = u0 + d;
  float* acc = mu + d;
  const int tau = p.row_ints[c], scheme = p.row_ints[p.C + c], delay_id = p.row_ints[2 * p.C + c];
  const int slots = tau + 1;
  const bool masked = p.drop && scheme == 2;
  const float step = p.step[c];

  for (int j = tid; j < d; j += kThreads) {
    const float wj = p.w[(size_t)c * d + j];
    for (int s = 0; s < slots; ++s) ring[(size_t)s * d + j] = wj;
    if (kSvrg) {
      u0[j] = wj;
      mu[j] = p.mu[(size_t)c * d + j];
      acc[j] = 0.0f;
    }
  }
  const RowKeys rk = row_keys({(uint32_t)p.keys[2 * c], (uint32_t)p.keys[2 * c + 1]});
  int cur = 0;  // m mod (tau + 1): the ring slot of u_m
  for (int m = 0; m < p.total; ++m) {
    __syncthreads();  // the last step's update and header reads are done
    if (warp == 0) {
      const Step st = draw_step(rk, m, (uint32_t)p.n, p.mult, tau, delay_id, lane);
      if (lane == 0) {
        head->idx = st.idx;
        head->slot = st.age % slots;
        head->slot_b = min(st.age + 1, m) % slots;
        head->span = (float)(m - st.age + 1);
        head->read = st.read;
        head->drop = st.drop;
      }
    }
    __syncthreads();
    const Header e = *head;
    load_sample(p.tokens, p.targets, e.idx, nt, tok, tgt);
    for (int j = tid; j < d; j += kThreads) {
      ur[j] = ring[(size_t)reader_slot(scheme, e.slot, e.slot_b, e.span, e.read, slots, j) * d + j];
    }
    __syncthreads();
    sample_pass(ur, tok, tgt, A, nt, true);
    if (kSvrg) sample_pass(u0, tok, tgt, B, nt, true);
    const int next = cur + 1 == slots ? 0 : cur + 1;
    for (int j = tid; j < d; j += kThreads) {
      const float u = ring[(size_t)cur * d + j];
      float g = (float)grad_coord(A, tok, nt, j);
      const float keep = masked && !(uniform_at(e.drop, (uint32_t)j) < p.keep_p) ? 0.0f : 1.0f;
      float un;
      if (kSvrg) {
        float g0 = (float)grad_coord(B, tok, nt, j);
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
  }
  __syncthreads();
  for (int j = tid; j < d; j += kThreads) {  // cur = total mod (tau + 1)
    const float wj = kSvrg && p.option == 2 ? __fdiv_rn(acc[j], (float)p.total)
                                            : ring[(size_t)cur * d + j];
    p.out[(size_t)c * d + j] = wj;
    ur[j] = wj;
  }
  // the loss at the row's new iterate, its samples' float64 losses summed in order
  double total = 0.0;
  for (int i = 0; i < p.n; ++i) {
    __syncthreads();
    load_sample(p.tokens, p.targets, i, nt, tok, tgt);
    __syncthreads();
    sample_pass(ur, tok, tgt, A, nt, false);
    if (tid == 0) total += sample_loss(A, nt);
  }
  if (tid == 0) p.loss[c] = (float)(total / (double)p.n);
}

// mu = (1/n) sum_i grad f_i(w) (with kGrad; acc64 [C, d] float64 scratch) and f(w), per row.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
    full_kernel(const int* tokens, const int* targets, const float* w, double* acc64, float* mu,
                float* loss, Net nt, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = nt.d, c = blockIdx.x, tid = threadIdx.x;
  const Acts A = carve(reinterpret_cast<double*>(smem), nt);
  int* tok = reinterpret_cast<int*>(smem + 8 * acts_doubles(nt) + kHeaderBase);
  int* tgt = tok + nt.S;
  const float* wc = w + (size_t)c * d;
  double* ac = kGrad ? acc64 + (size_t)c * d : nullptr;
  if (kGrad) {
    for (int j = tid; j < d; j += kThreads) ac[j] = 0.0;
  }
  double total = 0.0;
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    load_sample(tokens, targets, i, nt, tok, tgt);
    __syncthreads();
    sample_pass(wc, tok, tgt, A, nt, kGrad);
    if (tid == 0) total += sample_loss(A, nt);
    if (kGrad) {
      for (int j = tid; j < d; j += kThreads) ac[j] += grad_coord(A, tok, nt, j);
    }
  }
  if (kGrad) {
    for (int j = tid; j < d; j += kThreads) mu[(size_t)c * d + j] = (float)(ac[j] / (double)n);
  }
  if (tid == 0) loss[c] = (float)(total / (double)n);
}

// g = grad f_i(w) for one row w [d] and one sample i.
__global__ void __launch_bounds__(kThreads)
    sample_grad_kernel(const int* tokens, const int* targets, int i, const float* w, float* g,
                       Net nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Acts A = carve(reinterpret_cast<double*>(smem), nt);
  int* tok = reinterpret_cast<int*>(smem + 8 * acts_doubles(nt) + kHeaderBase);
  int* tgt = tok + nt.S;
  load_sample(tokens, targets, i, nt, tok, tgt);
  __syncthreads();
  sample_pass(w, tok, tgt, A, nt, true);
  for (int j = threadIdx.x; j < nt.d; j += kThreads) g[j] = (float)grad_coord(A, tok, nt, j);
}

// Dynamic shared memory of one block: `sets` activation sets, the header and, with the vectors
// in shared memory, the read iterate, the ring and (AsySVRG) u0, mu, acc.
long long layout_bytes(const Net& nt, int sets, long long vector_count) {
  return 8 * sets * acts_doubles(nt) + header_bytes(nt) + 4LL * vector_count * nt.d;
}

template <typename K>
int opt_in(K kernel, long long bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // a refused size is reported here
  return (int)err;
}

bool bad_widths(long long S, long long V, long long D, long long H, int act) {
  return S <= 0 || S > kThreads || V <= 0 || D <= 0 || H <= 0 || act < 0 || act > 2 ||
         H + V * D + D + D * H + H * V >= (1LL << 31);
}

}  // namespace

// The most dynamic shared memory a block may opt in to on `device` (232,448 on an H100).
extern "C" long long sweep_epoch_mlp_max_shared_bytes(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != 0) {
    return -1;
  }
  return bytes;
}

// tokens, targets [n, S] int32; w [C, d], mu [C, d] (ignored by Hogwild!, may be null) float32;
// keys [C, 2] int64 holding uint32 words; step [C] float32; row_ints [3, C] int32 (tau, scheme,
// delay id); vecs [C, vectors, d] float32 or null (vectors in shared memory); out [C, d]; loss
// [C]: contiguous, on one device. engine: 0 = AsySVRG, 1 = Hogwild!; act: 0 relu, 1 gelu, 2
// silu; smem_bytes: the caller's size of the dynamic shared memory, which must equal this file's
// layout. Returns the CUDA error code of the launch (0 = success).
extern "C" int sweep_epoch_mlp_launch(const int* tokens, const int* targets, const float* w,
                                      const float* mu, const long long* keys, const float* step,
                                      const int* row_ints, float* vecs, float* out, float* loss,
                                      long long n, long long S, long long V, long long D,
                                      long long H, int act, long long C, long long total,
                                      long long buf_len, int engine, int option, int drop,
                                      long long smem_bytes, float keep_p, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || C <= 0 || total <= 0 || buf_len <= 0 || engine < 0 ||
      engine > 1 || bad_widths(S, V, D, H, act)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const bool svrg = engine == 0;
  const long long bytes =
      layout_bytes(nt, svrg ? 2 : 1, vecs == nullptr ? vectors(svrg, buf_len) : 0);
  if (bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  EpochParams p{tokens, targets, w, mu, keys, step, row_ints, vecs, out, loss, nt, (int)n,
                (int)C, (int)total, (int)buf_len, option, drop,
                fold_multiplier((uint32_t)n), keep_p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = svrg ? opt_in(epoch_kernel<true>, bytes) : opt_in(epoch_kernel<false>, bytes);
  if (err != 0) return err;
  if (svrg) {
    epoch_kernel<true><<<(unsigned)C, kThreads, (size_t)bytes, st>>>(p);
  } else {
    epoch_kernel<false><<<(unsigned)C, kThreads, (size_t)bytes, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// tokens, targets [n, S] int32; w [C, d] float32; acc64 [C, d] float64 scratch and mu [C, d]
// float32, both null for the loss alone; loss [C] float32.
extern "C" int sweep_epoch_mlp_full(const int* tokens, const int* targets, const float* w,
                                    double* acc64, float* mu, float* loss, long long n,
                                    long long S, long long V, long long D, long long H, int act,
                                    long long C, long long smem_bytes, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || C <= 0 || bad_widths(S, V, D, H, act) ||
      (mu == nullptr) != (acc64 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const long long bytes = layout_bytes(nt, 1, 0);
  if (bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool grad = mu != nullptr;
  int err = grad ? opt_in(full_kernel<true>, bytes) : opt_in(full_kernel<false>, bytes);
  if (err != 0) return err;
  if (grad) {
    full_kernel<true><<<(unsigned)C, kThreads, (size_t)bytes, st>>>(tokens, targets, w, acc64, mu,
                                                                     loss, nt, (int)n);
  } else {
    full_kernel<false><<<(unsigned)C, kThreads, (size_t)bytes, st>>>(tokens, targets, w, nullptr,
                                                                      nullptr, loss, nt, (int)n);
  }
  return (int)cudaGetLastError();
}

// g [d] = grad f_i(w) for w [d] float32 and sample i of tokens, targets [n, S] int32.
extern "C" int sweep_epoch_mlp_sample_grad(const int* tokens, const int* targets, long long n,
                                           long long i, const float* w, float* g, long long S,
                                           long long V, long long D, long long H, int act,
                                           long long smem_bytes, void* stream) {
  if (n <= 0 || i < 0 || i >= n || bad_widths(S, V, D, H, act)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const long long bytes = layout_bytes(nt, 1, 0);
  if (bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  int err = opt_in(sample_grad_kernel, bytes);
  if (err != 0) return err;
  sample_grad_kernel<<<1, kThreads, (size_t)bytes, static_cast<cudaStream_t>(stream)>>>(
      tokens, targets, (int)i, w, g, nt);
  return (int)cudaGetLastError();
}
