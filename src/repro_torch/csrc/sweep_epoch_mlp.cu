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
// and each gradient coordinate is a float64 sum over the positions, rounded to float32 once, as
// MLPObjective computes it, so the card and the CPU agree to float64 rounding. Every dot
// product is summed in the order of the plain version's loops (kernels/sweep_epoch_mlp/ref.py).
// The full gradient sums the samples' float64 gradients in sample order and rounds once; the
// loss sums the samples' float64 losses in sample order. The update is float32 with explicit
// round-to-nearest intrinsics in the batched engine's order (kernels/svrg_update).
//
// Bound on this card: operations, float64 ones. Per gradient ~2 S (D H + H V) multiply-adds
// forward, as many backward and ~2 S d for the per-coordinate sums; two gradients per AsySVRG
// update. The kernel sits far above that bound: each row is a chain of `total` dependent
// updates on C of the 132 SMs, bound by the latency of one update, not by its operations.
//
// Design: one CTA per row, warp-specialised. What the design takes off the chain is everything
// that does not depend on the previous update, and every barrier a position does not need.
//   * Position warps. Each gradient set (AsySVRG: at u_read and at u0, in disjoint warps at
//     the same time; Hogwild!: at u_read) has P = min(S, 8) warps; warp k of a set runs
//     positions k, k + P, ... of the sample. Every array from e to de is indexed by the
//     position, so a position's forward and backward run inside its warp, synchronised by
//     __syncwarp alone: e gathered, r by a shuffle sum, x-hat and x; h and act' with a lane
//     per hidden unit, summed over D in order; the logits, the log-sum-exp by shuffle max and
//     sum, dl; da, dx, c and de. A set's activations (float64, shared memory) are e (then
//     de), x-hat, x, dx [S, D]; h, act' (then da) [S, H]; the logits (then dl) [S, V].
//   * The iterates a pass reads (u_read, u0) are kept widened to float64, written once where
//     the coordinate phase (or the launch's start) writes them: a pass converts no weight.
//     The forward reads rows of w1 and w2 across the lanes; the backward (da = dl w2^T with a
//     lane per hidden unit, dx = da w1^T with a lane per model unit) reads their columns. So
//     each such iterate has, beside it, w2 and w1 transposed, w2t[v * H' + k] and
//     w1t[k * D' + i] with rows of odd length H' = H | 1, D' = D | 1: the lanes' reads are
//     contiguous, and the coordinate phase's writes of one warp fall in 32 banks. The
//     full-gradient block copies its row so (float64, transposed beside) when it fits.
//   * The coordinate phase. Only the weight-gradient sums cross positions: coordinate j of g
//     (and g0) is a sum over the S positions of two of those arrays, computed where the
//     update needs it by the consumer thread that owns j, so the gradient is never stored.
//     Thread t owns j = t, t + T, ... and walks them leaf by leaf, each leaf's row and column
//     carried along from cursors set once a launch (`plan_cells`): the phase divides nothing,
//     and a warp's cells are of one kind but at a leaf's edge. The same thread writes
//     u_{m+1}[j] into the ring and the next step's read iterate u_read[j] =
//     ring[slot_{m+1, j}][j] (and its transposed place): an update passes two barriers of the
//     consumer threads (bar.sync 1, T; the producer never joins them), one between the passes
//     and the coordinate phase, one between the update and the next passes.
//   * Registers. A block of at most 12 warps (AsySVRG at S <= 4, every Hogwild! block) runs an
//     instance of the kernel with up to 168 registers a thread, a larger one (up to 20 warps)
//     one with 96, where the compiler spills some of the pass's and the walk's state.
//   * Exact shortcuts. A division by S or D where it is a power of two is a multiplication by
//     2^-k, and a shuffle tree skips the levels whose partner lanes hold only the identity;
//     both give the bits of the plain division and of the full tree.
//   * The producer warpgroup: 4 warps beside the consumers, which never run a pass. It draws
//     step m + 1 while the consumers run step m and writes it into a two-stage queue in
//     shared memory, as K3's producer (csrc/sweep_epoch.cu) does: the step header (sample
//     index, read slots age mod (tau + 1) and min(age + 1, m) mod (tau + 1), the unlock
//     range m - age + 1, the read and drop keys) with the sample's tokens and targets, and,
//     for inconsistent and unlock rows, one word per coordinate: its reader's slot, with bit
//     31 set where an unlock row with drop_prob > 0 drops the coordinate. Each stage has a
//     full mbarrier (the 128 producer threads arrive) and an empty one (consumer 0 arrives
//     once every consumer is past the step's coordinate phase). A stage lives from the
//     coordinate phase before its step (its slots) to its step's own coordinate phase (its
//     tokens and drop bits), so the producer has one pass to draw a step. No threefry is
//     evaluated on the consumer warps. The per-coordinate hashes are the producer's whole
//     cost: at d 2096 an inconsistent row hashes 2096 threefry2x32 per step, ~16 per
//     producer thread, ~1.4k integer instructions, inside one pass; four warps, one on each
//     of the SM's sub-partitions, fill its integer pipes (16 lanes each), so more warps would
//     wait on the same pipes, and fewer would leave sub-partitions idle. Measured at d 2096
//     (PERF.md): an inconsistent row's epoch within a few per cent of a consistent
//     row's, which draws no words; an unlock row dropping coordinates hashes twice per
//     coordinate, and there the draws reach the chain.
//   * The loss: the epoch's closing loss and the loss entry run their n forwards over the
//     consumer warps at once, a warp per sample (its positions in order, its own position
//     slice of a set), each sample's float64 loss into a cell of shared memory (that slice's
//     dx, which a forward leaves alone); thread 0 adds the cells in sample order.
//   * The full gradient spreads its samples over the warps of the row's block: `sets`
//     samples at once (at most 16 / P, as many as fit in shared memory), each a gradient set
//     with its own position warps; then each thread adds, for its coordinates, the batch's
//     samples' float64 gradients to the row's float64 sum in sample order. More CTAs per row
//     would have to meet in device memory with every sample's float64 gradient (n d 8 bytes
//     per row) and add them in sample order in a second pass; a row's warps meet in shared
//     memory and need no scratch beyond the [C, d] sum.
//   * The row's state (`row_bytes`): u_read and (AsySVRG) u0, each float64 with its
//     transposed copy, then float32 the ring of buf_len iterates, mu and acc (AsySVRG) and
//     the two stages of per-coordinate words. It lives in shared memory, or in a device
//     buffer of `row_bytes` a row that the wrapper passes where it does not fit
//     (kernels/sweep_epoch_mlp/ops.py picks by size). The wrapper passes the bytes and the
//     threads; the launch fails with cudaErrorInvalidValue where they disagree with this
//     file's layout:
//       epoch: activations (sets 8 S (4 D + 2 H + V)) | queue (2 (48 + 8 S), to 16 bytes) |
//              the row's state (8 sets (d + V H' + H D') + 4 (buf_len + 2 [AsySVRG] + 2) d,
//              to 16 bytes; shared placement only); threads 32 (sets P + 4);
//       full gradient, loss and sample gradient: `sets` samples, each its activations and
//              its positions' losses, 8 S (4 D + 2 H + V + 1), then with `staged` the row
//              and its transposed copy (8 (d + V H' + H D')); threads 32 sets P.
//   * A row's result never depends on the other rows of its launch: no sum crosses rows. A
//     mbarrier wait that outlasts 2^24 tries traps, so a broken pipeline fails its launch.
// Not here, and why:
//   * The float64 tensor cores (mma.sync.m8n8k4.f64): a position's products are one row of at
//     most S <= 8 by D <= 64 or H; DMMA's fixed 8-row tile would reorder the float64 sums, and
//     the chain is bound by latency, not by operations.
//   * A cluster of CTAs per row for the wide widths (d 98624), where one SM's coordinate phase
//     walks the whole row in device memory at every update.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"
#include "jax_prng.cuh"

namespace {

constexpr int kPosWarps = 8;       // most warps of one gradient set
constexpr int kProducerWarps = 4;  // the producer warpgroup
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kEpochThreads = 32 * (2 * kPosWarps + kProducerWarps);
constexpr int kSmallBlock = 384;  // 12 warps: AsySVRG at S <= 4, Hogwild! at S <= 8
constexpr int kFullWarps = 16;  // most warps of a full-gradient or loss block
constexpr int kStages = 2;      // the producer's queue depth
constexpr int kMaxSeq = 256;
constexpr double kRmsEps = 1e-6;  // models.layers.rmsnorm's
constexpr long long kStageBase = 48;  // two mbarriers and the step header, before the tokens
constexpr uint32_t kDropped = 0x80000000u;

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

__host__ __device__ __forceinline__ int position_warps(int S) { return S < kPosWarps ? S : kPosWarps; }

__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

// One iterate's transposed copies, w2t [V, H'] then w1t [H, D'], in floats.
__host__ __device__ __forceinline__ long long trans_floats(const Net& nt) {
  return (long long)nt.V * odd(nt.H) + (long long)nt.H * odd(nt.D);
}

// One gradient set's activations, in doubles.
__host__ __device__ __forceinline__ long long acts_doubles(const Net& nt) {
  return (long long)nt.S * (4LL * nt.D + 2LL * nt.H + nt.V);
}

__host__ __device__ __forceinline__ long long stage_bytes(const Net& nt) {
  return kStageBase + 8LL * nt.S;
}

__host__ __device__ __forceinline__ long long queue_bytes(const Net& nt) {
  return (kStages * stage_bytes(nt) + 15) / 16 * 16;
}

// One set's activations and their gradients (float64, shared memory): [S, D] e (then de), nh,
// x, dx; [S, H] h, ad (act', then da); [S, V] lg (the logits, then dl).
struct Acts {
  double *e, *nh, *x, *dx, *h, *ad, *lg;
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
  return a;
}

// Where the backward reads w2[k, v] and w1[i, k] of an iterate: w2b[k * w2k + v * w2v] and
// w1b[i * w1i + k * w1k], in the row itself or in its transposed copies. W: float for a row
// read where it lies in device memory, double for the iterates a block keeps (the float32
// values widened once, where they are written, not at every read).
template <typename W>
struct Back {
  const W* w2b;
  int w2k, w2v;
  const W* w1b;
  int w1i, w1k;
};

template <typename W>
__device__ __forceinline__ Back<W> natural(const W* w, const Net& nt) {
  return {w + nt.o_w2, nt.V, 1, w + nt.o_w1, nt.H, 1};
}

template <typename W>
__device__ __forceinline__ Back<W> transposed(const W* t, const Net& nt) {
  return {t, 1, odd(nt.H), t + (size_t)nt.V * odd(nt.H), 1, odd(nt.D)};
}

// The step the producer hands to the consumers, before the sample's tokens and targets.
struct Header {
  int idx, slot, slot_b;
  float span;
  Key read, drop;
};
static_assert(sizeof(Header) + 2 * sizeof(uint64_t) <= kStageBase, "step header too large");

// One stage of the queue: [full mbarrier | empty mbarrier | Header | tok [S] | tgt [S]].
struct Stage {
  uint32_t full, empty;
  Header* head;
  int* tok;
  int* tgt;
};

__device__ __forceinline__ Stage stage_at(unsigned char* queue, const Net& nt, int s) {
  unsigned char* p = queue + s * stage_bytes(nt);
  Stage st;
  st.full = smem_addr(p);
  st.empty = smem_addr(p + 8);
  st.head = reinterpret_cast<Header*>(p + 16);
  st.tok = reinterpret_cast<int*>(p + kStageBase);
  st.tgt = st.tok + nt.S;
  return st;
}

// The sum (and the max) over a warp's lanes by a fixed xor tree, where only lanes 0 .. n - 1 can
// hold other than the identity (+0.0 for a sum, -inf for a max): the tree's levels whose
// partners all lie past lane n - 1 add the identity to lanes 0 .. n - 1, so they are skipped,
// and those lanes get the full tree's value; lanes from n on hold no total.
__device__ __forceinline__ double warp_sum(double v, int n) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < n) v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__device__ __forceinline__ double warp_max(double v, int n) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < n) v = fmax(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// x / n for a count n >= 1, as the plain version divides: where n is a power of two the quotient
// is x times 2^-k, exactly, and the division's latency is saved.
__device__ __forceinline__ double div_count(double x, int n) {
  if (n & (n - 1)) return x / (double)n;
  const long long k = __ffs(n) - 1;
  return __dmul_rn(x, __longlong_as_double((1023 - k) << 52));
}

// named barrier 1 over the block's first `threads` threads
__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
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

// One position (token `tok`, target `tgt`) through the network at the flat row w (float32
// values, as float or widened to double; shared or device memory), inside one warp, in slice
// `q` of the set A: the forward and, with `grad`, the backward (lg becomes dl, ad da, e de, dx
// dx), reading w2 and w1 through `bk`. Returns the position's loss term logsumexp(l) - l[tgt]
// on every lane. Every lane of the warp calls it.
template <typename W>
__device__ double position_pass(const W* w, const Back<W>& bk, int tok, int tgt, const Acts& A,
                                const Net& nt, int q, bool grad, int lane) {
  const int S = nt.S, V = nt.V, D = nt.D, H = nt.H;
  const W* b1 = w;
  const W* erow = w + nt.o_emb + (size_t)tok * D;
  const W* nrm = w + nt.o_norm;
  const W* w1 = w + nt.o_w1;
  const W* w2 = w + nt.o_w2;
  double* e = A.e + (size_t)q * D;
  double* nh = A.nh + (size_t)q * D;
  double* x = A.x + (size_t)q * D;
  double* dx = A.dx + (size_t)q * D;
  double* h = A.h + (size_t)q * H;
  double* ad = A.ad + (size_t)q * H;
  double* lg = A.lg + (size_t)q * V;
  double ss = 0.0;
  for (int i = lane; i < D; i += 32) {
    const double v = (double)erow[i];
    e[i] = v;
    ss += v * v;
  }
  ss = warp_sum(ss, D);
  const double r = 1.0 / sqrt(div_count(ss, D) + kRmsEps);
  for (int i = lane; i < D; i += 32) {
    const double v = e[i] * r;
    nh[i] = v;
    x[i] = v * (1.0 + (double)nrm[i]);
  }
  __syncwarp();
  for (int k = lane; k < H; k += 32) {
    double z = 0.0;
#pragma unroll 4
    for (int i = 0; i < D; ++i) z += x[i] * (double)w1[(size_t)i * H + k];
    double deriv;
    h[k] = activate(nt.act, z + (double)b1[k], &deriv);
    ad[k] = deriv;
  }
  __syncwarp();
  for (int v = lane; v < V; v += 32) {
    double z = 0.0;
#pragma unroll 4
    for (int k = 0; k < H; ++k) z += h[k] * (double)w2[(size_t)k * V + v];
    lg[v] = z;
  }
  __syncwarp();
  double mx = -INFINITY;
  for (int v = lane; v < V; v += 32) mx = fmax(mx, lg[v]);
  mx = warp_max(mx, V);
  double se = 0.0;
  for (int v = lane; v < V; v += 32) se += exp(lg[v] - mx);
  se = warp_sum(se, V);
  const double lse = mx + log(se);
  const double term = lse - lg[tgt];
  if (!grad) return term;
  __syncwarp();  // every lane has read lg[tgt]
  for (int v = lane; v < V; v += 32) {
    lg[v] = div_count(exp(lg[v] - lse) - (v == tgt ? 1.0 : 0.0), S);
  }
  __syncwarp();
  for (int k = lane; k < H; k += 32) {  // da = (dl w2^T) act'(a)
    const W* col = bk.w2b + (size_t)k * bk.w2k;
    double z = 0.0;
#pragma unroll 4
    for (int v = 0; v < V; ++v) z += lg[v] * (double)col[(size_t)v * bk.w2v];
    ad[k] = z * ad[k];
  }
  __syncwarp();
  double c = 0.0;  // c = sum_i dnh_i e_i, dnh = dx (1 + norm)
  for (int i = lane; i < D; i += 32) {  // dx = da w1^T
    const W* col = bk.w1b + (size_t)i * bk.w1i;
    double z = 0.0;
#pragma unroll 4
    for (int k = 0; k < H; ++k) z += ad[k] * (double)col[(size_t)k * bk.w1k];
    dx[i] = z;
    c += z * (1.0 + (double)nrm[i]) * e[i];
  }
  c = warp_sum(c, D);
  for (int i = lane; i < D; i += 32) {  // de = r dnh - r^3 e c / D, into e
    const double dnh = dx[i] * (1.0 + (double)nrm[i]);
    e[i] = r * dnh - div_count(r * r * r * e[i] * c, D);
  }
  __syncwarp();
  return term;
}

// The leaves of the flat row, as the coordinate walks name them.
enum { kB1, kEmbed, kNorm, kW1, kW2 };
template <int K>
struct Kind {
  static constexpr int value = K;
};

// The gradient's coordinate of leaf K at row a, column b (b1[a], embed[a, b], norm[a],
// w1[a, b], w2[a, b]) after every position's pass with `grad`: a sum over the positions, in
// order; with kTwo the same coordinate of a second set B into gb, alongside.
template <int K, bool kTwo>
__device__ __forceinline__ void cell_grad(const Acts& A, const Acts& B, const int* tok,
                                          const Net& nt, int a, int b, double& ga, double& gb) {
  const int S = nt.S, V = nt.V, D = nt.D, H = nt.H;
  ga = 0.0;
  gb = 0.0;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    if (K == kB1) {
      ga += A.ad[s * H + a];
      if (kTwo) gb += B.ad[s * H + a];
    }
    if (K == kEmbed && tok[s] == a) {  // the positions holding token a
      ga += A.e[s * D + b];
      if (kTwo) gb += B.e[s * D + b];
    }
    if (K == kNorm) {
      ga += A.dx[s * D + a] * A.nh[s * D + a];
      if (kTwo) gb += B.dx[s * D + a] * B.nh[s * D + a];
    }
    if (K == kW1) {
      ga += A.x[s * D + a] * A.ad[s * H + b];
      if (kTwo) gb += B.x[s * D + a] * B.ad[s * H + b];
    }
    if (K == kW2) {
      ga += A.h[s * H + a] * A.lg[s * V + b];
      if (kTwo) gb += B.h[s * H + a] * B.lg[s * V + b];
    }
  }
}

// A thread's first cell q0 = r0 cols + c0 in one leaf of the flat row and its stride T = dr cols
// + dc, so that the walk over the leaf needs no division.
struct Cursor {
  int q0, r0, c0, dr, dc;
};

// The cursors of thread `tid` of T, which owns coordinates j = tid, tid + T, ... of the row.
struct Cells {
  Cursor b1, emb, norm, w1, w2;
};

__device__ __forceinline__ Cursor cursor(int offset, int cols, int tid, int T) {
  int q0 = tid - offset % T;  // the leaf's first cell that is the thread's
  if (q0 < 0) q0 += T;
  const int r0 = q0 / cols, dr = T / cols;
  return {q0, r0, q0 - r0 * cols, dr, T - dr * cols};
}

__device__ __forceinline__ Cells plan_cells(const Net& nt, int tid, int T) {
  return {cursor(0, nt.H, tid, T), cursor(nt.o_emb, nt.D, tid, T), cursor(nt.o_norm, nt.D, tid, T),
          cursor(nt.o_w1, nt.H, tid, T), cursor(nt.o_w2, nt.V, tid, T)};
}

// Calls f(r, c, q) for the cells q = r cols + c of a [rows, cols] leaf from cursor u on.
template <typename F>
__device__ __forceinline__ void walk(const Cursor& u, int rows, int cols, int T, F f) {
  int r = u.r0, c = u.c0;
  for (int q = u.q0; q < rows * cols; q += T) {
    f(r, c, q);
    r += u.dr;
    c += u.dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Calls f(Kind<K>(), j, a, b, t) for each coordinate j of the flat row that the cells' thread
// owns, leaf by leaf (K, a and b as cell_grad takes them), t its place in the transposed copies
// or -1.
template <typename F>
__device__ __forceinline__ void for_each_cell(const Net& nt, const Cells& cl, int T, F f) {
  const int V = nt.V, D = nt.D, H = nt.H, sH = odd(H), sD = odd(D);
  for (int k = cl.b1.q0; k < H; k += T) f(Kind<kB1>(), k, k, 0, -1);
  walk(cl.emb, V, D, T, [&](int t, int i, int q) { f(Kind<kEmbed>(), nt.o_emb + q, t, i, -1); });
  for (int i = cl.norm.q0; i < D; i += T) f(Kind<kNorm>(), nt.o_norm + i, i, 0, -1);
  walk(cl.w1, D, H, T,
       [&](int i, int k, int q) { f(Kind<kW1>(), nt.o_w1 + q, i, k, V * sH + k * sD + i); });
  walk(cl.w2, H, V, T,
       [&](int k, int v, int q) { f(Kind<kW2>(), nt.o_w2 + q, k, v, v * sH + k); });
}

// The row w [d] (and its transposed copy at wt), widened to double, from src, by the block's
// threads.
__device__ __forceinline__ void copy_row(double* w, double* wt, const float* src, const Net& nt) {
  const Cells cl = plan_cells(nt, threadIdx.x, blockDim.x);
  for_each_cell(nt, cl, blockDim.x, [&](auto, int j, int, int, int t) {
    const double v = (double)src[j];
    w[j] = v;
    if (t >= 0) wt[t] = v;
  });
}

// sum_i f_i(w) over the n samples, by the block's first T threads (named barrier 1): warp k
// runs whole samples k, k + T / 32, ..., position after position, in slice k mod P of set
// k / P (sets `stride` doubles apart from `base`), and leaves each sample's float64 loss in
// that slice's dx, which a forward does not touch; thread 0 adds them in sample order and
// alone holds the sum.
template <typename Wt>
__device__ double rows_loss(const Wt* w, const int* tokens, const int* targets, int n,
                            double* base, long long stride, const Net& nt, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int S = nt.S, P = position_warps(S);
  const Acts A = carve(base + (warp / P) * stride, nt);
  const int slot = warp % P;
  const Back<Wt> bk = natural(w, nt);  // a forward reads no column
  double total = 0.0;
  for (int i0 = 0; i0 < n; i0 += W) {
    const int i = i0 + warp;
    if (i < n) {
      double s = 0.0;
      for (int q = 0; q < S; ++q) {
        s += position_pass(w, bk, tokens[(size_t)i * S + q], targets[(size_t)i * S + q], A, nt,
                           slot, false, lane);
      }
      if (lane == 0) A.dx[(size_t)slot * nt.D] = s / S;
    }
    bar_sync(T);
    if (tid == 0) {
      for (int k = 0; k < W && i0 + k < n; ++k) {
        total += carve(base + (k / P) * stride, nt).dx[(size_t)(k % P) * nt.D];
      }
    }
    bar_sync(T);
  }
  return total;
}

struct EpochParams {
  const int* tokens;
  const int* targets;
  const float* w;
  const float* mu;
  const long long* keys;
  const float* step;
  const int* row_ints;  // [3, C]: tau, scheme id, delay id
  float* vecs;          // [C, row_bytes / 4] in device memory: the global placement
  float* out;
  float* loss;
  Net nt;
  int n, C, total, buf_len, option, drop;
  uint32_t mult;
  float keep_p;
};

// A row's state beside its activations, in bytes: the iterates the passes read, widened to
// double with their transposed copies (u_read; u0 for AsySVRG), then the float32 ring of buf_len
// iterates, mu and acc (AsySVRG) and the two stages of per-coordinate words; to 16 bytes.
__host__ __device__ __forceinline__ long long row_bytes(const Net& nt, bool svrg,
                                                        long long buf_len) {
  const long long sets = svrg ? 2 : 1;
  const long long floats = (buf_len + (svrg ? 2 : 0) + kStages) * nt.d;
  return (8 * sets * (nt.d + trans_floats(nt)) + 4 * floats + 15) / 16 * 16;
}

// The producer warpgroup: steps 0 .. total - 1 into the queue; q is the thread's index in it.
__device__ void produce(const EpochParams& p, unsigned char* queue, uint32_t* words, int tau,
                        int scheme, int delay_id, bool per_coord, bool masked, int q) {
  const Net& nt = p.nt;
  const int c = blockIdx.x, d = nt.d, S = nt.S, slots = tau + 1, lane = q & 31;
  const RowKeys rk = row_keys({(uint32_t)p.keys[2 * c], (uint32_t)p.keys[2 * c + 1]});
  for (int m = 0; m < p.total; ++m) {
    const int s = m % kStages, round = m / kStages;
    const Step st = draw_step(rk, m, (uint32_t)p.n, p.mult, tau, delay_id, lane);
    const int slot = st.age % slots;
    const int slot_b = min(st.age + 1, m) % slots;
    const float span = (float)(m - st.age + 1);
    const Stage sg = stage_at(queue, nt, s);
    mbar_wait(sg.empty, (round & 1) ^ 1);  // round 0 passes: the stage starts empty
    if (q == 0) *sg.head = Header{st.idx, slot, slot_b, span, st.read, st.drop};
    for (int k = q; k < S; k += kProducers) {
      sg.tok[k] = p.tokens[(size_t)st.idx * S + k];
      sg.tgt[k] = p.targets[(size_t)st.idx * S + k];
    }
    if (per_coord) {
      uint32_t* wd = words + (size_t)s * d;
#pragma unroll 4
      for (int j = q; j < d; j += kProducers) {
        uint32_t word = (uint32_t)reader_slot(scheme, slot, slot_b, span, st.read, slots, j);
        if (masked && !(uniform_at(st.drop, (uint32_t)j) < p.keep_p)) word |= kDropped;
        wd[j] = word;
      }
    }
    mbar_arrive(sg.full);  // releases this thread's writes
  }
}

// What the coordinate phase of one step updates: the row's vectors, the step's words, the ring
// slots of u_m and u_{m+1}, and for the next step (with `more`) its read slots.
struct Chain {
  double *ur, *urt;
  float *ring, *mu, *acc;
  const uint32_t *wd, *wn;
  int d, cur, next, rs_all;
  float step;
  bool masked, per_coord, more;
};

// Coordinate j's update from its gradients ga (at u_read) and gb (at u0), as the batched engine
// orders it, then u_read[j] of the next step (t: its place in the transposed copy, or -1).
template <bool kSvrg>
__device__ __forceinline__ void update(const Chain& ch, int j, int t, double ga, double gb) {
  const float u = ch.ring[(size_t)ch.cur * ch.d + j];
  float g = (float)ga;
  const float keep = ch.masked && (ch.wd[j] & kDropped) ? 0.0f : 1.0f;
  float un;
  if (kSvrg) {
    float g0 = (float)gb;
    float gf = ch.mu[j];
    if (ch.masked) {
      g = __fmul_rn(g, keep);
      g0 = __fmul_rn(g0, keep);
      gf = __fmul_rn(gf, keep);
    }
    un = __fsub_rn(u, __fmul_rn(ch.step, __fadd_rn(__fsub_rn(g, g0), gf)));
    ch.acc[j] = __fadd_rn(ch.acc[j], un);
  } else {
    if (ch.masked) g = __fmul_rn(g, keep);
    un = __fsub_rn(u, __fmul_rn(ch.step, g));
  }
  ch.ring[(size_t)ch.next * ch.d + j] = un;
  if (ch.more) {
    const int rs = ch.per_coord ? (int)(ch.wn[j] & ~kDropped) : ch.rs_all;
    const float r = rs == ch.next ? un : ch.ring[(size_t)rs * ch.d + j];
    ch.ur[j] = (double)r;
    if (t >= 0) ch.urt[t] = (double)r;
  }
}

// kShared: the vectors, the words and the transposed copies in shared memory (else in p.vecs).
// kBlock: the most threads of a block it runs, which sets its registers (65,536 / kBlock).
template <bool kSvrg, bool kShared, int kBlock>
__global__ void __launch_bounds__(kBlock) epoch_kernel(EpochParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Net nt = p.nt;
  const int d = nt.d, S = nt.S, c = blockIdx.x;
  const int P = position_warps(S);
  const int T = 32 * (kSvrg ? 2 : 1) * P;  // consumers; the producer warpgroup follows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long na = acts_doubles(nt), tw = trans_floats(nt);
  double* base = reinterpret_cast<double*>(smem);
  unsigned char* queue = smem + 8 * na * (kSvrg ? 2 : 1);
  // the row's state: [ur, urt | u0, u0t] double, then ring, mu, acc, words
  unsigned char* row = kShared ? queue + queue_bytes(nt)
                               : reinterpret_cast<unsigned char*>(p.vecs) +
                                     (size_t)c * row_bytes(nt, kSvrg, p.buf_len);
  double* ur = reinterpret_cast<double*>(row);
  double* urt = ur + d;
  double* u0 = urt + tw;  // u0, u0t, mu, acc: AsySVRG only
  double* u0t = u0 + d;
  float* ring = reinterpret_cast<float*>(kSvrg ? u0t + tw : urt + tw);
  float* mu = ring + (size_t)p.buf_len * d;
  float* acc = mu + d;
  uint32_t* words = reinterpret_cast<uint32_t*>(kSvrg ? acc + d : mu);
  const int tau = p.row_ints[c], scheme = p.row_ints[p.C + c], delay_id = p.row_ints[2 * p.C + c];
  const int slots = tau + 1;
  const bool masked = p.drop && scheme == 2;
  const bool per_coord = scheme != 0 || masked;

  if (tid == T) {
    for (int s = 0; s < kStages; ++s) {
      const Stage sg = stage_at(queue, nt, s);
      mbar_init(sg.full, kProducers);
      mbar_init(sg.empty, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const Cells cl = plan_cells(nt, tid, T);
  if (tid < T) {
    const float* wc = p.w + (size_t)c * d;
    for_each_cell(nt, cl, T, [&](auto, int j, int, int, int t) {
      const float wj = wc[j];
      for (int s = 0; s < slots; ++s) ring[(size_t)s * d + j] = wj;
      ur[j] = wj;  // every slot holds w: step 0 reads w whatever its slots
      if (t >= 0) urt[t] = wj;
      if (kSvrg) {
        u0[j] = wj;
        if (t >= 0) u0t[t] = wj;
        mu[j] = p.mu[(size_t)c * d + j];
        acc[j] = 0.0f;
      }
    });
  }
  __syncthreads();  // the block's last barrier: the producer leaves after its loop
  if (tid >= T) {
    produce(p, queue, words, tau, scheme, delay_id, per_coord, masked, tid - T);
    return;
  }

  // consumers: warp k runs set k / P (0 at u_read, 1 at u0) at positions k mod P, + P, ...
  const int set = warp / P, pw = warp - set * P;
  const Acts A = carve(base, nt);
  const Acts B = carve(base + (kSvrg ? na : 0), nt);
  const Acts mine = carve(base + set * na, nt);
  const double* wmine = ur + set * (d + tw);  // u_read, or u0 [d] beside u_read's copy
  const Back<double> bk = transposed(urt + set * (d + tw), nt);
  Chain ch{ur, urt, ring, mu, acc, nullptr, nullptr, d, 0, 0, 0, p.step[c], masked, per_coord,
           false};
  mbar_wait(stage_at(queue, nt, 0).full, 0);
  for (int m = 0; m < p.total; ++m) {
    const Stage cs = stage_at(queue, nt, m % kStages);
    for (int q = pw; q < S; q += P) {
      position_pass(wmine, bk, cs.tok[q], cs.tgt[q], mine, nt, q, true, lane);
    }
    bar_sync(T);  // every position's pass is done
    ch.more = m + 1 < p.total;
    const Stage ns = stage_at(queue, nt, (m + 1) % kStages);
    if (ch.more) mbar_wait(ns.full, ((m + 1) / kStages) & 1);
    ch.rs_all = ns.head->slot;  // the next step's slot of every coordinate (consistent)
    ch.wd = words + (size_t)(m % kStages) * d;
    ch.wn = words + (size_t)((m + 1) % kStages) * d;
    ch.next = ch.cur + 1 == slots ? 0 : ch.cur + 1;
    for_each_cell(nt, cl, T, [&](auto kind, int j, int a, int b, int t) {
      double ga, gb;
      cell_grad<decltype(kind)::value, kSvrg>(A, B, cs.tok, nt, a, b, ga, gb);
      update<kSvrg>(ch, j, t, ga, gb);
    });
    ch.cur = ch.next;
    bar_sync(T);  // the update and the next read iterate are written
    if (tid == 0) mbar_arrive(cs.empty);  // every consumer is done with step m's stage
  }
  for (int j = tid; j < d; j += T) {  // cur = total mod (tau + 1)
    const float wj = kSvrg && p.option == 2 ? __fdiv_rn(acc[j], (float)p.total)
                                            : ring[(size_t)ch.cur * d + j];
    p.out[(size_t)c * d + j] = wj;
    ur[j] = wj;
  }
  bar_sync(T);
  // the loss at the row's new iterate, its samples' float64 losses summed in order
  const double total = rows_loss(ur, p.tokens, p.targets, p.n, base, na, nt, T);
  if (tid == 0) p.loss[c] = (float)(total / (double)p.n);
}

// The row of a full-gradient, loss or sample-gradient block: with kStaged, w [d] and its
// transposed copy widened to double in shared memory after the block's `sets` sets, else the
// float32 row where it lies; and where its backward reads w2 and w1.
template <bool kStaged>
struct Row {
  using W = typename std::conditional<kStaged, double, float>::type;
  const W* w;
  Back<W> bk;
};

template <bool kStaged>
__device__ Row<kStaged> stage_row(const float* w, unsigned char* smem, const Net& nt, int sets) {
  if constexpr (kStaged) {
    double* ws = reinterpret_cast<double*>(smem + 8 * sets * (acts_doubles(nt) + nt.S));
    double* wt = ws + nt.d;
    copy_row(ws, wt, w, nt);
    bar_sync(blockDim.x);
    return {ws, transposed<double>(wt, nt)};
  } else {
    return {w, natural(w, nt)};
  }
}

// mu = (1/n) sum_i grad f_i(w) (with kGrad; acc64 [C, d] float64 scratch) and f(w), per row,
// `sets` samples at once: set b (its activations, then its positions' losses [S]) takes
// sample i0 + b of each batch.
template <bool kGrad, bool kStaged>
__global__ void __launch_bounds__(32 * kFullWarps)
    full_kernel(const int* tokens, const int* targets, const float* w, double* acc64, float* mu,
                float* loss, Net nt, int n, int sets) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = nt.d, S = nt.S, c = blockIdx.x, T = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, P = position_warps(S);
  const long long stride = acts_doubles(nt) + S;
  double* base = reinterpret_cast<double*>(smem);
  const Row<kStaged> rw = stage_row<kStaged>(w + (size_t)c * d, smem, nt, sets);
  if (!kGrad) {
    const double total = rows_loss(rw.w, tokens, targets, n, base, stride, nt, T);
    if (tid == 0) loss[c] = (float)(total / (double)n);
    return;
  }
  double* ac = acc64 + (size_t)c * d;
  for (int j = tid; j < d; j += T) ac[j] = 0.0;
  const Cells cl = plan_cells(nt, tid, T);
  const int set = warp / P, pw = warp - set * P;
  const Acts mine = carve(base + set * stride, nt);
  double total = 0.0;
  for (int i0 = 0; i0 < n; i0 += sets) {
    const int i = i0 + set;
    if (i < n) {
      double* ls = base + set * stride + acts_doubles(nt);
      for (int q = pw; q < S; q += P) {
        const double term = position_pass(rw.w, rw.bk, tokens[(size_t)i * S + q],
                                          targets[(size_t)i * S + q], mine, nt, q, true, lane);
        if (lane == 0) ls[q] = term;
      }
    }
    bar_sync(T);
    const int batch = min(sets, n - i0);
    if (tid == 0) {
      for (int b = 0; b < batch; ++b) {
        const double* ls = base + b * stride + acts_doubles(nt);
        double s = 0.0;
        for (int q = 0; q < S; ++q) s += ls[q];
        total += s / S;
      }
    }
    for_each_cell(nt, cl, T, [&](auto kind, int j, int a, int b, int) {
      double g = ac[j];
      for (int k = 0; k < batch; ++k) {
        const Acts X = carve(base + k * stride, nt);
        double gk, unused;
        cell_grad<decltype(kind)::value, false>(X, X, tokens + (size_t)(i0 + k) * S, nt, a, b,
                                                gk, unused);
        g += gk;
      }
      ac[j] = g;
    });
    bar_sync(T);
  }
  for (int j = tid; j < d; j += T) mu[(size_t)c * d + j] = (float)(ac[j] / (double)n);
  if (tid == 0) loss[c] = (float)(total / (double)n);
}

// g = grad f_i(w) for one row w [d] and one sample i.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kPosWarps)
    sample_grad_kernel(const int* tokens, const int* targets, int i, const float* w, float* g,
                       Net nt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = nt.S, P = position_warps(S), lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Acts A = carve(reinterpret_cast<double*>(smem), nt);
  const int* tok = tokens + (size_t)i * S;
  const Row<kStaged> rw = stage_row<kStaged>(w, smem, nt, 1);
  for (int q = warp; q < S; q += P) {
    position_pass(rw.w, rw.bk, tok[q], targets[(size_t)i * S + q], A, nt, q, true, lane);
  }
  __syncthreads();
  for_each_cell(nt, plan_cells(nt, threadIdx.x, blockDim.x), blockDim.x,
                [&](auto kind, int j, int a, int b, int) {
    double gj, unused;
    cell_grad<decltype(kind)::value, false>(A, A, tok, nt, a, b, gj, unused);
    g[j] = (float)gj;
  });
}

// Dynamic shared memory of an epoch block: the activation sets, the queue and, in the shared
// placement, the per-coordinate words, the vectors and the transposed copies.
long long epoch_bytes(const Net& nt, bool svrg, bool shared, long long buf_len) {
  return 8 * (svrg ? 2 : 1) * acts_doubles(nt) + queue_bytes(nt) +
         (shared ? row_bytes(nt, svrg, buf_len) : 0);
}

// Dynamic shared memory of a full-gradient, loss or sample-gradient block of `sets` samples,
// with `staged` the row and its transposed copy (double) too.
long long full_bytes(const Net& nt, int sets, bool staged) {
  return 8LL * sets * (acts_doubles(nt) + nt.S) + (staged ? 8 * (nt.d + trans_floats(nt)) : 0);
}

template <bool kGrad, bool kStaged>
int launch_full(const int* tokens, const int* targets, const float* w, double* acc64, float* mu,
                float* loss, const Net& nt, int n, int C, int sets, long long block,
                long long bytes, cudaStream_t st) {
  const int err = opt_in(full_kernel<kGrad, kStaged>, bytes);
  if (err != 0) return err;
  full_kernel<kGrad, kStaged><<<(unsigned)C, (unsigned)block, (size_t)bytes, st>>>(
      tokens, targets, w, acc64, mu, loss, nt, n, sets);
  return (int)cudaGetLastError();
}

template <typename K>
int opt_in(K kernel, long long bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // a refused size is reported here
  return (int)err;
}

template <bool kSvrg, bool kShared, int kBlock>
int launch_tier(const EpochParams& p, long long block, long long bytes, cudaStream_t st) {
  const int err = opt_in(epoch_kernel<kSvrg, kShared, kBlock>, bytes);
  if (err != 0) return err;
  epoch_kernel<kSvrg, kShared, kBlock><<<(unsigned)p.C, (unsigned)block, (size_t)bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// Blocks of at most kSmallBlock threads (S <= 4 for AsySVRG, every Hogwild! block) take the
// instance with 168 registers a thread, the rest the one with 96.
template <bool kSvrg, bool kShared>
int launch_epoch(const EpochParams& p, long long block, long long bytes, cudaStream_t st) {
  return block <= kSmallBlock ? launch_tier<kSvrg, kShared, kSmallBlock>(p, block, bytes, st)
                              : launch_tier<kSvrg, kShared, kEpochThreads>(p, block, bytes, st);
}

bool bad_widths(long long S, long long V, long long D, long long H, int act) {
  return S <= 0 || S > kMaxSeq || V <= 0 || D <= 0 || H <= 0 || act < 0 || act > 2 ||
         H + V * D + D + D * H + H * V >= (1LL << 31) ||
         V * (H | 1) + H * (D | 1) >= (1LL << 31);
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
// delay id); vecs [C, row_bytes / 4] float32 (the global placement) or null (all in shared
// memory); out [C, d]; loss [C]: contiguous, on one device. engine: 0 = AsySVRG, 1 = Hogwild!;
// act: 0 relu, 1 gelu, 2 silu; smem_bytes and threads: the caller's size of the dynamic shared
// memory and of the block, which must equal this file's layout. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int sweep_epoch_mlp_launch(const int* tokens, const int* targets, const float* w,
                                      const float* mu, const long long* keys, const float* step,
                                      const int* row_ints, float* vecs, float* out, float* loss,
                                      long long n, long long S, long long V, long long D,
                                      long long H, int act, long long C, long long total,
                                      long long buf_len, int engine, int option, int drop,
                                      long long smem_bytes, long long threads, float keep_p,
                                      void* stream) {
  if (n <= 0 || n >= (1LL << 31) || C <= 0 || total <= 0 || buf_len <= 0 || engine < 0 ||
      engine > 1 || bad_widths(S, V, D, H, act)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const bool svrg = engine == 0, shared = vecs == nullptr;
  const long long bytes = epoch_bytes(nt, svrg, shared, buf_len);
  const long long block = 32LL * ((svrg ? 2 : 1) * position_warps(nt.S) + kProducerWarps);
  if (bytes != smem_bytes || block != threads) return (int)cudaErrorInvalidValue;
  EpochParams p{tokens, targets, w, mu, keys, step, row_ints, vecs, out, loss, nt, (int)n,
                (int)C, (int)total, (int)buf_len, option, drop,
                fold_multiplier((uint32_t)n), keep_p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (svrg) {
    return shared ? launch_epoch<true, true>(p, block, bytes, st)
                  : launch_epoch<true, false>(p, block, bytes, st);
  }
  return shared ? launch_epoch<false, true>(p, block, bytes, st)
                : launch_epoch<false, false>(p, block, bytes, st);
}

// tokens, targets [n, S] int32; w [C, d] float32; acc64 [C, d] float64 scratch and mu [C, d]
// float32, both null for the loss alone; loss [C] float32; `sets` samples at once, each row
// copied into shared memory with `staged`, in blocks of `threads` threads with `smem_bytes` of
// dynamic shared memory (this file's layout).
extern "C" int sweep_epoch_mlp_full(const int* tokens, const int* targets, const float* w,
                                    double* acc64, float* mu, float* loss, long long n,
                                    long long S, long long V, long long D, long long H, int act,
                                    long long C, long long sets, int staged,
                                    long long smem_bytes, long long threads, void* stream) {
  if (n <= 0 || n >= (1LL << 31) || C <= 0 || bad_widths(S, V, D, H, act) ||
      (mu == nullptr) != (acc64 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const long long block = 32LL * sets * position_warps(nt.S);
  if (sets < 1 || block > 32 * kFullWarps || full_bytes(nt, (int)sets, staged) != smem_bytes ||
      block != threads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool grad = mu != nullptr;
  auto go = [&](auto kernel_launch) {
    return kernel_launch(tokens, targets, w, acc64, mu, loss, nt, (int)n, (int)C, (int)sets,
                         block, smem_bytes, st);
  };
  if (grad) return staged ? go(launch_full<true, true>) : go(launch_full<true, false>);
  return staged ? go(launch_full<false, true>) : go(launch_full<false, false>);
}

// g [d] = grad f_i(w) for w [d] float32 and sample i of tokens, targets [n, S] int32; one set,
// the row copied into shared memory with `staged`.
extern "C" int sweep_epoch_mlp_sample_grad(const int* tokens, const int* targets, long long n,
                                           long long i, const float* w, float* g, long long S,
                                           long long V, long long D, long long H, int act,
                                           int staged, long long smem_bytes, long long threads,
                                           void* stream) {
  if (n <= 0 || i < 0 || i >= n || bad_widths(S, V, D, H, act)) {
    return (int)cudaErrorInvalidValue;
  }
  const Net nt = make_net((int)S, (int)V, (int)D, (int)H, act);
  const long long block = 32LL * position_warps(nt.S);
  if (full_bytes(nt, 1, staged) != smem_bytes || block != threads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = staged ? opt_in(sample_grad_kernel<true>, smem_bytes)
                   : opt_in(sample_grad_kernel<false>, smem_bytes);
  if (err != 0) return err;
  if (staged) {
    sample_grad_kernel<true><<<1, (unsigned)block, (size_t)smem_bytes, st>>>(tokens, targets,
                                                                           (int)i, w, g, nt);
  } else {
    sample_grad_kernel<false><<<1, (unsigned)block, (size_t)smem_bytes, st>>>(tokens, targets,
                                                                            (int)i, w, g, nt);
  }
  return (int)cudaGetLastError();
}
