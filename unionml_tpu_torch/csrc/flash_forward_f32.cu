// Flash-attention forward for Hopper (sm_90a), float32: both products on the
// tensor cores in three TF32 passes (3xTF32), to near-f32 accuracy.
//
// Replaces the TPU kernel of unionml_tpu/ops/flash_attention.py
//   _flash_fwd_kernel (pallas_call at :160)
// for float32 inputs and computes what it computes (:60-125), reached under
// attention_impl="flash" for every unmasked attention call
// (unionml_tpu/ops/attention.py:82-87). (bfloat16 inputs run
// csrc/flash_forward.cu; the f32 backward is csrc/flash_backward_f32.cu.)
//
// Layout as in the JAX package: q [B, Lq, H, D], k and v [B, Lk, Hkv, D],
// all f32 and contiguous; out [B, Lq, H, D] f32, lse [B, H, Lq] f32. Query
// head h reads KV head h / (H / Hkv). Query row i sees key j when i + (Lk -
// Lq) >= j (causal) or always. With scale = D**-0.5 and S = scale * Q K^T
// (masked entries -inf):
//   out = softmax(S) V, lse = m + log(l) per row (natural log); a row that
//   sees no key writes 0 and lse = 1e30 (so the backward's exp(S - lse) is 0).
//
// Bound: operations. Two products of 2 * D multiply-adds per visible (query,
// key) pair, S = Q K^T and O += P V. An f32-accurate product costs three
// TF32 products, so the card's rate for it is 494.7 / 3 = 164.9 TFLOP/s
// (dense TF32). At B=1, H=32, Hkv=8, D=128, causal: S=256 is 0.0033 ms and
// S=2048 0.2085 ms, against 25 MB of inputs and outputs at S=2048 (0.0075 ms
// at 3.35 TB/s).
//
// Accuracy: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (rounded on the bits as cvt.rna.tf32.f32 does: csrc/hopper.cuh's
// split_tf32), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
// accumulation; the dropped a_lo b_lo term and lo's rounding are about 2**-22
// of a product. One TF32 pass (2**-11) would miss the f32 route's tolerance.
//
// Design (mma.sync m16n8k8; splitting an operand costs about as much as the
// products it feeds, so every operand is split once):
//  - Grid. One block of 8 warps per (query tile, batch, query head);
//    blockIdx runs over query tiles outermost, from the last down, so that
//    under causal masking the heaviest tiles start first. Two shapes: where
//    a grid of 128-row tiles fills the card's SMs, "wide" blocks (8 warps of
//    16 query rows, all of which copy and split each K/V tile before its
//    products); else "producer" blocks of 64 rows (4 warps of 16 rows take
//    tile i's products while 4 producer warps copy and split tile i + 1 into
//    a second stage; one barrier a tile, and the producers' own around the
//    raw rows), twice as many blocks, so that short sequences fill the card.
//  - Q. Each warp splits its 16 rows once, at the start, into hi and lo A
//    fragments in shared memory in fragment order (a lane's four hi values
//    of an 8-column step are one 16-byte word; so are its lo's). Registers
//    cannot hold them beside O: a copy that kept them there spilled, and its
//    S phase took three times as long.
//  - K and V. Tiles of 32 keys come by 16-byte cp.async into raw rows (where
//    D % 4 != 0 or a tensor is not 16-byte aligned, 4-byte cp.async fill the
//    same rows; rows past Lk are zero-filled, and the columns from D up to
//    the next 16 (K) or 32 (V) are zeroed once). Once a tile has landed it is
//    split once into hi/lo B fragments in fragment order (b0_hi, b1_hi,
//    b0_lo, b1_lo: one 16-byte read per three products). The head dim's
//    columns are taken in an order (below) that makes every raw read of the
//    split, every Q load and every output store 16 bytes.
//  - Per key tile, in each warp: S [16 rows, 32 keys] from Q's and K's
//    fragments; the mask only where the tile crosses the shifted diagonal or
//    the end of the keys (a warp whose rows see no key of the tile skips
//    it); the online softmax in log2 units, its row max over the 4 lanes of
//    an mma row (two shuffles; the row sum is reduced once, at the end);
//    O [16 rows, D] += P V with P's A fragment read from the S accumulator
//    in the order the accumulator holds it (columns 2t and 2t + 1 as the
//    fragment's t and t + 4) and V's fragments split in that key order.
//  - Determinism. No reduction crosses blocks or warps: the result is the
//    same bits on every call.
//
// What bounds it now (scripts/flash_forward_f32_phases.py; PERF.md): shared
// memory's bandwidth. Every warp reads a K and a V fragment (16 bytes a
// lane) per three products and its Q fragments once a key tile, which at
// mma.sync's rate is about what shared memory delivers; the split and the
// copies add to that traffic. Levers for later: two m-tiles a warp (each B
// fragment read feeds twice the products; O then needs 128 registers), and
// wgmma, whose TF32 form reads B only K-major from shared memory (P V would
// need V transposed there).
//
// Limits: f32, D <= 128, any lengths, causal or not, any Lk - Lq, H % Hkv ==
// 0, any alignment.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;             // eight warps
constexpr int kKeys = 32;                 // key rows of a K/V tile
constexpr int kKeySteps = kKeys / 8;      // 8-key steps of a tile: S's n-tiles, P V's k-steps
constexpr int kMaxHeadDim = 128;
constexpr int kSteps = kMaxHeadDim / 8;   // 8-column steps of the head dim
constexpr int kLdK = kMaxHeadDim + 16;    // floats between two raw K rows
constexpr int kLdV = kMaxHeadDim + 4;     // floats between two raw V rows
constexpr int kKVFrag = kKeySteps * kSteps * 32;  // 16-byte words of K's (or V's) fragments of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kBig = 1e30f;             // lse of a row that sees no key
constexpr int kMaxDevices = 64;
// the split's 16-byte raw reads, 8 lanes a phase: K's rows g, g + 1 (stride 16 banks) at columns 4t; V's rows
// 2t, 2t + 1 (stride 8 banks apart for t) at columns 4g: 32 distinct banks a phase
static_assert(kLdK % 32 == 16 && kLdV % 32 == 4 && (kKeys * kLdK) % 4 == 0, "the split's bank arithmetic");

// The two shapes of a block. Wide: 8 warps own 16 query rows each (128 rows), and all of them copy and split
// each K/V tile into one stage before its products. Producers: 4 warps own 16 rows each (64 rows) and 4 more
// copy and split tile i + 1 into the other of two stages while the first 4 take tile i's products. Shared
// memory, in 16-byte words: Q's fragments [warp][step][hi, lo][lane]; the stages, each K's fragments [key step]
// [step][lane] then V's [key step][n-tile][lane]; the raw K rows (kKeys of kLdK floats) and V rows (kLdV)
template <bool kProducers>
struct Shape {
  static constexpr int kWarps = kProducers ? 4 : 8;    // warps that own query rows
  static constexpr int kCopiers = kProducers ? 4 : 8;  // warps that copy and split K and V
  static constexpr int kRows = 16 * kWarps;            // query rows of a block
  static constexpr int kStages = kProducers ? 2 : 1;
  static constexpr int kOffStages = kWarps * kSteps * 2 * 32;
  static constexpr int kOffRaw = kOffStages + kStages * 2 * kKVFrag;
  static constexpr int kSmem = kOffRaw * 16 + kKeys * (kLdK + kLdV) * 4;
  static_assert(kSmem <= 232448, "an H100 block has 227 KB of shared memory");
  static_assert(kWarps + (kProducers ? kCopiers : 0) == kThreads / 32, "the block's warps");
};

// the producer warps' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void producer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(Shape<true>::kCopiers * 32) : "memory");
}

// The head dim's columns in the order the products take them. S = Q K^T sums over the columns in any order: its
// k-steps 2u and 2u + 1 take the 16 columns 16u .. 16u + 15, lane t's k indices t and t + 4 being columns 16u +
// 4t and + 1 in step 2u, + 2 and + 3 in step 2u + 1, so that a lane's Q and K values of the two steps are one
// 16-byte run. O += P V's n-tile 4v + i holds the output columns 32v + 4c + i (c its column index, 0 .. 7), so
// that a lane's V values of four n-tiles, and its output columns 32v + 8t .. + 7, are 16-byte runs.

// grid: x = query tiles x batch x query heads (query tile outermost, the last first). kFull: head_dim > 112, so
// every 16-column chunk of S's steps and every 32-column group of P V's n-tiles holds data, and the loops over
// them carry no guards (a copy with the guards at every D ran 1.24x to 1.45x slower at D=128)
template <bool kProducers, bool kFull>
__global__ void __launch_bounds__(kThreads, 1) flash_forward_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int batch, int n_heads, int n_kv, int q_len, int k_len, int head_dim, int causal,
    float scale, int aligned) {
  using Sh = Shape<kProducers>;
  constexpr int kCopyThreads = Sh::kCopiers * 32;
  extern __shared__ uint4 smem[];
  float* raw_k = reinterpret_cast<float*>(smem + Sh::kOffRaw);
  float* raw_v = raw_k + kKeys * kLdK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool producer = kProducers && warp >= Sh::kWarps;
  const int cw = producer ? warp - Sh::kWarps : warp;  // this warp among the copiers
  const int ct = 32 * cw + lane;                       // this thread among the copiers

  const int heads = batch * n_heads;
  const int n_q = (q_len + Sh::kRows - 1) / Sh::kRows;
  const int order = blockIdx.x / heads;
  const int bh = blockIdx.x - order * heads;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int hkv = h / (n_heads / n_kv);
  const int q0 = (n_q - 1 - order) * Sh::kRows;
  const int qw = q0 + 16 * warp;  // the first query row of a warp that owns rows
  const int offset = k_len - q_len;
  const int chunks = kFull ? kSteps / 2 : (head_dim + 15) >> 4;  // 16-column chunks: S's step pairs
  const int groups = kFull ? kSteps / 4 : (head_dim + 31) >> 5;  // 32-column groups: P V's n-tile quads
  const int n_k = (k_len + kKeys - 1) / kKeys;
  // causal: the key tiles up to the last one the block's last row sees
  const int last_key = min(q0 + Sh::kRows, q_len) - 1 + offset;
  const int tiles = causal ? (last_key < 0 ? 0 : min(n_k, last_key / kKeys + 1)) : n_k;

  // copiers: columns [head_dim, 16 chunks) of the raw K rows and [head_dim, 32 groups) of the raw V rows are
  // split as operands and never copied; they are zeroed once
  auto zero_pads = [&]() {
    const int pad_k = 16 * chunks - head_dim, pad_v = 32 * groups - head_dim;
    for (int i = ct; i < kKeys * pad_k; i += kCopyThreads) raw_k[(i / pad_k) * kLdK + head_dim + i % pad_k] = 0.f;
    for (int i = ct; i < kKeys * pad_v; i += kCopyThreads) raw_v[(i / pad_v) * kLdV + head_dim + i % pad_v] = 0.f;
  };

  // copiers: key tile i's K and V rows into the raw rows; rows past k_len read as 0. With 16-byte copies copier
  // warp w takes rows w, w + kCopiers, ... of K and of V, a lane a 16-byte chunk
  const int64_t kv_stride = static_cast<int64_t>(n_kv) * head_dim;
  const float* k_head = k + (static_cast<int64_t>(b) * k_len * n_kv + hkv) * head_dim;
  const float* v_head = v + (k_head - k);
  auto load_tile = [&](int i) {
    const int k0 = i * kKeys;
    if (aligned) {
      if (lane < (head_dim >> 2)) {
        const int64_t first = (k0 + cw) * kv_stride + 4 * lane;
#pragma unroll
        for (int j = 0; j < kKeys / Sh::kCopiers; ++j) {
          const int r = cw + Sh::kCopiers * j;
          const bool in = k0 + r < k_len;
          const int64_t src = in ? first + Sh::kCopiers * j * kv_stride : 0;  // rows past k_len read nothing
          cp_async_16(raw_k + r * kLdK + 4 * lane, k_head + src, in ? 16 : 0);
          cp_async_16(raw_v + r * kLdV + 4 * lane, v_head + src, in ? 16 : 0);
        }
      }
    } else {
      for (int x = ct; x < kKeys * head_dim; x += kCopyThreads) {
        const int r = x / head_dim, c = x - r * head_dim;
        const bool in = k0 + r < k_len;
        const int64_t src = in ? (k0 + r) * kv_stride + c : 0;
        cp_async_4(raw_k + r * kLdK + c, k_head + src, in ? 4 : 0);
        cp_async_4(raw_v + r * kLdV + c, v_head + src, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // copiers: the landed raw rows split once into stage `stage`, in fragment order (b0_hi, b1_hi, b0_lo, b1_lo).
  // A K task (key step j, chunk u): lane (g, t) reads K[8j + g][16u + 4t .. + 3], the B values of steps 2u and
  // 2u + 1. A V task (key step j, group v): lane (g, t) reads V[8j + 2t][32v + 4g .. + 3] and V[8j + 2t + 1][..],
  // the B values of n-tiles 4v .. 4v + 3 (keys in the order of P's fragment: k index t is key 2t, t + 4 is
  // 2t + 1)
  auto split_tile = [&](int stage) {
    uint4* k_frag = smem + Sh::kOffStages + stage * 2 * kKVFrag;
    uint4* v_frag = k_frag + kKVFrag;
#pragma unroll
    for (int i = 0; i < kKeySteps * (kSteps / 2) / Sh::kCopiers; ++i) {  // K tasks, copier warp w on w, w + ...
      const int task = cw + Sh::kCopiers * i, j = task / (kSteps / 2), u = task % (kSteps / 2);
      if (kFull || u < chunks) {
        const float4 x = *reinterpret_cast<const float4*>(raw_k + (8 * j + g) * kLdK + 16 * u + 4 * t);
        uint4 w0, w1;
        split_tf32(x.x, w0.x, w0.z);
        split_tf32(x.y, w0.y, w0.w);
        split_tf32(x.z, w1.x, w1.z);
        split_tf32(x.w, w1.y, w1.w);
        k_frag[(j * kSteps + 2 * u) * 32 + lane] = w0;
        k_frag[(j * kSteps + 2 * u + 1) * 32 + lane] = w1;
      }
    }
#pragma unroll
    for (int i = 0; i < kKeySteps * (kSteps / 4) / Sh::kCopiers; ++i) {  // V tasks (j, group)
      const int task = cw + Sh::kCopiers * i, j = task / (kSteps / 4), gv = task % (kSteps / 4);
      if (kFull || gv < groups) {
        const float* p = raw_v + (8 * j + 2 * t) * kLdV + 32 * gv + 4 * g;
        const float4 x = *reinterpret_cast<const float4*>(p), y = *reinterpret_cast<const float4*>(p + kLdV);
        const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint4 w;
          split_tf32(xs[c], w.x, w.z);
          split_tf32(ys[c], w.y, w.w);
          v_frag[(j * kSteps + 4 * gv + c) * 32 + lane] = w;
        }
      }
    }
  };

  // Q's rows qw + g and qw + g + 8 into this warp's A fragments, hi then lo: of steps 2u and 2u + 1, a0 (g, t),
  // a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), from Q[row][16u + 4t .. + 3] (see the column order above)
  uint4* q_warp = smem + warp * kSteps * 2 * 32 + lane;
  auto split_q = [&]() {
    const int64_t q_stride = static_cast<int64_t>(n_heads) * head_dim;
    const float* q_head = q + (static_cast<int64_t>(b) * q_len * n_heads + h) * head_dim;
    const int r0 = qw + g, r1 = r0 + 8;
    const float* rows[2] = {q_head + min(r0, q_len - 1) * q_stride, q_head + min(r1, q_len - 1) * q_stride};
    const bool in[2] = {r0 < q_len, r1 < q_len};
#pragma unroll
    for (int u = 0; u < kSteps / 2; ++u) {
      if (kFull || u < chunks) {
        const int c = 16 * u + 4 * t;
        float x[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (aligned) {  // head_dim % 4 == 0: the 4 columns are all in or all out
            const float4 y = in[r] && c < head_dim ? __ldg(reinterpret_cast<const float4*>(rows[r] + c))
                                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            x[r][0] = y.x, x[r][1] = y.y, x[r][2] = y.z, x[r][3] = y.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[r][e] = in[r] && c + e < head_dim ? __ldg(rows[r] + c + e) : 0.f;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 hi, lo;
          split_tf32(x[0][2 * half], hi.x, lo.x);
          split_tf32(x[1][2 * half], hi.y, lo.y);
          split_tf32(x[0][2 * half + 1], hi.z, lo.z);
          split_tf32(x[1][2 * half + 1], hi.w, lo.w);
          q_warp[(2 * (2 * u + half)) * 32] = hi;
          q_warp[(2 * (2 * u + half) + 1) * 32] = lo;
        }
      }
    }
  };

  // O [16 rows, D] as n-tiles: (n, e) is row g (+ 8 for e >= 2), column index 2t + (e & 1) of n-tile n; the
  // running max (log2 units, scale folded in) and this lane's share of the row sum of rows g and g + 8
  float o[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  // a warp's products of key tile i, whose fragments are in stage `stage`
  auto consume = [&](int i, int stage) {
    const int k0 = i * kKeys;
    if (qw >= q_len || (causal && k0 > qw + 15 + offset)) return;  // no row of this warp sees a key of the tile
    const uint4* k_frag = smem + Sh::kOffStages + stage * 2 * kKVFrag;
    const uint4* v_frag = k_frag + kKVFrag;

    // S = Q K^T: [16 rows, 32 keys], over the head dim
    float s_acc[kKeySteps][4];
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (kFull || s < 2 * chunks) {
        const uint4 hi = q_warp[(2 * s) * 32], lo = q_warp[(2 * s + 1) * 32];
        const uint32_t a_hi[4] = {hi.x, hi.y, hi.z, hi.w}, a_lo[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
        for (int j = 0; j < kKeySteps; ++j) {
          const uint4 w = k_frag[(j * kSteps + s) * 32 + lane];
          mma_1688_3xtf32(s_acc[j], a_hi, a_lo, w.x, w.y, w.z, w.w);
        }
      }
    }

    // the mask, only where the tile crosses the shifted diagonal of this warp's rows or the end of the keys.
    // Accumulator (j, e): row qw + g (+ 8 for e >= 2), key k0 + 8j + 2t + (e & 1)
    if (k0 + kKeys > k_len || (causal && k0 + kKeys - 1 > qw + offset)) {
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1), qi = qw + g + 4 * (e & 2);
          if (kj >= k_len || (causal && qi + offset < kj)) s_acc[j][e] = -INFINITY;
        }
    }

    // the online softmax of rows g (r = 0) and g + 8 (r = 1): the tile's row max over the 4 lanes of the row,
    // P = 2^(S scale log2(e) - m) in place, O and this lane's row sum rescaled
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j) mx = fmaxf(mx, fmaxf(s_acc[j][2 * r], s_acc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row that has seen no key keeps a zero state
      const float alpha = exp2f(m_run[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeySteps; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(fmaf(s_acc[j][e], scale_log2, -m_use));
          s_acc[j][e] = p;
          sum += p;
        }
      l_run[r] = l_run[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V: key step j of P in the order the accumulator holds it (the A fragment's column t is key 2t,
    // t + 4 is 2t + 1), V's fragments in the same order
#pragma unroll
    for (int j = 0; j < kKeySteps; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split_tf32(s_acc[j][0], p_hi[0], p_lo[0]);  // a0 (g, key 2t)
      split_tf32(s_acc[j][2], p_hi[1], p_lo[1]);  // a1 (g + 8, key 2t)
      split_tf32(s_acc[j][1], p_hi[2], p_lo[2]);  // a2 (g, key 2t + 1)
      split_tf32(s_acc[j][3], p_hi[3], p_lo[3]);  // a3 (g + 8, key 2t + 1)
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        if (kFull || n < 4 * groups) {
          const uint4 w = v_frag[(j * kSteps + n) * 32 + lane];
          mma_1688_3xtf32(o[n], p_hi, p_lo, w.x, w.y, w.z, w.w);
        }
      }
    }
  };

  if constexpr (kProducers) {
    // producers copy and split tile i + 1 into stage (i + 1) & 1 (read by the other warps during tile i - 1)
    // while the other warps take tile i's products from stage i & 1
    if (producer) {
      zero_pads();
      if (tiles > 0) load_tile(0);
      cp_async_wait<0>();
      producer_barrier();  // the first tile's rows and the pads are in place for every producer
      if (tiles > 0) split_tile(0);
      producer_barrier();  // the raw rows are read
      if (tiles > 1) load_tile(1);
    } else {
      split_q();
    }
    __syncthreads();  // stage 0 holds the first tile
    for (int i = 0; i < tiles; ++i) {
      if (!producer) {
        consume(i, i & 1);
      } else if (i + 1 < tiles) {
        cp_async_wait<0>();
        producer_barrier();  // tile i + 1's rows have landed for every producer
        split_tile((i + 1) & 1);
        producer_barrier();  // the raw rows are read
        if (i + 2 < tiles) load_tile(i + 2);
      }
      __syncthreads();  // stage i & 1 is read; stage (i + 1) & 1 holds tile i + 1
    }
    if (producer) return;
  } else {
    // every warp copies and splits each tile into the one stage, then takes its products
    zero_pads();
    if (tiles > 0) load_tile(0);
    split_q();
    for (int i = 0; i < tiles; ++i) {
      cp_async_wait<0>();
      __syncthreads();  // tile i's rows have landed for every thread; every warp is done with tile i - 1's stage
      split_tile(0);
      __syncthreads();  // the stage is written and the raw rows read
      if (i + 1 < tiles) load_tile(i + 1);  // under this tile's products
      consume(i, 0);
    }
  }

  // out = O / l and lse = m ln(2) + log(l) of rows qw + g and qw + g + 8, the row sum's four shares first. Of
  // group v, the lane holds output columns 32v + 8t .. + 3 (n-tiles 4v .. 4v + 3, e even) and 32v + 8t + 4 ..
  // + 7 (e odd)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = qw + g + 8 * r;
    if (qi >= q_len) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* dst = out + (static_cast<int64_t>(b * q_len + qi) * n_heads + h) * head_dim;
#pragma unroll
    for (int gv = 0; gv < kSteps / 4; ++gv) {
      if (!(kFull || gv < groups)) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 32 * gv + 8 * t + 4 * half, e = 2 * r + half;
        const float4 y = make_float4(o[4 * gv][e] * inv, o[4 * gv + 1][e] * inv, o[4 * gv + 2][e] * inv,
                                     o[4 * gv + 3][e] * inv);
        if (aligned) {  // head_dim % 4 == 0: the 4 columns are all in or all out
          if (d < head_dim) *reinterpret_cast<float4*>(dst + d) = y;
        } else {
          const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (d + c < head_dim) dst[d + c] = ys[c];
        }
      }
    }
    if (t == 0) lse[static_cast<int64_t>(bh) * q_len + qi] = l > 0.f ? m_run[r] * kLn2 + logf(l) : kBig;
  }
}

template <bool kProducers, bool kFull>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse, int batch, int n_heads,
                   int n_kv, int q_len, int k_len, int head_dim, int causal, float scale, int aligned,
                   cudaStream_t stream) {
  constexpr int kRows = Shape<kProducers>::kRows;
  const int64_t blocks = static_cast<int64_t>((q_len + kRows - 1) / kRows) * batch * n_heads;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  flash_forward_f32_kernel<kProducers, kFull><<<static_cast<unsigned>(blocks), kThreads,
                                                Shape<kProducers>::kSmem, stream>>>(
      q, k, v, out, lse, batch, n_heads, n_kv, q_len, k_len, head_dim, causal, scale, aligned);
  return cudaGetLastError();
}

template <bool kProducers>
cudaError_t configure() {
  constexpr int kSmem = Shape<kProducers>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(flash_forward_f32_kernel<kProducers, true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_forward_f32_kernel<kProducers, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
}

}  // namespace

// q f32 [B, Lq, H, D]; k, v f32 [B, Lk, Hkv, D]; out f32 [B, Lq, H, D]; lse f32 [B, H, Lq]. dtype: 0 = float32,
// the only type it takes (bfloat16 has its own entry, flash_attention_forward_bf16). Returns the cudaError_t of
// the launch (0 = success); the caller validated shapes, types and contiguity.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                       int n_heads, int n_kv, int q_len, int k_len, int head_dim, int causal,
                                       float scale, int dtype, void* stream) {
  if (dtype != 0 || batch <= 0 || n_kv <= 0 || n_heads % n_kv || q_len <= 0 || k_len <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured[kMaxDevices] = {};  // the attributes are set once a device
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = configure<false>();
    if (err == cudaSuccess) err = configure<true>();
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  // 16-byte copies need rows of whole chunks and aligned tensors; else 4-byte copies fill the same rows
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  const int aligned = head_dim % 4 == 0 && bases % 16 == 0;
  // wide blocks where their grid fills every SM once; else the producers' blocks, twice as many
  const bool wide = static_cast<int64_t>((q_len + 127) / 128) * batch * n_heads >= sms[device];
  const bool full = head_dim > kMaxHeadDim - 16;
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(out), *fl = static_cast<float*>(lse);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = wide ? (full ? launch<false, true> : launch<false, false>)
                  : (full ? launch<true, true> : launch<true, false>);
  return static_cast<int>(run(fq, fk, fv, fo, fl, batch, n_heads, n_kv, q_len, k_len, head_dim, causal, scale,
                              aligned, s));
}
