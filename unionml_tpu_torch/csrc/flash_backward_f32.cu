// Fused flash-attention backward for Hopper (sm_90a), float32: dq, dk and dv
// of one attention call in one launch, every product on the tensor cores in
// three TF32 passes (3xTF32), to near-f32 accuracy.
//
// Replaces the TPU kernels of unionml_tpu/ops/flash_attention.py
//   _flash_bwd_dq_kernel  (pallas_call at :318)
//   _flash_bwd_dkv_kernel (pallas_call at :343)
// and computes what _bwd_recompute (:193-215) and the two kernel bodies
// compute, for float32 inputs. (bfloat16 inputs run csrc/flash_backward.cu.)
//
// Layout as in the JAX package: q and dO [B, Lq, H, D], k and v [B, Lk, Hkv,
// D], all f32 and contiguous; lse and delta [B, H, Lq] f32. Query head h
// reads KV head h / (H / Hkv). Query row i sees key j when i + (Lk - Lq) >= j
// (causal) or always. With scale = D**-0.5:
//   P = exp(scale * Q K^T - lse), dS = P * (dO V^T - delta), masked entries 0
//   (a row with lse 1e30 gets P = 0);
//   dv = P^T dO, dk = scale * dS^T Q, written in f32 at query-head resolution
//   ([B, Lk, H, D]; the wrapper sums each KV group);
//   dq = scale * dS K, summed over key tiles in dq itself, in order.
//
// Bound: operations. Five products of 2 * D multiply-adds per visible (query,
// key) pair: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dQ =
// dS K. An f32-accurate product costs three TF32 products, so the card's rate
// for it is 494.7 / 3 = 164.9 TFLOP/s (dense TF32). At B=1, H=32, Hkv=8,
// D=128, causal: S=256 is 1.35 GFLOP, 0.0082 ms; S=2048 is 85.9 GFLOP, 0.521
// ms, against 128 MB of inputs and outputs (0.038 ms at 3.35 TB/s). The
// kernels this replaced (a dq kernel and a dk/dv kernel) computed 7 products
// on the CUDA cores.
//
// Accuracy: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), and a product is a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
// accumulation; the dropped a_lo b_lo term and lo's rounding are about 2**-22
// of a product. One TF32 pass (2**-11) would miss the f32 route's tolerance.
//
// Design (csrc/flash_backward.cu's outline, on mma.sync m16n8k8):
//  - Grid. One block per (key tile of 64 rows, batch, query head); blockIdx
//    runs over key tiles outermost, so that the heaviest (under causal
//    masking, the lowest) key tiles start first. The block keeps its K and V
//    tiles resident and walks the query tiles (64 rows) that see its keys,
//    from the last down.
//  - Copies. Rows of K, V, Q and dO sit in shared memory D + 4 = 132 floats
//    apart (a stride of 4 modulo 32 banks, so the fragment reads, 8 rows x 4
//    columns of a warp, or 4 rows x 8 columns, hit 32 distinct banks). They
//    come by 16-byte cp.async, warp w on rows w, w + 8, ..., a lane a chunk
//    (rows past L zero-filled). Q, dO and the tile's lse and delta use two
//    stages: the copy of the next query tile starts as soon as a tile begins
//    and lands under its work. Where D % 4 != 0 or a tensor is not 16-byte
//    aligned, plain loads fill the same rows. Columns from D up to the next
//    multiple of 8 are zero.
//  - Eight warps. Warp w owns key rows 16 (w % 4) .. + 15 and, of each query
//    tile, the 32 queries 32 (w / 4) .. + 31: S^T and dP^T [16 keys, 32
//    queries] (keys as M, the head dim as K); P^T and dS^T in registers; dV
//    += P^T dO and dK += dS^T Q with A from the accumulators and the k order
//    read as the accumulator holds it (columns 2t, 2t + 1 as the A fragment's
//    t, t + 4) and B's rows (dO, Q) read in the same order; [16 keys, D] f32
//    accumulators for dK and dV held across the whole walk. dS goes to shared
//    memory once; dQ = dS K is [16 queries, 64 columns] a warp over the 64
//    keys (keys again in the order 2t, 2t + 1, so A is one 8-byte read). The
//    two warps of a key group sum their dK and dV through shared memory at
//    the end, in a fixed order.
//  - Operand split. tf32_rna (csrc/hopper.cuh) rounds on the bits: sm_90 has
//    no single instruction for cvt.rna.tf32.f32, which compiles to a compare,
//    a select and integer operations.
//  - Determinism. dq's partial tiles are summed in dq itself. A counter per
//    (head, query tile) in device memory orders the adds by key tile: key
//    tile n adds after key tile n - 1 has, and the last key tile that sees
//    the query tile writes scale * sum. The partial tile goes through the
//    tile's Q stage, so that all threads read, add and write dq in 16-byte
//    pieces, every read before any write; the counter is released after the
//    next tile's first barrier. A block waits only on a block with a lower
//    blockIdx (launched before it), so the wait cannot deadlock however many
//    blocks are resident. The result is bitwise the same on every call.
//
// Limits: f32, D <= 128, any lengths, causal or not, any Lk - Lq, H % Hkv ==
// 0, any alignment.
//
// Left for later (PERF.md has where the time goes): mma.sync's TF32 rate is
// the ceiling of this design, and the operands are split again by every warp
// that reads them (K and V for every query tile, Q and dO by four warps);
// shared memory has no room for split copies beside two Q/dO stages, and the
// dK/dV accumulators hold half the registers. A producer warp, a persistent
// grid, and wgmma (its TF32 form takes only K-major operands from shared
// memory, while three of the five products read row-major tiles MN-major).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;              // eight warps: four key groups x two query halves
constexpr int kKeys = 64;                  // key rows of a block, 16 a key group
constexpr int kQueries = 64;               // query rows of a tile, 32 a warp
constexpr int kStages = 2;                 // Q/dO stages: this tile's and the next's
constexpr int kMaxHeadDim = 128;
constexpr int kSteps = kMaxHeadDim / 8;    // 8-column steps of the head dim
constexpr int kLd = kMaxHeadDim + 4;       // floats between two rows of a K, V, Q or dO tile
constexpr int kDsLd = kKeys + 8;           // floats between two query rows of dS
constexpr int kTile = kKeys * kLd;         // floats of a K, V, Q or dO tile (kKeys == kQueries)

// shared memory, in floats: K, V, the Q stages and the dO stages are 2 + 2 * kStages tiles back to back
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kTile;
constexpr int kOffQ = kOffV + kTile;
constexpr int kOffDO = kOffQ + kStages * kTile;
constexpr int kOffDS = kOffDO + kStages * kTile;  // dS [64 queries][kDsLd]
constexpr int kOffStats = kOffDS + kQueries * kDsLd;  // [stage][lse 64, delta 64]
constexpr int kSmem = (kOffStats + kStages * 2 * kQueries) * 4;
static_assert(kSmem <= 232448, "an H100 block has 227 KB of shared memory");
static_assert(4 * 32 * 2 * kSteps * 4 <= kStages * kTile, "the dK/dV exchange fits in the Q stages");
static_assert(kLd % 32 == 4 && kDsLd % 32 == 8, "the bank arithmetic of the fragment reads");
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// makes this block's earlier writes (ordered before it by a barrier) visible, then publishes v
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// grid: x = key tiles x batch x query heads (key tile outermost). kFull: head_dim > 120, so every 8-column step
// of the tiles holds data (the loops over them then carry no guards)
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1) flash_backward_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta, int* dq_count,
    float* dq, float* __restrict__ dk, float* __restrict__ dv, int batch, int n_heads, int n_kv, int q_len,
    int k_len, int head_dim, int causal, float scale, int aligned) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* k_s = smem + kOffK;
  float* v_s = smem + kOffV;
  float* q_s = smem + kOffQ;
  float* do_s = smem + kOffDO;
  float* ds_s = smem + kOffDS;
  float* stats = smem + kOffStats;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp & 3, qh = warp >> 2;  // key group (16 keys) and query half (32 queries) of this warp

  const int heads = batch * n_heads;
  const int n = blockIdx.x / heads;  // key tile
  const int bh = blockIdx.x - n * heads;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int hkv = h / (n_heads / n_kv);
  const int k0 = n * kKeys;
  const int offset = k_len - q_len;
  const int n_q = (q_len + kQueries - 1) / kQueries;
  const int n_k = (k_len + kKeys - 1) / kKeys;
  // causal: the first query row that sees key k0 is k0 - offset (<= q_len - 1, so steps >= 1)
  const int m_first = causal ? max(0, k0 - offset) / kQueries : 0;
  const int steps = n_q - m_first;
  const int nk = kFull ? kSteps : (head_dim + 7) >> 3;  // 8-column steps that hold the head dim

  // columns [head_dim, 8 nk) of every tile are read as operands and never copied: zero them once
  const int pad = 8 * nk - head_dim;
  if (pad) {
    for (int i = tid; i < (2 + 2 * kStages) * kKeys * pad; i += kThreads) {
      const int r = i / pad;
      smem[r * kLd + head_dim + (i - r * pad)] = 0.f;
    }
  }

  // rows [r0, r0 + 64) of head `head` of a [B, len, heads_of, D] tensor into dst; rows past len read as 0. With
  // 16-byte copies warp w takes rows w, w + 8, ..., a lane a 16-byte chunk
  auto load_rows = [&](float* dst, const float* src, int r0, int len, int heads_of, int head) {
    const float* base = src + (static_cast<int64_t>(b) * len * heads_of + head) * head_dim;
    const int64_t stride = static_cast<int64_t>(heads_of) * head_dim;
    if (aligned) {
      if (lane < (head_dim >> 2)) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const int r = warp + 8 * j, row = r0 + r;
          cp_async_16(dst + r * kLd + 4 * lane, base + min(row, len - 1) * stride + 4 * lane, row < len ? 16 : 0);
        }
      }
    } else {
      for (int i = tid; i < kKeys * head_dim; i += kThreads) {
        const int r = i / head_dim, c = i - r * head_dim, row = r0 + r;
        dst[r * kLd + c] = row < len ? base[row * stride + c] : 0.f;
      }
    }
  };
  // query tile n_q - 1 - i (the walk runs down) and its lse and delta into stage i % kStages
  auto load_tile = [&](int i) {
    const int s = i % kStages, q0 = (n_q - 1 - i) * kQueries;
    load_rows(q_s + s * kTile, q, q0, q_len, n_heads, h);
    load_rows(do_s + s * kTile, dout, q0, q_len, n_heads, h);
    if (tid < 2 * kQueries) {
      const int row = q0 + (tid & (kQueries - 1));
      const float* src = (tid < kQueries ? lse : delta) + static_cast<int64_t>(bh) * q_len + min(row, q_len - 1);
      cp_async_4(stats + s * 2 * kQueries + tid, src, row < q_len ? 4 : 0);
    }
  };

  load_rows(k_s, k, k0, k_len, n_kv, hkv);
  load_rows(v_s, v, k0, k_len, n_kv, hkv);
  load_tile(0);
  cp_async_commit();

  float dk_acc[kSteps][4], dv_acc[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const float* k_warp = k_s + 16 * kg * kLd;  // this warp's 16 key rows
  const float* v_warp = v_s + 16 * kg * kLd;
  const int kj0 = k0 + 16 * kg + g;           // this thread's key rows: kj0 and kj0 + 8
  const int qd = 16 * kg;                     // dQ: this warp's 16 query rows of the tile
  const int dh = qh;                          // dQ: this warp's 64 head-dim columns
  const float scale_log2 = scale * kLog2e;

  int* release = nullptr;  // the counter of the previous tile's add, when key tile n + 1 waits on it
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages, m = n_q - 1 - i, q0 = m * kQueries;
    cp_async_wait<0>();  // this tile has landed
    __syncthreads();     // ... for every thread's copies; the previous tile's reads of dS and of its stage and its
                         // adds are done
    if (tid == 0 && release != nullptr) store_release(release, n + 1);  // the previous tile's sum, to key tile n + 1
    if (i + 1 < steps) load_tile(i + 1);  // into the other stage, under this tile's work
    cp_async_commit();
    const float* q_t = q_s + s * kTile + 32 * qh * kLd;  // this warp's 32 query rows
    const float* do_t = do_s + s * kTile + 32 * qh * kLd;
    const float* lse_t = stats + s * 2 * kQueries + 32 * qh;
    const float* delta_t = lse_t + kQueries;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys, 32 queries] a warp, over the head dim
    float s_acc[4][4], dp_acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = dp_acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk < nk) {
        const int c = 8 * kk + t;
        uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
        split_tf32(k_warp[g * kLd + c], a_hi[0], a_lo[0]);
        split_tf32(k_warp[(g + 8) * kLd + c], a_hi[1], a_lo[1]);
        split_tf32(k_warp[g * kLd + c + 4], a_hi[2], a_lo[2]);
        split_tf32(k_warp[(g + 8) * kLd + c + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* row = q_t + (8 * j + g) * kLd + c;
          split_tf32(row[0], b_hi[0], b_lo[0]);
          split_tf32(row[4], b_hi[1], b_lo[1]);
          mma_1688_3xtf32(s_acc[j], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        }
        split_tf32(v_warp[g * kLd + c], a_hi[0], a_lo[0]);
        split_tf32(v_warp[(g + 8) * kLd + c], a_hi[1], a_lo[1]);
        split_tf32(v_warp[g * kLd + c + 4], a_hi[2], a_lo[2]);
        split_tf32(v_warp[(g + 8) * kLd + c + 4], a_hi[3], a_lo[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* row = do_t + (8 * j + g) * kLd + c;
          split_tf32(row[0], b_hi[0], b_lo[0]);
          split_tf32(row[4], b_hi[1], b_lo[1]);
          mma_1688_3xtf32(dp_acc[j], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        }
      }
    }

    // P^T and dS^T in place. Accumulator (j, e): key row kj0 (+ 8 for e >= 2), query column 8j + 2t + (e & 1)
    // of the warp's 32
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const int qi = q0 + 32 * qh + qc, kj = kj0 + (e & 2) * 4;
        const bool seen = qi < q_len && kj < k_len && (!causal || qi + offset >= kj);
        const float p = seen ? exp2f(fmaf(s_acc[j][e], scale_log2, -lse_t[qc] * kLog2e)) : 0.f;
        s_acc[j][e] = p;
        dp_acc[j][e] = p * (dp_acc[j][e] - delta_t[qc]);
      }
    }

    // dV += P^T dO and dK += dS^T Q: [16 keys, D], over the warp's 32 queries. K step j holds queries
    // 8j..8j+7 in the order the accumulator holds them: the A fragment's column t is query 2t, t + 4 is 2t + 1,
    // and B's rows follow
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = (r >> 1) | ((r & 1) << 1);  // a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
        split_tf32(s_acc[j][e], p_hi[r], p_lo[r]);
        split_tf32(dp_acc[j][e], ds_hi[r], ds_lo[r]);
      }
      const float* do_row = do_t + (8 * j + 2 * t) * kLd + g;
      const float* q_row = q_t + (8 * j + 2 * t) * kLd + g;
#pragma unroll
      for (int nn = 0; nn < kSteps; ++nn) {
        if (nn < nk) {
          uint32_t b_hi[2], b_lo[2];
          split_tf32(do_row[8 * nn], b_hi[0], b_lo[0]);
          split_tf32(do_row[8 * nn + kLd], b_hi[1], b_lo[1]);
          mma_1688_3xtf32(dv_acc[nn], p_hi, p_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
          split_tf32(q_row[8 * nn], b_hi[0], b_lo[0]);
          split_tf32(q_row[8 * nn + kLd], b_hi[1], b_lo[1]);
          mma_1688_3xtf32(dk_acc[nn], ds_hi, ds_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        }
      }
    }

    // dS into shared memory, [64 queries, 64 keys]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds_s[(32 * qh + 8 * j + 2 * t + (e & 1)) * kDsLd + 16 * kg + g + (e & 2) * 4] = dp_acc[j][e];
    __syncthreads();  // dS is written; stage s (Q, dO, lse, delta) has been read by every warp

    // dQ partial = dS K: [16 queries, 64 columns] a warp, over the block's 64 keys; k step kk holds keys
    // 8kk..8kk+7 in the order 2t (A column t), 2t + 1 (t + 4)
    float dq_acc[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[nn][e] = 0.f;
    const float* ds_row = ds_s + (qd + g) * kDsLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      const float2 top = *reinterpret_cast<const float2*>(ds_row + 8 * kk);
      const float2 bottom = *reinterpret_cast<const float2*>(ds_row + 8 * kDsLd + 8 * kk);
      uint32_t a_hi[4], a_lo[4];
      split_tf32(top.x, a_hi[0], a_lo[0]);
      split_tf32(bottom.x, a_hi[1], a_lo[1]);
      split_tf32(top.y, a_hi[2], a_lo[2]);
      split_tf32(bottom.y, a_hi[3], a_lo[3]);
      const float* k_row = k_s + (8 * kk + 2 * t) * kLd + 64 * dh + g;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        if (8 * dh + nn < nk) {
          uint32_t b_hi[2], b_lo[2];
          split_tf32(k_row[8 * nn], b_hi[0], b_lo[0]);
          split_tf32(k_row[8 * nn + kLd], b_hi[1], b_lo[1]);
          mma_1688_3xtf32(dq_acc[nn], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        }
      }
    }

    // the partial dQ tile into stage s's Q rows (read by every warp before the barrier above)
    float* part = q_s + s * kTile;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
        *reinterpret_cast<float2*>(part + (qd + g + 8 * r) * kLd + 64 * dh + 8 * nn + 2 * t) =
            make_float2(dq_acc[nn][2 * r], dq_acc[nn][2 * r + 1]);

    // the ordered add: key tile n adds after key tile n - 1 has; the last key tile that sees this query tile
    // writes dq = scale * sum
    const int n_last = causal ? min(n_k - 1, (q0 + kQueries - 1 + offset) / kKeys) : n_k - 1;
    int* count = dq_count + static_cast<int64_t>(bh) * n_q + m;
    if (n > 0 && tid == 0) {
      while (load_acquire(count) < n) {
      }
    }
    __syncthreads();  // the partial tile is in shared memory; key tile n - 1's sum is in dq
    const int rows = min(kQueries, q_len - q0);
    float* dq_tile = dq + (static_cast<int64_t>(b * q_len + q0) * n_heads + h) * head_dim;
    const int64_t row_stride = static_cast<int64_t>(n_heads) * head_dim;
    if ((head_dim & 3) == 0) {
      // 16-byte pieces: warp w on rows w, w + 8, ..., a lane a piece; every earlier sum is read before any is
      // written, so that the reads' trips to L2 overlap
      const int pieces = head_dim >> 2;
      float4 before[kQueries / 8];
#pragma unroll
      for (int j = 0; j < kQueries / 8; ++j) {
        const int r = min(warp + 8 * j, rows - 1);
        before[j] = n > 0 && lane < pieces ? __ldcg(reinterpret_cast<const float4*>(dq_tile + r * row_stride) + lane)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kQueries / 8; ++j) {
        const int r = warp + 8 * j;
        if (r >= rows || lane >= pieces) continue;
        const float4 add = *reinterpret_cast<const float4*>(part + r * kLd + 4 * lane);
        const float4 sum =
            make_float4(before[j].x + add.x, before[j].y + add.y, before[j].z + add.z, before[j].w + add.w);
        float4* to = reinterpret_cast<float4*>(dq_tile + r * row_stride) + lane;
        if (n == n_last) {
          *to = make_float4(sum.x * scale, sum.y * scale, sum.z * scale, sum.w * scale);
        } else {
          __stcg(to, sum);
        }
      }
    } else {
      for (int c = tid; c < rows * head_dim; c += kThreads) {
        const int r = c / head_dim, d = c - r * head_dim;
        float* to = dq_tile + r * row_stride + d;
        const float sum = (n > 0 ? __ldcg(to) + part[r * kLd + d] : part[r * kLd + d]);
        if (n == n_last) {
          *to = sum * scale;
        } else {
          __stcg(to, sum);
        }
      }
    }
    release = n < n_last ? count : nullptr;  // published in the next tile (or after the walk)
  }

  cp_async_wait<0>();
  __syncthreads();
  if (tid == 0 && release != nullptr) store_release(release, n + 1);

  // the two warps of a key group sum their dK and dV (this one's queries, then the other's) through the Q stages
  float* part = q_s + kg * (2 * kSteps * 4 * 32);
  if (qh == 1) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[(j * 4 + e) * 32 + lane] = dk_acc[j][e];
        part[((kSteps + j) * 4 + e) * 32 + lane] = dv_acc[j][e];
      }
  }
  __syncthreads();
  if (qh == 1) return;

  // dk = scale * dS^T Q and dv = P^T dO at query-head resolution, f32 [B, Lk, H, D]; accumulator (j, e): key
  // row kj0 (+ 8 for e >= 2), column 8j + 2t + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + 8 * r;
    if (kj >= k_len) continue;
    const int64_t row = (static_cast<int64_t>(b * k_len + kj) * n_heads + h) * head_dim;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e, slot = j * 4 + 2 * r + e;
        if (d >= head_dim) continue;
        dk[row + d] = (dk_acc[j][2 * r + e] + part[slot * 32 + lane]) * scale;
        dv[row + d] = dv_acc[j][2 * r + e] + part[(kSteps * 4 + slot) * 32 + lane];
      }
    }
  }
}

}  // namespace

// q, dout f32 [B, Lq, H, D]; k, v f32 [B, Lk, Hkv, D]; lse, delta f32 [B, H, Lq]; dq_count int32 [B * H,
// ceil(Lq / 64)] zeroed; dq f32 [B, Lq, H, D] (rows of query tiles that see no key are left as they are: the
// caller zeroes them); dk, dv f32 [B, Lk, H, D]. Returns the cudaError_t of the launch (0 = success); the caller
// validated shapes, types and contiguity.
extern "C" int flash_attention_backward_f32(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dq_count, void* dq, void* dk,
                                            void* dv, int batch, int n_heads, int n_kv, int q_len, int k_len,
                                            int head_dim, int causal, float scale, void* stream) {
  if (batch <= 0 || n_kv <= 0 || n_heads % n_kv || q_len <= 0 || k_len <= 0 || head_dim <= 0 ||
      head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured[kMaxDevices] = {};  // the attribute is set once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_backward_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(flash_backward_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  // 16-byte copies need rows of whole chunks and aligned tensors; else the tiles load with plain loads
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  const bool aligned = head_dim % 4 == 0 && bases % 16 == 0;
  const int64_t blocks = static_cast<int64_t>((k_len + kKeys - 1) / kKeys) * batch * n_heads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = head_dim > kMaxHeadDim - 8 ? flash_backward_f32_kernel<true> : flash_backward_f32_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<int*>(dq_count), static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), batch,
      n_heads, n_kv, q_len, k_len, head_dim, causal, scale, aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
