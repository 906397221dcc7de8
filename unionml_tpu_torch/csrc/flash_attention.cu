// Flash attention for Hopper (sm_90a), float32: the blocked online-softmax
// forward and the two recompute-backward kernels (dq, and dk/dv).
//
// Replaces the TPU kernels of unionml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _flash_fwd_kernel     (pallas_call at :160)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel  (pallas_call at :318)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel (pallas_call at :343)
// reached under attention_impl="flash" for every unmasked attention call
// (unionml_tpu/ops/attention.py:82-87): the training forward and backward.
// The three take float32 only: they are the exact-f32 route; bfloat16 runs
// on the tensor cores (the forward of flash_forward.cu, the fused backward
// of flash_backward.cu).
//
// Layout as in the JAX package: q [B, Lq, H, D], k/v [B, Lk, Hkv, D], all
// contiguous; lse and delta [B, H, Lq] f32. Query head h reads KV head
// h / (H / Hkv) (grouped-query attention, no repeated K/V). Causal masking
// lets query row i see key j when i + (Lk - Lq) >= j; tiles wholly above
// that shifted diagonal are skipped. Scores are scale * q.k with
// scale = D**-0.5, in f32.
//
//   forward: out = softmax(S) V, lse = m + log(l) per row; a row that sees
//            no key writes 0 and lse = 1e30 (so the backward's
//            exp(S - lse) is 0 there).
//   dq:      P = exp(S - lse), dS = P * (dO V^T - delta),
//            dq = scale * dS K, summed over key tiles.
//   dk/dv:   dv = P^T dO, dk = scale * dS^T Q, summed over query tiles AND
//            over the query heads of one KV group inside the kernel, in f32
//            (the JAX code writes query-head-resolution dk/dv and sums after
//            casting to the input type).
//
// Bound: operations. At the main path's shape (B=1, L=2048, H=32, Hkv=8,
// D=128, causal) each kernel does 2 (forward), 3 (dq) or 4 (dk/dv) products
// of 2 * Lq * Lk * D multiply-adds per head, halved by causality, against
// a few MB of inputs: far above the card's operations-per-byte ridge.
//
// Design (simple first): one 256-thread block per (64-row tile, b * h) (per
// (64-key tile, b * hkv) for dk/dv), a 16 x 16 thread grid. Tiles are staged
// in shared memory as f32 (row stride D + 1
// keeps the column reads of the score loop free of bank conflicts). Each
// thread owns a 4 x 4 block of the 64 x 64 score tile and a 4 x 8 block of
// the 64 x 128 output tile, accumulated in registers with f32 FMAs on the
// CUDA cores; row statistics are reduced across the 16 lanes that share a
// row with warp shuffles. Ragged tiles (a length that is not a multiple of
// 64) are zero-filled on load and masked.
//
// Speed is the bf16 kernels' concern; here f32 FMAs keep the results exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a 16 x 16 grid of threads
constexpr int kTile = 64;                // rows of a Q tile and of a K/V tile
constexpr int kRows = kTile / 16;        // score rows per thread
constexpr int kCols = kTile / 16;        // score columns per thread
constexpr int kMaxHeadDim = 128;
constexpr int kDCols = kMaxHeadDim / 16; // head-dim columns per thread
constexpr int kSStride = kTile + 1;      // row stride of a score tile in shared memory
constexpr float kBig = 1e30f;            // lse of a row that sees no key

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Stage rows [row0, row0 + kTile) of one head of a [*, len, heads, D] tensor
// (base points at position 0 of that head, consecutive positions are `row`
// elements apart) into dst[kTile][ld] as f32; rows past len are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ base, int row0, int len,
                                          int64_t row, int head_dim, int ld) {
  const int n = kTile * head_dim;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / head_dim;
    const int d = i - r * head_dim;
    const int pos = row0 + r;
    dst[r * ld + d] = pos < len ? to_float(base[pos * row + d]) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qi, int kj, int q_len, int k_len, int causal, int offset) {
  return qi < q_len && kj < k_len && (!causal || qi + offset >= kj);
}

// Number of key tiles a query tile starting at q0 must visit.
__device__ __forceinline__ int key_tiles(int q0, int q_len, int k_len, int causal) {
  const int n = (k_len + kTile - 1) / kTile;
  if (!causal) return n;
  const int last_row = min(q0 + kTile, q_len) - 1;
  const int last_key = last_row + (k_len - q_len);
  return last_key < 0 ? 0 : min(n, last_key / kTile + 1);
}

// s[a][c] = q_s[ty + 16a] . k_s[tx + 16c] over the head dim (and, when
// dp != nullptr, dp[a][c] = do_s[ty + 16a] . v_s[tx + 16c] in the same pass).
__device__ __forceinline__ void score_tile(const float* q_s, const float* k_s, const float* do_s,
                                           const float* v_s, int head_dim, int ld,
                                           float (&s)[kRows][kCols], float (&dp)[kRows][kCols],
                                           bool with_dp) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[a][c] = dp[a][c] = 0.f;
  for (int d = 0; d < head_dim; ++d) {
    float qv[kRows], kv[kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) qv[a] = q_s[(ty + 16 * a) * ld + d];
#pragma unroll
    for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    if (with_dp) {
#pragma unroll
      for (int a = 0; a < kRows; ++a) qv[a] = do_s[(ty + 16 * a) * ld + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = v_s[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) dp[a][c] = fmaf(qv[a], kv[c], dp[a][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int n_heads, int n_kv, int q_len, int k_len, int head_dim, int causal,
    float scale) {
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int hkv = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld = head_dim + 1;
  const int offset = k_len - q_len;

  extern __shared__ float smem[];
  float* q_s = smem;              // [kTile][ld]
  float* k_s = q_s + kTile * ld;  // [kTile][ld]
  float* v_s = k_s + kTile * ld;  // [kTile][ld]
  float* p_s = v_s + kTile * ld;  // [kTile][kSStride]

  const int64_t q_row = (int64_t)n_heads * head_dim;
  const int64_t kv_row = (int64_t)n_kv * head_dim;
  const int64_t q_off = (int64_t)b * q_len * q_row + (int64_t)h * head_dim;
  const int64_t kv_off = (int64_t)b * k_len * kv_row + (int64_t)hkv * head_dim;
  load_tile(q_s, q + q_off, q0, q_len, q_row, head_dim, ld);

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[a][j] = 0.f;
  }

  const int n_tiles = key_tiles(q0, q_len, k_len, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's reads of k_s, v_s and p_s are done
    load_tile(k_s, k + kv_off, k0, k_len, kv_row, head_dim, ld);
    load_tile(v_s, v + kv_off, k0, k_len, kv_row, head_dim, ld);
    __syncthreads();

    float s[kRows][kCols], unused[kRows][kCols];
    score_tile(q_s, k_s, nullptr, nullptr, head_dim, ld, s, unused, false);

#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int qi = q0 + ty + 16 * a;
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kj = k0 + tx + 16 * c;
        s[a][c] = visible(qi, kj, q_len, k_len, causal, offset) ? s[a][c] * scale : -INFINITY;
        tile_max = fmaxf(tile_max, s[a][c]);
      }
      const float m_new = fmaxf(m[a], row_max16(tile_max));
      // a row that has seen no key yet keeps a zero state: its p are all 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[a] - m_use);
      float tile_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[a][c] - m_use);
        tile_sum += p;
        p_s[(ty + 16 * a) * kSStride + tx + 16 * c] = p;
      }
      l[a] = l[a] * alpha + row_sum16(tile_sum);
      m[a] = m_new;
#pragma unroll
      for (int j = 0; j < kDCols; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float pv[kRows], vv[kDCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) pv[a] = p_s[(ty + 16 * a) * kSStride + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < head_dim ? v_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kDCols; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= q_len) continue;
    const float inv = l[a] > 0.f ? 1.f / l[a] : 0.f;
    T* dst = out + q_off + qi * q_row;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim) store(dst + d, acc[a][c] * inv);
    }
    if (tx == 0) lse[(int64_t)bh * q_len + qi] = l[a] > 0.f ? m[a] + logf(l[a]) : kBig;
  }
}

// P and dS of one (query tile, key tile) pair, from the score and dO.V^T
// tiles and each row's lse and delta; masked entries and rows give 0.
__device__ __forceinline__ void grad_tile(float (&s)[kRows][kCols], float (&dp)[kRows][kCols],
                                          const float (&row_lse)[kRows], const float (&row_delta)[kRows],
                                          int q0, int k0, int q_len, int k_len, int causal, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int offset = k_len - q_len;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qi = q0 + ty + 16 * a;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int kj = k0 + tx + 16 * c;
      const float p = visible(qi, kj, q_len, k_len, causal, offset) ? expf(s[a][c] * scale - row_lse[a]) : 0.f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - row_delta[a]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq, int n_heads,
    int n_kv, int q_len, int k_len, int head_dim, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int hkv = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld = head_dim + 1;

  extern __shared__ float smem[];
  float* q_s = smem;               // [kTile][ld]
  float* do_s = q_s + kTile * ld;  // [kTile][ld]
  float* k_s = do_s + kTile * ld;  // [kTile][ld]
  float* v_s = k_s + kTile * ld;   // [kTile][ld]
  float* ds_s = v_s + kTile * ld;  // [kTile][kSStride]

  const int64_t q_row = (int64_t)n_heads * head_dim;
  const int64_t kv_row = (int64_t)n_kv * head_dim;
  const int64_t q_off = (int64_t)b * q_len * q_row + (int64_t)h * head_dim;
  const int64_t kv_off = (int64_t)b * k_len * kv_row + (int64_t)hkv * head_dim;
  load_tile(q_s, q + q_off, q0, q_len, q_row, head_dim, ld);
  load_tile(do_s, dout + q_off, q0, q_len, q_row, head_dim, ld);

  float row_lse[kRows], row_delta[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qi = q0 + ty + 16 * a;
    row_lse[a] = qi < q_len ? lse[(int64_t)bh * q_len + qi] : kBig;
    row_delta[a] = qi < q_len ? delta[(int64_t)bh * q_len + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < kDCols; ++j) acc[a][j] = 0.f;
  }

  const int n_tiles = key_tiles(q0, q_len, k_len, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile(k_s, k + kv_off, k0, k_len, kv_row, head_dim, ld);
    load_tile(v_s, v + kv_off, k0, k_len, kv_row, head_dim, ld);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    score_tile(q_s, k_s, do_s, v_s, head_dim, ld, s, dp, true);
    grad_tile(s, dp, row_lse, row_delta, q0, k0, q_len, k_len, causal, scale);
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) ds_s[(ty + 16 * a) * kSStride + tx + 16 * c] = dp[a][c];
    __syncthreads();

    for (int j = 0; j < kTile; ++j) {
      float dsv[kRows], kv[kDCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) dsv[a] = ds_s[(ty + 16 * a) * kSStride + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < head_dim ? k_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kDCols; ++c) acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= q_len) continue;
    T* dst = dq + q_off + qi * q_row;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim) store(dst + d, acc[a][c] * scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int n_heads, int n_kv, int q_len, int k_len, int head_dim, int causal, float scale) {
  const int bkv = blockIdx.x;
  const int b = bkv / n_kv, hkv = bkv - b * n_kv;
  const int group = n_heads / n_kv;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld = head_dim + 1;
  const int offset = k_len - q_len;

  extern __shared__ float smem[];
  float* k_s = smem;                    // [kTile][ld]
  float* v_s = k_s + kTile * ld;        // [kTile][ld]
  float* q_s = v_s + kTile * ld;        // [kTile][ld]
  float* do_s = q_s + kTile * ld;       // [kTile][ld]
  float* p_s = do_s + kTile * ld;       // [kTile][kSStride], rows are query rows
  float* ds_s = p_s + kTile * kSStride; // [kTile][kSStride]
  float* lse_s = ds_s + kTile * kSStride;  // [kTile]
  float* delta_s = lse_s + kTile;          // [kTile]

  const int64_t q_row = (int64_t)n_heads * head_dim;
  const int64_t kv_row = (int64_t)n_kv * head_dim;
  const int64_t kv_off = (int64_t)b * k_len * kv_row + (int64_t)hkv * head_dim;
  load_tile(k_s, k + kv_off, k0, k_len, kv_row, head_dim, ld);
  load_tile(v_s, v + kv_off, k0, k_len, kv_row, head_dim, ld);

  // this thread's block of the [kTile keys, D] dk and dv tiles: keys ty + 16a
  float dk_acc[kRows][kDCols], dv_acc[kRows][kDCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int j = 0; j < kDCols; ++j) dk_acc[a][j] = dv_acc[a][j] = 0.f;

  // causal: the first query row that sees key k0 is k0 - offset
  const int first_q = causal ? max(0, k0 - offset) : 0;
  const int n_q_tiles = (q_len + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const int bh = b * n_heads + h;
    const int64_t q_off = (int64_t)b * q_len * q_row + (int64_t)h * head_dim;
    for (int qt = first_q / kTile; qt < n_q_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's reads of q_s, do_s, p_s and ds_s are done
      load_tile(q_s, q + q_off, q0, q_len, q_row, head_dim, ld);
      load_tile(do_s, dout + q_off, q0, q_len, q_row, head_dim, ld);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const int qi = q0 + r;
        lse_s[r] = qi < q_len ? lse[(int64_t)bh * q_len + qi] : kBig;
        delta_s[r] = qi < q_len ? delta[(int64_t)bh * q_len + qi] : 0.f;
      }
      __syncthreads();

      float s[kRows][kCols], dp[kRows][kCols], row_lse[kRows], row_delta[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        row_lse[a] = lse_s[ty + 16 * a];
        row_delta[a] = delta_s[ty + 16 * a];
      }
      score_tile(q_s, k_s, do_s, v_s, head_dim, ld, s, dp, true);
      grad_tile(s, dp, row_lse, row_delta, q0, k0, q_len, k_len, causal, scale);
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          p_s[(ty + 16 * a) * kSStride + tx + 16 * c] = s[a][c];
          ds_s[(ty + 16 * a) * kSStride + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();

      for (int r = 0; r < kTile; ++r) {
        float pv[kRows], dsv[kRows], dov[kDCols], qv[kDCols];
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          pv[a] = p_s[r * kSStride + ty + 16 * a];
          dsv[a] = ds_s[r * kSStride + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kDCols; ++c) {
          const int d = tx + 16 * c;
          dov[c] = d < head_dim ? do_s[r * ld + d] : 0.f;
          qv[c] = d < head_dim ? q_s[r * ld + d] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int c = 0; c < kDCols; ++c) {
            dv_acc[a][c] = fmaf(pv[a], dov[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsv[a], qv[c], dk_acc[a][c]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= k_len) continue;
    T* dk_dst = dk + kv_off + kj * kv_row;
    T* dv_dst = dv + kv_off + kj * kv_row;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) {
      const int d = tx + 16 * c;
      if (d < head_dim) {
        store(dk_dst + d, dk_acc[a][c] * scale);
        store(dv_dst + d, dv_acc[a][c]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

size_t tile_floats(int head_dim) { return (size_t)kTile * (head_dim + 1); }
constexpr size_t kScoreFloats = (size_t)kTile * kSStride;

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                       int n_heads, int n_kv, int q_len, int k_len, int head_dim, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * tile_floats(head_dim) + kScoreFloats);
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (q_len + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), n_heads, n_kv, q_len, k_len, head_dim, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* dq, int batch, int n_heads, int n_kv, int q_len, int k_len,
                      int head_dim, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * tile_floats(head_dim) + kScoreFloats);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (q_len + kTile - 1) / kTile);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n_heads, n_kv, q_len, k_len, head_dim, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int batch, int n_heads, int n_kv, int q_len,
                       int k_len, int head_dim, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * tile_floats(head_dim) + 2 * kScoreFloats + 2 * kTile);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_kv, (k_len + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n_heads, n_kv, q_len, k_len, head_dim, causal, scale);
  return cudaGetLastError();
}

bool shapes_ok(int batch, int n_heads, int n_kv, int q_len, int k_len, int head_dim) {
  return batch > 0 && n_kv > 0 && n_heads % n_kv == 0 && q_len > 0 && k_len > 0 && head_dim > 0 &&
         head_dim <= kMaxHeadDim;
}

}  // namespace

// dtype: 0 = float32, the only type the entries take (the kernels are
// templates over the element type). Each entry returns the cudaError_t of its launch (0 = success); the
// caller checks it. Tensors are contiguous and their shapes validated by the
// caller.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out, void* lse,
                                       int batch, int n_heads, int n_kv, int q_len, int k_len, int head_dim,
                                       int causal, float scale, int dtype, void* stream) {
  if (!shapes_ok(batch, n_heads, n_kv, q_len, k_len, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(q, k, v, out, lse, batch, n_heads, n_kv, q_len, k_len, head_dim, causal,
                                  scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                                           const void* lse, const void* delta, void* dq, int batch, int n_heads,
                                           int n_kv, int q_len, int k_len, int head_dim, int causal, float scale,
                                           int dtype, void* stream) {
  if (!shapes_ok(batch, n_heads, n_kv, q_len, k_len, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq<float>(q, k, v, dout, lse, delta, dq, batch, n_heads, n_kv, q_len, k_len, head_dim,
                                 causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dk, void* dv, int batch,
                                            int n_heads, int n_kv, int q_len, int k_len, int head_dim,
                                            int causal, float scale, int dtype, void* stream) {
  if (!shapes_ok(batch, n_heads, n_kv, q_len, k_len, head_dim)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, n_kv, q_len, k_len,
                                  head_dim, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
