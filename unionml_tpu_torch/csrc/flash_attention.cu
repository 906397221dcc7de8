// Flash attention for Hopper (sm_90a), float32: the blocked online-softmax
// forward.
//
// Replaces the TPU kernel of unionml_tpu/ops/flash_attention.py:
//   flash_fwd_kernel <- _flash_fwd_kernel (pallas_call at :160)
// reached under attention_impl="flash" for every unmasked attention call
// (unionml_tpu/ops/attention.py:82-87): the training forward. It takes
// float32 only: it is the f32 route; bfloat16 runs on the tensor cores
// (flash_forward.cu). The f32 backward is flash_backward_f32.cu.
//
// Layout as in the JAX package: q [B, Lq, H, D], k/v [B, Lk, Hkv, D], all
// contiguous; lse [B, H, Lq] f32. Query head h reads KV head h / (H / Hkv)
// (grouped-query attention, no repeated K/V). Causal masking lets query row
// i see key j when i + (Lk - Lq) >= j; tiles wholly above that shifted
// diagonal are skipped. Scores are scale * q.k with scale = D**-0.5, in f32.
//
//   out = softmax(S) V, lse = m + log(l) per row; a row that sees no key
//   writes 0 and lse = 1e30 (so the backward's exp(S - lse) is 0 there).
//
// Bound: operations. At the main path's shape (B=1, L=2048, H=32, Hkv=8,
// D=128, causal) it does 2 products of 2 * Lq * Lk * D multiply-adds per
// head, halved by causality, against a few MB of inputs: far above the
// card's operations-per-byte ridge.
//
// Design (simple first): one 256-thread block per (64-row tile, b * h), a
// 16 x 16 thread grid. Tiles are staged in shared memory as f32 (row stride
// D + 1 keeps the column reads of the score loop free of bank conflicts).
// Each thread owns a 4 x 4 block of the 64 x 64 score tile and a 4 x 8 block
// of the 64 x 128 output tile, accumulated in registers with f32 FMAs on the
// CUDA cores; row statistics are reduced across the 16 lanes that share a
// row with warp shuffles. Ragged tiles (a length that is not a multiple of
// 64) are zero-filled on load and masked.
//
// Left for later: the tensor cores in 3xTF32, as the backward does
// (csrc/hopper.cuh's mma_1688_3xtf32).

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

// s[a][c] = q_s[ty + 16a] . k_s[tx + 16c] over the head dim.
__device__ __forceinline__ void score_tile(const float* q_s, const float* k_s, int head_dim, int ld,
                                           float (&s)[kRows][kCols]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[a][c] = 0.f;
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

    float s[kRows][kCols];
    score_tile(q_s, k_s, head_dim, ld, s);

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
