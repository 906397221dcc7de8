// Paged decode attention for Hopper (sm_90a): one decode step of attention
// over a heads-major paged KV pool.
//
// Replaces the TPU kernel the JAX package calls for the same step: the Pallas
// kernel that ships with JAX, jax.experimental.pallas.ops.tpu.paged_attention,
// reached from unionml_tpu/ops/paged_attention.py:84 (paged_decode_attention)
// under attention_impl="flash" (unionml_tpu/models/layers.py:346-354).
//
// Computes, for every batch row b and query head h:
//   out[b, h] = softmax_t(q[b, h] . K[h_kv, page(b, t), t % page_size])
//               @ V[h_kv, page(b, t), t % page_size],  t < lengths[b]
// with q pre-scaled by head_dim**-0.5 (the wrapper does it, as the JAX
// wrapper does), h_kv = h / (n_heads / n_kv_heads) (grouped-query attention)
// and page(b, t) = page_indices[b, t / page_size]. A row with length 0 writes
// zeros. The gathered copy pool[table] is never materialized.
//
// Bound: bytes. Every visible K and V row is read once per step while the
// arithmetic is 4 * group multiply-adds per element read, far below the
// card's operations-per-byte ridge, so the floor is (K + V bytes visible) /
// memory bandwidth.
//
// Design (simple first): one thread block per (b, kv_head) loads its GQA
// group's query rows into shared memory once, so each K/V page is read once
// for the whole group. It walks the row's pages up to lengths[b]; each page's
// K and V rows are staged in shared memory as f32, one warp per (head,
// position) pair reduces the q.k dot product, and an online softmax keeps a
// running max, a running sum and an f32 accumulator per head. The ragged last
// page is masked by only staging and reading its valid rows.
//
// Left for later: flash-decoding (splitting a long row's pages across several
// blocks plus a reduce, so B * H_kv blocks no longer bound the parallelism),
// cp.async/TMA page loads double-buffered against the arithmetic, and int8
// pages with per-position scales. On an H100, 16-byte vector loads alone left
// the time unchanged (PERF.md): a page costs the four barrier-separated phases
// of one 4-warp block, and only B * H_kv blocks run, so the split comes first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ lengths, const int* __restrict__ page_indices, T* __restrict__ out,
    int n_heads, int n_kv_heads, int head_dim, int n_pages, int page_size, int pages_per_seq) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                          // [group, head_dim]
  float* acc_s = q_s + group * head_dim;      // [group, head_dim]
  float* k_s = acc_s + group * head_dim;      // [page_size, head_dim]
  float* v_s = k_s + page_size * head_dim;    // [page_size, head_dim]
  float* p_s = v_s + page_size * head_dim;    // [group, page_size] scores, then weights
  float* m_s = p_s + group * page_size;       // [group] running max
  float* l_s = m_s + group;                   // [group] running sum
  float* alpha_s = l_s + group;               // [group] rescale for this page

  const int row_elems = group * head_dim;
  const int64_t q_base = ((int64_t)b * n_heads + (int64_t)kvh * group) * head_dim;
  for (int i = tid; i < row_elems; i += kThreads) {
    q_s[i] = to_float(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  if (tid < group) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // lengths and table entries come from the serving engine; clamp them to
  // the table and the pool instead of reading out of bounds
  const int max_len = pages_per_seq * page_size;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > max_len ? max_len : length);
  const int n_tiles = (length + page_size - 1) / page_size;
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    int page = page_indices[(int64_t)b * pages_per_seq + tile];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    const int valid = min(page_size, length - tile * page_size);
    // one page of one KV head is a contiguous [page_size, head_dim] run
    const int64_t base = (((int64_t)kvh * n_pages + page) * page_size) * head_dim;
    const int n = valid * head_dim;
    for (int i = tid; i < n; i += kThreads) {
      k_s[i] = to_float(k_pages[base + i]);
      v_s[i] = to_float(v_pages[base + i]);
    }
    __syncthreads();

    for (int pair = warp; pair < group * valid; pair += kWarps) {
      const int g = pair / valid;
      const int t = pair - g * valid;
      float partial = 0.f;
      for (int d = lane; d < head_dim; d += 32) {
        partial += q_s[g * head_dim + d] * k_s[t * head_dim + d];
      }
      for (int offset = 16; offset > 0; offset >>= 1) {
        partial += __shfl_xor_sync(0xffffffffu, partial, offset);
      }
      if (lane == 0) p_s[g * page_size + t] = partial;
    }
    __syncthreads();

    if (tid < group) {
      const int g = tid;
      float* scores = p_s + g * page_size;
      const float m_old = m_s[g];
      float m_new = m_old;
      for (int t = 0; t < valid; ++t) m_new = fmaxf(m_new, scores[t]);
      // m_old is -inf on the first page, so the stale (zero) state drops out
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int t = 0; t < valid; ++t) {
        const float p = expf(scores[t] - m_new);
        scores[t] = p;
        sum += p;
      }
      m_s[g] = m_new;
      l_s[g] = l_s[g] * alpha + sum;
      alpha_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < row_elems; i += kThreads) {
      const int g = i / head_dim;
      const int d = i - g * head_dim;
      const float* weights = p_s + g * page_size;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < valid; ++t) a += weights[t] * v_s[t * head_dim + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < row_elems; i += kThreads) {
    const float l = l_s[i / head_dim];
    store(out + q_base + i, l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* lengths,
                   const int* page_indices, void* out, int batch, int n_heads, int n_kv_heads,
                   int head_dim, int n_pages, int page_size, int pages_per_seq, cudaStream_t stream) {
  const int group = n_heads / n_kv_heads;
  const size_t smem = sizeof(float) * (2 * (size_t)group * head_dim + 2 * (size_t)page_size * head_dim +
                                       (size_t)group * page_size + 3 * (size_t)group);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch, n_kv_heads);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      lengths, page_indices, static_cast<T*>(out), n_heads, n_kv_heads, head_dim, n_pages,
      page_size, pages_per_seq);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 = success); the caller checks it. Shapes are validated by the caller.
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* lengths, const void* page_indices, void* out,
                                      int batch, int n_heads, int n_kv_heads, int head_dim,
                                      int n_pages, int page_size, int pages_per_seq, int dtype,
                                      void* stream) {
  if (batch == 0) return 0;
  const int* lens = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(page_indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_pages, v_pages, lens, table, out, batch, n_heads, n_kv_heads, head_dim,
                        n_pages, page_size, pages_per_seq, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_pages, v_pages, lens, table, out, batch, n_heads, n_kv_heads,
                                head_dim, n_pages, page_size, pages_per_seq, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
