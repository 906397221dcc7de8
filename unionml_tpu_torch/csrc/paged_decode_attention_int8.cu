// Paged decode attention over int8 pages for Hopper (sm_90a): one decode step
// of attention over a heads-major paged KV pool stored as int8 values with one
// f32 scale per (position, KV head).
//
// Replaces the int8-page mode of the TPU kernel the JAX package calls for the
// same step: the Pallas kernel that ships with JAX,
// jax.experimental.pallas.ops.tpu.paged_attention, with QuantizedTensor pages,
// reached from unionml_tpu/ops/paged_attention.py:75-84 (paged_decode_attention
// with k_scales/v_scales).
//
// Computes, for every batch row b and query head h:
//   K'[t] = bf16_or_f32(float(K[h_kv, page(b, t), t % page_size]) * k_scale[...])
//   out[b, h] = softmax_t(q'[b, h] . K'[t]) @ V'[t],  t < lengths[b]
// where K' and V' are the int8 rows times their scale in f32, rounded to q's
// dtype (what the JAX package's int8 gather path computes before attending,
// unionml_tpu/models/layers.py:342-343), q' = q * head_dim**-0.5 rounded to
// q's dtype, h_kv = h / (n_heads / n_kv_heads) and page(b, t) =
// page_indices[b, t / page_size]. Lengths are clamped to [0, pages_per_seq *
// page_size] and table entries to [0, n_pages - 1]; a row of length 0 writes
// zeros. The gathered copy pool[table] is never made.
//
// Bound: bytes. Each visible position reads D bytes of K, D of V and two f32
// scales (the JAX library kernel broadcasts its scales to the full head width,
// about 5 bytes an element; here about 1), against 4 * group multiply-adds an
// element read.
//
// Design (the first for this mode; simple and right before fast):
//  - Split (flash-decoding), as the bf16 kernel: one block a (row, KV head,
//    tile of up to 8 heads, split), the splits of one (row, KV head, tile) a
//    thread-block cluster of up to 16 that combines its partials through
//    distributed shared memory in the same launch, in rank order. The wrapper
//    plans the split from shapes alone (_plan in ops/paged_attention.py).
//  - Rows loaded straight from device memory, no staging: the split's table
//    entries go to shared memory first, then a key row is split across L
//    lanes, 8 int8 values (8 bytes) a lane, neighbouring lanes on
//    neighbouring bytes; its scale is one 4-byte load shared by the row's
//    lanes. A warp takes 32 / L keys at once, C of them in flight a lane.
//  - CUDA cores in f32: each value is dequantized and rounded to q's dtype as
//    the twin rounds it, the group's q rows and P.V accumulators stay in
//    registers, dot products reduce by shuffles, and each (warp, key slot)
//    keeps its own online softmax, merged by shuffles, then across the 8 warps
//    through shared memory, then across the cluster.
//
// Limits: head_dim % 8 == 0 and head_dim <= 256; q and out float32 or
// bfloat16; pages int8, scales float32 [H_kv, n_pages, page_size, 1]; pools
// 8-byte aligned. The wrapper checks them.
//
// Left for later: staging pages through shared memory with bulk copies (the
// bf16 kernel's ring) and tensor cores for the products.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int C = 4;             // keys a key slot takes at once (independent loads in flight)
constexpr int kMaxCluster = 16;  // the non-portable cluster size of an H100
constexpr int kMaxHeadTile = 8;  // heads of a group one block takes
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

static_assert(kWarps <= kMaxCluster, "the weights buffer holds one row per warp or per rank");

// 4-byte words of one block's shared memory: the warps' partials (acc[G, D], m[G], l[G] each), the slices and
// (m, l) pushed by the cluster's ranks, the merge weights ([ranks or warps, G]) and the per-head sums, then the
// split's table entries
struct Smem {
  int part, warp_part, recv, weights, table, total;
  __host__ __device__ Smem(int heads, int head_dim, int per_split) {
    part = (heads * head_dim + 2 * heads + 3) & ~3;
    warp_part = 0;
    recv = kWarps * part;
    weights = recv + ((heads * head_dim + kMaxCluster + kMaxCluster * 2 * heads + 3) & ~3);
    table = weights + (kMaxCluster + 1) * heads;
    total = table + per_split;
  }
};

// q * scale rounded to q's dtype, as (q * scale).to(q.dtype) computes it
__device__ __forceinline__ float scaled(float x, float scale) { return __fmul_rn(x, scale); }
__device__ __forceinline__ float scaled(__nv_bfloat16 x, float scale) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(__bfloat162float(x), scale)));
}

// value e (0..7) of 8 packed int8 values times its scale in f32, rounded to T as (int8 * scale).to(T) rounds it
template <typename T>
__device__ __forceinline__ float dequant(uint2 w, int e, float s);
template <>
__device__ __forceinline__ float dequant<float>(uint2 w, int e, float s) {
  const uint32_t word = e < 4 ? w.x : w.y;
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(word >> (8 * (e & 3)))), s);
}
template <>
__device__ __forceinline__ float dequant<__nv_bfloat16>(uint2 w, int e, float s) {
  return __bfloat162float(__float2bfloat16(dequant<float>(w, e, s)));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// weight of a partial whose running max is m in a sum whose max is mx; 0 for a partial that saw no key
__device__ __forceinline__ float weight(float m, float mx) { return m == -INFINITY ? 0.f : expf(m - mx); }

// grid: x = splits (one cluster), y = KV heads x head tiles, z = rows. L lanes a key row, G heads a tile.
template <typename T, int L, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_int8_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages, const int8_t* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales, const int* __restrict__ lengths,
    const int* __restrict__ page_indices, T* __restrict__ out, int n_heads, int group, int head_dim, int n_pages,
    int page_size, int pages_per_seq, int splits, int per_split, float scale) {
  const int tiles = (group + G - 1) / G;
  const int kvh = blockIdx.y / tiles;
  const int tile = blockIdx.y - kvh * tiles;
  const int b = blockIdx.z;
  const int h0 = kvh * group + tile * G;
  const int n_h = min(G, group - tile * G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Smem lay(G, head_dim, per_split);
  extern __shared__ __align__(16) float smem[];
  float* warp_part = smem + lay.warp_part;
  float* recv = smem + lay.recv;
  float* wgt = smem + lay.weights;
  int* table = reinterpret_cast<int*>(smem + lay.table);
  // a peer's shared memory may be written only once the peer has started: arrive now, wait before the pushes
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // lengths and table entries come from the serving engine; clamp them to the table and the pool. The split's
  // entries are staged in shared memory first, so a key's row load waits on no device-memory table read.
  const int max_len = pages_per_seq * page_size;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > max_len ? max_len : length);
  const int first = blockIdx.x * per_split;
  const int key_begin = first * page_size;
  const int key_end = min(length, (first + per_split) * page_size);
  const int* row_table = page_indices + static_cast<int64_t>(b) * pages_per_seq + first;
  for (int i = tid; i < min(per_split, pages_per_seq - first); i += kThreads) {
    const int page = row_table[i];
    table[i] = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  }
  __syncthreads();
  const int64_t head_pages = static_cast<int64_t>(kvh) * n_pages;

  constexpr int R = 32 / L;                          // keys a warp takes at once
  const int slot = lane / L, col = (lane % L) * 8;  // the warp's key slot, this lane's 8 columns
  const bool has_col = col < head_dim;
  float qr[G][8], acc[G][8], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    const T* row = q + (static_cast<int64_t>(b) * n_heads + h0 + g) * head_dim + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < n_h && has_col ? scaled(row[e], scale) : 0.f;
    }
  }

  // a chunk: C keys a key slot (R slots a warp); warp-uniform, so every lane takes the shuffles
  for (int t0 = key_begin + warp * R * C; t0 < key_end; t0 += kWarps * R * C) {
    uint2 kr[C], vr[C];
    float ks[C], vs[C], sc[C][G];
    bool ok[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int t = t0 + c * R + slot;
      ok[c] = t < key_end;
      kr[c] = vr[c] = make_uint2(0u, 0u);
      ks[c] = vs[c] = 0.f;
      if (ok[c]) {
        const int64_t pos = (head_pages + table[t / page_size - first]) * page_size + t % page_size;
        ks[c] = k_scales[pos];
        vs[c] = v_scales[pos];
        if (has_col) {
          kr[c] = *reinterpret_cast<const uint2*>(k_pages + pos * head_dim + col);
          vr[c] = *reinterpret_cast<const uint2*>(v_pages + pos * head_dim + col);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float kf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = dequant<T>(kr[c], e, ks[c]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        sc[c][g] = dot;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int g = 0; g < G; ++g) sc[c][g] += __shfl_xor_sync(0xffffffffu, sc[c][g], off);
      }
    }
    if (!ok[0]) continue;  // the slot's first key is masked, so all its keys are
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int c = 0; c < C; ++c) mx = ok[c] ? fmaxf(mx, sc[c][g]) : mx;
      const float a = __expf(m[g] - mx);  // 0 on the slot's first chunk (m = -inf), 1 if the max held
      m[g] = mx;
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float vf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] = dequant<T>(vr[c], e, vs[c]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ok[c] ? __expf(sc[c][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // the warp's key slots merge by shuffles; slot 0 (lanes 0..L-1) holds the warp's partial
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = weight(m[g], mx), c = weight(mo, mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c;
      m[g] = mx;
    }
  }
  float* mine = warp_part + warp * lay.part;  // acc[G, D], then m[G], then l[G]
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (has_col) {
#pragma unroll
        for (int e = 0; e < 8; ++e) mine[g * head_dim + col + e] = acc[g][e];
      }
      if (lane == 0) {
        mine[G * head_dim + g] = m[g];
        mine[G * head_dim + G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the warps merge in order: the weight of each (warp, head) against the head's max once, then one weighted
  // sum per element. Unsplit, that is the output. Split, each block pushes its partial into the shared memory
  // of the rank that owns the element's slice (and its (m, l) into every rank's) before one cluster barrier;
  // each rank then combines its slice from local memory, the ranks in order.
  const int part = lay.part;
  const int n_out = n_h * head_dim;
  const int per = (n_out + splits - 1) / splits;  // output elements a rank combines
  const int rank = blockIdx.x;                    // the cluster is the grid's x extent
  float* recv_ml = recv + splits * per;           // [rank][m[G], l[G]] of every rank
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
  if (tid < n_h) {
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_part[w * part + G * head_dim + tid]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = weight(warp_part[w * part + G * head_dim + tid], mx);
      wgt[w * G + tid] = c;
      sum += warp_part[w * part + G * head_dim + G + tid] * c;
    }
    wgt[kMaxCluster * G + tid] = sum;
    if (splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = 0; r < splits; ++r) {
        float* dst = cluster.map_shared_rank(recv_ml, r) + rank * 2 * G;
        dst[tid] = mx;
        dst[G + tid] = sum;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n_out; idx += kThreads) {
    const int g = idx / head_dim;
    float a_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a_sum += warp_part[w * part + idx] * wgt[w * G + g];
    if (splits == 1) {
      const float sum = wgt[kMaxCluster * G + g];
      store(out + (static_cast<int64_t>(b) * n_heads + h0) * head_dim + idx, sum > 0.f ? a_sum / sum : 0.f);
    } else {
      const int owner = idx / per;
      cg::this_cluster().map_shared_rank(recv, owner)[rank * per + idx - owner * per] = a_sum;
    }
  }
  if (splits == 1) return;

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's pushes have landed; nothing remote is read after this
  float* total = wgt + kMaxCluster * G;  // l over the cluster, per head (the block's own sum is consumed)
  if (tid < n_h) {
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, recv_ml[r * 2 * G + tid]);
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float c = weight(recv_ml[r * 2 * G + tid], mx);  // 0 for a rank that saw no key: it adds nothing
      wgt[r * G + tid] = c;
      sum += recv_ml[r * 2 * G + G + tid] * c;
    }
    total[tid] = sum;
  }
  __syncthreads();
  const int begin = rank * per;
  for (int j = tid; j < min(per, n_out - begin); j += kThreads) {
    const int g = (begin + j) / head_dim;
    float a_sum = 0.f;
    for (int r = 0; r < splits; ++r) a_sum += recv[r * per + j] * wgt[r * G + g];
    const float sum = total[g];
    store(out + (static_cast<int64_t>(b) * n_heads + h0) * head_dim + begin + j, sum > 0.f ? a_sum / sum : 0.f);
  }
}

template <typename T, int L, int G>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                   const void* v_scales, const int* lengths, const int* page_indices, void* out, int batch,
                   int n_heads, int n_kv_heads, int head_dim, int n_pages, int page_size, int pages_per_seq,
                   int splits, int per_split, float scale, cudaStream_t stream) {
  auto kernel = paged_decode_int8_kernel<T, L, G>;
  static bool configured[kMaxDevices] = {};  // the attributes are set once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const int group = n_heads / n_kv_heads;
  const Smem lay(G, head_dim, per_split);
  const int smem_bytes = lay.total * static_cast<int>(sizeof(float));
  if (smem_bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(n_kv_heads * ((group + G - 1) / G)),
                        static_cast<unsigned>(batch));
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(q), static_cast<const int8_t*>(k_pages),
                           static_cast<const int8_t*>(v_pages), static_cast<const float*>(k_scales),
                           static_cast<const float*>(v_scales), lengths, page_indices, static_cast<T*>(out), n_heads,
                           group, head_dim, n_pages, page_size, pages_per_seq, splits, per_split, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#define PAGED_INT8_ARGS                                                                                       \
  q, k, v, ks, vs, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps, splits, per_split, \
      scale, s

// G = the heads of a tile (a power of two)
template <typename T, int L>
cudaError_t by_heads(int tile, const void* q, const void* k, const void* v, const void* ks, const void* vs,
                     const int* lens, const int* table, void* out, int batch, int n_heads, int n_kv, int head_dim,
                     int n_pages, int page_size, int pps, int splits, int per_split, float scale, cudaStream_t s) {
  switch (tile) {
    case 1:
      return launch<T, L, 1>(PAGED_INT8_ARGS);
    case 2:
      return launch<T, L, 2>(PAGED_INT8_ARGS);
    case 4:
      return launch<T, L, 4>(PAGED_INT8_ARGS);
    case 8:
      return launch<T, L, 8>(PAGED_INT8_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
}

// L = the lanes of a key row (8 values each, a power of two)
template <typename T>
cudaError_t by_width(int lanes, int tile, const void* q, const void* k, const void* v, const void* ks,
                     const void* vs, const int* lens, const int* table, void* out, int batch, int n_heads, int n_kv,
                     int head_dim, int n_pages, int page_size, int pps, int splits, int per_split, float scale,
                     cudaStream_t s) {
#define PAGED_INT8_BY_HEADS(LANES) by_heads<T, LANES>(tile, PAGED_INT8_ARGS)
  switch (lanes) {
    case 1:
      return PAGED_INT8_BY_HEADS(1);
    case 2:
      return PAGED_INT8_BY_HEADS(2);
    case 4:
      return PAGED_INT8_BY_HEADS(4);
    case 8:
      return PAGED_INT8_BY_HEADS(8);
    case 16:
      return PAGED_INT8_BY_HEADS(16);
    case 32:
      return PAGED_INT8_BY_HEADS(32);
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_INT8_BY_HEADS
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16; pages int8, scales float32. splits (1..16) blocks of a
// cluster share each (row, KV head, head tile), per_split table entries each (splits * per_split >=
// pages_per_seq); scale = head_dim**-0.5 as a float. Returns the cudaError_t of the launch (0 = success); the
// caller validated shapes, types, contiguity and alignment.
extern "C" int paged_decode_attention_int8(const void* q, const void* k_pages, const void* v_pages,
                                           const void* k_scales, const void* v_scales, const void* lengths,
                                           const void* page_indices, void* out, int batch, int n_heads,
                                           int n_kv_heads, int head_dim, int n_pages, int page_size,
                                           int pages_per_seq, int splits, int per_split, int dtype, float scale,
                                           void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || n_kv_heads <= 0 || n_heads % n_kv_heads || head_dim <= 0 || head_dim % 8 || head_dim > 256 ||
      n_pages <= 0 || page_size <= 0 || pages_per_seq < 0 || splits < 1 || splits > kMaxCluster || per_split < 1 ||
      static_cast<int64_t>(splits) * per_split < pages_per_seq) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lanes = next_pow2(head_dim / 8);
  const int tile = next_pow2(n_heads / n_kv_heads < kMaxHeadTile ? n_heads / n_kv_heads : kMaxHeadTile);
  const int* lens = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(page_indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void *q_ = q, *k = k_pages, *v = v_pages, *ks = k_scales, *vs = v_scales;
  cudaError_t err;
  if (dtype == 0) {
    err = by_width<float>(lanes, tile, q_, k, v, ks, vs, lens, table, out, batch, n_heads, n_kv_heads, head_dim,
                          n_pages, page_size, pages_per_seq, splits, per_split, scale, s);
  } else if (dtype == 1) {
    err = by_width<__nv_bfloat16>(lanes, tile, q_, k, v, ks, vs, lens, table, out, batch, n_heads, n_kv_heads,
                                  head_dim, n_pages, page_size, pages_per_seq, splits, per_split, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
