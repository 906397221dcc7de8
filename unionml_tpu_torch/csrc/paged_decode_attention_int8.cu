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
// element read. Dequantizing costs a few instructions an element read, so a
// kernel that also waits on each row's load is bound by issue and latency
// long before the bytes (the first design, direct loads on CUDA cores, reached
// 11-18 % of the bytes bound at long context).
//
// Design (the second, written for Hopper from the bf16-page kernel's parts):
//  - Split (flash-decoding), as the bf16 kernel: one block a (row, KV head,
//    tile of up to 8 heads, split), the splits of one (row, KV head, tile) a
//    thread-block cluster of up to 16 that combines its partials through
//    distributed shared memory in the same launch, in rank order. The wrapper
//    plans the split from shapes alone (_plan in ops/paged_attention.py) and
//    picks the route (_int8_route), which arrives here as an argument.
//  - Route "mma" (bf16 q, D % 16 == 0, page_size % 4 == 0, pools and scales
//    on a 16-byte boundary, a stage within the ring's 72 KB): a ninth warp
//    stages the split's table entries, then two of its lanes (alternate
//    entries) copy each entry's int8 K page, int8 V page, K scales and V
//    scales ([page_size] f32 each, contiguous in the
//    [H_kv, n_pages, page_size, 1] layout) with four 1D bulk copies into a
//    ring of up to 16 stages (an int8 page is half a bf16 page: twice the
//    pages in flight for the ring's bytes), completing on `full` mbarriers and
//    refilled once the reader arrives on `empty`. A reader waits for its
//    page by the parity of the stage's fill, so each stage has one reader
//    (the plan's stage count, _plan, and min(8, stages) readers): a reader
//    has read the stage's previous fill itself and cannot take it for its
//    own. Tensor cores, one warp a page; per 16 keys:
//    S^T[keys, heads] = K . q^T on mma.sync m16n8k16 with the keys as M and
//    the tile's heads as N. The K operand is built in registers from the
//    staged int8 bytes (a lane loads W = 4, 8 or 16 bytes of each of its two
//    rows, W / 4 k-steps, with q's B fragments in the same permuted d order),
//    each value dequantized as the twin rounds it: int8 -> f32 exactly (a byte
//    placed in the mantissa of 2^23, minus 2^23 + 128), __fmul_rn by the
//    position's scale, round to nearest bf16. V is dequantized the same way
//    into the warp's own bf16 tile in shared memory, rows padded by 16 bytes
//    (an odd number of 16-byte units apart, so the eight rows an ldmatrix
//    reads fall on distinct banks), and the stage is released; then the bf16
//    kernel's loop: an online softmax per head in registers, P^T rounded to
//    bf16 and moved to the B layout by shuffles, O^T += V^T . P^T with V^T
//    read from the tile by ldmatrix.trans.
//  - Route "direct" (f32 q, and every shape outside the mma route, with no
//    producer warp and no ring): the first design's loop on CUDA cores, rows
//    read straight from device memory, 8 bytes a lane, a key row split across
//    L lanes, dot products reduced by shuffles, an online softmax per (warp,
//    key slot), merged by shuffles. (A CUDA-core loop over the staged ring
//    for f32 q ran no faster than these direct loads on an H100, so f32 q
//    keeps them.)
//  - The 8 warps' partials merge in order through shared memory once, then
//    across the cluster. One launch a call, no scratch in device memory, the
//    same bits on every call.
//
// Limits: head_dim % 8 == 0 and head_dim <= 256; q and out float32 or
// bfloat16; pages int8, scales float32 [H_kv, n_pages, page_size, 1]; pools
// 8-byte aligned. The wrapper checks them.
//
// What holds it back (bf16 q, D=128, 16-position pages, an H100;
// scripts/paged_decode_int8_phases.py stamps a copy with %globaltimer): a
// block's pages land one after another, a few tenths of a microsecond apart
// (10-13 GB/s a block), a reading warp takes about 1.5 us a page (S, the V
// tile, softmax and P.V), and the cluster's combine takes 3-4 us, most of it
// waiting for the slowest rank. Left for later: a faster copy stream per
// block; splitting a page's dequantize across warps; a shorter combine.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                          // warps that read keys; the mma route adds a copying warp
constexpr int kDirectThreads = 32 * kWarps;
constexpr int kMmaThreads = 32 * (kWarps + 1);
constexpr int kDirectKeys = 4;  // keys a key slot of the direct route takes at once (independent loads in flight)
constexpr int kMaxCluster = 16;  // the non-portable cluster size of an H100
constexpr int kMaxStages = 16;
constexpr int kMaxHeadTile = 8;  // heads of a group one block takes
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kRouteDirect = 0, kRouteMma = 1;  // as ops/paged_attention.py's _INT8_ROUTES

static_assert(kWarps <= kMaxCluster, "the weights buffer holds one row per warp or per rank");

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// bytes between two rows of a warp's bf16 V tile (16 rows of head_dim = 16 DT values): 16 more than a row, an
// odd number of 16-byte units, so the 8 rows an ldmatrix reads fall on 8 distinct 16-byte bank groups
__host__ __device__ constexpr int tile_stride(int dt) { return 32 * dt + 16; }

// byte offsets in one block's dynamic shared memory: 2 x kMaxStages mbarriers, the split's table entries, one
// region a reading warp (its partial acc[heads, D], m[heads], l[heads] in f32, which the tensor-core route first
// uses as the warp's V tile), the slices and (m, l) pushed by the cluster's ranks, the merge weights ([ranks or
// warps, heads], then [heads] sums), then the ring of `stages` stages
struct Smem {
  int table, warp_part, part, recv, weights, ring, total;
  __host__ __device__ Smem(int heads, int head_dim, int per_split, int stages, int stage_bytes, int tile_bytes) {
    const int partial = align16((heads * head_dim + 2 * heads) * 4);
    table = 2 * kMaxStages * 8;
    warp_part = align16(table + per_split * 4);
    part = partial > align16(tile_bytes) ? partial : align16(tile_bytes);
    recv = warp_part + kWarps * part;
    weights = recv + align16((heads * head_dim + kMaxCluster + kMaxCluster * 2 * heads) * 4);
    ring = weights + align16((kMaxCluster + 1) * heads * 4);
    total = ring + stages * stage_bytes;
  }
};

// one stage: the int8 K page, the int8 V page, the K scales, the V scales (page_size f32 each)
__host__ __device__ constexpr int stage_bytes(int page_size, int head_dim) {
  return 2 * page_size * head_dim + 8 * page_size;
}

// q * scale rounded to q's dtype, as (q * scale).to(q.dtype) computes it
__device__ __forceinline__ float scaled(float x, float scale) { return __fmul_rn(x, scale); }
__device__ __forceinline__ float scaled(__nv_bfloat16 x, float scale) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(__bfloat162float(x), scale)));
}

// int8 value e (0..3) of a word as an exact f32: its byte, biased by 128, in the mantissa of 2^23, minus
// 2^23 + 128 (two full-rate instructions; the XOR is shared by the word's four values)
__device__ __forceinline__ float int8_f32(uint32_t word, int e) {
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7540 + e)) - 8388736.f;
}

// value e (0..7) of 8 packed int8 values times its scale in f32, rounded to T as (int8 * scale).to(T) rounds it
template <typename T>
__device__ __forceinline__ float dequant(uint2 w, int e, float s);
template <>
__device__ __forceinline__ float dequant<float>(uint2 w, int e, float s) {
  return __fmul_rn(int8_f32(e < 4 ? w.x : w.y, e & 3), s);
}
template <>
__device__ __forceinline__ float dequant<__nv_bfloat16>(uint2 w, int e, float s) {
  return __bfloat162float(__float2bfloat16(dequant<float>(w, e, s)));
}

// int8 values 2h and 2h + 1 of a word times `s` in f32, each rounded to bf16 as the twin rounds it, packed with
// value 2h in the low half: one bf16x2 operand register
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t word, int h, float s) {
  return pack_bf16(__fmul_rn(int8_f32(word, 2 * h), s), __fmul_rn(int8_f32(word, 2 * h + 1), s));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// weight of a partial whose running max is m in a sum whose max is mx; 0 for a partial that saw no key
__device__ __forceinline__ float weight(float m, float mx) { return m == -INFINITY ? 0.f : expf(m - mx); }

// The CUDA-core routes' step: NC keys of each key slot (their rows, 8 int8 values a lane, and scales), dequantized
// to T as the twin rounds them; dot products reduced over the L lanes of a row (warp-uniform: every lane takes the
// shuffles), then the slot's online softmax and P.V in f32.
template <typename T, int L, int G, int NC>
__device__ __forceinline__ void attend(const uint2 (&kr)[NC], const uint2 (&vr)[NC], const float (&ks)[NC],
                                       const float (&vs)[NC], const bool (&ok)[NC], const float (&qr)[G][8],
                                       float (&acc)[G][8], float (&m)[G], float (&l)[G]) {
  float sc[NC][G];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
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
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int g = 0; g < G; ++g) sc[c][g] += __shfl_xor_sync(0xffffffffu, sc[c][g], off);
    }
  }
  if (!ok[0]) return;  // the slot's first key is masked, so all its keys are
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = m[g];
#pragma unroll
    for (int c = 0; c < NC; ++c) mx = ok[c] ? fmaxf(mx, sc[c][g]) : mx;
    const float a = __expf(m[g] - mx);  // 0 on the slot's first chunk (m = -inf), 1 if the max held
    m[g] = mx;
    l[g] *= a;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] *= a;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
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

// q rows of the CUDA-core routes: this lane's 8 columns of each head of the tile, pre-scaled; zeroed accumulators
template <typename T, int G>
__device__ __forceinline__ void load_q_rows(const T* q, int col, bool has_col, int n_h, float scale,
                                            float (&qr)[G][8], float (&acc)[G][8], float (&m)[G], float (&l)[G],
                                            int head_dim) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    const T* row = q + g * head_dim + col;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < n_h && has_col ? scaled(row[e], scale) : 0.f;
    }
  }
}

// the CUDA-core routes' key slots merge by shuffles; slot 0 (lanes 0..L-1) writes the warp's partial to `mine`
template <int L, int G>
__device__ __forceinline__ void write_slots(float (&acc)[G][8], float (&m)[G], float (&l)[G], float* mine, int lane,
                                            int col, bool has_col, int head_dim) {
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
  if (lane < L) {
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
}

// The warps' partials (acc[G, D], m[G], l[G] a warp region) merge in order: the weight of each (warp, head)
// against the head's max once, then one weighted sum per element. Unsplit, that is the output. Split, each block
// pushes its partial into the shared memory of the rank that owns the element's slice (and its (m, l) into every
// rank's) before one cluster barrier; each rank then combines its slice from local memory, the ranks in order.
// Every thread of the block calls it, after a block barrier; `out_row` is out[b, h0].
template <typename T, int G, int NT>
__device__ __forceinline__ void combine(uint8_t* smem, const Smem& lay, T* out_row, int n_h, int head_dim,
                                        int splits, int tid) {
  const float* warp_part = reinterpret_cast<const float*>(smem + lay.warp_part);
  float* recv = reinterpret_cast<float*>(smem + lay.recv);
  float* wgt = reinterpret_cast<float*>(smem + lay.weights);
  const int part = lay.part / 4;  // floats between two warps' partials
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
  for (int idx = tid; idx < n_out; idx += NT) {
    const int g = idx / head_dim;
    float a_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a_sum += warp_part[w * part + idx] * wgt[w * G + g];
    if (splits == 1) {
      const float sum = wgt[kMaxCluster * G + g];
      store(out_row + idx, sum > 0.f ? a_sum / sum : 0.f);
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
  for (int j = tid; j < min(per, n_out - begin); j += NT) {
    const int g = (begin + j) / head_dim;
    float a_sum = 0.f;
    for (int r = 0; r < splits; ++r) a_sum += recv[r * per + j] * wgt[r * G + g];
    const float sum = total[g];
    store(out_row + begin + j, sum > 0.f ? a_sum / sum : 0.f);
  }
}

// lengths and table entries come from the serving engine: a row's length clamped to the table
__device__ __forceinline__ int clamped_length(const int* lengths, int b, int max_len) {
  const int length = lengths[b];
  return length < 0 ? 0 : (length > max_len ? max_len : length);
}

__device__ __forceinline__ int clamped_page(int page, int n_pages) {
  return page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
}

// Route "direct". grid: x = splits (one cluster), y = KV heads x head tiles, z = rows. L lanes a key row, G heads
// a tile.
template <typename T, int L, int G>
__global__ void __launch_bounds__(kDirectThreads) paged_decode_int8_direct(
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

  const Smem lay(G, head_dim, per_split, 0, 0, 0);
  extern __shared__ __align__(16) uint8_t smem[];
  int* table = reinterpret_cast<int*>(smem + lay.table);
  // a peer's shared memory may be written only once the peer has started: arrive now, wait before the pushes
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the split's entries are staged in shared memory first, so a key's row load waits on no device-memory table read
  const int length = clamped_length(lengths, b, pages_per_seq * page_size);
  const int first = blockIdx.x * per_split;
  const int key_begin = first * page_size;
  const int key_end = min(length, (first + per_split) * page_size);
  const int* row_table = page_indices + static_cast<int64_t>(b) * pages_per_seq + first;
  for (int i = tid; i < min(per_split, pages_per_seq - first); i += kDirectThreads) {
    table[i] = clamped_page(row_table[i], n_pages);
  }
  __syncthreads();
  const int64_t head_pages = static_cast<int64_t>(kvh) * n_pages;

  constexpr int R = 32 / L;                          // keys a warp takes at once
  const int slot = lane / L, col = (lane % L) * 8;  // the warp's key slot, this lane's 8 columns
  const bool has_col = col < head_dim;
  float qr[G][8], acc[G][8], m[G], l[G];
  load_q_rows<T, G>(q + (static_cast<int64_t>(b) * n_heads + h0) * head_dim, col, has_col, n_h, scale, qr, acc, m, l,
                    head_dim);

  // a chunk: kDirectKeys keys a key slot (R slots a warp)
  constexpr int NC = kDirectKeys;
  for (int t0 = key_begin + warp * R * NC; t0 < key_end; t0 += kWarps * R * NC) {
    uint2 kr[NC], vr[NC];
    float ks[NC], vs[NC];
    bool ok[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
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
    attend<T, L, G, NC>(kr, vr, ks, vs, ok, qr, acc, m, l);
  }
  write_slots<L, G>(acc, m, l, reinterpret_cast<float*>(smem + lay.warp_part + warp * lay.part), lane, col, has_col,
                    head_dim);
  __syncthreads();
  combine<T, G, kDirectThreads>(smem, lay, out + (static_cast<int64_t>(b) * n_heads + h0) * head_dim, n_h, head_dim,
                                splits, tid);
}

// W bytes of a K row as W / 4 words (W = 4, 8 or 16; p W-byte aligned)
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W / 4], const int8_t* p) {
  if constexpr (W == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (W == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// Route "mma" (bf16 q, head_dim = 16 DT, G = 8 heads a tile): tensor cores over a ring of staged pages. grid as
// the direct route's; a ninth warp fills the ring.
template <int DT>
__global__ void __launch_bounds__(kMmaThreads, DT <= 8 ? 2 : 1)
    paged_decode_int8_mma(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                          const int8_t* __restrict__ v_pages, const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales, const int* __restrict__ lengths,
                          const int* __restrict__ page_indices, __nv_bfloat16* __restrict__ out, int n_heads,
                          int group, int head_dim, int n_pages, int page_size, int pages_per_seq, int splits,
                          int per_split, int stages, float scale) {
  using T = __nv_bfloat16;
  constexpr int G = kMaxHeadTile;
  const int tiles = (group + G - 1) / G;
  const int kvh = blockIdx.y / tiles;
  const int tile = blockIdx.y - kvh * tiles;
  const int b = blockIdx.z;
  const int h0 = kvh * group + tile * G;
  const int n_h = min(G, group - tile * G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int page_bytes = page_size * head_dim;  // one int8 page
  const int stage = stage_bytes(page_size, head_dim);
  const Smem lay(G, head_dim, per_split, stages, stage, 16 * tile_stride(DT));
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's four copies have landed
  uint64_t* empty = full + kMaxStages;                 // the warp that reads a stage is done with it
  int* table = reinterpret_cast<int*>(smem + lay.table);
  uint8_t* ring = smem + lay.ring;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a peer's shared memory may be written only once the peer has started: arrive now, wait before the pushes
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int length = clamped_length(lengths, b, pages_per_seq * page_size);
  const int first = blockIdx.x * per_split;
  const int n_local = max(0, min(first + per_split, (length + page_size - 1) / page_size) - first);

  // the producer warp stages the split's table entries (read beside lengths[b], not after it), then its issuing
  // lanes copy entry i's K page, V page, K scales and V scales into stage i % stages, refilling a stage once the
  // warp that reads it has arrived on its `empty`. Two lanes issue, alternate entries, where each stage is then
  // filled by one lane (an even number of stages, or none refilled): that lane waited for the stage's previous
  // release itself.
  if (warp == kWarps) {
    const int64_t row = static_cast<int64_t>(b) * pages_per_seq + first;
    for (int i = lane; i < min(per_split, pages_per_seq - first); i += 32) {
      table[i] = clamped_page(page_indices[row + i], n_pages);
    }
    __syncwarp();
    const int issuers = stages % 2 == 0 || stages >= per_split ? 2 : 1;
    if (lane < issuers) {
      for (int i = lane; i < n_local; i += issuers) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
        const int64_t page = static_cast<int64_t>(kvh) * n_pages + table[i];
        uint8_t* dst = ring + static_cast<int64_t>(s) * stage;
        mbar_arrive_expect_tx(&full[s], stage);
        bulk_load(dst, k_pages + page * page_bytes, page_bytes, &full[s]);
        bulk_load(dst + page_bytes, v_pages + page * page_bytes, page_bytes, &full[s]);
        bulk_load(dst + 2 * page_bytes, k_scales + page * page_size, 4 * page_size, &full[s]);
        bulk_load(dst + 2 * page_bytes + 4 * page_size, v_scales + page * page_size, 4 * page_size, &full[s]);
      }
    }
    __syncwarp();  // the other lanes wait here, rather than run ahead into the readers' code and slow the issue
  }
  float* mine = reinterpret_cast<float*>(smem + lay.warp_part + warp * lay.part);  // a reading warp's region
  // tensor cores (bf16): per 16 keys of a page, S^T[keys, heads] = K . q^T on mma.sync m16n8k16 with the keys
  // as M, the tile's heads as N (8) and d as K; then O^T[d, heads] += V^T . P^T, V^T by ldmatrix.trans from the
  // warp's bf16 tile. One warp a page. The K operand comes from the int8 bytes in registers: a lane loads W
  // bytes of each of its rows at d = 4 W j + W tig, which feed W / 4 k-steps; k-step (W / 4) j + c takes
  // d = 4 W j + W tig + 4 c + (0, 1) as the lane's k pair 2 tig.. and + (2, 3) as 2 tig + 8.. (the order of
  // q . k is permuted; q's B fragments follow it, so the sum is the same).
  constexpr int D = 16 * DT;
  constexpr int W = DT % 4 == 0 ? 16 : (DT % 2 == 0 ? 8 : 4);
  constexpr int KS = W / 4;    // k-steps one load feeds
  constexpr int NJ = DT / KS;  // loads a K row takes
  constexpr int CPR = D / 8;   // 8-value chunks a V row
  constexpr int kStride = tile_stride(DT);
  const int gid = lane >> 2, tig = lane & 3;  // a fragment's row group and column pair
  uint32_t qb[DT][2];                         // B fragments of q^T (head gid of the tile)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      const T* row = q + (static_cast<int64_t>(b) * n_heads + h0 + gid) * D + 4 * W * j + W * tig + 4 * c;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gid < n_h ? scaled(row[e], scale) : 0.f;
      qb[j * KS + c][0] = pack_bf16(v[0], v[1]);  // exact: the scaled q is a bf16
      qb[j * KS + c][1] = pack_bf16(v[2], v[3]);
    }
  }
  float o[DT][4];  // O^T tile t: (d 16 t + gid, heads 2 tig and 2 tig + 1), then d + 8
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // heads 2 tig, 2 tig + 1 (l: this lane's keys)
  uint8_t* vt = reinterpret_cast<uint8_t*>(mine);             // the warp's bf16 V tile, 16 rows
  const int readers = min(kWarps, stages);  // warp w reads pages w (mod readers): each stage has one reader
  for (int i = warp < readers ? warp : n_local; i < n_local; i += readers) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const int8_t* kp = reinterpret_cast<const int8_t*>(ring + static_cast<int64_t>(s) * stage);
    const int8_t* vp = kp + page_bytes;
    const float* kscale = reinterpret_cast<const float*>(vp + page_bytes);
    const float* vscale = kscale + page_size;
    const int valid = min(page_size, length - (first + i) * page_size);
    for (int k0 = 0; k0 < valid; k0 += 16) {
      const int rows = min(16, valid - k0);
      // K rows past the valid keys read key k0 (finite) and get weight 0
      const bool ok0 = gid < rows, ok1 = gid + 8 < rows;
      const int r0 = k0 + (ok0 ? gid : 0), r1 = k0 + (ok1 ? gid + 8 : 0);
      const float s0 = kscale[r0], s1 = kscale[r1];
      float sc[4] = {0.f, 0.f, 0.f, 0.f};  // (key k0 + gid: heads 2 tig, 2 tig + 1), then key + 8
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t lo[KS], hi[KS];
        load_words<W>(lo, kp + r0 * D + 4 * W * j + W * tig);
        load_words<W>(hi, kp + r1 * D + 4 * W * j + W * tig);
#pragma unroll
        for (int c = 0; c < KS; ++c) {
          const uint32_t a[4] = {dequant_bf16x2(lo[c], 0, s0), dequant_bf16x2(hi[c], 0, s1),
                                 dequant_bf16x2(lo[c], 1, s0), dequant_bf16x2(hi[c], 1, s1)};
          mma_16816(sc, a, qb[j * KS + c][0], qb[j * KS + c][1]);
        }
      }
      // V rows k0 .. k0 + rows into the tile as bf16, 8 values a lane at a time; then the stage is free
      __syncwarp();  // the previous group's ldmatrix reads of the tile are done
#pragma unroll 4
      for (int idx = lane; idx < rows * CPR; idx += 32) {
        const int r = idx / CPR, c = idx - r * CPR;
        const uint2 w = *reinterpret_cast<const uint2*>(vp + (k0 + r) * D + 8 * c);
        const float sv = vscale[k0 + r];
        const uint4 packed = make_uint4(dequant_bf16x2(w.x, 0, sv), dequant_bf16x2(w.x, 1, sv),
                                        dequant_bf16x2(w.y, 0, sv), dequant_bf16x2(w.y, 1, sv));
        *reinterpret_cast<uint4*>(vt + r * kStride + 16 * c) = packed;
      }
      __syncwarp();
      if (k0 + 16 >= valid && lane == 0) mbar_arrive(&empty[s]);  // the page's last group has read the stage
      if (!ok0) sc[0] = sc[1] = -INFINITY;
      if (!ok1) sc[2] = sc[3] = -INFINITY;
      float x0 = fmaxf(sc[0], sc[2]), x1 = fmaxf(sc[1], sc[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // over the 8 row groups: every key of the 16
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      }
      const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);  // finite: key k0 is valid
      const float a0s = __expf(m0 - n0), a1s = __expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      const float p0 = __expf(sc[0] - n0), p1 = __expf(sc[1] - n1), p2 = __expf(sc[2] - n0), p3 = __expf(sc[3] - n1);
      l0 = l0 * a0s + p0 + p2;
      l1 = l1 * a1s + p1 + p3;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[t][0] *= a0s;
        o[t][1] *= a1s;
        o[t][2] *= a0s;
        o[t][3] *= a1s;
      }
      // P^T from the accumulator layout (key gid, heads 2 tig..) to the B layout (keys 2 tig.., head gid)
      const uint32_t plo = pack_bf16(p0, p1), phi = pack_bf16(p2, p3);
      const int src = 8 * tig + (gid >> 1);
      const uint32_t sel = gid & 1 ? 0x7632u : 0x5410u;
      const uint32_t b0 =
          __byte_perm(__shfl_sync(0xffffffffu, plo, src), __shfl_sync(0xffffffffu, plo, src + 4), sel);
      const uint32_t b1 =
          __byte_perm(__shfl_sync(0xffffffffu, phi, src), __shfl_sync(0xffffffffu, phi, src + 4), sel);
      // V^T tiles: lanes 0-7, 8-15, 16-23, 24-31 address tile rows j, j, 8 + j, 8 + j at d 16 t, 16 t + 8,
      // 16 t, 16 t + 8; rows past the valid keys read row 0 (finite) and meet P = 0
      const int kr = (lane & 7) + ((lane >> 4) << 3);
      const uint8_t* v_row = vt + (kr < rows ? kr : 0) * kStride + ((lane >> 3) & 1) * 16;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, v_row + 32 * t);
        mma_16816(o[t], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {  // l over the 8 row groups
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncwarp();  // the tile's last reads are done before the partial overwrites it
  if (warp < kWarps) {
    const int h_a = 2 * tig, h_b = 2 * tig + 1;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = 16 * t + gid;
      if (h_a < n_h) {
        mine[h_a * D + d] = o[t][0];
        mine[h_a * D + d + 8] = o[t][2];
      }
      if (h_b < n_h) {
        mine[h_b * D + d] = o[t][1];
        mine[h_b * D + d + 8] = o[t][3];
      }
    }
    if (gid == 0 && h_a < n_h) {
      mine[G * D + h_a] = m0;
      mine[G * D + G + h_a] = l0;
    }
    if (gid == 0 && h_b < n_h) {
      mine[G * D + h_b] = m1;
      mine[G * D + G + h_b] = l1;
    }
  }
  __syncthreads();
  combine<T, G, kMmaThreads>(smem, lay, out + (static_cast<int64_t>(b) * n_heads + h0) * head_dim, n_h, head_dim,
                             splits, tid);
}

// the arguments every launch passes on
struct Args {
  const void *q, *k, *v, *ks, *vs;
  const int *lens, *table;
  void* out;
  int batch, n_heads, n_kv, head_dim, n_pages, page_size, pps, splits, per_split, stages;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, bool* configured) {  // the attributes are set once a device
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
  return cudaSuccess;
}

// the direct kernel (DIRECT), else the tensor-core kernel (head_dim = 16 DT)
template <typename T, int L, int G, int DT, bool DIRECT>
cudaError_t launch(const Args& a) {
  const int group = a.n_heads / a.n_kv;
  const Smem lay = DIRECT ? Smem(G, a.head_dim, a.per_split, 0, 0, 0)
                          : Smem(G, a.head_dim, a.per_split, a.stages, stage_bytes(a.page_size, a.head_dim),
                                 16 * tile_stride(DT));
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(a.splits), static_cast<unsigned>(a.n_kv * ((group + G - 1) / G)),
                        static_cast<unsigned>(a.batch));
  config.blockDim = dim3(DIRECT ? kDirectThreads : kMmaThreads, 1, 1);
  config.dynamicSmemBytes = lay.total;
  config.stream = a.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = a.splits > 1 ? 1 : 0;
  const T* q = static_cast<const T*>(a.q);
  const int8_t *k = static_cast<const int8_t*>(a.k), *v = static_cast<const int8_t*>(a.v);
  const float *ks = static_cast<const float*>(a.ks), *vs = static_cast<const float*>(a.vs);
  T* out = static_cast<T*>(a.out);
  static bool configured[kMaxDevices] = {};  // the attributes are set once a device
  cudaError_t err;
  if constexpr (DIRECT) {
    auto kernel = paged_decode_int8_direct<T, L, G>;
    err = configure(kernel, configured);
    if (err == cudaSuccess) {
      err = cudaLaunchKernelEx(&config, kernel, q, k, v, ks, vs, a.lens, a.table, out, a.n_heads, group, a.head_dim,
                               a.n_pages, a.page_size, a.pps, a.splits, a.per_split, a.scale);
    }
  } else {
    auto kernel = paged_decode_int8_mma<DT>;
    err = configure(kernel, configured);
    if (err == cudaSuccess) {
      err = cudaLaunchKernelEx(&config, kernel, q, k, v, ks, vs, a.lens, a.table, out, a.n_heads, group, a.head_dim,
                               a.n_pages, a.page_size, a.pps, a.splits, a.per_split, a.stages, a.scale);
    }
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the direct route: L = the lanes of a key row (8 values each), G = the heads of a tile (powers of two)
template <typename T, int L>
cudaError_t by_heads(int tile, const Args& a) {
  switch (tile) {
    case 1:
      return launch<T, L, 1, 0, true>(a);
    case 2:
      return launch<T, L, 2, 0, true>(a);
    case 4:
      return launch<T, L, 4, 0, true>(a);
    case 8:
      return launch<T, L, 8, 0, true>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_width(int lanes, int tile, const Args& a) {
  switch (lanes) {
    case 1:
      return by_heads<T, 1>(tile, a);
    case 2:
      return by_heads<T, 2>(tile, a);
    case 4:
      return by_heads<T, 4>(tile, a);
    case 8:
      return by_heads<T, 8>(tile, a);
    case 16:
      return by_heads<T, 16>(tile, a);
    case 32:
      return by_heads<T, 32>(tile, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// the tensor-core route: bf16, head_dim = 16 DT (DT = 1..16), 8 heads a tile
template <int DT>
cudaError_t by_tiles(int dt, const Args& a) {
  if constexpr (DT > 16) {
    return cudaErrorInvalidValue;
  } else {
    if (dt != DT) return by_tiles<DT + 1>(dt, a);
    return launch<__nv_bfloat16, 1, kMaxHeadTile, DT, false>(a);
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16; pages int8, scales float32. splits (1..16) blocks of a cluster
// share each (row, KV head, head tile), per_split table entries each (splits * per_split >= pages_per_seq);
// stages (1..16) pages of K and V (and their scales) in flight a block on the mma route; route: 0 = direct, 1 =
// mma (tensor cores over staged pages, bfloat16 q, head_dim % 16 == 0, page_size % 4 == 0, pools and scales on a
// 16-byte boundary). scale = head_dim**-0.5 as a float. Returns the cudaError_t of the launch (0 = success); the
// caller validated shapes, types, contiguity and alignment and chose the route (_int8_route in
// ops/paged_attention.py).
extern "C" int paged_decode_attention_int8(const void* q, const void* k_pages, const void* v_pages,
                                           const void* k_scales, const void* v_scales, const void* lengths,
                                           const void* page_indices, void* out, int batch, int n_heads,
                                           int n_kv_heads, int head_dim, int n_pages, int page_size,
                                           int pages_per_seq, int splits, int per_split, int stages, int route,
                                           int dtype, float scale, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || n_kv_heads <= 0 || n_heads % n_kv_heads || head_dim <= 0 || head_dim % 8 || head_dim > 256 ||
      n_pages <= 0 || page_size <= 0 || pages_per_seq < 0 || splits < 1 || splits > kMaxCluster || per_split < 1 ||
      static_cast<int64_t>(splits) * per_split < pages_per_seq || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteDirect) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages) |
                            reinterpret_cast<uintptr_t>(k_scales) | reinterpret_cast<uintptr_t>(v_scales);
    if (route != kRouteMma || dtype != 1 || head_dim % 16 || page_size % 4 || bases % 16 || stages < 1 ||
        stages > kMaxStages) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const Args a{q, k_pages, v_pages, k_scales, v_scales, static_cast<const int*>(lengths),
               static_cast<const int*>(page_indices), out, batch, n_heads, n_kv_heads, head_dim, n_pages, page_size,
               pages_per_seq, splits, per_split, stages, scale, static_cast<cudaStream_t>(stream)};
  const int lanes = next_pow2(head_dim / 8);
  const int tile = next_pow2(n_heads / n_kv_heads < kMaxHeadTile ? n_heads / n_kv_heads : kMaxHeadTile);
  cudaError_t err;
  if (route == kRouteMma) {
    err = by_tiles<1>(head_dim / 16, a);
  } else if (dtype == 0) {
    err = by_width<float>(lanes, tile, a);
  } else {
    err = by_width<__nv_bfloat16>(lanes, tile, a);
  }
  return static_cast<int>(err);
}
