// Paged decode attention for Hopper (sm_90a): one decode step of attention
// over a heads-major paged KV pool.
//
// Replaces the TPU kernel the JAX package calls for the same step: the Pallas
// kernel that ships with JAX, jax.experimental.pallas.ops.tpu.paged_attention,
// reached from unionml_tpu/ops/paged_attention.py:84 (paged_decode_attention)
// under attention_impl="flash" (unionml_tpu/models/layers.py:346-354).
//
// Computes, for every batch row b and query head h:
//   out[b, h] = softmax_t(q'[b, h] . K[h_kv, page(b, t), t % page_size])
//               @ V[h_kv, page(b, t), t % page_size],  t < lengths[b]
// with q' = q * head_dim**-0.5 rounded to q's dtype (the JAX wrapper's
// pre-scale, done here on load: the scale arrives as the float the wrapper
// computed, so the bits are those of (q * scale).to(q.dtype)),
// h_kv = h / (n_heads / n_kv_heads) (grouped-query attention) and
// page(b, t) = page_indices[b, t / page_size]. Lengths are clamped to
// [0, pages_per_seq * page_size] and table entries to [0, n_pages - 1]. A row
// with length 0 writes zeros. The gathered copy pool[table] is never made.
//
// Bound: bytes. Every visible K and V row is read once per step while the
// arithmetic is 4 * group multiply-adds per element read, far below the
// card's operations-per-byte ridge. At decode sizes the step is latency- and
// parallelism-bound before it is bandwidth-bound: a few MB spread over the
// rows and KV heads of a small batch.
//
// Design (the second, written for Hopper; the first ran one block per
// (row, KV head) and four block-barrier phases a page):
//  - Split (flash-decoding). One block handles one (row, KV head, tile of up
//    to 8 heads of its group, split); a split is a contiguous run of
//    pages_per_split table entries. The wrapper plans the split count from
//    shapes alone (never from lengths), aiming at one wave of two blocks an
//    SM; a block whose pages lie past its row's length keeps an empty
//    partial (m = -inf, l = 0).
//  - Combine in the launch. The splits of one (row, KV head, head tile) form
//    a thread-block cluster (up to 16, the non-portable size). Each block
//    pushes its partial (acc[heads, D] and m, l per head) into the shared
//    memory of the rank that owns each output element (distributed shared
//    memory stores, no round trip), then one cluster barrier; each rank
//    combines its slice from local memory, the ranks in order. One launch a
//    call, no scratch in device memory, no atomics, the same bits on every
//    call. A partial that saw no key weighs 0, so exp(-inf - -inf) is never
//    taken, and a row of length 0 writes exact zeros.
//  - Pages by the bulk-copy unit. One page of one KV head is a contiguous
//    [page_size, D] run. A ninth warp stages the split's table entries (read
//    beside lengths[b], not after it), then its lane 0 copies the K and V
//    pages of each entry with two 1D bulk copies (cp.async.bulk, no tensor
//    map, so no host work a call) into a ring of up to 8 stages, completing
//    on the stage's `full` mbarrier, and refills a stage once the warps that
//    read it have arrived on its `empty` mbarrier. A ragged last page is
//    copied whole and masked by position. A reader waits for its page by the
//    parity of the stage's fill, so each stage has one reader (the plan's
//    stage count, _plan, and min(8, stages) readers): a reader has read the
//    stage's previous fill itself and cannot take it for its own.
//  - Compute, bf16 with D % 32 == 0 and D <= 128 (the served path): tensor
//    cores. Each of 8 warps takes whole pages; per 16 keys,
//    S^T[keys, heads] = K . q^T on mma.sync m16n8k16 with the keys as M and
//    the tile's heads as N (the operands swapped, as the int8 kernel swaps
//    its own), an online softmax per head in registers, P^T moved from the
//    accumulator layout to the B layout by four shuffles, and
//    O^T[D, heads] += V^T . P^T with V^T read by ldmatrix.trans. P is
//    rounded to bf16 for the product.
//  - Compute, float32 and the other head sizes: CUDA cores. A key row is
//    split across L lanes (8 values each), so a warp takes 32 / L keys at
//    once, two per lane group in flight; the group's q rows and P.V
//    accumulators stay in registers in f32, the dot products are reduced by
//    shuffles, and each (warp, key slot) keeps its own online softmax, merged
//    by shuffles at the end.
//  - The 8 warps' partials merge in order through shared memory once, with
//    one weight per (warp, head).
//
// Limits: head_dim % 8 == 0 and head_dim <= 256; float32 or bfloat16 (q,
// pools and out of one dtype); pools 16-byte aligned; a page of at most
// 64 KB. The wrapper checks them.
//
// Left for later: a padded or swizzled page layout (the pages land unpadded,
// so ldmatrix reads of V rows 256 bytes apart conflict on the banks); more
// pages in flight where one block has an SM to itself. (int8 pages with
// per-position scales have their own kernel, paged_decode_attention_int8.cu.)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;             // consumer warps; one more warp issues the page copies
constexpr int kThreads = 32 * (kWarps + 1);
constexpr int C = 2;                  // keys a key slot takes at once (independent chains for the scheduler)
constexpr int kMaxCluster = 16;  // the non-portable cluster size of an H100
constexpr int kMaxStages = 8;
constexpr int kMaxHeadTile = 8;  // heads of a group one block takes
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

static_assert(kWarps <= kMaxCluster, "the weights buffer holds one row per warp or per rank");

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// dynamic shared memory of one block: 2 x kMaxStages mbarriers, the split's table entries, the consumer
// warps' partials, the slices and (m, l) pushed by the cluster's ranks, the merge weights, then the ring of
// `stages` (K page, V page) pairs
struct Smem {
  int table, warp_part, recv, weights, ring, total;
  __host__ __device__ Smem(int heads, int head_dim, int per_split, int stages, int page_bytes) {
    const int part = (heads * head_dim + 2 * heads) * 4;  // acc[heads, D], m[heads], l[heads] in f32
    table = 2 * kMaxStages * 8;
    warp_part = align16(table + per_split * 4);
    recv = warp_part + kWarps * align16(part);  // the ranks' pushed slices, then their (m, l)
    weights = recv + align16((heads * head_dim + kMaxCluster + kMaxCluster * 2 * heads) * 4);
    ring = weights + align16((kMaxCluster + 1) * heads * 4);  // [ranks or warps, heads] weights, [heads] sums
    total = ring + stages * 2 * page_bytes;
  }
};

// warps that share one page: enough key slots (32 / lanes a warp, C keys each) to cover it, a power of two
__device__ __forceinline__ int warps_per_page(int page_size, int lanes) {
  const int need = (page_size + (32 / lanes) * C - 1) / ((32 / lanes) * C);
  int w = 1;
  while (w < need && w < kWarps) w <<= 1;
  return w;
}

// 8 consecutive values of a row as loaded (16 bytes of bf16 stay packed until used), and value e as f32
template <typename T>
struct Row8;

template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ float get(int e) const {
    const float4& h = e < 4 ? a : b;
    const int i = e & 3;
    return i == 0 ? h.x : (i == 1 ? h.y : (i == 2 ? h.z : h.w));
  }
};

template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = e < 4 ? (e < 2 ? u.x : u.y) : (e < 6 ? u.z : u.w);
    return __uint_as_float(e & 1 ? w & 0xFFFF0000u : w << 16);  // bf16 -> f32 is a shift
  }
};

// q * scale rounded to q's dtype, as (q * scale).to(q.dtype) computes it
__device__ __forceinline__ float scaled(float x, float scale) { return __fmul_rn(x, scale); }
__device__ __forceinline__ float scaled(__nv_bfloat16 x, float scale) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(__bfloat162float(x), scale)));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// weight of a partial whose running max is m in a sum whose max is mx; 0 for a partial that saw no key
__device__ __forceinline__ float weight(float m, float mx) { return m == -INFINITY ? 0.f : expf(m - mx); }

// grid: x = splits (one cluster), y = KV heads x head tiles, z = rows. G heads a tile. DT > 0: the
// tensor-core route (bf16, head_dim = 16 DT, G = 8); DT = 0: CUDA cores, L lanes a key row.
template <typename T, int L, int G, int DT>
__global__ void __launch_bounds__(kThreads, G <= 4 || DT > 0 ? 2 : 1) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ lengths, const int* __restrict__ page_indices, T* __restrict__ out, int n_heads,
    int group, int head_dim, int n_pages, int page_size, int pages_per_seq, int splits, int per_split, int stages,
    float scale) {
  const int tiles = (group + G - 1) / G;
  const int kvh = blockIdx.y / tiles;
  const int tile = blockIdx.y - kvh * tiles;
  const int b = blockIdx.z;
  const int h0 = kvh * group + tile * G;
  const int n_h = min(G, group - tile * G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int page_elems = page_size * head_dim;
  const int page_bytes = page_elems * static_cast<int>(sizeof(T));
  const Smem lay(G, head_dim, per_split, stages, page_bytes);
  const int part = align16((G * head_dim + 2 * G) * 4) / 4;  // floats between two warps' partials
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // a stage's two pages have landed
  uint64_t* empty = full + kMaxStages;                 // the warps that read a stage are done with it
  int* table = reinterpret_cast<int*>(smem + lay.table);
  float* warp_part = reinterpret_cast<float*>(smem + lay.warp_part);
  float* recv = reinterpret_cast<float*>(smem + lay.recv);
  float* wgt = reinterpret_cast<float*>(smem + lay.weights);
  T* ring = reinterpret_cast<T*>(smem + lay.ring);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], DT > 0 ? 1 : warps_per_page(page_size, L));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a peer's shared memory may be written only once the peer has started: arrive now, wait before the pushes
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // lengths and table entries come from the serving engine; clamp them to the table and the pool
  const int max_len = pages_per_seq * page_size;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > max_len ? max_len : length);
  const int first = blockIdx.x * per_split;
  const int n_local = max(0, min(first + per_split, (length + page_size - 1) / page_size) - first);

  // the producer: the K and V pages of the split's entry i into stage i % stages
  auto issue = [&](int i) {
    const int s = i % stages;
    const int64_t base = (static_cast<int64_t>(kvh) * n_pages + table[i]) * page_elems;
    T* dst = ring + static_cast<int64_t>(s) * 2 * page_elems;
    mbar_arrive_expect_tx(&full[s], 2 * page_bytes);
    bulk_load(dst, k_pages + base, page_bytes, &full[s]);
    bulk_load(dst + page_elems, v_pages + base, page_bytes, &full[s]);
  };

  // the producer warp stages the split's table entries (read beside lengths[b], not after it), then its
  // lane 0 fills the ring, refilling a stage once the warps that read it have arrived on its `empty`
  if (warp == kWarps) {
    const int64_t row = static_cast<int64_t>(b) * pages_per_seq + first;
    for (int i = lane; i < min(per_split, pages_per_seq - first); i += 32) {
      const int page = page_indices[row + i];
      table[i] = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n_local; ++i) {
        if (i >= stages) mbar_wait(&empty[i % stages], (i / stages - 1) & 1);
        issue(i);
      }
    }
  }
  if constexpr (DT > 0) {
    // tensor cores (bf16): per 16 keys of a page, S^T[keys, heads] = K . q^T on mma.sync m16n8k16 with
    // the keys as M, the tile's heads as N (8) and d as K; then O^T[d, heads] += V^T . P^T, V^T by
    // ldmatrix.trans. One warp a page. The K order of q . k is permuted (the sum is the same): k-step
    // pair c covers d = 32 c + 8 tig + 0..7, so a lane's one 16-byte load of a K row feeds two k-steps.
    const int gid = lane >> 2, tig = lane & 3;  // a fragment's row group and column pair
    uint32_t qb[DT][2];                         // B fragments of q^T (head gid of the tile)
#pragma unroll
    for (int c = 0; c < DT / 2; ++c) {
      float v[8];
      const T* row = q + (static_cast<int64_t>(b) * n_heads + h0 + gid) * head_dim + 32 * c + 8 * tig;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = gid < n_h ? scaled(row[e], scale) : 0.f;
      qb[2 * c][0] = pack_bf16(v[0], v[1]);  // exact: the scaled q is a bf16
      qb[2 * c][1] = pack_bf16(v[2], v[3]);
      qb[2 * c + 1][0] = pack_bf16(v[4], v[5]);
      qb[2 * c + 1][1] = pack_bf16(v[6], v[7]);
    }
    float o[DT][4];  // O^T tile t: (d 16 t + gid, heads 2 tig and 2 tig + 1), then d + 8
#pragma unroll
    for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // heads 2 tig, 2 tig + 1 (l: this lane's keys)
    const int readers = min(kWarps, stages);  // warp w reads pages w (mod readers): each stage has one reader
    for (int i = warp < readers ? warp : n_local; i < n_local; i += readers) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const T* ks = ring + static_cast<int64_t>(s) * 2 * page_elems;
      const T* vs = ks + page_elems;
      const int valid = min(page_size, length - (first + i) * page_size);
      for (int k0 = 0; k0 < valid; k0 += 16) {
        // rows past the valid keys read row 0 (finite) and get weight 0
        const bool ok0 = k0 + gid < valid, ok1 = k0 + gid + 8 < valid;
        const T* k_lo = ks + (ok0 ? k0 + gid : 0) * head_dim + 8 * tig;
        const T* k_hi = ks + (ok1 ? k0 + gid + 8 : 0) * head_dim + 8 * tig;
        float sc[4] = {0.f, 0.f, 0.f, 0.f};  // (key k0 + gid: heads 2 tig, 2 tig + 1), then key + 8
#pragma unroll
        for (int c = 0; c < DT / 2; ++c) {
          const uint4 u = *reinterpret_cast<const uint4*>(k_lo + 32 * c);
          const uint4 w = *reinterpret_cast<const uint4*>(k_hi + 32 * c);
          const uint32_t a0[4] = {u.x, w.x, u.y, w.y}, a1[4] = {u.z, w.z, u.w, w.w};
          mma_16816(sc, a0, qb[2 * c][0], qb[2 * c][1]);
          mma_16816(sc, a1, qb[2 * c + 1][0], qb[2 * c + 1][1]);
        }
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
        const uint32_t lo = pack_bf16(p0, p1), hi = pack_bf16(p2, p3);
        const int src = 8 * tig + (gid >> 1);
        const uint32_t sel = gid & 1 ? 0x7632u : 0x5410u;
        const uint32_t b0 = __byte_perm(__shfl_sync(0xffffffffu, lo, src), __shfl_sync(0xffffffffu, lo, src + 4), sel);
        const uint32_t b1 = __byte_perm(__shfl_sync(0xffffffffu, hi, src), __shfl_sync(0xffffffffu, hi, src + 4), sel);
        // V^T tiles: lanes 0-7, 8-15, 16-23, 24-31 address keys k0 + j, k0 + j, k0 + 8 + j, k0 + 8 + j at
        // d 16 t, 16 t + 8, 16 t, 16 t + 8
        const int kr = k0 + (lane & 7) + ((lane >> 4) << 3);
        const T* v_row = vs + (kr < valid ? kr : 0) * head_dim + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int t = 0; t < DT; ++t) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, v_row + 16 * t);
          mma_16816(o[t], a, b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // l over the 8 row groups
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    float* mine = warp_part + warp * part;  // acc[G, D], then m[G], then l[G]
    if (warp < kWarps) {
      const int h_a = 2 * tig, h_b = 2 * tig + 1;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        const int d = 16 * t + gid;
        if (h_a < n_h) {
          mine[h_a * head_dim + d] = o[t][0];
          mine[h_a * head_dim + d + 8] = o[t][2];
        }
        if (h_b < n_h) {
          mine[h_b * head_dim + d] = o[t][1];
          mine[h_b * head_dim + d + 8] = o[t][3];
        }
      }
      if (gid == 0 && h_a < n_h) {
        mine[G * head_dim + h_a] = m0;
        mine[G * head_dim + G + h_a] = l0;
      }
      if (gid == 0 && h_b < n_h) {
        mine[G * head_dim + h_b] = m1;
        mine[G * head_dim + G + h_b] = l1;
      }
    }
  } else {
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

    // consumer warp `warp` takes the pages i = warp / wpp (mod pao): wpp warps share a page, pao pages at once,
    // at most one a stage (each stage has one reader)
    const int wpp = warps_per_page(page_size, L);
    const int pao = min(kWarps / wpp, stages);
    const int wslot = warp % wpp;
    for (int i = warp < pao * wpp ? warp / wpp : n_local; i < n_local; i += pao) {
      const int s = i % stages;
      mbar_wait(&full[s], (i / stages) & 1);
      const T* ks = ring + static_cast<int64_t>(s) * 2 * page_elems;
      const T* vs = ks + page_elems;
      const int valid = min(page_size, length - (first + i) * page_size);
      // a chunk: C keys a key slot (R slots a warp); warp-uniform, so every lane takes the shuffles
      for (int t0 = wslot * R * C; t0 < valid; t0 += wpp * R * C) {
        Row8<T> kr[C], vr[C];
        float sc[C][G];
        bool ok[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int t = t0 + c * R + slot;
          ok[c] = t < valid;
          if (ok[c] && has_col) {
            kr[c].load(ks + t * head_dim + col);
            vr[c].load(vs + t * head_dim + col);
          } else {
            kr[c].zero();
            vr[c].zero();
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) dot = fmaf(qr[g][e], kr[c].get(e), dot);
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
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float p = ok[c] ? __expf(sc[c][g] - mx) : 0.f;
            l[g] += p;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vr[c].get(e), acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
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
    float* mine = warp_part + warp * part;  // acc[G, D], then m[G], then l[G]
    if (slot == 0 && warp < kWarps) {
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
  __syncthreads();

  // the consumer warps merge in order: the weight of each (warp, head) against the head's max once, then
  // one weighted sum per element. Unsplit, that is the output. Split, each block pushes its partial into
  // the shared memory of the rank that owns the element's slice (and its (m, l) into every rank's) before
  // one cluster barrier; each rank then combines its slice from local memory, the ranks in order.
  const int n_out = n_h * head_dim;
  const int per = (n_out + splits - 1) / splits;           // output elements a rank combines
  const int rank = blockIdx.x;                             // the cluster is the grid's x extent
  float* recv_ml = recv + splits * per;                    // [rank][m[G], l[G]] of every rank
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

template <typename T, int L, int G, int DT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* lengths,
                   const int* page_indices, void* out, int batch, int n_heads, int n_kv_heads, int head_dim,
                   int n_pages, int page_size, int pages_per_seq, int splits, int per_split, int stages, float scale,
                   cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, L, G, DT>;
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
  const Smem lay(G, head_dim, per_split, stages, page_size * head_dim * static_cast<int>(sizeof(T)));
  if (lay.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(n_kv_heads * ((group + G - 1) / G)),
                        static_cast<unsigned>(batch));
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = lay.total;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(q), static_cast<const T*>(k_pages),
                           static_cast<const T*>(v_pages), lengths, page_indices, static_cast<T*>(out), n_heads,
                           group, head_dim, n_pages, page_size, pages_per_seq, splits, per_split, stages, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// L = the lanes of a key row (8 values each, a power of two), G = the heads of a tile (a power of two)
template <typename T, int L>
cudaError_t by_heads(int tile, const void* q, const void* k, const void* v, const int* lens, const int* table,
                     void* out, int batch, int n_heads, int n_kv, int head_dim, int n_pages, int page_size, int pps,
                     int splits, int per_split, int stages, float scale, cudaStream_t s) {
  switch (tile) {
    case 1:
      return launch<T, L, 1, 0>(q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps,
                             splits, per_split, stages, scale, s);
    case 2:
      return launch<T, L, 2, 0>(q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps,
                             splits, per_split, stages, scale, s);
    case 4:
      return launch<T, L, 4, 0>(q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps,
                             splits, per_split, stages, scale, s);
    case 8:
      return launch<T, L, 8, 0>(q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps,
                             splits, per_split, stages, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_width(int lanes, int tile, const void* q, const void* k, const void* v, const int* lens,
                     const int* table, void* out, int batch, int n_heads, int n_kv, int head_dim, int n_pages,
                     int page_size, int pps, int splits, int per_split, int stages, float scale, cudaStream_t s) {
#define PAGED_BY_HEADS(LANES)                                                                                        \
  by_heads<T, LANES>(tile, q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, page_size, pps, \
                     splits, per_split, stages, scale, s)
  switch (lanes) {
    case 1:
      return PAGED_BY_HEADS(1);
    case 2:
      return PAGED_BY_HEADS(2);
    case 4:
      return PAGED_BY_HEADS(4);
    case 8:
      return PAGED_BY_HEADS(8);
    case 16:
      return PAGED_BY_HEADS(16);
    case 32:
      return PAGED_BY_HEADS(32);
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_BY_HEADS
}

// the tensor-core route: bf16, head_dim = 16 DT with DT even (two k-steps a 16-byte load), 8 heads a tile
cudaError_t by_tiles(int dt, const void* q, const void* k, const void* v, const int* lens, const int* table,
                     void* out, int batch, int n_heads, int n_kv, int head_dim, int n_pages, int page_size, int pps,
                     int splits, int per_split, int stages, float scale, cudaStream_t s) {
#define PAGED_MMA(DT)                                                                                           \
  launch<__nv_bfloat16, 1, kMaxHeadTile, DT>(q, k, v, lens, table, out, batch, n_heads, n_kv, head_dim, n_pages, \
                                             page_size, pps, splits, per_split, stages, scale, s)
  switch (dt) {
    case 2:
      return PAGED_MMA(2);
    case 4:
      return PAGED_MMA(4);
    case 6:
      return PAGED_MMA(6);
    case 8:
      return PAGED_MMA(8);
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_MMA
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. splits (1..16) blocks of a cluster share each (row, KV head, head tile),
// per_split table entries each (splits * per_split >= pages_per_seq); stages (1..8) pages of K and V in flight
// a block; scale = head_dim**-0.5 as a float. Returns the cudaError_t of the launch (0 = success); the caller
// validated shapes, types, contiguity and alignment.
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages, const void* lengths,
                                      const void* page_indices, void* out, int batch, int n_heads, int n_kv_heads,
                                      int head_dim, int n_pages, int page_size, int pages_per_seq, int splits,
                                      int per_split, int stages, int dtype, float scale, void* stream) {
  if (batch == 0) return 0;
  if (batch < 0 || n_kv_heads <= 0 || n_heads % n_kv_heads || head_dim <= 0 || head_dim % 8 || head_dim > 256 ||
      n_pages <= 0 || page_size <= 0 || pages_per_seq < 0 || splits < 1 || splits > kMaxCluster || per_split < 1 ||
      static_cast<int64_t>(splits) * per_split < pages_per_seq || stages < 1 || stages > kMaxStages) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lanes = next_pow2(head_dim / 8);
  const int tile = next_pow2(n_heads / n_kv_heads < kMaxHeadTile ? n_heads / n_kv_heads : kMaxHeadTile);
  const int* lens = static_cast<const int*>(lengths);
  const int* table = static_cast<const int*>(page_indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = by_width<float>(lanes, tile, q, k_pages, v_pages, lens, table, out, batch, n_heads, n_kv_heads, head_dim,
                          n_pages, page_size, pages_per_seq, splits, per_split, stages, scale, s);
  } else if (dtype == 1 && head_dim % 32 == 0 && head_dim <= 128) {
    err = by_tiles(head_dim / 16, q, k_pages, v_pages, lens, table, out, batch, n_heads, n_kv_heads, head_dim,
                   n_pages, page_size, pages_per_seq, splits, per_split, stages, scale, s);
  } else if (dtype == 1) {
    err = by_width<__nv_bfloat16>(lanes, tile, q, k_pages, v_pages, lens, table, out, batch, n_heads, n_kv_heads,
                                  head_dim, n_pages, page_size, pages_per_seq, splits, per_split, stages, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
