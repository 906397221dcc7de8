// Fused flash-attention backward for Hopper (sm_90a), bf16: dq, dk and dv of
// one attention call in one launch, every product on the tensor cores.
//
// Replaces the TPU kernels of unionml_tpu/ops/flash_attention.py
//   _flash_bwd_dq_kernel  (pallas_call at :318)
//   _flash_bwd_dkv_kernel (pallas_call at :343)
// and computes what _bwd_recompute (:193-215) and the two kernel bodies
// compute, for bf16 inputs. (float32 inputs run csrc/flash_backward_f32.cu.)
//
// Layout as in the JAX package: q and dO [B, Lq, H, D], k and v [B, Lk, Hkv,
// D], all bf16 and contiguous; lse and delta [B, H, Lq] f32. Query head h
// reads KV head h / (H / Hkv). Query row i sees key j when i + (Lk - Lq) >= j
// (causal) or always. With scale = D**-0.5:
//   P = exp(scale * Q K^T - lse), dS = P * (dO V^T - delta), both rounded to
//   bf16 before their products (as the JAX code casts them);
//   dv = P^T dO, dk = scale * dS^T Q, written in f32 at query-head resolution
//   ([B, Lk, H, D]; the wrapper sums each KV group in f32 and casts);
//   dq = scale * dS K, summed over key tiles in an f32 workspace, in order.
//
// Bound: operations. Five products of 2 * D multiply-adds per visible (query,
// key) pair: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dQ =
// dS K. At B=1, L=2048, H=32, Hkv=8, D=128, causal that is 0.0869 ms at the
// bf16 tensor-core rate of 989 TFLOP/s; its 68 MB of inputs and outputs take
// 0.020 ms at 3.35 TB/s.
//
// Design (FlashAttention-3's backward in outline):
//  - Grid. One block per (key tile of 128 rows, batch, query head); blockIdx
//    runs over key tiles outermost, so that the heaviest (under causal
//    masking, the lowest) key tiles start first. The block keeps its K and V
//    tiles resident and walks the query tiles (64 rows) that see its keys,
//    from the last down (to the shifted diagonal under causal masking), so
//    that the blocks of one head reach a query tile together and wait little
//    for each other's dq adds (below).
//  - Copies. Thread 0 loads K and V once and streams the Q and dO tiles
//    through a ring of two stages, each an mbarrier-tracked TMA box of a 4D
//    tensor map over [B, L, heads, D] in the 128-byte swizzle (two boxes of
//    64 head-dim columns; rows past L and columns past D read as 0). The
//    load of query tile i + 2 starts as soon as tile i is done, so it runs
//    under the products of tile i + 1.
//  - Two warpgroups, each owning 64 of the key rows. Per query tile:
//    S^T = K Q^T and dP^T = V dO^T (wgmma, A and B K-major from shared
//    memory); P^T and dS^T in f32 registers (masked entries 0), rounded to
//    bf16 in the register layout of a wgmma A operand; dV += P^T dO and dK +=
//    dS^T Q with A from registers and B MN-major from the same Q and dO tiles,
//    f32 accumulators held across the whole walk; dS^T written once to shared
//    memory; then dQ = dS K (A and B MN-major from shared memory), each
//    warpgroup 64 of the head-dim columns over all 128 keys.
//  - Determinism. dq's partial tiles are summed in an f32 workspace [B, H, Lq,
//    D]. A per-(head, query tile, warpgroup) counter in device memory orders
//    the adds by key tile: key tile n adds after key tile n - 1 has, and the
//    last key tile that sees the query tile writes scale * sum as bf16 into
//    dq. A block waits only at its add, and only on a block with a lower
//    blockIdx (launched before it), so the wait cannot deadlock however many
//    blocks are resident. The result is bitwise the same on every call.
//
// Limits: bf16, D % 16 == 0 and D <= 128 (the tiles are always 128 columns
// wide; D <= 64 computes on zero columns), any lengths, causal or not, any
// Lk - Lq, H % Hkv == 0, 16-byte aligned tensors.
//
// Left for later: a producer warp with setmaxnreg and consumer warpgroups on
// mbarriers instead of block barriers; overlapping one tile's dq add and
// elementwise work with the next tile's products; a persistent grid.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;     // two warpgroups
constexpr int kKeys = 128;        // key rows of a block, 64 a warpgroup
constexpr int kQueries = 64;      // query rows of a tile
constexpr int kHalves = 2;        // 64-column halves of the head dim
constexpr int kStages = 2;        // Q/dO stages in flight
constexpr int kMaxHeadDim = 64 * kHalves;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// shared memory, in bytes from a 1024-aligned base
constexpr int kKHalf = kKeys * kRowBytes;        // one 64-column half of the K (or V) tile
constexpr int kKV = kHalves * kKHalf;            // the K (or V) tile
constexpr int kQHalf = kQueries * kRowBytes;     // one 64-column half of a Q (or dO) tile
constexpr int kQ = kHalves * kQHalf;             // a Q (or dO) tile
constexpr int kDS = kKeys * kRowBytes;           // dS^T, bf16 [128 keys, 64 queries], swizzled
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kKV;
constexpr int kOffQ = kOffV + kKV;
constexpr int kOffDO = kOffQ + kStages * kQ;
constexpr int kOffDS = kOffDO + kStages * kQ;
constexpr int kOffStats = kOffDS + kDS;          // f32 [2 warpgroups][lse, delta][64 queries]
constexpr int kOffBar = kOffStats + 2 * 2 * kQueries * 4;
constexpr int kSmem = kOffBar + 8 * (1 + kStages) + 1024;  // + slack to align the base
static_assert(kSmem <= 232448, "an H100 block has 227 KB of shared memory");

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// makes this block's earlier writes (ordered before it by a barrier) visible, then publishes v
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// keeps the register A operands of in-flight wgmmas alive (and in place) until they are waited for
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// grid: x = key tiles x batch x query heads (key tile outermost)
__global__ void __launch_bounds__(kThreads, 1) flash_backward_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* dq_sum, int* dq_count,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int batch, int n_heads,
    int n_kv, int q_len, int k_len, int head_dim, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem + kOffK;
  uint8_t* v_s = smem + kOffV;
  uint8_t* q_s = smem + kOffQ;
  uint8_t* do_s = smem + kOffDO;
  uint8_t* ds_s = smem + kOffDS;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = kv_full + 1;  // a Q/dO stage has landed

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  float* my_lse = reinterpret_cast<float*>(smem + kOffStats) + wg * 2 * kQueries;  // log2 units
  float* my_delta = my_lse + kQueries;

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

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 brings query tile n_q - 1 - i (the walk runs down) into stage i % kStages
  auto load_tile = [&](int i) {
    const int s = i % kStages, q0 = (n_q - 1 - i) * kQueries;
    mbar_arrive_expect_tx(&full[s], 2 * kQ);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      tma_load_4d(q_s + s * kQ + half * kQHalf, &q_map, 64 * half, h, q0, b, &full[s]);
      tma_load_4d(do_s + s * kQ + half * kQHalf, &do_map, 64 * half, h, q0, b, &full[s]);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * kKV);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      tma_load_4d(k_s + half * kKHalf, &k_map, 64 * half, hkv, k0, b, kv_full);
      tma_load_4d(v_s + half * kKHalf, &v_map, 64 * half, hkv, k0, b, kv_full);
    }
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < steps) load_tile(i);
    }
  }

  float dv_acc[64], dk_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  const uint32_t k_addr = smem_addr(k_s), v_addr = smem_addr(v_s), ds_addr = smem_addr(ds_s);
  const float scale_log2 = scale * kLog2e;
  const int key_row = 64 * wg + 16 * warp + (lane >> 2);  // this thread's key rows: key_row and key_row + 8
  const int kj0 = k0 + key_row;
  mbar_wait(kv_full, 0);

  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages, m = n_q - 1 - i, q0 = m * kQueries;
    const uint32_t q_addr = smem_addr(q_s + s * kQ), do_addr = smem_addr(do_s + s * kQ);
    mbar_wait(&full[s], (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T: [64 keys, 64 queries] a warpgroup, over the head dim
    float s_acc[32], dp_acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s_acc[j] = dp_acc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kHalves; ++kk) {
      const uint32_t col = (kk >> 2) * kKHalf + (kk & 3) * 32;
      const uint32_t qcol = (kk >> 2) * kQHalf + (kk & 3) * 32;
      Wgmma<64>::run(s_acc, sw128_desc(k_addr + col + wg * 64 * kRowBytes), sw128_desc(q_addr + qcol));
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4 * kHalves; ++kk) {
      const uint32_t col = (kk >> 2) * kKHalf + (kk & 3) * 32;
      const uint32_t qcol = (kk >> 2) * kQHalf + (kk & 3) * 32;
      Wgmma<64>::run(dp_acc, sw128_desc(v_addr + col + wg * 64 * kRowBytes), sw128_desc(do_addr + qcol));
    }
    wgmma_commit();

    // this tile's lse (in log2 units) and delta, fetched while the products run
    {
      const int r = t & (kQueries - 1), qi = q0 + r;
      const int64_t at = static_cast<int64_t>(bh) * q_len + qi;
      if (t < kQueries) {
        my_lse[r] = qi < q_len ? lse[at] * kLog2e : 0.f;
      } else {
        my_delta[r] = qi < q_len ? delta[at] : 0.f;
      }
    }
    named_barrier(1 + wg, 128);

    // accumulator (key row, query column) of element 4j + e: rows key_row (+ 8 for e >= 2), columns
    // 8j + 2 * (lane % 4) + (e & 1)
    wgmma_wait<1>();
    fence_accumulators<32>(s_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * (lane & 3) + (e & 1);
        const int qi = q0 + qc, kj = kj0 + (e & 2) * 4;
        const bool seen = qi < q_len && kj < k_len && (!causal || qi + offset >= kj);
        s_acc[4 * j + e] = seen ? exp2f(s_acc[4 * j + e] * scale_log2 - my_lse[qc]) : 0.f;  // P
      }
    }
    wgmma_wait<0>();
    fence_accumulators<32>(dp_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * (lane & 3) + (e & 1);
        dp_acc[4 * j + e] = s_acc[4 * j + e] * (dp_acc[4 * j + e] - my_delta[qc]);  // dS
      }
    }

    // P^T and dS^T in bf16 as wgmma A fragments: K slice kk (queries 16kk..16kk+15) is accumulator
    // elements 8kk..8kk+7, in pairs
    uint32_t p_frag[4][4], ds_frag[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p_frag[kk][r] = pack_bf16(s_acc[8 * kk + 2 * r], s_acc[8 * kk + 2 * r + 1]);
        ds_frag[kk][r] = pack_bf16(dp_acc[8 * kk + 2 * r], dp_acc[8 * kk + 2 * r + 1]);
      }
    }
    // dV += P^T dO and dK += dS^T Q: [64 keys, 128 columns], over the tile's 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_rs_mn(dv_acc, p_frag[kk], sw128_mn_desc(do_addr + kk * 2048, kQHalf));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n128_rs_mn(dk_acc, ds_frag[kk], sw128_mn_desc(q_addr + kk * 2048, kQHalf));
    wgmma_commit();

    // dS^T into shared memory, [128 keys, 64 queries] in the 128-byte swizzle: chunk j of rows key_row
    // and key_row + 8 holds queries 8j..8j+7, this thread's pair at byte 4 * (lane % 4)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(ds_s + sw128_offset(key_row, j) + 4 * (lane & 3)) = ds_frag[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(ds_s + sw128_offset(key_row + 8, j) + 4 * (lane & 3)) =
          ds_frag[j >> 1][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    __syncthreads();  // both warpgroups' dS^T is written

    // dQ partial = dS K: [64 queries, this warpgroup's 64 columns], over the block's 128 keys
    float dq_acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) dq_acc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_m64n64_mn_mn(dq_acc, sw128_mn_desc(ds_addr + kk * 2048, kDS),
                         sw128_mn_desc(k_addr + wg * kKHalf + kk * 2048, kKHalf));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(dq_acc);
    fence_accumulators<64>(dv_acc);
    fence_accumulators<64>(dk_acc);
    fence_fragments(p_frag);
    fence_fragments(ds_frag);

    // the ordered add: key tile n after key tile n - 1; the last key tile that sees this query tile
    // writes dq = scale * sum in bf16
    const int n_last = causal ? min(n_k - 1, (q0 + kQueries - 1 + offset) / kKeys) : n_k - 1;
    int* count = dq_count + (static_cast<int64_t>(bh) * n_q + m) * 2 + wg;
    if (n > 0) {
      if (t == 0) {
        while (load_acquire(count) < n) {
        }
      }
      named_barrier(1 + wg, 128);
    }
    // accumulator (query row, column) of element 4j + e: rows 16 * warp + lane / 4 (+ 8 for e >= 2),
    // columns 64 * wg + 8j + 2 * (lane % 4) + (e & 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + 16 * warp + (lane >> 2) + 8 * r;
      if (qi >= q_len) continue;
      float* sum_row = dq_sum + (static_cast<int64_t>(bh) * q_len + qi) * head_dim;
      __nv_bfloat16* dq_row = dq + (static_cast<int64_t>(b * q_len + qi) * n_heads + h) * head_dim;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * wg + 8 * j + 2 * (lane & 3);
        if (d >= head_dim) continue;
        float2 part = make_float2(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
        if (n > 0) {
          const float2 prev = __ldcg(reinterpret_cast<const float2*>(sum_row + d));
          part.x = prev.x + part.x;
          part.y = prev.y + part.y;
        }
        if (n == n_last) {
          *reinterpret_cast<uint32_t*>(dq_row + d) = pack_bf16(part.x * scale, part.y * scale);
        } else {
          __stcg(reinterpret_cast<float2*>(sum_row + d), part);
        }
      }
    }
    if (n < n_last) {
      named_barrier(1 + wg, 128);  // every thread's add is written
      if (t == 0) store_release(count, n + 1);
    }

    __syncthreads();  // stage s, the dS^T buffer and the statistics are free
    if (tid == 0 && i + kStages < steps) load_tile(i + kStages);
  }

  // dk = scale * dS^T Q and dv = P^T dO at query-head resolution, f32 [B, Lk, H, D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + 8 * r;
    if (kj >= k_len) continue;
    const int64_t row = (static_cast<int64_t>(b * k_len + kj) * n_heads + h) * head_dim;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= head_dim) continue;
      *reinterpret_cast<float2*>(dk + row + d) =
          make_float2(dk_acc[4 * j + 2 * r] * scale, dk_acc[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dv + row + d) = make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

}  // namespace

// q, dout bf16 [B, Lq, H, D]; k, v bf16 [B, Lk, Hkv, D]; lse, delta f32 [B, H, Lq]; dq_sum f32 [B, H,
// Lq, D] scratch; dq_count int32 [B * H, ceil(Lq / 64), 2] zeroed; dq bf16 [B, Lq, H, D] (rows of query
// tiles that see no key are left as they are: the caller zeroes them); dk, dv f32 [B, Lk, H, D].
// Returns the cudaError_t of the launch (0 = success); the caller validated shapes, types and contiguity.
extern "C" int flash_attention_backward_fused(const void* q, const void* k, const void* v, const void* dout,
                                              const void* lse, const void* delta, void* dq_sum, void* dq_count,
                                              void* dq, void* dk, void* dv, int batch, int n_heads, int n_kv,
                                              int q_len, int k_len, int head_dim, int causal, float scale,
                                              void* stream) {
  if (batch <= 0 || n_kv <= 0 || n_heads % n_kv || q_len <= 0 || k_len <= 0 || head_dim <= 0 ||
      head_dim % 16 || head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured[kMaxDevices] = {};  // the attribute is set once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(flash_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap q_map, k_map, v_map, do_map;
  err = head_map(&q_map, q, batch, q_len, n_heads, head_dim, kQueries);
  if (err == cudaSuccess) err = head_map(&do_map, dout, batch, q_len, n_heads, head_dim, kQueries);
  if (err == cudaSuccess) err = head_map(&k_map, k, batch, k_len, n_kv, head_dim, kKeys);
  if (err == cudaSuccess) err = head_map(&v_map, v, batch, k_len, n_kv, head_dim, kKeys);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((k_len + kKeys - 1) / kKeys) * batch * n_heads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  flash_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_sum), static_cast<int*>(dq_count), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), batch, n_heads, n_kv, q_len, k_len, head_dim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
