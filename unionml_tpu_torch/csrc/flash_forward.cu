// Flash-attention forward for Hopper (sm_90a), bf16: both products on the
// tensor cores, K and V streamed by the TMA unit.
//
// Replaces the TPU kernel of unionml_tpu/ops/flash_attention.py
//   _flash_fwd_kernel (pallas_call at :160)
// for bf16 inputs and computes what it computes (:60-125). (float32 inputs
// run csrc/flash_forward_f32.cu.)
//
// Layout as in the JAX package: q [B, Lq, H, D], k and v [B, Lk, Hkv, D],
// all bf16 and contiguous; out [B, Lq, H, D] bf16, lse [B, H, Lq] f32. Query
// head h reads KV head h / (H / Hkv). Query row i sees key j when i + (Lk -
// Lq) >= j (causal) or always. With scale = D**-0.5 and S = scale * Q K^T in
// f32 (masked entries -inf):
//   m = rowmax(S), P = exp(S - m) in f32, l = rowsum(P) of the f32 P;
//   out = (bf16(P) V) / l, the product over P rounded to bf16 as the JAX
//   kernel casts p.astype(v.dtype), divided by l at the end;
//   lse = m + log(l) in natural-log units, as the backward reads it.
// A row that sees no key writes 0 and lse = 1e30 (the contract of
// unionml_tpu/ops/attention.py:56-58), so the backward's exp(S - lse) is 0.
//
// Bound: operations. Two products of 2 * D multiply-adds per visible (query,
// key) pair: at B=1, L=2048, H=32, Hkv=8, D=128, causal, 0.0348 ms at the
// bf16 tensor-core rate of 989 TFLOP/s; its 25 MB of inputs and outputs take
// 0.0075 ms at 3.35 TB/s.
//
// Design (FlashAttention-3's forward in outline, kept simple):
//  - Grid. One block per (query tile of 128 rows, batch, query head), two
//    warpgroups of 64 query rows each. blockIdx runs over query tiles
//    outermost, from the last down, so that under causal masking the
//    heaviest tiles start first.
//  - Copies. One thread loads the Q tile once and streams the K and V tiles
//    (128 keys) through a ring of two stages, each an mbarrier-tracked TMA box
//    of a 4D tensor map over [B, L, heads, D] in the 128-byte swizzle (two
//    boxes of 64 head-dim columns; rows past L and columns past D read as 0).
//    A stage is released when both warpgroups are done with it: the second
//    to finish (a counter in shared memory) issues the load of the tile two
//    ahead, so that it runs under the products of the next tile. Key tiles
//    wholly above the shifted diagonal are never loaded.
//  - Per key tile, in each warpgroup: S = Q K^T (wgmma m64n128k16, A and B
//    K-major from shared memory); scale, mask and the online max over the
//    four lanes of a quad that share an accumulator row (log2 units);
//    O rescaled by exp(m_old - m_new); P rounded to bf16 in the register
//    layout of a wgmma A operand; O += P V (A from registers, V the MN-major
//    B operand); the products waited for before the stage is released. The
//    row sums stay per lane and are summed over the quad once, at the end.
//  - Epilogue. out = O / l in bf16 and lse, straight from the registers.
//  - Determinism. No atomics touch the results; two calls on the same inputs
//    give the same bits.
//
// Limits (the fused backward's): bf16, D % 16 == 0 and D <= 128 (the tiles
// are always 128 columns wide; D <= 64 computes on zero columns), any
// lengths, causal or not, any Lk - Lq, H % Hkv == 0, 16-byte aligned tensors.
//
// Left for later: a producer warp with setmaxnreg; ping-pong scheduling of
// the two warpgroups (one's softmax under the other's products); overlapping
// a tile's softmax with the next tile's Q K^T inside a warpgroup; a
// persistent grid; a TMA store of the output tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kQueries = 128;  // query rows of a block, 64 a warpgroup
constexpr int kKeys = 128;     // key rows of a tile
constexpr int kHalves = 2;     // 64-column halves of the head dim
constexpr int kStages = 2;     // K/V stages in flight
constexpr int kMaxHeadDim = 64 * kHalves;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kBig = 1e30f;  // lse of a row that sees no key
constexpr int kMaxDevices = 64;

// shared memory, in bytes from a 1024-aligned base
constexpr int kQHalf = kQueries * kRowBytes;  // one 64-column half of the Q tile
constexpr int kQ = kHalves * kQHalf;
constexpr int kKVHalf = kKeys * kRowBytes;    // one 64-column half of a K (or V) tile
constexpr int kKV = kHalves * kKVHalf;
constexpr int kOffQ = 0;
constexpr int kOffK = kOffQ + kQ;
constexpr int kOffV = kOffK + kStages * kKV;
constexpr int kOffBar = kOffV + kStages * kKV;  // Q's mbarrier, then one a stage
constexpr int kOffRelease = kOffBar + 8 * (1 + kStages);
constexpr int kSmem = kOffRelease + 4 * kStages + 1024;  // + slack to align the base
static_assert(kSmem <= 232448, "an H100 block has 227 KB of shared memory");

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// keeps the register A operands of in-flight wgmmas alive (and in place) until they are waited for
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// grid: x = query tiles x batch x query heads (query tile outermost, walked from the last down)
__global__ void __launch_bounds__(kThreads, 1) flash_forward_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int n_heads, int n_kv, int heads, int q_len, int k_len, int head_dim, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem + kOffQ;
  uint8_t* k_s = smem + kOffK;
  uint8_t* v_s = smem + kOffV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = q_full + 1;  // a K/V stage has landed
  int* release = reinterpret_cast<int*>(smem + kOffRelease);  // 2 arrivals a use of a stage

  const int tid = threadIdx.x;
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int n_q = (q_len + kQueries - 1) / kQueries;
  const int m = n_q - 1 - static_cast<int>(blockIdx.x) / heads;  // query tile
  const int bh = blockIdx.x % heads;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int hkv = h / (n_heads / n_kv);
  const int q0 = m * kQueries;
  const int offset = k_len - q_len;
  const int n_k = (k_len + kKeys - 1) / kKeys;
  // causal: the last key the block's last row sees is last_row + offset
  const int last_key = min(q0 + kQueries, q_len) - 1 + offset;
  const int n_tiles = causal ? (last_key < 0 ? 0 : min(n_k, last_key / kKeys + 1)) : n_k;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      release[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // key tile i into stage i % kStages
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    mbar_arrive_expect_tx(&full[s], 2 * kKV);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      tma_load_4d(k_s + s * kKV + half * kKVHalf, &k_map, 64 * half, hkv, i * kKeys, b, &full[s]);
      tma_load_4d(v_s + s * kKV + half * kKVHalf, &v_map, 64 * half, hkv, i * kKeys, b, &full[s]);
    }
  };
  if (tid == 0) {
    mbar_arrive_expect_tx(q_full, kQ);
#pragma unroll
    for (int half = 0; half < kHalves; ++half) tma_load_4d(q_s + half * kQHalf, &q_map, 64 * half, h, q0, b, q_full);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < n_tiles) load_tile(i);
    }
  }

  // accumulator (query row, column) of element 4j + e: rows row0 (+ 8 for e >= 2), columns
  // 8j + 2 * (lane % 4) + (e & 1)
  const int qw0 = q0 + 64 * wg;  // this warpgroup's first query row
  const int row0 = qw0 + 16 * warp + (lane >> 2);
  float o_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o_acc[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // of scale * log2(e) * S
  float row_sum[2] = {0.f, 0.f};              // this lane's part of l
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_addr(q_s) + wg * 64 * kRowBytes;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, k0 = i * kKeys;
    mbar_wait(&full[s], (i / kStages) & 1);
    // this warpgroup's rows see some key of the tile; some entry of the tile is masked
    const bool sees = qw0 < q_len && (!causal || k0 <= qw0 + 63 + offset);
    const bool masked = k0 + kKeys > k_len || (causal && k0 + kKeys - 1 > qw0 + offset);
    if (sees) {
      const uint32_t k_addr = smem_addr(k_s + s * kKV), v_addr = smem_addr(v_s + s * kKV);

      // S = Q K^T: [64 queries, 128 keys], over the head dim
      float s_acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) s_acc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kHalves; ++kk) {
        const uint32_t col = (kk >> 2) * kQHalf + (kk & 3) * 32;
        const uint32_t kcol = (kk >> 2) * kKVHalf + (kk & 3) * 32;
        Wgmma<128>::run(s_acc, sw128_desc(q_addr + col), sw128_desc(k_addr + kcol));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_accumulators<64>(s_acc);

      // scale (log2 units) and mask, then the tile's max of each row over the quad
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e] * scale_log2;
          if (masked) {
            const int qi = row0 + 4 * (e & 2), kj = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
            if (kj >= k_len || (causal && qi + offset < kj)) x = -INFINITY;
          }
          s_acc[4 * j + e] = x;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
        }
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = tile_max[r];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(row_max[r], x);
        // a row that has seen no key yet keeps a zero state: its P are all 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(row_max[r] - m_use[r]);
        row_max[r] = m_new;
        row_sum[r] *= alpha[r];
      }

      // P in f32 (summed into l), then rounded to bf16 as wgmma A fragments: K slice kk (keys
      // 16kk..16kk+15) is accumulator elements 8kk..8kk+7, in pairs
      uint32_t p_frag[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r, row = r & 1;
          const float p0 = exp2f(s_acc[e] - m_use[row]), p1 = exp2f(s_acc[e + 1] - m_use[row]);
          row_sum[row] += p0 + p1;
          p_frag[kk][r] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) o_acc[j] *= alpha[(j >> 1) & 1];

      // O += P V: [64 queries, 128 columns], over the tile's 128 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_m64n128_rs_mn(o_acc, p_frag[kk], sw128_mn_desc(v_addr + kk * 2048, kKVHalf));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_accumulators<64>(o_acc);
      fence_fragments(p_frag);
    }

    // release stage s: the second warpgroup to be done with it loads key tile i + kStages there
    named_barrier(1 + wg, 128);
    if (t == 0) {
      const int arrived = atomicAdd(&release[s], 1);
      if ((arrived & 1) && i + kStages < n_tiles) load_tile(i + kStages);
    }
  }

  // out = O / l in bf16, lse = m + log(l) (natural log); a row that saw no key writes 0 and 1e30
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = row0 + 8 * r;
    if (qi >= q_len) continue;
    __nv_bfloat16* dst = out + (static_cast<int64_t>(b * q_len + qi) * n_heads + h) * head_dim;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * (lane & 3);
      if (d >= head_dim) continue;
      const float x = l > 0.f ? o_acc[4 * j + 2 * r] / l : 0.f;
      const float y = l > 0.f ? o_acc[4 * j + 2 * r + 1] / l : 0.f;
      *reinterpret_cast<uint32_t*>(dst + d) = pack_bf16(x, y);
    }
    if ((lane & 3) == 0) {
      lse[static_cast<int64_t>(bh) * q_len + qi] = l > 0.f ? row_max[r] * kLn2 + logf(l) : kBig;
    }
  }
}

}  // namespace

// q bf16 [B, Lq, H, D]; k, v bf16 [B, Lk, Hkv, D]; out bf16 [B, Lq, H, D]; lse f32 [B, H, Lq].
// Returns the cudaError_t of the launch (0 = success); the caller validated types, contiguity and alignment.
extern "C" int flash_attention_forward_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                                            int batch, int n_heads, int n_kv, int q_len, int k_len, int head_dim,
                                            int causal, float scale, void* stream) {
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
    err = cudaFuncSetAttribute(flash_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  CUtensorMap q_map, k_map, v_map;
  err = head_map(&q_map, q, batch, q_len, n_heads, head_dim, kQueries);
  if (err == cudaSuccess) err = head_map(&k_map, k, batch, k_len, n_kv, head_dim, kKeys);
  if (err == cudaSuccess) err = head_map(&v_map, v, batch, k_len, n_kv, head_dim, kKeys);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t heads = static_cast<int64_t>(batch) * n_heads;
  const int64_t blocks = static_cast<int64_t>((q_len + kQueries - 1) / kQueries) * heads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  flash_forward_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n_heads, n_kv,
      static_cast<int>(heads), q_len, k_len, head_dim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
