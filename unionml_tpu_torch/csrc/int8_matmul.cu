// Int8 weight-only matmul for Hopper (sm_90a):
//   out[M, F] = (bf16(x)[M, K] @ q[K, F]) * scale[1, F]
// with x bfloat16 (the wrapper rounds a float32 x to bfloat16 first, round
// to nearest even), q int8 in the flax [in, out] layout (F is the contiguous
// axis), per-output-channel f32 scales, f32 accumulation, and out float32 or
// bfloat16.
//
// Replaces the TPU kernel unionml_tpu/ops/int8_matmul.py::_kernel (the
// pl.pallas_call at :102), reached there through int8_matmul and
// quantized_matmul(impl="pallas"). In the port every quantized matmul of the
// int8 serving path comes here under attention_impl="flash".
//
// Bounds on an H100 SXM. Decode (M <= 8) is bound by bytes: a [4096, 14336]
// weight is 58.7 MB of int8, 17.6 us at 3.35 TB/s. Admission prefill
// (M = 256 on the same weight) is bound by operations: 30.1 GFLOP, 30.4 us at
// the bf16 tensor-core rate of 989 TFLOP/s.
//
// Design. The products run on the tensor cores with the operands swapped:
// out^T[F, M] = q^T[F, K] . x^T[K, M], one wgmma.m64nNk16 (bf16 in, f32
// accumulators in registers) per 16 K rows and 64 output channels. F fills
// the instruction's 64-row side and the tokens are its N (8, 16, 32, 64, 128
// or 256, the smallest that holds M; larger M takes several N tiles on
// gridDim.y), so one design serves both regimes: at decode the tensor cores
// take the multiply-adds off the CUDA cores, which are left with the int8 ->
// bf16 conversion only, and at prefill every weight tile read from device
// memory serves all 256 rows of x in one pass.
//  - Copies. A ring of S stages in shared memory, each KT K tiles of 64 rows
//    (KT = 2 at N <= 16, where a stage is otherwise too small to pay for its
//    barriers): thread 0 asks the TMA unit for one 2D box of the int8 weight
//    [KT x 64, F_tile] (in the F_tile-byte swizzle; columns past F read as 0)
//    and one box of x per K tile [N, 64] (bf16, in the 128-byte swizzle
//    wgmma reads; rows past M and K read as 0), completing on the stage's
//    mbarrier. The tensor maps are encoded on the host at each launch. S - 1
//    stages are in flight ahead of the one being converted. (16-byte cp.async
//    copies from every thread kept too few bytes in flight per SM to stream a
//    decode weight near the bytes bound.)
//  - Conversion. Each thread turns 8 K rows x 4 channels of the int8 tile
//    into four 16-byte rows of bf16, K-major in the 128-byte swizzle (so both
//    operands are K-major and no transpose flag is used): a transpose in
//    registers by byte selects, then per pair of values two masks into bf16
//    magic numbers and one bf16x2 add, exact since |q| <= 127 fits bf16's 8
//    significant bits. The lanes of a warp read their rows in an order that
//    the weight's swizzle spreads over all 32 banks, and write whole
//    128-byte rows. A fence.proxy.async and a barrier order the writes
//    before the wgmma that reads them.
//  - Overlap. One warpgroup (two at N >= 128, F_tile = 128) issues the
//    wgmmas of step s asynchronously, then converts step s + 1 into a second
//    buffer while they run (AB = 2), or, at N <= 16 where the products are
//    small, into the same buffer once they are done (AB = 1: a smaller block,
//    so more of them share an SM), with two barriers a step.
//  - Filling the card at decode. M <= 8 leaves F / 64 blocks; K is split
//    across the blocks of a thread-block cluster (up to 16, the non-portable
//    size), aiming at two blocks per SM (one at N >= 128, where one block
//    fills an SM's shared memory). The blocks of a cluster add their f32
//    partial tiles through distributed shared memory, each block a slice of
//    the output, summing the ranks in a fixed order: one launch, no scratch
//    in device memory, no atomics, a bitwise-deterministic result.
//  - Epilogue. The accumulators go through shared memory as an [N, F_tile]
//    f32 tile (rows padded by 4 floats, free of bank conflicts), so the
//    stores to out[M, F] run along F in 16- or 8-byte vectors; the scale of
//    each channel is applied once to the sum, then the cast; rows past M and
//    channels past F are masked.
//
// Limits: K % 64 == 0, F % 16 == 0, 16-byte aligned x, q and scale, any M.
//
// Left for later: decode is bound by the per-stage work of each block
// (barriers, the conversion) more than by the bytes; a producer warp with
// setmaxnreg and converter warps on mbarriers instead of block barriers, A
// from registers, and a persistent schedule over output tiles would cut it.
// At prefill, TMA multicast of the x tile across a cluster along F (each of
// the F / 128 blocks reads all of x through L2). fp8/int8 tensor-core
// products for int8 activations.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStepK = 64;       // K rows of a K tile: one 128-byte row of bf16 in the swizzled tiles
constexpr int kMaxCluster = 16;  // the non-portable cluster size of an H100
constexpr int kMaxDevices = 64;

// two int8 -> bf16x2, exactly and without float conversions: `v` holds byte b of each value in bits
// 7:0 of its 16-bit lane (bits 15:8 are ignored). 0x4300 | (b & 0x7F) is the bf16 of 128 + (b & 127),
// 0xC300 | (b & 0x80) that of -128 (b >= 0) or -256 (b < 0), and their sum, b, is exact in bf16.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t v) {
  const uint32_t high = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t offset = (v & 0x00800080u) | 0xC300C300u;
  const __nv_bfloat162 sum =
      __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&high), *reinterpret_cast<const __nv_bfloat162*>(&offset));
  return *reinterpret_cast<const uint32_t*>(&sum);
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 pair;
  pair.x = *reinterpret_cast<const uint32_t*>(&lo);
  pair.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = pair;
}

// shared memory of one block: N tokens a tile, WGS consumer warpgroups (64 channels each), S stages of
// KT 64-row K tiles each, AB converted weight buffers (2: the conversion of a stage overlaps the
// products of the one before; 1: it waits for them, and the block fits more of itself on an SM)
template <int N, int WGS, int S, int KT, int AB>
struct Layout {
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kFTile = 64 * WGS;              // output channels a block
  static constexpr int kStep = KT * kStepK;            // K rows a stage
  static constexpr int kA1 = kFTile * kRowBytes;       // one converted K tile, bf16 [F_tile, 64], swizzled
  static constexpr int kX1 = N * kRowBytes;            // one x K tile, bf16 [N, 64], swizzled
  static constexpr int kA = KT * kA1;                  // a stage's converted weight
  static constexpr int kX = KT * kX1;                  // a stage's x
  static constexpr int kQ = kStep * kFTile;            // a stage's weight, int8 [KT x 64, F_tile], swizzled
  static constexpr int kCLd = kFTile + 4;              // row pitch (floats) of the epilogue's [N, F_tile] tile
  static constexpr int kBytes = AB * kA + S * (kX + kQ);
  static constexpr int kSmem = kBytes + 8 * S + 1024;  // + the stages' barriers, + slack to align the tiles
  static_assert(S >= 2, "the loop keeps S - 1 stages in flight");
  static_assert(N * kCLd * 4 <= kBytes, "the epilogue tile fits the pipeline's buffers");
  static_assert(kSmem <= 232448, "an H100 block has 227 KB of shared memory");
};

// byte offset of 4-byte word w of row r in an int8 [64, FT] weight stage as the TMA unit writes it in
// the FT-byte swizzle: 16-byte chunk c of row r lands at c ^ ((r >> 1) & 3) (FT = 64) or c ^ (r & 7) (FT = 128)
template <int FT>
__device__ __forceinline__ int q_offset(int r, int w) {
  const int swizzle = FT == 64 ? ((r >> 1) & 3) : (r & 7);
  return r * FT + (((w >> 2) ^ swizzle) << 4) + ((w & 3) << 2);
}

// int8 weight stage [64, F_tile] -> bf16 [F_tile, 64] (K-major, 128-byte swizzle): thread t converts K
// rows 8 * (t % 8) .. + 7 of channels 4 * (t / 8) .. + 3 (2 * F_tile threads cover the tile once). The
// 8 lanes of one channel group read their rows in the order i ^ (t % 8), so each load of a warp hits 32
// distinct banks through the swizzle; selects and the byte selector put the rows back in order. Each
// 8 lanes then write one 128-byte row of the converted tile.
template <int FT>
__device__ __forceinline__ void convert_tile(const uint8_t* __restrict__ qs, uint8_t* __restrict__ as, int tid) {
  const int kc = tid & 7;
  const int g = tid >> 3;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = *reinterpret_cast<const uint32_t*>(qs + q_offset<FT>(8 * kc + (i ^ kc), g));
#pragma unroll
  for (int b = 2; b < 8; b <<= 1) {  // w[i] holds row i ^ kc: undo bits 1 and 2 of the xor here
    const bool flip = (kc & b) != 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & b) continue;
      const uint32_t lo = w[i], hi = w[i | b];
      w[i] = flip ? hi : lo;
      w[i | b] = flip ? lo : hi;
    }
  }
  // and bit 0 in the byte selector: byte j of rows 2p and 2p + 1 into the low bytes of a pair's lanes
  const uint32_t select = (kc & 1) ? 0x0004u : 0x0400u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sj = select + 0x0101u * j;
    uint4 chunk;
    chunk.x = int8x2_to_bf16x2(__byte_perm(w[0], w[1], sj));
    chunk.y = int8x2_to_bf16x2(__byte_perm(w[2], w[3], sj));
    chunk.z = int8x2_to_bf16x2(__byte_perm(w[4], w[5], sj));
    chunk.w = int8x2_to_bf16x2(__byte_perm(w[6], w[7], sj));
    *reinterpret_cast<uint4*>(as + sw128_offset(4 * g + j, kc)) = chunk;
  }
}

// grid: x = F tiles x splits (the splits of one tile form a cluster), y = N tiles of M
template <int N, int WGS, int S, int KT, int AB, typename TO>
__global__ void __launch_bounds__(128 * WGS) int8_matmul_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap q_map, const float* __restrict__ scale,
    TO* __restrict__ out, int m, int k, int f, int splits, int k_per_split) {
  using L = Layout<N, WGS, S, KT, AB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_buf = smem;                   // AB converted weight stages
  uint8_t* x_buf = smem + AB * L::kA;      // S x stages
  uint8_t* q_buf = x_buf + S * L::kX;      // S weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(q_buf + S * L::kQ);  // a stage's copies have landed

  const int tid = threadIdx.x;
  const int f0 = (blockIdx.x / splits) * L::kFTile;
  const int n0 = blockIdx.y * N;
  const int rows = min(N, m - n0);
  const int cols = min(L::kFTile, f - f0);  // output channels of this tile (weight columns past F read as 0)
  const int k_begin = (blockIdx.x % splits) * k_per_split;
  // the last stage of the last rank may run past K: the TMA unit reads those rows of q and x as 0
  const int steps = (max(0, min(k_per_split, k - k_begin)) + L::kStep - 1) / L::kStep;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 brings step `step` into slot `slot`: one 2D box of the weight and one of x (rows past M and
  // columns past F zero-filled by the TMA unit)
  auto load_step = [&](int step, int slot) {
    if (tid != 0) return;
    const int k0 = k_begin + step * L::kStep;
    mbar_arrive_expect_tx(&full[slot], L::kQ + L::kX);
    tma_load_2d(q_buf + slot * L::kQ, &q_map, f0, k0, &full[slot]);
#pragma unroll
    for (int t = 0; t < KT; ++t) tma_load_2d(x_buf + slot * L::kX + t * L::kX1, &x_map, k0 + t * kStepK, n0, &full[slot]);
  };
  auto wait_step = [&](int step) { mbar_wait(&full[step % S], (step / S) & 1); };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_accumulators<N / 2>(acc);

  // prologue: S - 1 steps in flight, then step 0 converted
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < steps) load_step(st, st);
  }
  if (steps > 0) {
    wait_step(0);
#pragma unroll
    for (int t = 0; t < KT; ++t) convert_tile<L::kFTile>(q_buf + t * kStepK * L::kFTile, a_buf + t * L::kA1, tid);
    fence_proxy_async();
    __syncthreads();
  }

  const int wg = tid >> 7;
  for (int s = 0; s < steps; ++s) {
    // the products of step s run while step s + 1 is converted
    const uint32_t a_addr = smem_addr(a_buf + (s % AB) * L::kA + wg * 64 * kRowBytes);
    const uint32_t x_addr = smem_addr(x_buf + (s % S) * L::kX);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int kk = 0; kk < kStepK / 16; ++kk) {
        Wgmma<N>::run(acc, sw128_desc(a_addr + t * L::kA1 + 32 * kk), sw128_desc(x_addr + t * L::kX1 + 32 * kk));
      }
    }
    wgmma_commit();
    wgmma_wait<AB - 1>();  // this warpgroup's products of step s - 1 (AB = 2) or s (AB = 1) are done
    __syncthreads();  // every warpgroup's are: the slot of step s - 1 and the buffer step s + 1 converts into are free
    if (s + S - 1 < steps) load_step(s + S - 1, (s + S - 1) % S);
    if (s + 1 < steps) {
      wait_step(s + 1);
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        convert_tile<L::kFTile>(q_buf + ((s + 1) % S) * L::kQ + t * kStepK * L::kFTile,
                                a_buf + ((s + 1) % AB) * L::kA + t * L::kA1, tid);
      }
      fence_proxy_async();
    }
    __syncthreads();
  }
  wgmma_wait<0>();
  fence_accumulators<N / 2>(acc);
  __syncthreads();  // the pipeline's buffers are free: the epilogue tile goes over them

  // accumulator (row F, column token) of thread t: rows 16 * warp + lane / 4 (+ 8) of its warpgroup's
  // 64, columns 8 * j + 2 * (lane % 4) (+ 1); stored transposed, [token, channel]
  float* c_tile = reinterpret_cast<float*>(smem);
  {
    const int lane = tid & 31;
    const int fr = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int n = 8 * j + 2 * (lane & 3);
      c_tile[n * L::kCLd + fr] = acc[4 * j];
      c_tile[(n + 1) * L::kCLd + fr] = acc[4 * j + 1];
      c_tile[n * L::kCLd + fr + 8] = acc[4 * j + 2];
      c_tile[(n + 1) * L::kCLd + fr + 8] = acc[4 * j + 3];
    }
  }

  constexpr int kQuads = L::kFTile / 4;  // 4-channel vectors of a tile row
  const int quads = rows * kQuads;
  if (splits == 1) {
    __syncthreads();
    for (int i = tid; i < quads; i += L::kThreads) {
      const int n = i / kQuads, c = (i % kQuads) * 4;
      if (c >= cols) continue;
      const float4 v = *reinterpret_cast<const float4*>(c_tile + n * L::kCLd + c);
      const float4 sc = *reinterpret_cast<const float4*>(scale + f0 + c);
      store4(out + static_cast<int64_t>(n0 + n) * f + f0 + c,
             make_float4(v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w));
    }
    return;
  }
  // split K: each block of the cluster sums one slice of the tile over every rank's partial tile
  // (distributed shared memory, ranks in order), scales and writes it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's partial tile is written
  const int per = (quads + splits - 1) / splits;
  const int begin = static_cast<int>(cluster.block_rank()) * per;
  const int end = min(quads, begin + per);
  for (int i = begin + tid; i < end; i += L::kThreads) {
    const int n = i / kQuads, c = (i % kQuads) * 4;
    if (c >= cols) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(cluster.map_shared_rank(c_tile, r) + n * L::kCLd + c);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(scale + f0 + c);
    store4(out + static_cast<int64_t>(n0 + n) * f + f0 + c,
           make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w));
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

// a row-major [rows, cols] tensor of `item`-byte elements at `base`, read in [box_rows, box_cols] boxes
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, int cols, int rows, int item,
                          int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, element_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, int WGS, int S, int KT, int AB, typename TO>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, int m, int k, int f, int splits,
                   int k_per_split, cudaStream_t stream) {
  using L = Layout<N, WGS, S, KT, AB>;
  if (k_per_split % L::kStep) return cudaErrorInvalidValue;
  auto kernel = int8_matmul_kernel<N, WGS, S, KT, AB, TO>;
  static bool configured[kMaxDevices] = {};  // the attributes are set once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  // x as a [M, K] bf16 tensor read in [N, 64] boxes in the 128-byte swizzle the wgmma descriptors name,
  // q as a [K, F] int8 tensor read in [64, F_tile] boxes in the F_tile-byte swizzle convert_tile reads
  CUtensorMap x_map, q_map;
  cudaError_t bad = tensor_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2, kStepK, N,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (bad == cudaSuccess) {
    bad = tensor_map_2d(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, f, k, 1, L::kFTile, L::kStep,
                        L::kFTile == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (bad != cudaSuccess) return bad;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>((f + L::kFTile - 1) / L::kFTile * splits),
                        static_cast<unsigned>((m + N - 1) / N), 1);
  config.blockDim = dim3(L::kThreads, 1, 1);
  config.dynamicSmemBytes = L::kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(splits);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, x_map, q_map, static_cast<const float*>(scale),
                           static_cast<TO*>(out), m, k, f, splits, k_per_split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// (N tile, warpgroups, stages, K tiles a stage, converted buffers); the wrapper's _TILES lists the same F_tile = 64 x
// warpgroups and K tiles a stage for each N tile
template <typename TO>
cudaError_t by_tile(int n_tile, const void* x, const void* q, const void* scale, void* out, int m, int k, int f,
                    int splits, int k_per_split, cudaStream_t stream) {
  switch (n_tile) {
    case 8:
      return launch<8, 1, 4, 2, 1, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    case 16:
      return launch<16, 1, 4, 2, 1, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    case 32:
      return launch<32, 1, 5, 1, 2, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    case 64:
      return launch<64, 1, 4, 1, 2, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    case 128:
      return launch<128, 2, 4, 1, 2, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    case 256:
      return launch<256, 2, 4, 1, 2, TO>(x, q, scale, out, m, k, f, splits, k_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x bfloat16 [m, k]; out_dtype: 0 = float32, 1 = bfloat16. n_tile is 8, 16, 32, 64, 128 or 256;
// splits (1..16) blocks of a cluster share each tile's K, k_per_split (a multiple of 64) rows each.
// Returns the cudaError_t of the launch (0 = success); the caller validated shapes, types,
// contiguity and alignment.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, void* out, int m, int k, int f,
                           int n_tile, int splits, int k_per_split, int out_dtype, void* stream) {
  if (m == 0) return 0;
  if (m < 0 || k <= 0 || k % kStepK || f <= 0 || f % 16 || splits < 1 || splits > kMaxCluster ||
      k_per_split <= 0 || k_per_split % kStepK || static_cast<int64_t>(splits) * k_per_split < k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (out_dtype == 0) {
    err = by_tile<float>(n_tile, x, q, scale, out, m, k, f, splits, k_per_split, s);
  } else if (out_dtype == 1) {
    err = by_tile<__nv_bfloat16>(n_tile, x, q, scale, out, m, k, f, splits, k_per_split, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
