// Int8 weight-only matmul for Hopper (sm_90a):
//   out[M, F] = (bf16(x)[M, K] @ q[K, F]) * scale[1, F]
// with x float32 or bfloat16, q int8 in the flax [in, out] layout (F is the
// contiguous axis), per-output-channel f32 scales, and out float32 or
// bfloat16.
//
// Replaces the TPU kernel unionml_tpu/ops/int8_matmul.py::_kernel (the
// pl.pallas_call at :102), reached there through int8_matmul and
// quantized_matmul(impl="pallas"). In the port every quantized matmul of the
// int8 serving path comes here under attention_impl="flash".
//
// Bound. At decode (M <= 4) the bytes: a [4096, 14336] weight is 58.7 MB of
// int8, 17.5 us at 3.35 TB/s, against 0.47 GFLOP. At admission prefill
// (M = 256 on the same weight) the operations: 30 GFLOP, 30 us at the bf16
// tensor-core rate of 989 TFLOP/s.
//
// Design (simple first). Each thread owns VEC neighbouring output columns
// and reads its slice of a weight row with one VEC-byte load (16, 8 or 4
// bytes; a warp reads 32 * VEC contiguous bytes). The int8 values become f32
// exactly by a byte permute into the mantissa of 2^23. A block of 8 warps
// covers 32 * VEC columns and a tile of TM rows of x (TM * VEC = 64 f32
// accumulators a thread): TM = 4 at decode, for the widest loads, and 16 for
// prefill, so each weight byte read from device memory serves 16 rows. The
// block stages its x tile 256 K rows at a time in shared memory, rounded to
// bf16 and held as f32; each warp takes 32 K rows of every staged chunk, and
// the 8 warps then sum their accumulators in a fixed tree through shared
// memory. Products float(bf16(x)) * float(q) are exact in f32, so the kernel
// computes the TPU kernel's function up to summation order, with f32 FMAs on
// the CUDA cores. At decode the column blocks alone leave most SMs idle, so
// the wrapper splits K across blocks: each writes f32 partial sums to a
// [splits, M, F] scratch, and a second kernel adds them in a fixed order,
// applies the scale once and casts (deterministic, no atomics). With one
// split the epilogue fuses. The ragged edges of M and F are masked; M is not
// padded.
//
// Left for later: tensor-core products (mma.sync/wgmma on bf16 tiles), which
// the prefill regime needs to come near its operations bound; cp.async/TMA
// double buffering of the weight tiles; a persistent schedule that needs no
// split-K scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 32;                 // K rows each warp takes from a staged chunk
constexpr int kChunk = kWarps * kRowsPerWarp;    // K rows of x staged at a time
constexpr int kAcc = 64;                         // TM * VEC accumulators a thread
constexpr int kSmemFloats = (kWarps / 2) * 32 * kAcc;  // the reduction tree's first round; holds the x tile too

__device__ __forceinline__ float x_to_float(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float x_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// four int8 (one 32-bit word) -> exact f32: each byte b, offset to b + 128,
// becomes the low mantissa bits of 2^23; subtracting 2^23 + 128 leaves b
__device__ __forceinline__ void unpack4(uint32_t word, float* out) {
  const uint32_t u = word ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

template <int VEC>
__device__ __forceinline__ void load_weights(const int8_t* p, float* w);

template <>
__device__ __forceinline__ void load_weights<16>(const int8_t* p, float* w) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  unpack4(v.x, w);
  unpack4(v.y, w + 4);
  unpack4(v.z, w + 8);
  unpack4(v.w, w + 12);
}

template <>
__device__ __forceinline__ void load_weights<8>(const int8_t* p, float* w) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  unpack4(v.x, w);
  unpack4(v.y, w + 4);
}

template <>
__device__ __forceinline__ void load_weights<4>(const int8_t* p, float* w) {
  unpack4(__ldg(reinterpret_cast<const unsigned int*>(p)), w);
}

// KG consecutive staged x values of one row (a broadcast read: every lane
// of the warp reads the same address)
template <int KG>
__device__ __forceinline__ void load_x(const float* p, float* xs);

template <>
__device__ __forceinline__ void load_x<1>(const float* p, float* xs) {
  xs[0] = *p;
}

template <>
__device__ __forceinline__ void load_x<4>(const float* p, float* xs) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  xs[0] = v.x;
  xs[1] = v.y;
  xs[2] = v.z;
  xs[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(p);
  pair[0] = __floats2bfloat162_rn(a, b);
  pair[1] = __floats2bfloat162_rn(c, d);
}

template <typename TX, typename TO, int TM, int VEC>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const TX* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
    TO* __restrict__ out, float* __restrict__ partial, int m, int k, int f, int k_per_split) {
  static_assert(TM * VEC == kAcc, "64 accumulators a thread");
  static_assert(TM * kChunk <= kSmemFloats, "the x tile fits the shared buffer");
  constexpr int KG = VEC >= 16 ? 1 : 4;  // K rows a step: 16-byte x reads where registers allow
  __shared__ __align__(16) float smem[kSmemFloats];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * (32 * VEC) + lane * VEC;
  const int row0 = blockIdx.y * TM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const bool active = col < f;  // f is a multiple of VEC: a lane's columns are all in or all out

  float acc[TM][VEC];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
  }

  for (int c = k_begin; c < k_end; c += kChunk) {
    // a multiple of 32 (k and k_per_split are multiples of 64), so each
    // warp's 32 rows are all in or all out
    const int rows = min(kChunk, k_end - c);
    for (int i = threadIdx.x; i < TM * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int kk = i - r * kChunk;
      float v = 0.f;
      if (row0 + r < m && kk < rows) v = x_to_float(x[(int64_t)(row0 + r) * k + c + kk]);
      smem[i] = v;
    }
    __syncthreads();
    const int w0 = warp * kRowsPerWarp;
    if (active && w0 < rows) {
      const int8_t* qp = q + (int64_t)(c + w0) * f + col;
#pragma unroll 4
      for (int j = 0; j < kRowsPerWarp; j += KG) {
        float w[KG][VEC];
#pragma unroll
        for (int g = 0; g < KG; ++g) load_weights<VEC>(qp + (int64_t)(j + g) * f, w[g]);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          float xs[KG];
          load_x<KG>(smem + r * kChunk + w0 + j, xs);
#pragma unroll
          for (int g = 0; g < KG; ++g) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(xs[g], w[g][v], acc[r][v]);
          }
        }
      }
    }
    __syncthreads();
  }

  // sum the warps' accumulators in a fixed tree (8 -> 4 -> 2 -> 1) through
  // shared memory laid out [slot][accumulator][lane], free of bank conflicts
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
      float* dst = smem + (warp - half) * 32 * kAcc + lane;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) dst[(r * VEC + v) * 32] = acc[r][v];
      }
    }
    __syncthreads();
    if (warp < half) {
      const float* src = smem + warp * 32 * kAcc + lane;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] += src[(r * VEC + v) * 32];
      }
    }
    __syncthreads();
  }

  if (warp != 0 || !active) return;
  if (partial != nullptr) {  // split K: f32 partial sums, scaled by the second kernel
    float* p = partial + ((int64_t)blockIdx.z * m + row0) * f + col;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      if (row0 + r >= m) break;
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        store4(p + (int64_t)r * f + v, acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
      }
    }
    return;
  }
  float s[VEC];
#pragma unroll
  for (int v = 0; v < VEC; v += 4) {
    const float4 sv = *reinterpret_cast<const float4*>(scale + col + v);
    s[v] = sv.x;
    s[v + 1] = sv.y;
    s[v + 2] = sv.z;
    s[v + 3] = sv.w;
  }
  TO* o = out + (int64_t)row0 * f + col;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    if (row0 + r >= m) break;
#pragma unroll
    for (int v = 0; v < VEC; v += 4) {
      store4(o + (int64_t)r * f + v, acc[r][v] * s[v], acc[r][v + 1] * s[v + 1], acc[r][v + 2] * s[v + 2],
             acc[r][v + 3] * s[v + 3]);
    }
  }
}

// out = (sum over splits, in order, of partial[s]) * scale, four columns a thread
template <typename TO>
__global__ void split_sum_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                                 TO* __restrict__ out, int m, int f, int splits) {
  const int64_t total = (int64_t)m * f;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  const int col = (int)(i % f);
  float4 sum = *reinterpret_cast<const float4*>(partial + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(partial + s * total + i);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(scale + col);
  store4(out + i, sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
}

template <typename TX, typename TO, int TM, int VEC>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out, float* partial, int m, int k,
                   int f, int splits, int k_per_split, cudaStream_t stream) {
  const dim3 grid((f + 32 * VEC - 1) / (32 * VEC), (m + TM - 1) / TM, splits);
  int8_matmul_kernel<TX, TO, TM, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<TO*>(out), splits > 1 ? partial : nullptr, m, k, f, k_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  constexpr int kSumThreads = 256;
  const int64_t quads = (int64_t)m * f / 4;
  split_sum_kernel<TO><<<(unsigned)((quads + kSumThreads - 1) / kSumThreads), kSumThreads, 0, stream>>>(
      partial, static_cast<const float*>(scale), static_cast<TO*>(out), m, f, splits);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t by_tile(int tile_m, const void* x, const void* q, const void* scale, void* out, float* partial, int m,
                    int k, int f, int splits, int k_per_split, cudaStream_t stream) {
  switch (tile_m) {  // TM * VEC = 64; the wrapper's _TILES lists the same pairs
    case 4:
      return launch<TX, TO, 4, 16>(x, q, scale, out, partial, m, k, f, splits, k_per_split, stream);
    case 8:
      return launch<TX, TO, 8, 8>(x, q, scale, out, partial, m, k, f, splits, k_per_split, stream);
    case 16:
      return launch<TX, TO, 16, 4>(x, q, scale, out, partial, m, k, f, splits, k_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t by_out(int out_dtype, int tile_m, const void* x, const void* q, const void* scale, void* out,
                   float* partial, int m, int k, int f, int splits, int k_per_split, cudaStream_t stream) {
  if (out_dtype == 0) return by_tile<TX, float>(tile_m, x, q, scale, out, partial, m, k, f, splits, k_per_split, stream);
  if (out_dtype == 1) {
    return by_tile<TX, __nv_bfloat16>(tile_m, x, q, scale, out, partial, m, k, f, splits, k_per_split, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype/out_dtype: 0 = float32, 1 = bfloat16. tile_m is 4, 8 or 16;
// k_per_split a multiple of 64; partial holds splits * m * f floats when
// splits > 1. Returns the cudaError_t of the launches (0 = success); the
// caller validated shapes, types, contiguity and alignment.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, void* out, void* partial, int m, int k,
                           int f, int tile_m, int splits, int k_per_split, int x_dtype, int out_dtype,
                           void* stream) {
  if (m == 0) return 0;
  if (m < 0 || k % 64 || f % 16 || splits < 1 || k_per_split % 64 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0) {
    err = by_out<float>(out_dtype, tile_m, x, q, scale, out, part, m, k, f, splits, k_per_split, s);
  } else if (x_dtype == 1) {
    err = by_out<__nv_bfloat16>(out_dtype, tile_m, x, q, scale, out, part, m, k, f, splits, k_per_split, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
