// PTX helpers shared by the port's Hopper (sm_90a) kernels: shared-memory
// addresses, mbarriers, 1D bulk copies and TMA tensor copies, the wgmma
// fences, 128-byte-swizzle matrix descriptors and the wgmma instructions
// (bf16 in, f32 accumulators), mma.sync m16n8k16 and ldmatrix, mma.sync
// m16n8k8 in TF32 with the 3xTF32 split, cp.async copies,
// the packing of two f32 into a bf16x2 register, the host-side lookup of
// libcuda's cuTensorMapEncodeTiled and the flash kernels' 4D head maps.
//
// Layout conventions. A tile that the TMA unit writes in the 128-byte swizzle
// is rows of 128 bytes (64 bf16) whose 16-byte chunk c of row r sits at
// c ^ (r & 7); tiles start on 1024-byte boundaries. Read as a wgmma operand
// it is either K-major (the 64 values of a row run along K: sw128_desc) or
// MN-major (they run along M or N, and the rows along K: sw128_mn_desc).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 128;  // a swizzled tile's row: 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` more of asynchronous copies before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one plain arrival (no transaction bytes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// `bytes` contiguous bytes global -> shared by the bulk-copy unit (no tensor map), completing on `bar`; both
// addresses 16-byte aligned, `bytes` a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// one box of a 2D tensor map global -> shared (swizzled, rows past the tensor zero-filled), completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// one box of a 4D tensor map (coordinates innermost first), as tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's generic-proxy writes to shared memory before later async-proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the asynchronous wgmma region
template <int R>
__device__ __forceinline__ void fence_accumulators(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart (stride byte offset), leading
// byte offset unused (1), layout type 1 (SWIZZLE_128B); tiles start on
// 1024-byte boundaries, and a 16-row K slice starts 32 bytes further
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// wgmma matrix descriptor of an MN-major tile in the 128-byte swizzle: each
// 128-byte row holds 64 consecutive M (or N) values of one K index, K runs
// down the rows, 8-row K groups are 1024 bytes apart (stride byte offset), and
// the next 64 M (or N) values start `mn_block_bytes` further (leading byte
// offset); a 16-row K slice starts 2048 bytes further
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr, uint32_t mn_block_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((mn_block_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// two f32 rounded to bf16 (to nearest even) in one register, lo in the low half: a wgmma A fragment's pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers), D += A . B: A row-major 16 x 16 in four
// bf16x2 registers, B column-major 16 x 8 in two, D 16 x 8 in four (the PTX ISA's fragment layouts)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, in a .b32 register with the low 13 bits
// clear: what cvt.rna.tf32.f32 computes, on the bits (half a TF32 unit added to the magnitude, the rest cleared).
// sm_90 has no single instruction for that cvt (it compiles to a compare, a select and integer operations); this
// is two. Finite values and infinities round as the cvt does (past the largest TF32 value to infinity)
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// x as a TF32 pair for 3xTF32 products: hi = tf32_rna(x), lo = tf32_rna(x - hi) (x - hi is exact in f32);
// hi + lo is x to within about 2**-22 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// mma.sync.m16n8k8 (tf32 in, f32 accumulators in registers), D += A . B: A row-major 16 x 8 in four registers
// (a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) with g = lane / 4, t = lane % 4), B
// column-major 8 x 8 in two (b0 (row t, col g), b1 (t + 4, g)), D 16 x 8 in four (rows g and g + 8, columns
// 2t and 2t + 1), as mma_16816's accumulators
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A . B to near-f32 accuracy in three TF32 passes (3xTF32): a_lo b_hi + a_hi b_lo + a_hi b_hi, operands split
// by split_tf32 (the a_lo b_lo term, about 2**-22 of the product, is dropped)
__device__ __forceinline__ void mma_1688_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                                uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_1688_tf32(d, a_lo, b0_hi, b1_hi);
  mma_1688_tf32(d, a_hi, b0_lo, b1_lo);
  mma_1688_tf32(d, a_hi, b0_hi, b1_hi);
}

// 16 bytes global -> shared without the registers (cp.async, L2 only); src_bytes < 16 zero-fills the rest, 0 reads
// nothing. Both addresses 16-byte aligned. Completes at cp_async_wait of the group it was committed in
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared as cp_async_16 (4-byte aligned addresses; src_bytes 0 writes 0)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits until at most N of this thread's committed cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared memory, transposed: lanes 8j..8j+7 give the row addresses of matrix j,
// and register j of lane l holds its elements (row 2 (l % 4), column l / 4) and (row 2 (l % 4) + 1, same)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// byte offset of the 16-byte chunk c (0..7) of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128_offset(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

// wgmma.m64nNk16.f32.bf16.bf16, A and B K-major from shared memory, D += A . B
template <int N>
struct Wgmma;

#define REG4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : REG4(0)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : REG4(0), REG4(4)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : REG4(0), REG4(4), REG4(8), REG4(12)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REG4(0), REG4(4), REG4(8), REG4(12), REG4(16), REG4(20), REG4(24), REG4(28)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : REG4(0), REG4(4), REG4(8), REG4(12), REG4(16), REG4(20), REG4(24), REG4(28),
        REG4(32), REG4(36), REG4(40), REG4(44), REG4(48), REG4(52), REG4(56), REG4(60)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float* d, uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : REG4(0), REG4(4), REG4(8), REG4(12), REG4(16), REG4(20), REG4(24), REG4(28),
        REG4(32), REG4(36), REG4(40), REG4(44), REG4(48), REG4(52), REG4(56), REG4(60),
        REG4(64), REG4(68), REG4(72), REG4(76), REG4(80), REG4(84), REG4(88), REG4(92),
        REG4(96), REG4(100), REG4(104), REG4(108), REG4(112), REG4(116), REG4(120), REG4(124)
      : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

// wgmma.m64n64k16 with A and B both MN-major from shared memory (transpose bits set), D += A . B
__device__ __forceinline__ void wgmma_m64n64_mn_mn(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
    "%32, %33, p, 1, 1, 1, 1;\n}\n"
    : REG4(0), REG4(4), REG4(8), REG4(12), REG4(16), REG4(20), REG4(24), REG4(28)
    : "l"(desc_a), "l"(desc_b), "r"(1));
}

// wgmma.m64n128k16 with A from registers (four bf16x2 a warp-fragment, the
// layout of an m64nN accumulator's 16 columns) and B MN-major from shared
// memory, D += A . B
__device__ __forceinline__ void wgmma_m64n128_rs_mn(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
    "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
    : REG4(0), REG4(4), REG4(8), REG4(12), REG4(16), REG4(20), REG4(24), REG4(28),
      REG4(32), REG4(36), REG4(40), REG4(44), REG4(48), REG4(52), REG4(56), REG4(60)
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef REG4

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no link against libcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a contiguous bf16 [batch, len, heads, head_dim] tensor read in [64 columns, 1 head, rows, 1] boxes in the
// 128-byte swizzle (rows past len and columns past head_dim read as 0)
inline cudaError_t head_map(CUtensorMap* map, const void* base, int batch, int len, int heads, int head_dim,
                            int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(head_dim) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * len};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
