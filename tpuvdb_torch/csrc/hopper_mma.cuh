// Hopper building blocks shared by csrc/scan.cu and csrc/ivf_probe.cu: a
// 128-row x N-query product on the tensor cores (wgmma), fed by a ring of
// asynchronous copies (TMA, mbarriers), with the epilogue left to the caller.
//
// Both kernels reduce to the same step: a block holds a tile of N queries
// (B, N a multiple of 8) and walks a sequence of 128-row blocks of the
// corpus or of the packed cells (A: rows row0 .. row0 + 127, contiguous,
// d wide), computing the 128 x N product of each before folding it.
//
//   * 288 threads: two consumer warpgroups (rows 0-63 and 64-127 of each
//     block, one m64nNk wgmma chain each) and one producer warp.
//   * The producer fills a ring of stages, one 128-byte-wide slice of the
//     depth per stage (32 f32, 64 bf16 or 128 int8 columns): the A slice
//     (128 rows), the query slice (N rows) and, for f32, the slice of the
//     queries' low parts. Each lands by a 2-D TMA box in the 128-byte swizzle that
//     wgmma's K-major descriptors read; one mbarrier a stage counts the
//     bytes ("full"), one counts the 256 consumer threads that let the stage
//     go ("empty"). TMA needs a 16-byte aligned base and a row stride that
//     is a multiple of 16 bytes; a corpus off either (d = 99, 100 in bf16, a
//     pointer off 16 bytes) takes the ragged path instead: the producer warp
//     copies A element by element (lane = column, so a warp reads a row's
//     128 contiguous bytes at a time), zero-filled past the ragged edges,
//     into the same swizzled layout, fences it for the async proxy and
//     arrives. The queries always take TMA: prep_queries_kernel writes
//     their f32/bf16 operands with rows padded to a multiple of 16 bytes,
//     the int8 caller pads its quantized queries the same way. (cp.async
//     copies at least 4 bytes, so a bf16 row off a 4-byte boundary cannot
//     be copied by it.)
//   * Each stage carries its metadata (row0, two words for the caller, the
//     depth slice index), so the consumers follow whatever walk the producer
//     takes; a stage with row0 = -1 ends the walk.
//   * bf16: wgmma m64nNk16 bf16 x bf16 -> f32. The queries arrive rounded to
//     bf16 (distance.queries_like), so each product is the exact bf16 x bf16
//     product and only the f32 summation order differs from the reference.
//   * int8: wgmma m64nNk32 s8 x s8 -> s32, 128 columns a stage (one
//     128-byte row, as bf16's 64), a ring of 6 stages. A k32 step of s8 is
//     32 bytes, as a k16 step of bf16, so the descriptors and the swizzle
//     are the same; TMA copies the bytes as UINT8 (the map type has no
//     signed 8-bit kind; the bits are the same). The dot is exact in int32
//     (|q|, |x| <= 127: |dot| <= 127^2 d, below 2^31 for d <= 133,144),
//     so the order of the sums does not matter. The caller passes queries
//     already quantized, rows padded with zeros to a multiple of 16 bytes
//     (zero columns add 0 to an exact dot); no prep_queries.
//   * f32: 3xTF32. Each operand x is split into hi = tf32(x) and lo =
//     tf32(x - hi) (round to nearest, cvt.rna); the sum is lo*hi + hi*lo +
//     hi*hi, in f32, on wgmma m64nNk8 tf32. prep_queries_kernel splits the
//     queries once a call; each consumer warpgroup splits its own 64 rows
//     of a stage in place (hi over the f32 slice, lo into a second buffer)
//     before its wgmmas read them. x - hi is exact in f32 and |lo| <= 2^-11 |x|, so the
//     split itself loses only lo's rounding (2^-22 |x|) and the dropped
//     lo*lo term (2^-22 |q||x|): about 2^-21 |q||x| a product, the order of
//     f32 rounding over a 512-long sum (tests/test_torch_scan.py holds a
//     numpy emulation to the scan's and the probe's tolerances at d = 512).
//   * Consumers keep one wgmma group in flight (wait_group 1) and let the
//     older stage go; at the last slice of a block they wait for all, let
//     the stage go, and call the epilogue with the accumulator and the
//     block's metadata while the producer loads ahead.
//
// Accumulator layout (m64nN, f32 or s32): thread t of a warpgroup (warp
// w = t / 32, lane l) holds acc[4 j + e] = element (16 w + l / 4 +
// 8 (e / 2), 8 j + 2 (l % 4) + (e % 2)) of its 64 x N tile.

#pragma once

#include <cuda.h>  // CUtensorMap and the encode function's types
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {
namespace hop {

constexpr int kBlockRows = 128;   // rows of one A block (a chunk, a group)
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kBoxBytes = 128;    // one swizzled row of a stage

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kBK = 32;        // columns a stage
  static constexpr int kStages = 3;
  static constexpr bool kSplit = true;  // 3xTF32
  static constexpr CUtensorMapDataType kTmaType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  using Acc = float;                    // the accumulator's type
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr int kStages = 4;
  static constexpr bool kSplit = false;
  static constexpr CUtensorMapDataType kTmaType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  using Acc = float;
};
template <>
struct Tile<int8_t> {
  static constexpr int kBK = 128;
  static constexpr int kStages = 6;     // 6 x 32 KiB at N = 128
  static constexpr bool kSplit = false;
  static constexpr CUtensorMapDataType kTmaType =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;
  using Acc = int;
};

// Byte offsets in the (1024-aligned) shared memory of a block; the caller's
// own storage starts at kEnd.
template <typename T, int N>
struct Layout {
  static constexpr int kA = kBlockRows * kBoxBytes;  // 16 KiB
  static constexpr int kB = N * kBoxBytes;
  static constexpr bool kSplit = Tile<T>::kSplit;
  static constexpr int kOffA = 0;
  static constexpr int kOffALo = kA;                 // f32 only
  static constexpr int kOffB = kSplit ? 2 * kA : kA;
  static constexpr int kOffBLo = kOffB + kB;         // f32 only
  static constexpr int kStage = kSplit ? 2 * kA + 2 * kB : kA + kB;
  static constexpr int kStages = Tile<T>::kStages;
  static constexpr int kBars = kStage * kStages;     // full[S], empty[S]
  static constexpr int kMeta = kBars + 2 * kStages * 8;  // int4[S]
  static constexpr int kEnd = kMeta + kStages * 16;
  static constexpr uint32_t kTxBytes = kA + (kSplit ? 2 : 1) * kB;
  static_assert(kStage % 1024 == 0, "swizzled tiles need 1024-byte bases");
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory, aligned up to 1024 bytes (the 128-byte
// swizzle repeats every 8 rows of 128 bytes and keys on address bits)
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// 2-D TMA box {c0 (columns), c1 (rows)} into shared memory; completes bytes
// on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(acc[i]) :: "memory");
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused in this mode. One
// k-step (32 bytes of depth) further is start address + 2 (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// round to the nearest tf32 (10 mantissa bits), ties away from zero, as
// the f32 bits with the low 13 cleared
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// The wgmma instructions for each N this repository uses, written out: the
// inline PTX names every accumulator register. scale_d = 0 overwrites the
// accumulator, 1 adds to it; both operands K-major ("1, 1" scale A and B by
// +1; bf16 also takes "0, 0": no transpose; the integer forms take
// neither).

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3 "
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// --------------------------------------------------------- the pipeline

template <typename T>
using Raw = typename std::conditional<
    sizeof(T) == 4, uint32_t,
    typename std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type>::type;

// The ragged path's copy of one 128 x kBK slice of A, element by element,
// zeros past row n and column d, into the swizzled layout.
template <typename T>
__device__ __forceinline__ void store_slice(unsigned char* dst, const T* x,
                                            int n, int d, int row0, int k0,
                                            int lane) {
  constexpr int kBK = Tile<T>::kBK;
  constexpr int kPer = kBK / 32;   // columns a lane
  const Raw<T>* xr = reinterpret_cast<const Raw<T>*>(x);
  for (int r = 0; r < kBlockRows; ++r) {
    const long long row = static_cast<long long>(row0) + r;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = lane * kPer + e;
      const int col = k0 + c;
      const Raw<T> v = (row < n && col < d)
                           ? __ldg(xr + row * static_cast<long long>(d) + col)
                           : Raw<T>(0);
      const int byte = c * static_cast<int>(sizeof(T));
      *reinterpret_cast<Raw<T>*>(
          dst + r * kBoxBytes + ((((byte >> 4) ^ (r & 7))) << 4) +
          (byte & 15)) = v;
    }
  }
}

// Barrier setup, by the whole block before the roles split.
template <typename T, int N>
__device__ __forceinline__ void init_ring(unsigned char* base) {
  using L = Layout<T, N>;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&full[L::kStages + s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer warp. walk.next(&row0, &aux0, &aux1) gives the next 128-row
// block (the same answer in every lane) or false at the end. q0 is the
// block's first query row in the query maps.
template <typename T, int N, class Walk>
__device__ __forceinline__ void produce(unsigned char* base,
                                        const CUtensorMap* map_x,
                                        const CUtensorMap* map_qh,
                                        const CUtensorMap* map_ql,
                                        const T* x, int n, int d, int q0,
                                        bool ragged, Walk& walk) {
  using L = Layout<T, N>;
  constexpr int kBK = Tile<T>::kBK;
  constexpr int S = L::kStages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + S;
  int4* meta = reinterpret_cast<int4*>(base + L::kMeta);
  const int lane = threadIdx.x & 31;
  const int n_kb = (d + kBK - 1) / kBK;
  int it = 0;
  while (true) {
    int row0 = -1, aux0 = 0, aux1 = 0;
    const bool more = walk.next(&row0, &aux0, &aux1);
    for (int kb = 0; kb < (more ? n_kb : 1); ++kb, ++it) {
      const int s = it % S;
      mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
      unsigned char* st = base + s * L::kStage;
      if (!more) {  // the end of the walk
        if (lane == 0) {
          meta[s] = make_int4(-1, 0, 0, 0);
          mbar_arrive(&full[s]);
        }
        return;
      }
      if (lane == 0) {
        meta[s] = make_int4(row0, aux0, aux1, kb);
        if (!ragged) {
          mbar_arrive_expect_tx(&full[s], L::kTxBytes);
          tma_load_2d(st + L::kOffA, map_x, kb * kBK, row0, &full[s]);
        } else {
          mbar_expect_tx(&full[s], L::kTxBytes - L::kA);
        }
        tma_load_2d(st + L::kOffB, map_qh, kb * kBK, q0, &full[s]);
        if constexpr (L::kSplit)
          tma_load_2d(st + L::kOffBLo, map_ql, kb * kBK, q0, &full[s]);
      }
      if (ragged) {
        store_slice<T>(st + L::kOffA, x, n, d, row0, kb * kBK, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
  }
}

// The two consumer warpgroups. For each 128-row block, epi(acc, meta) with
// meta = (row0, aux0, aux1, -) of the block and acc of Tile<T>::Acc (f32,
// or s32 for int8); this warpgroup's rows are 64 * (threadIdx.x / 128) ..
// + 63 of it.
template <typename T, int N, class Epi>
__device__ __forceinline__ void consume(unsigned char* base, int d,
                                        Epi& epi) {
  using L = Layout<T, N>;
  constexpr int kBK = Tile<T>::kBK;
  constexpr int S = L::kStages;
  constexpr int kHalf = L::kA / 2;  // one warpgroup's 64 rows
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBars);
  uint64_t* empty = full + S;
  const int4* meta = reinterpret_cast<const int4*>(base + L::kMeta);
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int n_kb = (d + kBK - 1) / kBK;
  typename Tile<T>::Acc acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  int4 block = make_int4(0, 0, 0, 0);
  int pending = -1;  // a stage whose wgmmas may still run
  for (int it = 0;; ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const int4 m = meta[s];
    if (m.x < 0) break;
    if (m.w == 0) block = m;
    unsigned char* st = base + s * L::kStage;
    if constexpr (L::kSplit) {  // own rows -> hi in place, lo beside
      float4* hi = reinterpret_cast<float4*>(st + L::kOffA + wg * kHalf);
      float4* lo = reinterpret_cast<float4*>(st + L::kOffALo + wg * kHalf);
#pragma unroll
      for (int i = 0; i < kHalf / 16 / 128; ++i) {
        const int j = t + 128 * i;
        const float4 v = hi[j];
        const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                     tf32_rna(v.z), tf32_rna(v.w));
        lo[j] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                            tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
        hi[j] = h;
      }
      fence_proxy_async();
      named_bar(1 + wg, 128);
    }
    const uint64_t da = sw128_desc(st + L::kOffA + wg * kHalf);
    const uint64_t db = sw128_desc(st + L::kOffB);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {  // four 32-byte k-steps a stage
      const int keep = (m.w > 0 || ks > 0) ? 1 : 0;
      if constexpr (L::kSplit) {
        const uint64_t dal = sw128_desc(st + L::kOffALo + wg * kHalf);
        const uint64_t dbl = sw128_desc(st + L::kOffBLo);
        wgmma_tf32<N>(acc, dal + 2 * ks, db + 2 * ks, keep);
        wgmma_tf32<N>(acc, da + 2 * ks, dbl + 2 * ks, 1);
        wgmma_tf32<N>(acc, da + 2 * ks, db + 2 * ks, 1);
      } else if constexpr (std::is_same<T, int8_t>::value) {
        wgmma_s8<N>(acc, da + 2 * ks, db + 2 * ks, keep);
      } else {
        wgmma_bf16<N>(acc, da + 2 * ks, db + 2 * ks, keep);
      }
    }
    wgmma_commit();
    fence_acc(acc);
    if (m.w == n_kb - 1) {
      wgmma_wait<0>();
      fence_acc(acc);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      mbar_arrive(&empty[s]);
      pending = -1;
      epi(acc, block);
    } else {
      wgmma_wait<1>();
      fence_acc(acc);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      pending = s;
    }
  }
}

// The query operands, from the f32 queries (nq, d): rows padded with zeros
// to d_pad (a multiple of 16 bytes, so TMA reads them); f32: qh = tf32(q),
// ql = tf32(q - qh); bf16: qh = q rounded to bf16 (nearest even, as a
// torch cast), ql unused.
template <typename T>
__global__ void prep_queries_kernel(const float* __restrict__ q,
                                    T* __restrict__ qh, T* __restrict__ ql,
                                    int nq, int d, int d_pad) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(nq) * d_pad) return;
  const long long r = i / d_pad;
  const int c = static_cast<int>(i % d_pad);
  const float v = c < d ? q[r * d + c] : 0.f;
  if constexpr (Tile<T>::kSplit) {
    const float h = tf32_rna(v);
    qh[i] = h;
    ql[i] = tf32_rna(v - h);
  } else {
    qh[i] = __float2bfloat16_rn(v);
  }
}

// ------------------------------------------------------------ host side

template <typename T>
cudaError_t prep_queries(const float* q, void* qh, void* ql, int nq, int d,
                         int d_pad, cudaStream_t stream) {
  const long long count = static_cast<long long>(nq) * d_pad;
  if (count == 0) return cudaSuccess;
  prep_queries_kernel<T><<<static_cast<int>((count + 255) / 256), 256, 0,
                           stream>>>(q, static_cast<T*>(qh),
                                     static_cast<T*>(ql), nq, d, d_pad);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up by the CUDA runtime (no link against
// libcuda); nullptr where the installed CUDA lacks it
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A (rows, cols) row-major matrix, rows `stride` elements apart, read as
// boxes of box_rows x kBK in the 128-byte swizzle; out-of-range elements
// read as zero.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, long long rows,
                     long long cols, long long stride, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Tile<T>::kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, Tile<T>::kTmaType, 2, const_cast<void*>(ptr),
                         dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hop
}  // namespace
