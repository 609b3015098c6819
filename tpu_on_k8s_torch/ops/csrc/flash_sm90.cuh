// Hopper pieces of the port's wgmma kernels: TMA tensor maps and loads into
// an mbarrier ring, warpgroup register hand-over, and wgmma on operands in
// 128-byte-swizzled shared memory. The flash-attention kernels (flash_fwd.cu's
// forward, flash_bwd.cu's dq and dk/dv) use the bf16 products; the int8 GEMM
// (int8_matmul.cu) the s8 one. Everything is in an anonymous namespace, so
// each .cu that includes it gets its own copy.
//
// Shared-memory tiles. A [rows, D] bf16 tile is stored as D/64 column blocks,
// each [rows, 64] with rows of 128 bytes, exactly as a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B and a box of {64, rows} writes it: the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8). Every block starts on a 1024-byte
// boundary (one 8-row swizzle atom), which the wgmma descriptors assume. An
// int8 tile of 128 bytes of K per row is one such block.
//
// wgmma descriptors (PTX ISA, "Matrix Descriptor Format"): start address,
// leading and stride byte offsets in 16-byte units, and layout 1 = 128-byte
// swizzle.
//   * K-major operand (Q, dO as A; K, V as the B of Q K^T, dO V^T; K, V as
//     the A of K Q^T, V dO^T; both int8 operands): 8-row groups 1024 bytes
//     apart (SBO); the leading offset is unused (1). The k-step kk (16 bf16
//     or 32 int8 elements, 32 bytes either way) inside a column block is the
//     start address plus 32*kk bytes; the hardware applies the swizzle to the
//     full address.
//   * MN-major operand (V in P V, K in dS K, dO in P^T dO, Q in dS^T Q, where
//     the sequence dim is the reduction): 8 rows of 128 bytes form an atom,
//     atoms 1024 bytes apart along the rows (SBO), 64-wide column blocks
//     rows*128 bytes apart (LBO); the k-step kk is the start address plus
//     16*128*kk bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached below
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSm90Rows = 128;       // query rows per block: 2 warpgroups x 64
constexpr int kSm90Threads = 384;    // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 24;    // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;   //   <= 65,536 registers of the SM
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (the k-th completion
// of a barrier has parity k & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// The box at (c0, c1, c2, c3) = (column, row, head, batch) of a 4-D map into
// shared memory; completion is reported to `bar` as bytes. Rows outside the
// map's extent arrive as zeros and still count their bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box at (c0, c1) = (column, row) of a 2-D map.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The box at (c0, c1, c2, c3) from shared memory into the map's tensor; rows
// outside the extent are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commit the stores issued so far and wait until their shared-memory source
// has been read (the block may then exit or reuse it).
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (TMA stores, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `threads` threads (a warpgroup) on hardware barrier `id`
// (0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- warpgroup registers and wgmma -----------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across a
// wgmma that is still in flight.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for an RS wgmma's A fragment, which the hardware reads until the
// wgmma completes: keeps its registers from being reused before the wait.
template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: k-step kk (16 elements) of a tile of `rows` rows at `tile`.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows,
                                                 int kk) {
  return gmma_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k-step kk (16 key rows) of a [rows, D] tile at `tile`.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows,
                                                  int kk) {
  return gmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, fp32 accumulators; scale_d 0
// overwrites d. Accumulator layout (warp w of the warpgroup, lane 4g + t):
// d[4j + e] is row 16w + g + 8*(e >> 1), column 8j + 2t + (e & 1). The
// register A fragment is mma.sync's m16n8k16 A fragment of the warp's 16 rows.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // SS: A and B from shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // RS: A from registers (four bf16x2 per thread), B from shared memory,
  // MN-major (imm-trans-b = 1).
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // SS: A and B from shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
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
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // RS: A from registers (four bf16x2 per thread), B from shared memory,
  // MN-major (imm-trans-b = 1).
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  // RS only (the D 256 kernels' O += P V and dQ += dS K): A from registers
  // (four bf16x2 per thread), B from shared memory, MN-major (imm-trans-b =
  // 1), 256 columns in four 64-wide column blocks rows*128 bytes apart.
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

// d[64 x 256] (+)= A[64 x 32] B[32 x 256], int8 in, exact int32 accumulators;
// scale_d 0 overwrites d. Both operands from shared memory, K-major (int8
// wgmma takes no MN-major operand). The accumulator layout is the bf16
// products': d[4j + e] is row 16w + g + 8*(e >> 1), column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_s8_m64n256(int (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The A fragment of k-step kk (columns 16kk..16kk+15) of a warpgroup's fp32
// accumulator, cast to bf16: the accumulator of one product is the A operand
// of the next without leaving registers.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * i],
                                             d[8 * kk + 2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// Byte offset of element (row, col) in a [rows, 64] block with the 128-byte
// swizzle (the block 1024-byte aligned).
__device__ __forceinline__ uint32_t swizzle128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// A consumer warpgroup's [64, D] fp32 result, each row divided by its divisor
// (div0 for the thread's first row, div1 for its second), as bf16 rows
// [row0, row0 + 64) of head (b, h) of the map's tensor: written into the
// warpgroup's 64 rows of a 128-row swizzled tile at `tile` (row 0 of the
// warpgroup, column block 0; the tile must no longer be read by any wgmma),
// then stored by one TMA per column block, which drops rows past L. The 32
// lanes of a warp write 32 distinct banks.
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map,
                                           unsigned char* tile,
                                           const float (&acc)[D / 2],
                                           float div0, float div1, int tid,
                                           int barrier_id, int row0, int h,
                                           int b) {
  const int r0 = 16 * (tid / 32) + (tid % 32) / 4;
  const int t = tid % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* block = tile + (j / 8) * kSm90Rows * 128;
    const int col = (j % 8) * 8 + 2 * t;
    __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j] / div0,
                                              acc[4 * j + 1] / div0);
    __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2] / div1,
                                              acc[4 * j + 3] / div1);
    *reinterpret_cast<__nv_bfloat162*>(block + swizzle128(r0, col)) = lo;
    *reinterpret_cast<__nv_bfloat162*>(block + swizzle128(r0 + 8, col)) = hi;
  }
  fence_proxy_async();
  named_barrier(barrier_id, 128);
  if (tid == 0) {
    for (int c = 0; c < D / 64; ++c) {
      tma_store_4d(map, tile + c * kSm90Rows * 128, c * 64, row0, h, b);
    }
    tma_store_wait();
  }
}

// The barriers of a block: one for the query-side tiles, loaded once, and a
// full-K, full-V and empty barrier per stage of the K/V ring (the empty one
// completes when all 256 consumer threads have released the stage). One
// thread calls this, before the block's __syncthreads.
__device__ __forceinline__ void init_barriers(uint64_t* bar_q,
                                              uint64_t* full_k,
                                              uint64_t* full_v,
                                              uint64_t* empty, int stages) {
  mbar_init(bar_q, 1);
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full_k[s], 1);
    mbar_init(&full_v[s], 1);
    mbar_init(&empty[s], 2 * 128);
  }
  mbar_fence_init();
}

// Rows [row0, row0 + kRows) of head (b, h) into a swizzled tile, one box
// per column block, reported to `bar` (which expects the bytes already).
template <int D, int kRows>
__device__ __forceinline__ void load_rows(unsigned char* tile,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
  for (int c = 0; c < D / 64; ++c) {
    tma_load_4d(tile + c * kRows * 128, map, bar, c * 64, row0, h, b);
  }
}

// The producer's loop: the K and V tiles 0..n_tiles-1 of kv-head (b, hk),
// kN keys each, tile j into stage j % kStages of the two rings once the
// consumers have released the tile kStages before it.
template <int D, int kN, int kStages>
__device__ __forceinline__ void produce_kv(unsigned char* k_ring,
                                           unsigned char* v_ring,
                                           const CUtensorMap* k,
                                           const CUtensorMap* v,
                                           uint64_t* full_k, uint64_t* full_v,
                                           uint64_t* empty, int n_tiles,
                                           int hk, int b) {
  constexpr int kBytes = kN * D * 2;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&empty[s], (j / kStages + 1) & 1);
    mbar_expect_tx(&full_k[s], kBytes);
    load_rows<D, kN>(k_ring + s * kBytes, k, &full_k[s], j * kN, hk, b);
    mbar_expect_tx(&full_v[s], kBytes);
    load_rows<D, kN>(v_ring + s * kBytes, v, &full_v[s], j * kN, hk, b);
  }
}

// The block's dynamic shared memory, aligned up to 1024 bytes (one 8-row
// swizzle atom); the launch asks for 1024 bytes more than it uses.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The mask of _mask_scores on key column `col` for one query row: key before
// kv_end, causal, same segment (seg_key null without segments).
__device__ __forceinline__ bool keep_key(int col, int row, int kv_end,
                                         int causal, const int* seg_key,
                                         int seg_row) {
  return col < kv_end && !(causal && col > row) &&
         (seg_key == nullptr || *seg_key == seg_row);
}

// Loads the segment ids of keys [k0, k0 + n) into `dst` (-2 past L, where
// kv_end masks anyway), 128 threads of a warpgroup, then a warpgroup barrier.
__device__ __forceinline__ void load_key_segments(int* dst, const int* seg_b,
                                                  int k0, int n, int L,
                                                  int tid, int barrier_id) {
  for (int i = tid; i < n; i += 128) {
    dst[i] = k0 + i < L ? seg_b[k0 + i] : -2;
  }
  named_barrier(barrier_id, 128);
}

// ---- host: launch and tensor maps -----------------------------------------

// Launch with `smem` bytes of dynamic shared memory (allowed above 48 KB
// first); returns the launch's error, since a refused launch never runs.
template <typename Kernel, typename Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, int smem,
                          const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query, so the libraries need not link libcuda; null if the driver lacks it.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [B, H, L, D] operand with element strides (sb, sh, sl) and a
// contiguous head dim, as a 4-D map (D, L, H, B) read and written in boxes
// of [box_rows, 64] with the 128-byte swizzle. The map is made on the host
// for each launch and travels in the kernel's parameters. False if the driver
// refuses it (a stride not a multiple of 16 bytes, say).
bool make_tile_map(CUtensorMap* map, const void* base, int D, int L, int H,
                   int B, long long sl, long long sh, long long sb,
                   int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const long long elems[3] = {sl, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    // a dim of extent 1 is never stepped over: give it the packed stride,
    // whatever stride the caller's tensor reports for it
    strides[i] = dims[i + 1] == 1
                     ? (i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i])
                     : static_cast<cuuint64_t>(elems[i]) * 2;
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A contiguous int8 [rows, K] operand as a 2-D map (K, rows) read in boxes of
// [box_rows, 128 bytes] with the 128-byte swizzle; K must be a multiple of
// 16 and the base 16-byte aligned. Rows and bytes past the extent arrive as
// zeros.
bool make_byte_map(CUtensorMap* map, const void* base, int rows, int K,
                   int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
