// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masks of the TPU kernels' _mask_scores, bf16 mma.sync fragments, and a
// shared-memory tile loader. Everything is in an anonymous namespace, so each
// .cu that includes it gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as NEG_INF in the TPU kernels

// Batch, head and sequence strides (in elements) of one [B, H, L, D] operand.
struct Strides {
  long long b, h, l;
};

// The three masks of _mask_scores for one (query row, key col) pair: key
// validity (keys at positions >= kv_end, which is valid_len or L), causal,
// and same segment. seg_b is the batch row's [L] segments or null; seg_row is
// the query row's segment (-1 past L).
__device__ __forceinline__ bool keep_pair(int kv_end, int causal,
                                          const int* seg_b, int row, int col,
                                          int seg_row) {
  if (col >= kv_end) return false;
  if (causal && col > row) return false;
  if (seg_b != nullptr && seg_b[col] != seg_row) return false;
  return true;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 at unrelated addresses as one fragment register (lo in bits 0-15).
__device__ __forceinline__ uint32_t pack_u16(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] * b[16x8], bf16 inputs, fp32 accumulation.
// Fragments (lane = 4*g + t): a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
// (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g), (k 2t+8..2t+9, n g)};
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [16w, 16w+16) and columns [16kk, 16kk+16) of a bf16
// tile in shared memory with row stride ld.
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile, int ld,
                                            int w, int kk, int g, int t) {
  const __nv_bfloat16* p = tile + w * 16 * ld + kk * 16 + 2 * t;
  a[0] = ld_u32(p + g * ld);
  a[1] = ld_u32(p + (g + 8) * ld);
  a[2] = ld_u32(p + g * ld + 8);
  a[3] = ld_u32(p + (g + 8) * ld + 8);
}

// The A fragment of key columns [16kk, 16kk+16) built from fp32 accumulators
// c[n] of 8-column groups n (the S or P accumulator re-packed in registers).
__device__ __forceinline__ void acc_to_a_frag(uint32_t a[4],
                                              float (*c)[4], int kk) {
  a[0] = pack_f32(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_f32(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_f32(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_f32(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [row0, row0+ROWS) of a [L, D] bf16 head into shared memory with row
// stride D+8 (so fragment reads hit 32 distinct banks); rows past `rows` are
// zero. 16-byte loads, THREADS threads.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int row0,
                                               int rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c * 8) = val;
  }
}

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

}  // namespace
