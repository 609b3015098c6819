// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the masks of the TPU kernels' _mask_scores and the operand strides.
// Everything is in an anonymous namespace, so each .cu that includes it gets
// its own copy.
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

}  // namespace
