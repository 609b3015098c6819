// Flash-attention backward for NVIDIA Hopper (sm_90a): dq and dk/dv.
//
// Replaces the Pallas TPU kernels of tpu_on_k8s/ops/flash_attention.py
// (both launched by _bwd):
//   * _dq_kernel: per query row, over the keys it attends to,
//       p = exp(s - lse), dp = dO.V^T, ds = p * (dp - delta) * scale cast to
//       the input type, dq += ds.K (fp32 accumulation);
//   * _dkv_kernel: per key, over the queries that attend to it,
//       dv += p(cast)^T.dO, dk += ds^T.Q (fp32 accumulation), and the rep
//       q-heads of a kv head summed in the output type, in order r = 0..rep-1.
// s = scale * q.k is masked (causal, key < valid length, same segment) to the
// finite -1e30; p comes from the forward's saved lse, never from a fresh max;
// delta = rowsum(dO * O) (less the lse cotangent) is computed by the caller, as
// XLA computes it outside the TPU kernels. Layouts: q, dO, dq [B,H,L,D]; k, v,
// dk, dv [B,Hkv,L,D] with q-head h reading kv-head h / (H/Hkv); lse, delta
// [B,H,1,L] fp32. Any batch/head/sequence strides with a contiguous head dim.
// Ragged L is masked in the kernel: rows past L load as zeros, are masked as
// queries and as keys, and are never stored, so padded query rows contribute
// exactly zero to dk/dv. No atomics: every output element is written by one
// thread, so the result is the same from run to run.
//
// What bounds them on an H100 SXM: dq does three products over the kept
// (query, key) pairs (QK^T, dO V^T, dS K: 6*B*H*D*pairs FLOPs) and dk/dv four
// (QK^T, dO V^T, P^T dO, dS^T Q: 8*B*H*D*pairs), against 989 TFLOP/s of bf16
// tensor cores; the bytes (q, k, v, dO, lse, delta read once, the gradients
// written once) against 3.35 TB/s. At the training shape (L=2048, D=128) both
// are bound by operations by a wide margin.
//
// What the design does about it (a first, simple version; no TMA, wgmma or
// pipelining yet):
//   * dq: one block of 4 warps per (b, h, 64-row query tile); each warp owns
//     16 query rows. Q and dO stay in shared memory; a loop over 64-key K/V
//     tiles computes S and dP on the tensor cores (mma.sync.m16n8k16 bf16 ->
//     fp32), turns them into dS in registers, and re-packs dS as the A fragment
//     of dQ += dS K, so neither S, P nor dS touches shared or device memory.
//     Under causal masking the loop stops at the diagonal tile.
//   * dk/dv: one block of 4 warps per (b, kv head, 64-key tile); each warp owns
//     16 keys and computes S^T = K Q^T and dP^T = V dO^T directly in the
//     transposed orientation, so P^T and dS^T are A fragments of dV += P^T dO
//     and dK += dS^T Q without a transpose. The dk and dv accumulators of 16
//     keys x D take D/2 + D/2 fp32 registers a thread (128 at D = 128), so the
//     query tiles are 32 rows wide to leave room for S^T and dP^T (16 + 16).
//     The loop runs over the group's q-heads and, for each, over the query
//     tiles that attend into the key tile (from the diagonal on, under causal
//     masking). After each q-head its fp32 sums are cast to the output type
//     and added, in that type, to what the earlier q-heads stored (each thread
//     reads back only what it wrote).
// The float32 path runs the same tiling and masking with scalar FMAs in shared
// memory. It exists so that a check on the card can also compare at full
// precision; it is not tuned.

#include "flash_common.cuh"

namespace {

constexpr int kBf16Threads = 128;  // 4 warps x 16 rows
constexpr int kF32Threads = 256;
constexpr int kDqRows = 64;        // dq: query rows per block
constexpr int kDqKeys = 64;        // dq: keys per K/V tile
constexpr int kDkvKeys = 64;       // dk/dv: keys per block
constexpr int kDkvRows = 32;       // dk/dv (bf16): query rows per Q/dO tile
constexpr int kF32Tile = 64;       // float32 path: every tile is 64 rows

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, 1, L]
  const float* delta;  // [B, H, 1, L]
  const int* seg;      // [B, L] int32 or null
  void* dq;
  void* dk;
  void* dv;
  int H, L, rep, kv_end, causal;
  float scale;
  Strides q_s, k_s, v_s, do_s, dq_s, dk_s, dv_s;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const Strides& s,
                                             int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* head_ptr(void* base, const Strides& s, int b,
                                       int h) {
  return static_cast<T*>(base) + b * s.b + h * s.h;
}

// A query row's mask test; rows past L are masked too, so they add nothing.
__device__ __forceinline__ bool keep(const BwdArgs& a, const int* seg_b,
                                     int row, int col, int seg_row) {
  return row < a.L && keep_pair(a.kv_end, a.causal, seg_b, row, col, seg_row);
}

// K tiles of `tile` keys that a query tile [q0, q0+rows) attends into.
__device__ __forceinline__ int num_k_tiles(const BwdArgs& a, int q0, int rows,
                                           int tile) {
  int n = (a.kv_end + tile - 1) / tile;
  if (a.causal) {
    const int last_row = min(q0 + rows, a.L) - 1;
    n = min(n, last_row / tile + 1);
  }
  return n;
}

// The first query tile of `rows` rows that attends into keys from k0 on.
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0,
                                            int rows) {
  return a.causal ? k0 / rows : 0;
}

__device__ __forceinline__ float row_stat(const float* stat, int b, int h,
                                          const BwdArgs& a, int row) {
  return row < a.L ? stat[(static_cast<long long>(b) * a.H + h) * a.L + row]
                   : 0.f;
}

// out += round(x) in the output type, rounding the sum once more, as
// `ref[...] += x.astype(ref.dtype)` does; the first q-head stores round(x).
__device__ __forceinline__ void store_or_add(__nv_bfloat16* p, float x0,
                                             float x1, bool first) {
  __nv_bfloat162 x = __floats2bfloat162_rn(x0, x1);
  if (!first) {
    const float2 old = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(p));
    const float2 add = __bfloat1622float2(x);
    x = __floats2bfloat162_rn(old.x + add.x, old.y + add.y);
  }
  *reinterpret_cast<__nv_bfloat162*>(p) = x;
}

__device__ __forceinline__ void store_or_add(float* p, float x, bool first) {
  *p = first ? x : *p + x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBf16Threads) dq_bf16_kernel(BwdArgs a) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDo = sQ + kDqRows * kLd;
  __nv_bfloat16* sK = sDo + kDqRows * kLd;
  __nv_bfloat16* sV = sK + kDqKeys * kLd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;

  const __nv_bfloat16* q = head_ptr<__nv_bfloat16>(a.q, a.q_s, b, h);
  const __nv_bfloat16* dout = head_ptr<__nv_bfloat16>(a.dout, a.do_s, b, h);
  const __nv_bfloat16* k = head_ptr<__nv_bfloat16>(a.k, a.k_s, b, hk);
  const __nv_bfloat16* v = head_ptr<__nv_bfloat16>(a.v, a.v_s, b, hk);
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;

  load_tile_bf16<D, kDqRows, kBf16Threads>(sQ, q, a.q_s.l, q0, a.L, tid);
  load_tile_bf16<D, kDqRows, kBf16Threads>(sDo, dout, a.do_s.l, q0, a.L, tid);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int seg_row[2];
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    seg_row[r] = (seg_b != nullptr && rows[r] < a.L) ? seg_b[rows[r]] : -1;
    lse[r] = row_stat(a.lse, b, h, a, rows[r]);
    delta[r] = row_stat(a.delta, b, h, a, rows[r]);
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dn][e] = 0.f;
  }

  const int n_tiles = num_k_tiles(a, q0, kDqRows, kDqKeys);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kDqKeys;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kDqKeys, kBf16Threads>(sK, k, a.k_s.l, k0, a.L, tid);
    load_tile_bf16<D, kDqKeys, kBf16Threads>(sV, v, a.v_s.l, k0, a.L, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kDqKeys / 8][4];
    float dp[kDqKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kDqKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = 0.f;
        dp[n][e] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, sQ, kLd, warp, kk, g, t);
      load_a_frag(da, sDo, kLd, warp, kk, g, t);
#pragma unroll
      for (int n = 0; n < kDqKeys / 8; ++n) {
        const __nv_bfloat16* kr = sK + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        const __nv_bfloat16* vr = sV + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_bf16(s[n], qa, ld_u32(kr), ld_u32(kr + 8));
        mma_bf16(dp[n], da, ld_u32(vr), ld_u32(vr + 8));
      }
    }

    // dS = P * (dP - delta) * scale, with P = exp(S_masked - lse); kept in s
#pragma unroll
    for (int n = 0; n < kDqKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float x = keep(a, seg_b, rows[r], col, seg_row[r])
                            ? a.scale * s[n][e]
                            : kNegInf;
        const float p = expf(x - lse[r]);
        s[n][e] = p * (dp[n][e] - delta[r]) * a.scale;
      }
    }

    // dQ += dS K: dS (cast to bf16) is the A fragment; K's B fragment pairs
    // two keys of one head-dim column.
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a_frag(sa, s, kk);
      const __nv_bfloat16* kr = sK + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* kc = kr + dn * 8;
        mma_bf16(dq[dn], sa, pack_u16(kc, kc + kLd),
                 pack_u16(kc + 8 * kLd, kc + 9 * kLd));
      }
    }
  }

  __nv_bfloat16* out = head_ptr<__nv_bfloat16>(a.dq, a.dq_s, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= a.L) continue;
    __nv_bfloat16* orow = out + rows[r] * a.dq_s.l + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_f32(dq[dn][2 * r], dq[dn][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads) dkv_bf16_kernel(BwdArgs a) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kDkvKeys * kLd;
  __nv_bfloat16* sQ = sV + kDkvKeys * kLd;
  __nv_bfloat16* sDo = sQ + kDkvRows * kLd;
  float* sLse = reinterpret_cast<float*>(sDo + kDkvRows * kLd);
  float* sDelta = sLse + kDkvRows;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kDkvKeys;  // under causal masking, heaviest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;

  load_tile_bf16<D, kDkvKeys, kBf16Threads>(
      sK, head_ptr<__nv_bfloat16>(a.k, a.k_s, b, hk), a.k_s.l, k0, a.L, tid);
  load_tile_bf16<D, kDkvKeys, kBf16Threads>(
      sV, head_ptr<__nv_bfloat16>(a.v, a.v_s, b, hk), a.v_s.l, k0, a.L, tid);

  // this thread's accumulator rows are keys[0] and keys[1]
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  // no key of the tile is valid: dk = dv = 0, and the loop below is empty
  const int i_begin = first_q_tile(a, k0, kDkvRows);
  const int i_end = k0 < a.kv_end ? (a.L + kDkvRows - 1) / kDkvRows : 0;
  __nv_bfloat16* dk_out = head_ptr<__nv_bfloat16>(a.dk, a.dk_s, b, hk);
  __nv_bfloat16* dv_out = head_ptr<__nv_bfloat16>(a.dv, a.dv_s, b, hk);

  for (int r = 0; r < a.rep; ++r) {
    const int h = hk * a.rep + r;
    const __nv_bfloat16* q = head_ptr<__nv_bfloat16>(a.q, a.q_s, b, h);
    const __nv_bfloat16* dout = head_ptr<__nv_bfloat16>(a.dout, a.do_s, b, h);
    float dk[D / 8][4];
    float dv[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[dn][e] = 0.f;
        dv[dn][e] = 0.f;
      }
    }

    for (int i = i_begin; i < i_end; ++i) {
      const int q0 = i * kDkvRows;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile_bf16<D, kDkvRows, kBf16Threads>(sQ, q, a.q_s.l, q0, a.L, tid);
      load_tile_bf16<D, kDkvRows, kBf16Threads>(sDo, dout, a.do_s.l, q0, a.L,
                                                tid);
      if (tid < kDkvRows) {
        sLse[tid] = row_stat(a.lse, b, h, a, q0 + tid);
        sDelta[tid] = row_stat(a.delta, b, h, a, q0 + tid);
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
      float st[kDkvRows / 8][4];
      float dpt[kDkvRows / 8][4];
#pragma unroll
      for (int n = 0; n < kDkvRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] = 0.f;
          dpt[n][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag(ka, sK, kLd, warp, kk, g, t);
        load_a_frag(va, sV, kLd, warp, kk, g, t);
#pragma unroll
        for (int n = 0; n < kDkvRows / 8; ++n) {
          const __nv_bfloat16* qr = sQ + (n * 8 + g) * kLd + kk * 16 + 2 * t;
          const __nv_bfloat16* dr = sDo + (n * 8 + g) * kLd + kk * 16 + 2 * t;
          mma_bf16(st[n], ka, ld_u32(qr), ld_u32(qr + 8));
          mma_bf16(dpt[n], va, ld_u32(dr), ld_u32(dr + 8));
        }
      }

      // P^T (kept in st) and dS^T = P^T * (dP^T - delta) * scale (in dpt)
#pragma unroll
      for (int n = 0; n < kDkvRows / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1];
          const int c = n * 8 + 2 * t + (e & 1);
          const int row = q0 + c;
          const int seg_row =
              (seg_b != nullptr && row < a.L) ? seg_b[row] : -1;
          const float x = keep(a, seg_b, row, key, seg_row)
                              ? a.scale * st[n][e]
                              : kNegInf;
          const float p = expf(x - sLse[c]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDelta[c]) * a.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T (cast to bf16) are A
      // fragments; dO's and Q's B fragments pair two queries of one column.
#pragma unroll
      for (int kk = 0; kk < kDkvRows / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a_frag(pa, st, kk);
        acc_to_a_frag(sa, dpt, kk);
        const __nv_bfloat16* dr = sDo + (kk * 16 + 2 * t) * kLd + g;
        const __nv_bfloat16* qr = sQ + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const __nv_bfloat16* dc = dr + dn * 8;
          const __nv_bfloat16* qc = qr + dn * 8;
          mma_bf16(dv[dn], pa, pack_u16(dc, dc + kLd),
                   pack_u16(dc + 8 * kLd, dc + 9 * kLd));
          mma_bf16(dk[dn], sa, pack_u16(qc, qc + kLd),
                   pack_u16(qc + 8 * kLd, qc + 9 * kLd));
        }
      }
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (keys[rr] >= a.L) continue;
      __nv_bfloat16* dkrow = dk_out + keys[rr] * a.dk_s.l + 2 * t;
      __nv_bfloat16* dvrow = dv_out + keys[rr] * a.dv_s.l + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        store_or_add(dkrow + dn * 8, dk[dn][2 * rr], dk[dn][2 * rr + 1],
                     r == 0);
        store_or_add(dvrow + dn * 8, dv[dn][2 * rr], dv[dn][2 * rr + 1],
                     r == 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs in shared memory (full-precision reference path)
// ---------------------------------------------------------------------------

// Rows [row0, row0+64) of a [L, D] fp32 head into shared memory with row
// stride ld; rows past L are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld,
                                              const float* src,
                                              long long stride, int row0,
                                              int rows, int tid) {
  for (int i = tid; i < kF32Tile * D; i += kF32Threads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * ld + c] = (row0 + r < rows) ? src[(row0 + r) * stride + c] : 0.f;
  }
}

// dS (dq kernel) or P and dS (dk/dv kernel) of a 64 x 64 tile pair into
// shared memory, indexed [query][key] with row stride 65. sQ/sDo are [64][D]
// query rows from q0, sK/sV [64][D+1] key rows from k0.
template <int D>
__device__ __forceinline__ void scores_f32(const BwdArgs& a, const int* seg_b,
                                           const float* sQ, const float* sDo,
                                           const float* sK, const float* sV,
                                           const float* sLse,
                                           const float* sDelta, int q0, int k0,
                                           float* sP, float* sDs, int tid) {
  constexpr int kLdK = D + 1;
  constexpr int kLdS = kF32Tile + 1;
  const int c = tid % kF32Tile;
  const int col = k0 + c;
  for (int r = tid / kF32Tile; r < kF32Tile; r += kF32Threads / kF32Tile) {
    float dot = 0.f;
    float dpd = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      dot = fmaf(sQ[r * D + d], sK[c * kLdK + d], dot);
      dpd = fmaf(sDo[r * D + d], sV[c * kLdK + d], dpd);
    }
    const int row = q0 + r;
    const int seg_row = (seg_b != nullptr && row < a.L) ? seg_b[row] : -1;
    const float x =
        keep(a, seg_b, row, col, seg_row) ? a.scale * dot : kNegInf;
    const float p = expf(x - sLse[r]);
    if (sP != nullptr) sP[r * kLdS + c] = p;
    sDs[r * kLdS + c] = p * (dpd - sDelta[r]) * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) dq_f32_kernel(BwdArgs a) {
  constexpr int kLdK = D + 1;  // thread c reads key row c: no bank conflicts
  constexpr int kLdS = kF32Tile + 1;
  constexpr int kRowGroups = kF32Threads / D;
  constexpr int kRowsPerThread = kF32Tile / kRowGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [64][D]
  float* sDo = sQ + kF32Tile * D;                  // [64][D]
  float* sK = sDo + kF32Tile * D;                  // [64][D+1]
  float* sV = sK + kF32Tile * kLdK;                // [64][D+1]
  float* sDs = sV + kF32Tile * kLdK;               // [64][65]
  float* sLse = sDs + kF32Tile * kLdS;
  float* sDelta = sLse + kF32Tile;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Tile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;
  const float* k = head_ptr<float>(a.k, a.k_s, b, hk);
  const float* v = head_ptr<float>(a.v, a.v_s, b, hk);
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;

  load_tile_f32<D>(sQ, D, head_ptr<float>(a.q, a.q_s, b, h), a.q_s.l, q0, a.L,
                   tid);
  load_tile_f32<D>(sDo, D, head_ptr<float>(a.dout, a.do_s, b, h), a.do_s.l, q0,
                   a.L, tid);
  if (tid < kF32Tile) {
    sLse[tid] = row_stat(a.lse, b, h, a, q0 + tid);
    sDelta[tid] = row_stat(a.delta, b, h, a, q0 + tid);
  }
  const int dcol = tid % D;
  const int rg = tid / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  const int n_tiles = num_k_tiles(a, q0, kF32Tile, kF32Tile);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kF32Tile;
    __syncthreads();
    load_tile_f32<D>(sK, kLdK, k, a.k_s.l, k0, a.L, tid);
    load_tile_f32<D>(sV, kLdK, v, a.v_s.l, k0, a.L, tid);
    __syncthreads();
    scores_f32<D>(a, seg_b, sQ, sDo, sK, sV, sLse, sDelta, q0, k0, nullptr,
                  sDs, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + kRowGroups * i;
      float x = acc[i];
      for (int c = 0; c < kF32Tile; ++c) {
        x = fmaf(sDs[r * kLdS + c], sK[c * kLdK + dcol], x);
      }
      acc[i] = x;
    }
  }

  float* out = head_ptr<float>(a.dq, a.dq_s, b, h);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + kRowGroups * i;
    if (q0 + r < a.L) out[(q0 + r) * a.dq_s.l + dcol] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) dkv_f32_kernel(BwdArgs a) {
  constexpr int kLdK = D + 1;
  constexpr int kLdS = kF32Tile + 1;
  constexpr int kKeyGroups = kF32Threads / D;
  constexpr int kKeysPerThread = kF32Tile / kKeyGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // [64][D+1]
  float* sV = sK + kF32Tile * kLdK;                // [64][D+1]
  float* sQ = sV + kF32Tile * kLdK;                // [64][D]
  float* sDo = sQ + kF32Tile * D;                  // [64][D]
  float* sP = sDo + kF32Tile * D;                  // [64][65]
  float* sDs = sP + kF32Tile * kLdS;               // [64][65]
  float* sLse = sDs + kF32Tile * kLdS;
  float* sDelta = sLse + kF32Tile;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kF32Tile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;
  load_tile_f32<D>(sK, kLdK, head_ptr<float>(a.k, a.k_s, b, hk), a.k_s.l, k0,
                   a.L, tid);
  load_tile_f32<D>(sV, kLdK, head_ptr<float>(a.v, a.v_s, b, hk), a.v_s.l, k0,
                   a.L, tid);
  const int dcol = tid % D;
  const int kg = tid / D;
  const int i_begin = first_q_tile(a, k0, kF32Tile);
  const int i_end = k0 < a.kv_end ? (a.L + kF32Tile - 1) / kF32Tile : 0;
  float* dk_out = head_ptr<float>(a.dk, a.dk_s, b, hk);
  float* dv_out = head_ptr<float>(a.dv, a.dv_s, b, hk);

  for (int r = 0; r < a.rep; ++r) {
    const int h = hk * a.rep + r;
    float dk[kKeysPerThread];
    float dv[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    for (int i = i_begin; i < i_end; ++i) {
      const int q0 = i * kF32Tile;
      __syncthreads();
      load_tile_f32<D>(sQ, D, head_ptr<float>(a.q, a.q_s, b, h), a.q_s.l, q0,
                       a.L, tid);
      load_tile_f32<D>(sDo, D, head_ptr<float>(a.dout, a.do_s, b, h),
                       a.do_s.l, q0, a.L, tid);
      if (tid < kF32Tile) {
        sLse[tid] = row_stat(a.lse, b, h, a, q0 + tid);
        sDelta[tid] = row_stat(a.delta, b, h, a, q0 + tid);
      }
      __syncthreads();
      scores_f32<D>(a, seg_b, sQ, sDo, sK, sV, sLse, sDelta, q0, k0, sP, sDs,
                    tid);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int c = kg + kKeyGroups * j;
        float xv = dv[j];
        float xk = dk[j];
        for (int rq = 0; rq < kF32Tile; ++rq) {
          xv = fmaf(sP[rq * kLdS + c], sDo[rq * D + dcol], xv);
          xk = fmaf(sDs[rq * kLdS + c], sQ[rq * D + dcol], xk);
        }
        dv[j] = xv;
        dk[j] = xk;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int key = k0 + kg + kKeyGroups * j;
      if (key >= a.L) continue;
      store_or_add(dk_out + key * a.dk_s.l + dcol, dk[j], r == 0);
      store_or_add(dv_out + key * a.dv_s.l + dcol, dv[j], r == 0);
    }
  }
}

template <int D>
int dq_bf16_smem() { return (2 * kDqRows + 2 * kDqKeys) * (D + 8) * 2; }

template <int D>
int dkv_bf16_smem() {
  return (2 * kDkvKeys + 2 * kDkvRows) * (D + 8) * 2 + 2 * kDkvRows * 4;
}

template <int D>
int dq_f32_smem() {
  return (2 * kF32Tile * D + 2 * kF32Tile * (D + 1) +
          kF32Tile * (kF32Tile + 1) + 2 * kF32Tile) * 4;
}

template <int D>
int dkv_f32_smem() {
  return (2 * kF32Tile * (D + 1) + 2 * kF32Tile * D +
          2 * kF32Tile * (kF32Tile + 1) + 2 * kF32Tile) * 4;
}

// Fills BwdArgs from the C arguments; false for shapes the kernels refuse.
bool make_args(BwdArgs* a, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* segments, void* dq, void* dk, void* dv, int batch,
               int heads, int kv_heads, int seq_len, int causal,
               int valid_len, float scale, const long long* strides) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_len <= 0 ||
      batch <= 0 || valid_len < 0 || valid_len > seq_len) {
    return false;
  }
  a->q = q;
  a->k = k;
  a->v = v;
  a->dout = dout;
  a->lse = static_cast<const float*>(lse);
  a->delta = static_cast<const float*>(delta);
  a->seg = static_cast<const int*>(segments);
  a->dq = dq;
  a->dk = dk;
  a->dv = dv;
  a->H = heads;
  a->L = seq_len;
  a->rep = heads / kv_heads;
  a->kv_end = valid_len > 0 ? valid_len : seq_len;
  a->causal = causal;
  a->scale = scale;
  Strides* s[7] = {&a->q_s, &a->k_s, &a->v_s, &a->do_s,
                   &a->dq_s, &a->dk_s, &a->dv_s};
  for (int i = 0; i < 7; ++i) {
    *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. strides: the batch,
// head and sequence strides (in elements) of q, k, v, dout, dq, dk and dv, in
// that order (21 values; flash_bwd_dq ignores the last six, flash_bwd_dkv
// those of dq); the head dim must be contiguous. lse and delta: [batch, heads,
// 1, seq_len] fp32, contiguous. segments: [batch, seq_len] int32 or null.
// valid_len: 0, or mask keys at positions >= valid_len. Each returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for an unsupported
// dtype, head_dim or shape.
int flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, const void* segments, void* dq, int batch,
                 int heads, int kv_heads, int seq_len, int causal,
                 int valid_len, float scale, const long long* strides,
                 void* stream) {
  BwdArgs a;
  if (!make_args(&a, q, k, v, dout, lse, delta, segments, dq, nullptr,
                 nullptr, batch, heads, kv_heads, seq_len, causal, valid_len,
                 scale, strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_bf16((seq_len + kDqRows - 1) / kDqRows, heads, batch);
  const dim3 grid_f32((seq_len + kF32Tile - 1) / kF32Tile, heads, batch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) {
    err = launch_kernel(dq_bf16_kernel<128>, grid_bf16, kBf16Threads,
                        dq_bf16_smem<128>(), a, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch_kernel(dq_bf16_kernel<64>, grid_bf16, kBf16Threads,
                        dq_bf16_smem<64>(), a, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch_kernel(dq_f32_kernel<128>, grid_f32, kF32Threads,
                        dq_f32_smem<128>(), a, s);
  } else if (dtype == 0 && head_dim == 64) {
    err = launch_kernel(dq_f32_kernel<64>, grid_f32, kF32Threads,
                        dq_f32_smem<64>(), a, s);
  }
  return static_cast<int>(err);
}

int flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                  const void* v, const void* dout, const void* lse,
                  const void* delta, const void* segments, void* dk, void* dv,
                  int batch, int heads, int kv_heads, int seq_len, int causal,
                  int valid_len, float scale, const long long* strides,
                  void* stream) {
  BwdArgs a;
  if (!make_args(&a, q, k, v, dout, lse, delta, segments, nullptr, dk, dv,
                 batch, heads, kv_heads, seq_len, causal, valid_len, scale,
                 strides)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid_bf16((seq_len + kDkvKeys - 1) / kDkvKeys, kv_heads, batch);
  const dim3 grid_f32((seq_len + kF32Tile - 1) / kF32Tile, kv_heads, batch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) {
    err = launch_kernel(dkv_bf16_kernel<128>, grid_bf16, kBf16Threads,
                        dkv_bf16_smem<128>(), a, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch_kernel(dkv_bf16_kernel<64>, grid_bf16, kBf16Threads,
                        dkv_bf16_smem<64>(), a, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch_kernel(dkv_f32_kernel<128>, grid_f32, kF32Threads,
                        dkv_f32_smem<128>(), a, s);
  } else if (dtype == 0 && head_dim == 64) {
    err = launch_kernel(dkv_f32_kernel<64>, grid_f32, kF32Threads,
                        dkv_f32_smem<64>(), a, s);
  }
  return static_cast<int>(err);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
