// Flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_on_k8s/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd). It computes the same function: for q [B,H,L,D] and k/v
// [B,Hkv,L,D] (q-head h reads kv-head h / (H/Hkv); no repeated K/V), the fp32
// scores scale * q.k are masked (causal, key < valid length, same segment) to
// the finite -1e30, an online softmax runs over K tiles in fp32, P is cast to
// the input type before the P.V product, and the outputs are o = acc / l in the
// input type and lse = m + log(l) in fp32 [B,H,1,L].
//
// What bounds it on an H100 SXM: 4*B*H*L^2*D FLOPs (about half of that under
// causal masking) against 989 TFLOP/s of bf16 tensor cores, and the bytes of
// q, k, v and o (each read or written once; lse is small) against 3.35 TB/s.
// With H=32, Hkv=8 that is H*L/(2*(H+Hkv)) = 0.4*L FLOPs per byte under causal
// masking, against the card's ~295: the serving prefill (B 4, H 32, Hkv 8,
// L 512, D 128: 8.6 GFLOP, 42 MB) is bound by bytes, 0.0126 ms; the training
// shape (B 4, H 16, L 2048, D 128: 68.7 GFLOP) by operations, 0.0695 ms. Only
// wgmma reaches the bf16 tensor-core rate, and only with its operands fed
// from shared memory while the previous tile computes.
//
// The bf16 design (flash_sm90.cuh holds the Hopper pieces):
//   * one block of 384 threads per (b, h, 128-row query tile), heaviest tiles
//     first: a producer warpgroup, of which one thread issues every TMA load
//     and the rest give their registers away (setmaxnreg 24), and two
//     consumer warpgroups (setmaxnreg 240) of 64 query rows each;
//   * Q is TMA-loaded once; K and V stream through a ring of two stages of
//     128 keys each (full/empty mbarriers), so loads of the next tiles
//     overlap the products of this one; the maps read the caller's strided
//     views in place, and rows past L arrive as zeros;
//   * S = Q K^T is a wgmma with both operands in shared memory (K-major);
//     the online softmax runs in fp32 registers, in base 2 with scale*log2(e)
//     folded into one multiply of the fp32 dot product; P is cast to bf16 in
//     registers and is the A operand of O += P V, a wgmma with V read
//     MN-major from the same tile TMA wrote;
//   * masks run only on the tiles that need them: the tile(s) crossing the
//     causal diagonal, the tile holding kv_end (valid_len or the ragged L),
//     and every tile when segments are given, whose key ids are read once
//     per tile into shared memory; interior tiles skip the test, and the
//     causal loop stops at the diagonal;
//   * o = acc / l is written as bf16 over the warpgroup's own Q rows in
//     shared memory and stored by TMA, which drops rows past L; lse is
//     stored by the threads that hold it.
// Shared memory at D 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB.
//
// The float32 path runs a 64 x 64 tiling with scalar FMAs in shared memory.
// It exists so that a check on the card can also compare at full precision;
// it is not tuned.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int kBlockM = 64;        // float32 path: query rows per block
constexpr int kBlockN = 64;        // float32 path: keys per K/V tile
constexpr int kF32Threads = 256;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // [B, L] int32 or null
  void* o;
  float* lse;      // [B, H, 1, L]
  int H, L, rep, kv_end, causal;
  float scale;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
};

__device__ __forceinline__ bool keep(const FwdArgs& a, const int* seg_b,
                                     int row, int col, int seg_row) {
  return keep_pair(a.kv_end, a.causal, seg_b, row, col, seg_row);
}

// K tiles a query tile attends into: up to the last valid key and, under
// causal masking, up to the tile holding the diagonal.
__device__ __forceinline__ int num_kv_tiles(const FwdArgs& a, int q0) {
  int n = (a.kv_end + kBlockN - 1) / kBlockN;
  if (a.causal) {
    const int last_row = min(q0 + kBlockM, a.L) - 1;
    n = min(n, last_row / kBlockN + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma, one producer thread and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kFwdKeys = 128;  // keys per K/V tile
constexpr int kFwdStages = 2;  // K/V tiles in flight

struct FwdSm90Params {
  CUtensorMap q;   // boxes of [128 rows, 64]
  CUtensorMap k;   // [kFwdKeys rows, 64]
  CUtensorMap v;   // [kFwdKeys rows, 64]
  CUtensorMap o;   // [64 rows, 64]: one consumer warpgroup's rows
  const int* seg;  // [B, L] int32 or null
  float* lse;      // [B, H, 1, L]
  int H, L, rep, kv_end, causal;
  float scale_log2;  // scale * log2(e)
};

// Byte offsets in the block's shared memory (after aligning it to 1024).
template <int D>
struct FwdSmem {
  static constexpr int kKV = kFwdKeys * D * 2;          // one K or V tile
  static constexpr int kK = kSm90Rows * D * 2;          // Q (later O) first
  static constexpr int kV = kK + kFwdStages * kKV;
  static constexpr int kSeg = kV + kFwdStages * kKV;    // [2 wg][2][keys]
  static constexpr int kBar = kSeg + 2 * 2 * kFwdKeys * 4;
  static constexpr int kLaunch = kBar + (1 + 3 * kFwdStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdSm90Params p) {
  using S = FwdSmem<D>;
  constexpr int kN = kFwdKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + kFwdStages;
  uint64_t* empty = full_v + kFwdStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kSm90Rows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int n_tiles = (p.kv_end + kN - 1) / kN;
  if (p.causal) {
    n_tiles = min(n_tiles, (min(q0 + kSm90Rows, p.L) - 1) / kN + 1);
  }
  if (threadIdx.x == 0) init_barriers(bar_q, full_k, full_v, empty, kFwdStages);
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the K/V ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kSm90Rows * D * 2);
      load_rows<D, kSm90Rows>(smem, &p.q, bar_q, q0, h, b);
      produce_kv<D, kN, kFwdStages>(smem + S::kK, smem + S::kV, &p.k, &p.v,
                                    full_k, full_v, empty, n_tiles,
                                    h / p.rep, b);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;  // consumer warpgroup: 0 or 1
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;
    const int t = tid % 4;
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int rows[2] = {row0 + 16 * warp + g, row0 + 16 * warp + g + 8};
    const int* seg_b =
        p.seg ? p.seg + static_cast<long long>(b) * p.L : nullptr;
    int seg_row[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      seg_row[r] = (seg_b != nullptr && rows[r] < p.L) ? seg_b[rows[r]] : -1;
    }
    int* seg_keys = reinterpret_cast<int*>(smem + S::kSeg) + wg * 2 * kN;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // m: running row max of scale*log2(e)*s; l: this lane's share of the
    // row sum (the quad's four shares are added once, at the end)
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    const uint32_t q_tile = smem_u32(smem) + wg * 64 * 128;
    mbar_wait(bar_q, 0);

    // K/V tiles are as tall as the query tile, so the causal loop reaches
    // no tile that lies wholly after a warpgroup's rows: every tile computes
    static_assert(kFwdKeys == kSm90Rows, "no tile is skipped");
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kFwdStages;
      const uint32_t parity = (j / kFwdStages) & 1;
      const int k0 = j * kN;
      const uint32_t k_tile = smem_u32(smem + S::kK + s * S::kKV);
      const uint32_t v_tile = smem_u32(smem + S::kV + s * S::kKV);
      const bool masked = seg_b != nullptr || k0 + kN > p.kv_end ||
                          (p.causal && k0 + kN - 1 > row0);
      const int* seg_tile = nullptr;
      if (seg_b != nullptr) {
        int* buf = seg_keys + (j & 1) * kN;
        load_key_segments(buf, seg_b, k0, kN, p.L, tid, 1 + wg);
        seg_tile = buf;
      }
      float sc[kN / 2];
      mbar_wait(&full_k[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<kN>::ss(sc, desc_k_major(q_tile, kSm90Rows, kk),
                      desc_k_major(k_tile, kN, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(sc);

      // A masked tile is scaled and masked first: y = scale*log2(e)*s, or
      // -1e30 where masked, and p = exp2(y - m), so a masked key gives
      // exactly 0 (or 1 in a row with no key kept yet, as in the
      // reference). An interior tile keeps the raw scores, takes their row
      // max (scale > 0 commutes with max) and forms p = exp2(s*c - m) in
      // one FMA; that form would turn -1e30 into the product's rounding
      // error, so it is used only where nothing is masked.
      if (masked) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int r = (i >> 1) & 1;
          sc[i] = keep_key(col, rows[r], p.kv_end, p.causal,
                           seg_tile ? seg_tile + (col - k0) : nullptr,
                           seg_row[r])
                      ? sc[i] * p.scale_log2
                      : kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new =
            fmaxf(m[r], masked ? mx[r] : mx[r] * p.scale_log2);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      if (masked) {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(sc[i] - m[r]);
          l[r] += sc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = exp2f(fmaf(sc[i], p.scale_log2, -m[r]));
          l[r] += sc[i];
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      uint32_t pa[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) acc_to_a(pa[kk], sc, kk);

      mbar_wait(&full_v[s], parity);
      fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        Wgmma<D>::rs(o, pa[kk], desc_mn_major(v_tile, kN, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
      fence_operand(pa);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    // o = acc / l over the warpgroup's own Q rows, which no wgmma reads
    store_rows<D>(&p.o, smem + wg * 64 * 128, o, l[0], l[1], tid, 1 + wg,
                  row0, h, b);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < p.L) {
          p.lse[(static_cast<long long>(b) * p.H + h) * p.L + rows[r]] =
              m[r] * kLn2 + logf(l[r]);
        }
      }
    }
  }
}

// Builds the four tensor maps and launches the bf16 kernel.
cudaError_t launch_fwd_sm90(int D, const void* q, const void* k, const void* v,
                            const void* segments, void* o, void* lse,
                            int batch, int heads, int kv_heads, int seq_len,
                            int causal, int kv_end, float scale,
                            const long long* st, cudaStream_t stream) {
  FwdSm90Params p;
  const bool mapped =
      make_tile_map(&p.q, q, D, seq_len, heads, batch, st[2], st[1], st[0],
                    kSm90Rows) &&
      make_tile_map(&p.k, k, D, seq_len, kv_heads, batch, st[5], st[4], st[3],
                    kFwdKeys) &&
      make_tile_map(&p.v, v, D, seq_len, kv_heads, batch, st[8], st[7], st[6],
                    kFwdKeys) &&
      make_tile_map(&p.o, o, D, seq_len, heads, batch, st[11], st[10], st[9],
                    64);
  if (!mapped) return cudaErrorInvalidValue;
  p.seg = static_cast<const int*>(segments);
  p.lse = static_cast<float*>(lse);
  p.H = heads;
  p.L = seq_len;
  p.rep = heads / kv_heads;
  p.kv_end = kv_end;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  const dim3 grid((seq_len + kSm90Rows - 1) / kSm90Rows, heads, batch);
  if (D == 128) {
    return launch_kernel(flash_fwd_sm90_kernel<128>, grid, kSm90Threads,
                         FwdSmem<128>::kLaunch, p, stream);
  }
  return launch_kernel(flash_fwd_sm90_kernel<64>, grid, kSm90Threads,
                       FwdSmem<64>::kLaunch, p, stream);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs in shared memory (full-precision reference path)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(FwdArgs a) {
  constexpr int kLdK = D + 1;  // thread c reads key row c: no bank conflicts
  constexpr int kLdS = kBlockN + 1;
  constexpr int kRowGroups = kF32Threads / D;
  constexpr int kRowsPerThread = kBlockM / kRowGroups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [64][D]
  float* sK = sQ + kBlockM * D;                    // [64][D+1]
  float* sV = sK + kBlockN * kLdK;                 // [64][D]
  float* sS = sV + kBlockN * D;                    // [64][65] scores, then p
  float* sM = sS + kBlockM * kLdS;                 // running row max
  float* sL = sM + kBlockM;                        // running row sum
  float* sC = sL + kBlockM;                        // this tile's correction

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;

  for (int i = tid; i < kBlockM * D; i += kF32Threads) {
    const int r = i / D;
    sQ[i] = (q0 + r < a.L) ? q[(q0 + r) * a.q_sl + i % D] : 0.f;
  }
  if (tid < kBlockM) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int dcol = tid % D;
  const int rg = tid / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  const int n_tiles = num_kv_tiles(a, q0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();
    for (int i = tid; i < kBlockN * D; i += kF32Threads) {
      const int r = i / D;
      const int c = i % D;
      const bool in = k0 + r < a.L;
      sK[r * kLdK + c] = in ? k[(k0 + r) * a.k_sl + c] : 0.f;
      sV[i] = in ? v[(k0 + r) * a.v_sl + c] : 0.f;
    }
    __syncthreads();
    {
      const int c = tid % kBlockN;
      const int col = k0 + c;
      for (int r = tid / kBlockN; r < kBlockM; r += kF32Threads / kBlockN) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(sQ[r * D + d], sK[c * kLdK + d], dot);
        const int row = q0 + r;
        const int seg_row = (seg_b != nullptr && row < a.L) ? seg_b[row] : -1;
        sS[r * kLdS + c] =
            keep(a, seg_b, row, col, seg_row) ? a.scale * dot : kNegInf;
      }
    }
    __syncthreads();
    if (tid < kBlockM) {
      float* srow = sS + tid * kLdS;
      float mx = sM[tid];
      for (int c = 0; c < kBlockN; ++c) mx = fmaxf(mx, srow[c]);
      float sum = 0.f;
      for (int c = 0; c < kBlockN; ++c) {
        const float p = expf(srow[c] - mx);
        srow[c] = p;
        sum += p;
      }
      const float corr = expf(sM[tid] - mx);
      sL[tid] = sL[tid] * corr + sum;
      sM[tid] = mx;
      sC[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + kRowGroups * i;
      float x = acc[i] * sC[r];
      for (int c = 0; c < kBlockN; ++c) x = fmaf(sS[r * kLdS + c], sV[c * D + dcol], x);
      acc[i] = x;
    }
  }
  __syncthreads();

  float* out = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + kRowGroups * i;
    if (q0 + r < a.L) out[(q0 + r) * a.o_sl + dcol] = acc[i] / sL[r];
  }
  if (tid < kBlockM && q0 + tid < a.L) {
    a.lse[(static_cast<long long>(b) * a.H + h) * a.L + q0 + tid] =
        sM[tid] + logf(sL[tid]);
  }
}

template <int D>
int f32_smem() {
  return (kBlockM * D + kBlockN * (D + 1) + kBlockN * D +
          kBlockM * (kBlockN + 1) + 3 * kBlockM) * 4;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. strides: the batch,
// head and sequence strides (in elements) of q, k, v and o, in that order;
// the head dim must be contiguous (bf16: every stride a multiple of 8
// elements, as TMA requires). segments: [batch, seq_len] int32 or null.
// valid_len: 0, or mask keys at positions >= valid_len. Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for an unsupported
// dtype, head_dim or layout.
int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
              const void* v, const void* segments, void* o, void* lse,
              int batch, int heads, int kv_heads, int seq_len, int causal,
              int valid_len, float scale, const long long* strides,
              void* stream) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_len <= 0 ||
      batch <= 0 || valid_len < 0 || valid_len > seq_len ||
      (head_dim != 64 && head_dim != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kv_end = valid_len > 0 ? valid_len : seq_len;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(launch_fwd_sm90(
        head_dim, q, k, v, segments, o, lse, batch, heads, kv_heads, seq_len,
        causal, kv_end, scale, strides, s));
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg = static_cast<const int*>(segments);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.H = heads;
  a.L = seq_len;
  a.rep = heads / kv_heads;
  a.kv_end = kv_end;
  a.causal = causal;
  a.scale = scale;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_sl = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_sl = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_sl = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_sl = strides[11];
  const dim3 grid((seq_len + kBlockM - 1) / kBlockM, heads, batch);
  cudaError_t err = head_dim == 128
      ? launch_kernel(flash_fwd_f32_kernel<128>, grid, kF32Threads,
                      f32_smem<128>(), a, s)
      : launch_kernel(flash_fwd_f32_kernel<64>, grid, kF32Threads,
                      f32_smem<64>(), a, s);
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
