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
// masking, against the card's ~295: at the serving prefill shape (L=512) the
// kernel is bound by bytes, from L of about 740 on by operations.
//
// What the design does about it (a first, simple kernel; no TMA, wgmma or warp
// specialisation yet):
//   * one block of 4 warps per (b, h, 64-row query tile); each warp owns 16
//     query rows, which it keeps in registers as mma.sync A fragments, so q is
//     read from device memory once;
//   * a loop over 64-key K/V tiles staged in shared memory (16-byte loads,
//     rows padded by 8 elements so the fragment reads hit 32 distinct banks);
//   * S = Q K^T and O += P V on the tensor cores with
//     mma.sync.m16n8k16 bf16 -> fp32; the S accumulator is re-packed in
//     registers into the A fragment of the P V product, so neither S nor P
//     nor O ever goes through shared or device memory;
//   * the online softmax runs in fp32 registers; a row's 16 values of a tile
//     sit in the 4 lanes of a quad and are reduced with two shuffles;
//   * under causal masking the K loop stops at the diagonal tile, and query
//     tiles are launched heaviest first;
//   * ragged lengths are masked in-kernel: rows past L load as zeros, their
//     keys are masked and their queries are never stored, so the caller
//     needs no pad-and-slice.
// Later work: K/V tiles shared by the H/Hkv q-heads of a group (today each
// head's block reads them again, from L2), cp.async/TMA double buffering, and
// wgmma.
//
// The float32 path runs the same tiling and masking with scalar FMAs in
// shared memory. It exists so that a check on the card can also compare at
// full precision; it is not tuned.

#include "flash_common.cuh"

namespace {

constexpr int kBlockM = 64;        // query rows per block
constexpr int kBlockN = 64;        // keys per K/V tile
constexpr int kBf16Threads = 128;  // 4 warps x 16 query rows
constexpr int kF32Threads = 256;
static_assert(kBlockM == kBlockN, "one tile loader serves Q, K and V");

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
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
    flash_fwd_bf16_kernel(FwdArgs a) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kLd;
  __nv_bfloat16* sV = sK + kBlockN * kLd;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.rep;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* seg_b = a.seg ? a.seg + static_cast<long long>(b) * a.L : nullptr;

  load_tile_bf16<D, kBlockN, kBf16Threads>(sQ, q, a.q_sl, q0, a.L, tid);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a_frag(qf[kk], sQ, kLd, warp, kk, g, t);

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int seg_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    seg_row[r] = (seg_b != nullptr && rows[r] < a.L) ? seg_b[rows[r]] : -1;
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  }
  // m is the running row max; l this lane's share of the row sum (the quad's
  // four shares are added once, at the end).
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = num_kv_tiles(a, q0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kBlockN, kBf16Threads>(sK, k, a.k_sl, k0, a.L, tid);
    load_tile_bf16<D, kBlockN, kBf16Threads>(sV, v, a.v_sl, k0, a.L, tid);
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const __nv_bfloat16* kr = sK + (n * 8 + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        mma_bf16(s[n], qf[kk], ld_u32(kr + kk * 16), ld_u32(kr + kk * 16 + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float x = keep(a, seg_b, rows[r], col, seg_row[r])
                            ? a.scale * s[n][e]
                            : kNegInf;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = expf(s[n][e] - mx[r]);
        l[r] += s[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }

    // O += P V: the S accumulators of key columns [16kk, 16kk+16) are the A
    // fragment of step kk; V's B fragment pairs two keys of one column.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a_frag(pa, s, kk);
      const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t) * kLd + g;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vc = vr + dn * 8;
        mma_bf16(o[dn], pa, pack_u16(vc, vc + kLd),
                 pack_u16(vc + 8 * kLd, vc + 9 * kLd));
      }
    }
  }

  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= a.L) continue;
    __nv_bfloat16* orow = out + rows[r] * a.o_sl + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8) =
          pack_f32(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
    }
    if (t == 0) {
      a.lse[(static_cast<long long>(b) * a.H + h) * a.L + rows[r]] =
          m[r] + logf(l[r]);
    }
  }
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, const FwdArgs& a,
                   int batch, cudaStream_t stream) {
  const dim3 grid((a.L + kBlockM - 1) / kBlockM, a.H, batch);
  return launch_kernel(kernel, grid, threads, smem, a, stream);
}

template <int D>
int bf16_smem() { return 3 * kBlockM * (D + 8) * 2; }

template <int D>
int f32_smem() {
  return (kBlockM * D + kBlockN * (D + 1) + kBlockN * D +
          kBlockM * (kBlockN + 1) + 3 * kBlockM) * 4;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. strides: the batch,
// head and sequence strides (in elements) of q, k, v and o, in that order;
// the head dim must be contiguous. segments: [batch, seq_len] int32 or null.
// valid_len: 0, or mask keys at positions >= valid_len. Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for an unsupported
// dtype or head_dim.
int flash_fwd(int dtype, int head_dim, const void* q, const void* k,
              const void* v, const void* segments, void* o, void* lse,
              int batch, int heads, int kv_heads, int seq_len, int causal,
              int valid_len, float scale, const long long* strides,
              void* stream) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || seq_len <= 0 ||
      batch <= 0 || valid_len < 0 || valid_len > seq_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  a.kv_end = valid_len > 0 ? valid_len : seq_len;
  a.causal = causal;
  a.scale = scale;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_sl = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_sl = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_sl = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_sl = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 128) {
    err = launch(flash_fwd_bf16_kernel<128>, kBf16Threads, bf16_smem<128>(), a, batch, s);
  } else if (dtype == 1 && head_dim == 64) {
    err = launch(flash_fwd_bf16_kernel<64>, kBf16Threads, bf16_smem<64>(), a, batch, s);
  } else if (dtype == 0 && head_dim == 128) {
    err = launch(flash_fwd_f32_kernel<128>, kF32Threads, f32_smem<128>(), a, batch, s);
  } else if (dtype == 0 && head_dim == 64) {
    err = launch(flash_fwd_f32_kernel<64>, kF32Threads, f32_smem<64>(), a, batch, s);
  }
  return static_cast<int>(err);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
