// Int8 GEMM with a fused dequantizing epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_on_k8s/ops/int8_matmul.py::_mm_kernel
// (launched by _fwd_impl_pallas). It computes the same function: for row-
// quantized activations xq [M, K] int8 with scales sx [M] fp32, and weights
// quantized per output channel wq [N, K] int8 with scales sw [N] fp32,
//
//     out[m, n] = ((float)(sum_k xq[m, k] * wq[n, k]) * sx[m]) * sw[n]
//
// with the sum exact in int32, the epilogue in fp32 in that order, and the
// result rounded to nearest once, into bf16, fp16 or fp32. The weight is the
// port's [out, in] Dense layout, so both operands are K-contiguous: exactly
// the row-major A and column-major B operands of an int8 MMA, no transpose.
// |sum| <= 127^2 * K, which the wrapper keeps below 2^31 (K <= 133,144).
//
// What bounds it on an H100 SXM: 2*M*N*K int8 operations against 1,979 TOP/s
// of int8 tensor cores, and the bytes of xq, wq, the scales and out against
// 3.35 TB/s. At the training shapes (M = 8192, K >= 2048) that is well above
// the card's ~590 operations per byte: the kernel is bound by operations.
//
// What the design does about it (the aligned path: K a multiple of 16 and
// both operands 16-byte aligned, every shape of the port's training path):
//   * a persistent grid, one block of 384 threads per SM walking over the
//     128 x 256 output tiles (M fastest): one producer thread issues every
//     TMA load and the rest of its warpgroup gives its registers away
//     (setmaxnreg 24); two consumer warpgroups (setmaxnreg 240) own 64 rows
//     each, with 128 int32 accumulators a thread kept in registers from the
//     first K tile to the epilogue (as the TPU kernel keeps its int32
//     accumulator in VMEM): the int32 product never reaches device memory;
//   * 128-byte K tiles of A [128 rows] and B [256 rows] reach a ring of four
//     stages (48 KB each) by 2-D TMA maps with the 128-byte swizzle, tracked
//     by full/empty mbarriers; the producer runs on into the next tile's
//     loads while the consumers write this tile's epilogue. Rows past M or N
//     and bytes past K arrive as zeros;
//   * the product is wgmma m64n256k32 s8.s8 -> s32 with both operands
//     K-major in shared memory (int8 wgmma takes no MN-major operand, which
//     is why the port stores w as [N, K]), one wgmma group kept in flight
//     while the next K tile is waited for;
//   * the epilogue converts each accumulator with __int2float_rn, multiplies
//     by sx then sw in fp32 and stores bf16, fp16 or fp32 pairs from
//     registers, masked at M and N (an fp32 out with N % 4 != 0 has rows a
//     TMA store cannot address).
// The int32 sum is exact in any order of the K steps, so the result is the
// same bits as the plain version's.
//
// Shapes TMA cannot describe (K % 16 != 0, or an operand not 16-byte
// aligned) take a byte-wise kernel, chosen by shape before the launch: one
// block of 8 warps per 128 x 128 output tile, the warps 2 x 4 over it, each a
// 64 x 32 sub-tile of mma.sync.m16n8k32 s8 -> s32 (64 int32 accumulators a
// thread), fed by synchronous byte loads of 64-byte K tiles into shared
// memory (rows padded to 80 bytes so a warp's fragment reads hit 32 distinct
// banks), with the same epilogue. The mma.sync fragment layouts (PTX ISA,
// m16n8k32 with .s8): a thread (group g = lane / 4, t = lane % 4) holds
// A[g][4t..4t+3], A[g+8][4t..4t+3], A[g][16+4t..], A[g+8][16+4t..] and
// B[4t..4t+3][g], B[16+4t..][g] (four int8 to a 32-bit register), and
// accumulators C[g][2t, 2t+1], C[g+8][2t, 2t+1].

#include <cuda_fp16.h>

#include "flash_sm90.cuh"

namespace {

enum OutCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Args {
  const int8_t* xq;   // [M, K]
  const float* sx;    // [M]
  const int8_t* wq;   // [N, K]
  const float* sw;    // [N]
  void* out;          // [M, N]
  int M, N, K;
};

// out[m, n .. n+1] from two products; `pair` stores both at once (n even
// and N even: 4- or 8-byte aligned), else each one that lies inside N.
template <int kOut>
__device__ __forceinline__ void store_pair(void* out, long long idx, float v0,
                                           float v1, bool pair, bool has1) {
  if constexpr (kOut == kBF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + idx;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (has1) o[1] = __float2bfloat16_rn(v1);
    }
  } else if constexpr (kOut == kF16) {
    __half* o = static_cast<__half*>(out) + idx;
    if (pair) {
      *reinterpret_cast<__half2*>(o) =
          __halves2half2(__float2half_rn(v0), __float2half_rn(v1));
    } else {
      o[0] = __float2half_rn(v0);
      if (has1) o[1] = __float2half_rn(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + idx;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (has1) o[1] = v1;
    }
  }
}

// The epilogue of the accumulator pair at (m, n .. n+1), n < N, with sw0 =
// sw[n] and sw1 = sw[n + 1]: (float)acc * sx[m] * sw[n], rounded once to the
// output type, stored where it lies inside the output.
template <int kOut>
__device__ __forceinline__ void store_acc(const Args& a, int m, int n,
                                          float sxm, float sw0, float sw1,
                                          int acc0, int acc1) {
  if (m >= a.M) return;
  const bool has1 = n + 1 < a.N;
  const float v0 = __int2float_rn(acc0) * sxm * sw0;
  const float v1 = has1 ? __int2float_rn(acc1) * sxm * sw1 : 0.f;
  store_pair<kOut>(a.out, static_cast<long long>(m) * a.N + n, v0, v1,
                   has1 && (a.N & 1) == 0, has1);
}

// sw[n] and sw[n + 1] (0 past N) for an epilogue at column n < N.
__device__ __forceinline__ float2 load_sw(const Args& a, int n) {
  return make_float2(a.sw[n], n + 1 < a.N ? a.sw[n + 1] : 0.f);
}

// ---------------------------------------------------------------------------
// The aligned path: TMA-fed wgmma, one producer thread, two consumer
// warpgroups, a persistent grid
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;   // output rows per tile: 2 warpgroups x 64
constexpr int kTileN = 256;   // output cols per tile
constexpr int kTileK = 128;   // bytes of K per stage (one swizzled row)
constexpr int kStages = 4;
constexpr int kStageA = kTileM * kTileK;            // 16 KB
constexpr int kStageB = kTileN * kTileK;            // 32 KB
constexpr int kStage = kStageA + kStageB;
constexpr int kBarOffset = kStages * kStage;
constexpr int kSm90Smem = kBarOffset + 2 * kStages * 8 + 1024;

struct GemmParams {
  CUtensorMap a;  // xq [M, K]: boxes of [kTileM rows, 128 bytes]
  CUtensorMap b;  // wq [N, K]: boxes of [kTileN rows, 128 bytes]
  Args args;
  int m_tiles, tiles, k_tiles;
};

template <int kOut>
__global__ void __launch_bounds__(kSm90Threads, 1)
    int8_matmul_sm90_kernel(const __grid_constant__ GemmParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full, tile after tile
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        const int m0 = (tile % p.m_tiles) * kTileM;
        const int n0 = (tile / p.m_tiles) * kTileN;
        for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages + 1) & 1);
          mbar_expect_tx(&full[s], kStage);
          unsigned char* stage = smem + s * kStage;
          tma_load_2d(stage, &p.a, &full[s], kt * kTileK, m0);
          tma_load_2d(stage + kStageA, &p.b, &full[s], kt * kTileK, n0);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1;  // consumer warpgroup: 0 or 1
    const int tid = threadIdx.x % 128;
    const int t = tid % 4;
    const int row = 64 * wg + 16 * (tid / 32) + (tid % 32) / 4;
    int it = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int m0 = (tile % p.m_tiles) * kTileM;
      const int n0 = (tile / p.m_tiles) * kTileN;
      int acc[kTileN / 2];
      for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        const uint32_t a_tile = smem_u32(smem + s * kStage) + wg * 64 * 128;
        const uint32_t b_tile = smem_u32(smem + s * kStage + kStageA);
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 32; ++kk) {
          wgmma_s8_m64n256(acc, desc_k_major(a_tile, kTileM, kk),
                           desc_k_major(b_tile, kTileN, kk),
                           kt > 0 || kk > 0);
        }
        wgmma_commit();
        fence_operand(acc);
        // the previous K tile's products are done: release its stage
        wgmma_wait<1>();
        if (kt > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(&empty[(it - 1) % kStages]);

      const int m[2] = {m0 + row, m0 + row + 8};
      float sxm[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        sxm[half] = m[half] < p.args.M ? p.args.sx[m[half]] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= p.args.N) continue;
        const float2 sw = load_sw(p.args, n);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          store_acc<kOut>(p.args, m[half], n, sxm[half], sw.x, sw.y,
                          acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

// The number of SMs of the current device: the persistent grid's size.
int sm_count() {
  int device = 0;
  int n = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

cudaError_t launch_sm90(const Args& a, int out_code, cudaStream_t stream) {
  GemmParams p;
  if (!make_byte_map(&p.a, a.xq, a.M, a.K, kTileM) ||
      !make_byte_map(&p.b, a.wq, a.N, a.K, kTileN)) {
    return cudaErrorInvalidValue;
  }
  p.args = a;
  p.m_tiles = (a.M + kTileM - 1) / kTileM;
  const long long tiles =
      static_cast<long long>(p.m_tiles) * ((a.N + kTileN - 1) / kTileN);
  const int sms = sm_count();
  if (tiles > 0x7fffffff || sms <= 0) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  p.k_tiles = (a.K + kTileK - 1) / kTileK;
  const dim3 grid(p.tiles < sms ? p.tiles : sms);
  switch (out_code) {
    case kF32:
      return launch_kernel(int8_matmul_sm90_kernel<kF32>, grid, kSm90Threads,
                           kSm90Smem, p, stream);
    case kBF16:
      return launch_kernel(int8_matmul_sm90_kernel<kBF16>, grid, kSm90Threads,
                           kSm90Smem, p, stream);
    case kF16:
      return launch_kernel(int8_matmul_sm90_kernel<kF16>, grid, kSm90Threads,
                           kSm90Smem, p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The byte-wise path: mma.sync from synchronous byte loads
// ---------------------------------------------------------------------------

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output cols per block
constexpr int kBK = 64;           // bytes of K per shared-memory tile
constexpr int kLd = kBK + 16;     // padded row, bytes
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64;           // warp tile rows
constexpr int kWN = 32;           // warp tile cols
constexpr int kMT = kWM / 16;     // m16 tiles a warp
constexpr int kNT = kWN / 8;      // n8 tiles a warp

// One 128-row x 64-byte tile of a K-contiguous int8 operand [rows, K] into
// shared memory, rows past `rows` and bytes past K as zeros. 512 chunks of 16
// bytes, two a thread.
__device__ __forceinline__ void load_tile(int8_t (*dst)[kLd], const int8_t* src,
                                          int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int r = chunk >> 2;
    const int c = (chunk & 3) * 16;
    const int grow = row0 + r;
    const int gk = k0 + c;
    alignas(16) int8_t buf[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      buf[b] = (grow < rows && gk + b < K)
                   ? src[static_cast<long long>(grow) * K + gk + b]
                   : static_cast<int8_t>(0);
    }
    *reinterpret_cast<int4*>(&dst[r][c]) = *reinterpret_cast<const int4*>(buf);
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kOut>
__global__ void __launch_bounds__(kThreads)
int8_matmul_bytes_kernel(const Args a) {
  __shared__ __align__(16) int8_t sA[kBM][kLd];
  __shared__ __align__(16) int8_t sB[kBN][kLd];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 2) * kWM;   // warp's rows within the tile
  const int wn = (warp & 3) * kWN;    // warp's cols within the tile

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    __syncthreads();   // every warp is done with the previous tiles
    load_tile(sA, a.xq, m0, a.M, k0, a.K);
    load_tile(sB, a.wq, n0, a.N, k0, a.K);
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t fa[kMT][4];
      uint32_t fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm + i * 16 + g;
        fa[i][0] = lds32(&sA[r][ks + 4 * t]);
        fa[i][1] = lds32(&sA[r + 8][ks + 4 * t]);
        fa[i][2] = lds32(&sA[r][ks + 16 + 4 * t]);
        fa[i][3] = lds32(&sA[r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = wn + j * 8 + g;
        fb[j][0] = lds32(&sB[c][ks + 4 * t]);
        fb[j][1] = lds32(&sB[c][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= a.N) continue;
    const float2 sw = load_sw(a, n);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        store_acc<kOut>(a, m, n, m < a.M ? a.sx[m] : 0.f, sw.x, sw.y,
                        acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

cudaError_t launch_bytes(const Args& a, int out_code, cudaStream_t s) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  switch (out_code) {
    case kF32:
      int8_matmul_bytes_kernel<kF32><<<grid, kThreads, 0, s>>>(a);
      break;
    case kBF16:
      int8_matmul_bytes_kernel<kBF16><<<grid, kThreads, 0, s>>>(a);
      break;
    case kF16:
      int8_matmul_bytes_kernel<kF16><<<grid, kThreads, 0, s>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [M, N] = dequant(xq [M, K] . wq [N, K]^T). All operands contiguous.
// out_code: 0 fp32, 1 bf16, 2 fp16. Returns a cudaError_t (0 on success).
int int8_matmul(const void* xq, const void* sx, const void* wq, const void* sw,
                void* out, int M, int N, int K, int out_code, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.sx = static_cast<const float*>(sx);
  a.wq = static_cast<const int8_t*>(wq);
  a.sw = static_cast<const float*>(sw);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  const bool aligned = K % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      aligned ? launch_sm90(a, out_code, s) : launch_bytes(a, out_code, s);
  return static_cast<int>(err);
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
