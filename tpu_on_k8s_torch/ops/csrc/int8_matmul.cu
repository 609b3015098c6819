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
// What the design does about it (a first, simple kernel: no wgmma, TMA or
// warp specialisation yet):
//   * one block of 8 warps per 128 x 128 output tile, the warps 2 x 4 over it,
//     each warp a 64 x 32 sub-tile: 4 x 4 mma.sync.m16n8k32 s8 -> s32 per 32
//     bytes of K, with 64 int32 accumulators a thread kept in registers from
//     the first K tile to the epilogue (as the TPU kernel keeps its int32
//     accumulator in VMEM): the int32 product never reaches device memory;
//   * 64-byte K tiles of A and B staged in shared memory, double buffered
//     with cp.async (16-byte copies; rows padded to 80 bytes so the fragment
//     reads of a warp hit 32 distinct banks);
//   * the epilogue converts each accumulator with __int2float_rn, multiplies
//     by sx then sw in fp32 and stores bf16 pairs (__float2bfloat16_rn) or
//     fp32 pairs;
//   * ragged edges are handled in the kernel: rows of A or B past M or N and
//     bytes past K load as zeros (cp.async's zero fill), and stores past M or
//     N are masked, so every shape runs here (the TPU path needed its tiles
//     to divide the shape or fell back to XLA). A K that is not a multiple of
//     16 bytes, or a misaligned operand, takes a synchronous byte-wise load
//     of the same tiles.
//
// The fragment layouts are those of the PTX ISA for m16n8k32 with .s8: a
// thread (group g = lane / 4, t = lane % 4) holds A[g][4t..4t+3],
// A[g+8][4t..4t+3], A[g][16+4t..], A[g+8][16+4t..] and B[4t..4t+3][g],
// B[16+4t..][g] (four int8 to a 32-bit register), and accumulators
// C[g][2t, 2t+1], C[g+8][2t, 2t+1].

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 128;          // output cols per block
constexpr int kBK = 64;           // bytes of K per shared-memory tile
constexpr int kLd = kBK + 16;     // padded row, bytes
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64;           // warp tile rows
constexpr int kWN = 32;           // warp tile cols
constexpr int kMT = kWM / 16;     // m16 tiles a warp
constexpr int kNT = kWN / 8;      // n8 tiles a warp

enum OutCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Args {
  const int8_t* xq;   // [M, K]
  const float* sx;    // [M]
  const int8_t* wq;   // [N, K]
  const float* sw;    // [N]
  void* out;          // [M, N]
  int M, N, K;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in_bounds) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = in_bounds ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 128-row x 64-byte tile of a K-contiguous int8 operand [rows, K] into
// shared memory, rows past `rows` and bytes past K as zeros. 512 chunks of 16
// bytes, two a thread.
template <bool kAsync>
__device__ __forceinline__ void load_tile(int8_t (*dst)[kLd], const int8_t* src,
                                          int row0, int rows, int k0, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int r = chunk >> 2;
    const int c = (chunk & 3) * 16;
    const int grow = row0 + r;
    const int gk = k0 + c;
    if constexpr (kAsync) {
      const bool ok = grow < rows && gk < K;   // K % 16 == 0: whole chunks
      const int8_t* p = ok ? src + static_cast<long long>(grow) * K + gk : src;
      cp_async16(&dst[r][c], p, ok);
    } else {
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

template <bool kAsync, int kOut>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const Args a) {
  __shared__ __align__(16) int8_t sA[2][kBM][kLd];
  __shared__ __align__(16) int8_t sB[2][kBN][kLd];

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

  const int n_k = (a.K + kBK - 1) / kBK;
  load_tile<kAsync>(sA[0], a.xq, m0, a.M, 0, a.K);
  load_tile<kAsync>(sB[0], a.wq, n0, a.N, 0, a.K);
  if constexpr (kAsync) cp_async_commit();

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {
      load_tile<kAsync>(sA[cur ^ 1], a.xq, m0, a.M, (kt + 1) * kBK, a.K);
      load_tile<kAsync>(sB[cur ^ 1], a.wq, n0, a.N, (kt + 1) * kBK, a.K);
      if constexpr (kAsync) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (kAsync) {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t fa[kMT][4];
      uint32_t fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm + i * 16 + g;
        fa[i][0] = lds32(&sA[cur][r][ks + 4 * t]);
        fa[i][1] = lds32(&sA[cur][r + 8][ks + 4 * t]);
        fa[i][2] = lds32(&sA[cur][r][ks + 16 + 4 * t]);
        fa[i][3] = lds32(&sA[cur][r + 8][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = wn + j * 8 + g;
        fb[j][0] = lds32(&sB[cur][c][ks + 4 * t]);
        fb[j][1] = lds32(&sB[cur][c][ks + 16 + 4 * t]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();   // the next iteration's loads overwrite this stage
  }

  // epilogue: (float)acc * sx[m] * sw[n], rounded once to the output type
  const bool even_n = (a.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= a.M) continue;
      const float sxm = a.sx[m];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (n >= a.N) continue;
        const bool has1 = n + 1 < a.N;
        const float v0 =
            __int2float_rn(acc[i][j][2 * half]) * sxm * a.sw[n];
        const float v1 =
            has1 ? __int2float_rn(acc[i][j][2 * half + 1]) * sxm * a.sw[n + 1]
                 : 0.f;
        store_pair<kOut>(a.out, static_cast<long long>(m) * a.N + n, v0, v1,
                         has1 && even_n, has1);
      }
    }
  }
}

template <bool kAsync>
cudaError_t launch(const Args& a, int out_code, cudaStream_t s) {
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  switch (out_code) {
    case kF32:
      int8_matmul_kernel<kAsync, kF32><<<grid, kThreads, 0, s>>>(a);
      break;
    case kBF16:
      int8_matmul_kernel<kAsync, kBF16><<<grid, kThreads, 0, s>>>(a);
      break;
    case kF16:
      int8_matmul_kernel<kAsync, kF16><<<grid, kThreads, 0, s>>>(a);
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
      aligned ? launch<true>(a, out_code, s) : launch<false>(a, out_code, s);
  return static_cast<int>(err);
}

const char* int8_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
