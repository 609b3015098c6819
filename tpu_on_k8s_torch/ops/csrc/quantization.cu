// Row-wise int8 quantization with stochastic rounding, and its inverse, for
// NVIDIA Hopper (sm_90a).
//
// quantize_int8 replaces the Pallas TPU kernel
// tpu_on_k8s/ops/quantization.py::_quant_kernel (launched by quantize_int8).
// For x [R, C] (bf16, fp16 or fp32) it computes, per row, the same function:
//
//     scale  = max(max_c |x[r, c]|, 1e-30) * fp32(1 / 127)   (fp32)
//     scaled = x / scale                                      (fp32)
//     lo     = floor(scaled)
//     u      = (bits >> 8) * 2^-24                            (24 random bits)
//     values = clip(lo + (u < scaled - lo), -127, 127)        (int8)
//
// The TPU kernel draws its bits from the TPU's generator; here they come from
// Philox4x32-10 (Salmon et al., SC'11), written out below, keyed by the 64-bit
// seed. Element (r, c) has the flat index f = r * C + c and takes 32-bit word
// f % 4 of Philox(counter = (f / 4 low, f / 4 high, 0, 0)): every element of a
// call gets its own bits, and the plain PyTorch version
// (ops/quantization.py::_philox_bits) computes the same ones, so kernel and
// plain version agree bit for bit.
//
// (The reference's scale, as XLA evaluates it, multiplies by the fp32
// reciprocal of 127, its rewrite of a division by a constant; so does this
// kernel, and its scales match the reference's bit for bit.)
//
// dequantize_int8 replaces _dequant_kernel (launched by dequantize_int8):
// out = (float)values * scales[r], rounded once to the output type.
//
// What bounds them on an H100 SXM: bytes. The quantizer reads x and writes
// the int8 values and a scale a row; the dequantizer reads values and
// scales and writes the output: a few operations a byte, far below the
// card's ~295 bf16 FLOP per byte (Philox's ~40 integer operations serve four
// elements).
//
// What the design does about it:
//   * quantize: one block of 256 threads per row. A first pass reads the
//     row in 16-byte vectors and reduces |x| to the row's absmax (warp
//     shuffles, then shared memory); a second pass reads the row again
//     (from L2 for rows up to a few hundred KB) and writes the rounded int8
//     values, one Philox call per four elements;
//   * dequantize: a grid-stride pass over 16-element chunks (16 bytes of
//     int8 in, 32 or 64 bytes out, each as 16-byte stores);
//   * a row length that does not fit the vectors (C not a multiple of the
//     vector width, or a misaligned row) takes the same passes one element
//     at a time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kQuantThreads = 256;
constexpr int kDequantThreads = 256;

// Philox4x32-10.
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = kM0 * ctr.x, hi0 = __umulhi(kM0, ctr.x);
    const uint32_t lo1 = kM1 * ctr.z, hi1 = __umulhi(kM1, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

__device__ __forceinline__ uint4 philox_group(unsigned long long group,
                                              uint2 key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(group),
                                  static_cast<uint32_t>(group >> 32), 0u, 0u),
                       key);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// The stochastic rounding of the TPU kernel, for one element.
__device__ __forceinline__ int8_t round_one(float x, float scale,
                                            uint32_t bits) {
  const float scaled = x / scale;
  const float lo = floorf(scaled);
  const float u = __uint2float_rn(bits >> 8) * (1.0f / 16777216.0f);
  float r = lo + ((u < scaled - lo) ? 1.0f : 0.0f);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (kQuantThreads >> 5) ? red[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// One block per row. kVec elements (16 bytes of T) per vector step, or one
// element at a time when kVec == 1.
template <typename T, int kVec>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
             float* __restrict__ scales, long long C, uint2 key) {
  __shared__ float red[kQuantThreads / 32];
  const long long r = blockIdx.x;
  const T* row = x + r * C;
  int8_t* out = values + r * C;

  float m = 0.0f;
  if constexpr (kVec > 1) {
    for (long long c = threadIdx.x * kVec; c < C; c += kQuantThreads * kVec) {
      const int4 raw = *reinterpret_cast<const int4*>(row + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) m = fmaxf(m, fabsf(to_f32(v[i])));
    }
  } else {
    for (long long c = threadIdx.x; c < C; c += kQuantThreads)
      m = fmaxf(m, fabsf(to_f32(row[c])));
  }
  const float scale = fmaxf(block_max(m, red), 1e-30f) * (1.0f / 127.0f);
  if (threadIdx.x == 0) scales[r] = scale;

  if constexpr (kVec > 1) {
    // kVec is 4 or 8 and C a multiple of it, so each vector starts at a flat
    // index divisible by 4: its elements use whole Philox groups
    for (long long c = threadIdx.x * kVec; c < C; c += kQuantThreads * kVec) {
      const int4 raw = *reinterpret_cast<const int4*>(row + c);
      const T* v = reinterpret_cast<const T*>(&raw);
      const unsigned long long f = static_cast<unsigned long long>(r * C + c);
      alignas(8) int8_t q[kVec];
#pragma unroll
      for (int grp = 0; grp < kVec / 4; ++grp) {
        const uint4 bits = philox_group((f >> 2) + grp, key);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q[grp * 4 + i] = round_one(to_f32(v[grp * 4 + i]), scale,
                                     word(bits, i));
      }
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(out + c) = *reinterpret_cast<const uint2*>(q);
      } else {
        *reinterpret_cast<uint32_t*>(out + c) =
            *reinterpret_cast<const uint32_t*>(q);
      }
    }
  } else {
    for (long long c = threadIdx.x; c < C; c += kQuantThreads) {
      const unsigned long long f = static_cast<unsigned long long>(r * C + c);
      const uint4 bits = philox_group(f >> 2, key);
      out[c] = round_one(to_f32(row[c]), scale, word(bits, static_cast<int>(f & 3)));
    }
  }
}

// 16 int8 values a chunk when kVec, else one element a step.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ values,
               const float* __restrict__ scales, T* __restrict__ out,
               long long total, long long C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (kVec) {
    constexpr int kOutVecs = 16 * sizeof(T) / 16;   // int4 stores a chunk
    for (; i * 16 < total; i += stride) {
      const long long e = i * 16;
      const float s = scales[e / C];
      const int4 raw = *reinterpret_cast<const int4*>(values + e);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      alignas(16) T o[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        o[k] = from_f32<T>(static_cast<float>(v[k]) * s);
#pragma unroll
      for (int k = 0; k < kOutVecs; ++k)
        reinterpret_cast<int4*>(out + e)[k] = reinterpret_cast<const int4*>(o)[k];
    }
  } else {
    for (; i < total; i += stride)
      out[i] = from_f32<T>(static_cast<float>(values[i]) * scales[i / C]);
  }
}

template <typename T>
cudaError_t launch_quant(const void* x, void* values, void* scales, long long R,
                         long long C, uint2 key, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = C % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 8 == 0;
  const T* xt = static_cast<const T*>(x);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  if (vec) {
    quant_kernel<T, kVec><<<static_cast<unsigned>(R), kQuantThreads, 0, s>>>(
        xt, v, sc, C, key);
  } else {
    quant_kernel<T, 1><<<static_cast<unsigned>(R), kQuantThreads, 0, s>>>(
        xt, v, sc, C, key);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequant(const void* values, const void* scales, void* out,
                           long long R, long long C, cudaStream_t s) {
  const long long total = R * C;
  const bool vec = C % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long work = vec ? total / 16 : total;
  const long long blocks_needed = (work + kDequantThreads - 1) / kDequantThreads;
  const unsigned blocks = static_cast<unsigned>(
      blocks_needed < 132LL * 32 ? blocks_needed : 132LL * 32);
  const int8_t* v = static_cast<const int8_t*>(values);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  if (vec) {
    dequant_kernel<T, true><<<blocks, kDequantThreads, 0, s>>>(v, sc, o, total, C);
  } else {
    dequant_kernel<T, false><<<blocks, kDequantThreads, 0, s>>>(v, sc, o, total, C);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [R, C] (in_code: 0 fp32, 1 bf16, 2 fp16) -> values [R, C] int8 and
// scales [R] fp32, stochastic rounding keyed by the 64-bit seed.
int quantize_int8(const void* x, int in_code, void* values, void* scales,
                  long long R, long long C, unsigned long long seed,
                  void* stream) {
  if (R <= 0 || C <= 0 || R > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (in_code == kF32) {
    err = launch_quant<float>(x, values, scales, R, C, key, s);
  } else if (in_code == kBF16) {
    err = launch_quant<__nv_bfloat16>(x, values, scales, R, C, key, s);
  } else if (in_code == kF16) {
    err = launch_quant<__half>(x, values, scales, R, C, key, s);
  }
  return static_cast<int>(err);
}

// values [R, C] int8, scales [R] fp32 -> out [R, C] (out_code as above).
int dequantize_int8(const void* values, const void* scales, void* out,
                    int out_code, long long R, long long C, void* stream) {
  if (R <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (out_code == kF32) {
    err = launch_dequant<float>(values, scales, out, R, C, s);
  } else if (out_code == kBF16) {
    err = launch_dequant<__nv_bfloat16>(values, scales, out, R, C, s);
  } else if (out_code == kF16) {
    err = launch_dequant<__half>(values, scales, out, R, C, s);
  }
  return static_cast<int>(err);
}

const char* quantization_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
