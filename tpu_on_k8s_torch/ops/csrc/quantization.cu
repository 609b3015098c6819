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
// What bounds them on an H100 SXM: the dequantizer, bytes: it reads values
// and scales and writes the output. The quantizer reads x once and writes
// the int8 values and a scale a row, but it is held as much by the
// instructions it issues: a Philox call (ten rounds of two 32x32->64
// multiplies and two three-way xors) serves four elements, and the division
// and rounding of each element are some twenty more, about 30 an element
// against 3 bytes an element moved.
//
// What the design does about it:
//   * quantize (quant_kernel): one 256-thread block per row, the row held in
//     registers: each thread loads its 16-byte vectors of the row (up to
//     kQuantMaxSteps, all loads in flight at once), so x is read from device
//     memory once; the absmax is reduced across the block, and the same
//     registers are rounded. Per element: the quotient from the row's
//     correctly rounded reciprocal and two residual corrections in place of
//     an IEEE division (exact: see div_rn), the round keys read from the
//     constant bank, and the int8 value from the float's bits in place of a
//     conversion. A row of more than kQuantMaxSteps * 256 vectors (C 32000
//     fp32) takes quant_long_kernel, which reads the row a second time for
//     the rounding (mostly from L2), kQuantMaxSteps loads in flight. A ring
//     of row buffers in shared memory, filled by 1-D TMA bulk copies, was
//     measured and dropped: it was slower at every shape but the longest
//     rows (PERF.md);
//   * dequantize (dequant_kernel): each thread converts four chunks of 16
//     output bytes (4 or 8 values), all four loads in flight before the
//     first store; a warp's loads and its streaming 16-byte stores are each
//     one contiguous run; the row of a chunk follows from the previous one
//     by addition (no division in the loop);
//   * a row the vectors cannot address (C * size not a multiple of 16 bytes,
//     or a misaligned base) takes the element-wise kernels
//     (quant_bytes_kernel, dequant_bytes_kernel) of the same function.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DtypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kQuantThreads = 256;
// A row of up to kQuantMaxSteps * kQuantThreads 16-byte vectors stays in
// registers (C 11008 bf16, C 5632 fp32).
constexpr int kQuantMaxSteps = 6;
// Blocks an SM of the persistent grid for longer rows (quant_long_kernel).
constexpr int kLongBlocksPerSm = 2;
constexpr int kBytesThreads = 256;
constexpr int kDequantThreads = 256;
constexpr int kDequantUnroll = 4;   // 16-byte loads in flight per thread

// ---- Philox4x32-10 ----------------------------------------------------------

// The ten round keys of a seed, computed on the host and passed as a kernel
// parameter: the rounds' three-way xors read them from the constant bank.
struct PhiloxKeys {
  uint32_t x[10], y[10];
};

PhiloxKeys philox_keys(unsigned long long seed) {
  PhiloxKeys k;
  for (uint32_t i = 0; i < 10; ++i) {
    k.x[i] = static_cast<uint32_t>(seed) + i * 0x9E3779B9u;
    k.y[i] = static_cast<uint32_t>(seed >> 32) + i * 0xBB67AE85u;
  }
  return k;
}

// The four words of counter (group low, group high, 0, 0).
__device__ __forceinline__ uint4 philox(unsigned long long group,
                                        const PhiloxKeys& k) {
  constexpr unsigned long long kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  uint32_t c0 = static_cast<uint32_t>(group);
  uint32_t c1 = static_cast<uint32_t>(group >> 32), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned long long p0 = kM0 * c0, p1 = kM1 * c2;
    const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k.x[i];
    const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k.y[i];
    c1 = static_cast<uint32_t>(p1);
    c3 = static_cast<uint32_t>(p0);
    c0 = n0;
    c2 = n2;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// ---- element types ------------------------------------------------------------

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

// ---- the rounding of one element ----------------------------------------------

// A row's scale, its correctly rounded reciprocal, and the least |x| whose
// quotient div_rn may take from the reciprocal: 2^-99 and 2^-99 * scale,
// so that x and x / scale both stay above 2^-100; NaN (no element) for an
// infinite scale.
struct RowScale {
  float scale, inv, tiny;
};

__device__ __forceinline__ RowScale row_scale(float absmax) {
  const float scale = fmaxf(absmax, 1e-30f) * (1.0f / 127.0f);
  const float tiny = isinf(scale) ? __int_as_float(0x7fc00000)
                                  : fmaxf(0x1p-99f, scale * 0x1p-99f);
  return {scale, __frcp_rn(scale), tiny};
}

// x / scale for G elements, each rounded to nearest even exactly as an IEEE
// division, from the row's correctly rounded reciprocal `inv`: q = x * inv,
// then two residual corrections q += (x - q * scale) * inv, each residual
// exact in an FMA (Markstein's theorem: with inv = RN(1 / scale) and q within
// an ulp of the quotient, the corrected q is the rounded quotient). The
// theorem needs no underflow in the residual, so a group holding an element
// below rs.tiny (zeros, subnormals, a small value in a row with a huge
// absmax), or in a row whose scale is infinite, divides outright: one branch
// a group.
template <int G>
__device__ __forceinline__ void div_rn(const float (&x)[G], const RowScale& rs,
                                       float (&q)[G]) {
  float smallest = INFINITY;
#pragma unroll
  for (int e = 0; e < G; ++e) {
    float t = x[e] * rs.inv;
    float r = fmaf(-t, rs.scale, x[e]);
    t = fmaf(r, rs.inv, t);
    r = fmaf(-t, rs.scale, x[e]);
    q[e] = fmaf(r, rs.inv, t);
    smallest = fminf(smallest, fabsf(x[e]));
  }
  if (!(smallest >= rs.tiny)) {
#pragma unroll
    for (int e = 0; e < G; ++e) q[e] = __fdiv_rn(x[e], rs.scale);
  }
}

// The stochastic rounding of the TPU kernel for one quotient, as the bits of
// a float: its low byte is the int8 value. clip(...) is an integer in
// [-127, 127], so adding 1.5 * 2^23 puts it, in two's complement, into the
// low bits of the sum's mantissa (no float-to-int conversion).
__device__ __forceinline__ uint32_t round_one(float scaled, uint32_t bits) {
  const float lo = floorf(scaled);
  const float u = __uint2float_rn(bits >> 8) * 0x1p-24f;
  float r = lo + ((u < scaled - lo) ? 1.0f : 0.0f);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return __float_as_uint(r + 12582912.0f);
}

// Four rounded quotients packed as int8 bytes (element 0 lowest).
__device__ __forceinline__ uint32_t round_four(const float* q, uint4 bits) {
  const uint32_t a = round_one(q[0], bits.x);
  const uint32_t b = round_one(q[1], bits.y);
  const uint32_t c = round_one(q[2], bits.z);
  const uint32_t d = round_one(q[3], bits.w);
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block's max of v: every thread gets it. Uses one __syncthreads; `red`
// may be written again only after a later barrier.
template <int kThreads>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// ---- quantize ------------------------------------------------------------------

// The largest |x| of one 16-byte vector of x, folded into m.
template <typename T>
__device__ __forceinline__ float vector_absmax(const uint4& raw, float m) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    m = fmaxf(m, fabsf(to_f32(e[j])));
  return m;
}

// One 16-byte vector of x (4 or 8 elements) whose first element has the flat
// index f (a multiple of 4: whole Philox groups), rounded and stored as
// int8 at out in one 4- or 8-byte store.
template <typename T>
__device__ __forceinline__ void round_vector(const uint4& raw,
                                             const RowScale& rs,
                                             unsigned long long f,
                                             const PhiloxKeys& keys,
                                             int8_t* out) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  float v[kVec], q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = to_f32(e[j]);
  div_rn<kVec>(v, rs, q);
  uint32_t packed[kVec / 4];
#pragma unroll
  for (int j = 0; j < kVec / 4; ++j)
    packed[j] = round_four(q + 4 * j, philox((f >> 2) + j, keys));
  if constexpr (kVec == 8) {
    *reinterpret_cast<uint2*>(out) = make_uint2(packed[0], packed[1]);
  } else {
    *reinterpret_cast<uint32_t*>(out) = packed[0];
  }
}

// One block per row, the row in registers: thread t holds vectors t,
// t + 256, ... (kSteps of them), loaded once, reduced, then rounded.
template <typename T, int kSteps>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
             float* __restrict__ scales, long long C, PhiloxKeys keys) {
  __shared__ float red[kQuantThreads / 32];
  constexpr int kVec = 16 / sizeof(T);
  const long long r = blockIdx.x;
  const uint4* row = reinterpret_cast<const uint4*>(x + r * C);
  const int vecs = static_cast<int>(C / kVec);
  uint4 raw[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int g = threadIdx.x + i * kQuantThreads;
    if (g < vecs) raw[i] = __ldcs(row + g);
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    if (threadIdx.x + i * kQuantThreads < vecs)
      m = vector_absmax<T>(raw[i], m);
  }
  const RowScale rs = row_scale(block_max<kQuantThreads>(m, red));
  if (threadIdx.x == 0) scales[r] = rs.scale;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int g = threadIdx.x + i * kQuantThreads;
    if (g < vecs) {
      const long long e = r * C + static_cast<long long>(g) * kVec;
      round_vector<T>(raw[i], rs, static_cast<unsigned long long>(e), keys,
                      values + e);
    }
  }
}

// A row too long for the registers: the absmax pass and then the rounding
// pass, which reads the row again from L2; each thread keeps kQuantMaxSteps
// loads in flight in both. A persistent grid of kLongBlocksPerSm blocks an
// SM walks over the rows, so the rows being read (blocks x row bytes, 34 MB
// at C 32000 fp32) stay within L2 for the second pass.
template <typename T>
__device__ __forceinline__ void quant_long_row(
    const T* __restrict__ x, int8_t* __restrict__ values,
    float* __restrict__ scales, long long r, long long C,
    const PhiloxKeys& keys, float* red) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kStride = kQuantThreads * kQuantMaxSteps;
  const uint4* row = reinterpret_cast<const uint4*>(x + r * C);
  const long long vecs = C / kVec;
  uint4 raw[kQuantMaxSteps];
  float m = 0.0f;
  for (long long g0 = threadIdx.x; g0 < vecs; g0 += kStride) {
#pragma unroll
    for (int i = 0; i < kQuantMaxSteps; ++i) {
      if (g0 + i * kQuantThreads < vecs) raw[i] = row[g0 + i * kQuantThreads];
    }
#pragma unroll
    for (int i = 0; i < kQuantMaxSteps; ++i) {
      if (g0 + i * kQuantThreads < vecs) m = vector_absmax<T>(raw[i], m);
    }
  }
  const RowScale rs = row_scale(block_max<kQuantThreads>(m, red));
  if (threadIdx.x == 0) scales[r] = rs.scale;
  for (long long g0 = threadIdx.x; g0 < vecs; g0 += kStride) {
#pragma unroll
    for (int i = 0; i < kQuantMaxSteps; ++i) {
      if (g0 + i * kQuantThreads < vecs)
        raw[i] = __ldcs(row + g0 + i * kQuantThreads);
    }
#pragma unroll
    for (int i = 0; i < kQuantMaxSteps; ++i) {
      const long long g = g0 + i * kQuantThreads;
      if (g < vecs) {
        const long long e = r * C + g * kVec;
        round_vector<T>(raw[i], rs, static_cast<unsigned long long>(e), keys,
                        values + e);
      }
    }
  }
  __syncthreads();   // red is written again by the block's next row
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_long_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                  float* __restrict__ scales, long long R, long long C,
                  PhiloxKeys keys) {
  __shared__ float red[kQuantThreads / 32];
  for (long long r = blockIdx.x; r < R; r += gridDim.x)
    quant_long_row<T>(x, values, scales, r, C, keys, red);
}

// The element-wise form for rows the vectors cannot address: one block per
// row, one element a step, two passes over the row in device memory.
template <typename T>
__global__ void __launch_bounds__(kBytesThreads)
quant_bytes_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                   float* __restrict__ scales, long long C, PhiloxKeys keys) {
  __shared__ float red[kBytesThreads / 32];
  const long long r = blockIdx.x;
  const T* row = x + r * C;
  float m = 0.0f;
  for (long long c = threadIdx.x; c < C; c += kBytesThreads)
    m = fmaxf(m, fabsf(to_f32(row[c])));
  const RowScale rs = row_scale(block_max<kBytesThreads>(m, red));
  if (threadIdx.x == 0) scales[r] = rs.scale;
  for (long long c = threadIdx.x; c < C; c += kBytesThreads) {
    const unsigned long long f = static_cast<unsigned long long>(r * C + c);
    const uint32_t bits = word(philox(f >> 2, keys), static_cast<int>(f & 3));
    const float v[1] = {to_f32(row[c])};
    float q[1];
    div_rn<1>(v, rs, q);
    values[r * C + c] = static_cast<int8_t>(round_one(q[0], bits) & 0xFF);
  }
}

// ---- dequantize ----------------------------------------------------------------

// Chunk j holds values [V j, V j + V) of the flat [R, C] array, V = 16 bytes
// of T (4 fp32, 8 bf16 or fp16 values; C a multiple of 16, so a chunk lies in
// one row): a lane reads V int8 values and writes one 16-byte vector, so a
// warp's loads and stores are each one contiguous run. Thread t of block b
// converts chunks b * T * U + t + u * T, u < U, all U loads issued before the
// first store; the row and column of each chunk follow from the previous ones
// by adding (T / cpr, T % cpr), cpr = C / V.
template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ values,
               const float* __restrict__ scales, T* __restrict__ out,
               uint32_t n_chunks, uint32_t cpr, uint32_t step_rows,
               uint32_t step_cols) {
  constexpr int V = 16 / sizeof(T);
  using Load = typename std::conditional<V == 4, uint32_t, uint2>::type;
  uint32_t j = blockIdx.x * (kDequantThreads * kDequantUnroll) + threadIdx.x;
  uint32_t row = j / cpr, col = j - row * cpr;
  Load raw[kDequantUnroll];
  float s[kDequantUnroll];
  uint32_t at[kDequantUnroll];
#pragma unroll
  for (int u = 0; u < kDequantUnroll; ++u) {
    at[u] = j;
    if (j < n_chunks) {
      raw[u] = __ldcs(reinterpret_cast<const Load*>(values) + j);
      s[u] = __ldg(scales + row);
    }
    j += kDequantThreads;
    row += step_rows;
    col += step_cols;
    if (col >= cpr) {
      col -= cpr;
      ++row;
    }
  }
#pragma unroll
  for (int u = 0; u < kDequantUnroll; ++u) {
    if (at[u] >= n_chunks) break;
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw[u]);
    alignas(16) T o[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = from_f32<T>(static_cast<float>(v[e]) * s[u]);
    __stcs(reinterpret_cast<int4*>(out) + at[u],
           *reinterpret_cast<const int4*>(o));
  }
}

// The element-wise form for a C that is not a multiple of 16 or misaligned
// arrays: a grid-stride pass, one element a step.
template <typename T>
__global__ void __launch_bounds__(kBytesThreads)
dequant_bytes_kernel(const int8_t* __restrict__ values,
                     const float* __restrict__ scales, T* __restrict__ out,
                     long long total, long long C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride)
    out[i] = from_f32<T>(static_cast<float>(values[i]) * scales[i / C]);
}

// ---- launchers -------------------------------------------------------------------

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename T>
cudaError_t launch_quant(const void* x, void* values, void* scales, long long R,
                         long long C, const PhiloxKeys& keys, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  int8_t* v = static_cast<int8_t*>(values);
  float* sc = static_cast<float*>(scales);
  const unsigned grid = static_cast<unsigned>(R);
  // whole 16-byte vectors of x at 16-byte aligned bases, and int8 stores of
  // 16 / size(T) bytes
  const bool vec = (C * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0;
  if (!vec) {
    quant_bytes_kernel<T><<<grid, kBytesThreads, 0, s>>>(xt, v, sc, C, keys);
    return cudaGetLastError();
  }
  const long long steps =
      (C * static_cast<long long>(sizeof(T)) / 16 + kQuantThreads - 1) /
      kQuantThreads;
  if (steps <= 1) {
    quant_kernel<T, 1><<<grid, kQuantThreads, 0, s>>>(xt, v, sc, C, keys);
  } else if (steps <= 2) {
    quant_kernel<T, 2><<<grid, kQuantThreads, 0, s>>>(xt, v, sc, C, keys);
  } else if (steps <= 4) {
    quant_kernel<T, 4><<<grid, kQuantThreads, 0, s>>>(xt, v, sc, C, keys);
  } else if (steps <= kQuantMaxSteps) {
    quant_kernel<T, kQuantMaxSteps><<<grid, kQuantThreads, 0, s>>>(
        xt, v, sc, C, keys);
  } else {
    const long long cap = static_cast<long long>(kLongBlocksPerSm) * sm_count();
    quant_long_kernel<T><<<static_cast<unsigned>(R < cap ? R : cap),
                           kQuantThreads, 0, s>>>(xt, v, sc, R, C, keys);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dequant(const void* values, const void* scales, void* out,
                           long long R, long long C, cudaStream_t s) {
  const long long total = R * C;
  const int8_t* v = static_cast<const int8_t*>(values);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  constexpr long long kPerBlock = kDequantThreads * kDequantUnroll;
  const bool vec = C % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   total / 4 + kPerBlock < (1LL << 32);
  if (vec) {
    constexpr long long V = 16 / sizeof(T);
    const uint32_t n_chunks = static_cast<uint32_t>(total / V);
    const uint32_t cpr = static_cast<uint32_t>(C / V);
    const unsigned blocks =
        static_cast<unsigned>((n_chunks + kPerBlock - 1) / kPerBlock);
    dequant_kernel<T><<<blocks, kDequantThreads, 0, s>>>(
        v, sc, o, n_chunks, cpr, kDequantThreads / cpr, kDequantThreads % cpr);
    return cudaGetLastError();
  }
  const long long blocks_needed = (total + kBytesThreads - 1) / kBytesThreads;
  const unsigned blocks = static_cast<unsigned>(
      blocks_needed < 132LL * 32 ? blocks_needed : 132LL * 32);
  dequant_bytes_kernel<T><<<blocks, kBytesThreads, 0, s>>>(v, sc, o, total, C);
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
  const PhiloxKeys key = philox_keys(seed);
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
