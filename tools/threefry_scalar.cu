// The threefry kernels in their one-element-a-thread form: a grid-stride
// loop over elements with 64-bit indices, libdevice's log1pf, erfinv's two
// constant sets chosen by selects on every element, the key injections
// added per element. Built only by tools/threefry_sweep.py, which times
// the package's kernels (src/repro_torch/kernels/csrc/threefry.cu) against
// it in the same run; it computes the same function, bit for bit, through
// the same C entry points.
//
// Bound on this card: the instruction stream. Its element loop compiles to
// 173 SASS instructions (81 on the half-rate ALU pipe) where the function
// needs 99 issue slots an update.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // grid-stride beyond this
constexpr int kSumBlocks = 1024;            // partial sums of a sumsq launch

struct Key {
  uint32_t k0, k1, k2;
};

__host__ Key make_key(uint32_t k0, uint32_t k1) {
  return Key{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32(key, (e >> 32, e)) folded to 32 bits: b1 ^ b2.
__device__ __forceinline__ uint32_t threefry_bits(const Key& k,
                                                  unsigned long long e) {
  uint32_t x0 = static_cast<uint32_t>(e >> 32) + k.k0;
  uint32_t x1 = static_cast<uint32_t>(e) + k.k1;
#define TF_ROUND(r)  \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k1; x1 += k.k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.k2; x1 += k.k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k0; x1 += k.k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k.k1; x1 += k.k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k.k2; x1 += k.k0 + 5u;
#undef TF_ROUND
  return x0 ^ x1;
}

// XLA's f32 erfinv (see the note at the top).
__device__ __forceinline__ float erfinv_xla(float x) {
  const float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float t = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = lt ? 2.81022636e-08f : -0.000200214257f;
  p = __fmaf_rn(p, t, lt ? 3.43273939e-07f : 0.000100950558f);
  p = __fmaf_rn(p, t, lt ? -3.5233877e-06f : 0.00134934322f);
  p = __fmaf_rn(p, t, lt ? -4.39150654e-06f : -0.00367342844f);
  p = __fmaf_rn(p, t, lt ? 0.00021858087f : 0.00573950773f);
  p = __fmaf_rn(p, t, lt ? -0.00125372503f : -0.0076224613f);
  p = __fmaf_rn(p, t, lt ? -0.00417768164f : 0.00943887047f);
  p = __fmaf_rn(p, t, lt ? 0.246640727f : 1.00167406f);
  p = __fmaf_rn(p, t, lt ? 1.50140941f : 2.83297682f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000))
                          : __fmul_rn(p, x);
}

// z from the cipher's 32 bits: uniform on [nextafter(-1, 0), 1), then
// sqrt(2) * erfinv.
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  const float lo = __int_as_float(0xBF7FFFFF);          // nextafter(-1, 0)
  const float f =
      __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  return __fmul_rn(__int_as_float(0x3FB504F3), erfinv_xla(u));  // sqrt(2)
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
threefry_update_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long n, Key k, const float* __restrict__ coeff,
                       const float* __restrict__ scale,
                       unsigned long long offset) {
  const float c = *coeff;
  const bool scaled = scale != nullptr;
  const float s = scaled ? *scale : 1.0f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    float z = normal_of_bits(threefry_bits(k, offset + i));
    if (scaled) z = __fmul_rn(z, s);
    y[i] = from_f32<T>(__fadd_rn(to_f32(x[i]), __fmul_rn(c, z)));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc += sum over the leaf of z^2. partials: gridDim.x floats; counter: one
// uint32, 0 on entry, left 0 by the last block.
__global__ void __launch_bounds__(kThreads)
threefry_sumsq_kernel(long long n, Key k, unsigned long long offset,
                      float* __restrict__ partials,
                      unsigned int* __restrict__ counter,
                      float* __restrict__ acc) {
  __shared__ float warp_ss[kThreads / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float ss = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const float z = normal_of_bits(threefry_bits(k, offset + i));
    ss = __fmaf_rn(z, z, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) b += warp_ss[w];
    partials[blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  __threadfence();
  float t = 0.0f;
  for (int b = lane; b < static_cast<int>(gridDim.x); b += 32) {
    t += __ldcg(partials + b);
  }
  t = warp_sum(t);
  if (lane == 0) {
    *acc = __fadd_rn(*acc, t);
    *counter = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
threefry_noise_kernel(uint32_t* __restrict__ bits, float* __restrict__ z,
                      long long n, Key k, unsigned long long offset) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const uint32_t b = threefry_bits(k, offset + i);
    bits[i] = b;
    z[i] = normal_of_bits(b);
  }
}

// z for each of the 2^23 values of bits >> 9.
__global__ void __launch_bounds__(kThreads)
threefry_normal_table_kernel(float* __restrict__ z) {
  const uint32_t m = blockIdx.x * kThreads + threadIdx.x;
  z[m] = normal_of_bits(m << 9);
}

unsigned int blocks_for(long long n, long long cap) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < cap ? b : cap);
}

}  // namespace

// x, y: n contiguous elements (dtype 0 = float32, 1 = bfloat16); key
// (k0, k1); coeff: one device float; scale: one device float or null;
// offset: the linear index of x[0] in its leaf.
extern "C" int threefry_update_launch(const void* x, void* y, long long n,
                                      int dtype, unsigned int k0,
                                      unsigned int k1, const float* coeff,
                                      const float* scale,
                                      unsigned long long offset,
                                      void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Key k = make_key(k0, k1);
  const unsigned int blocks = blocks_for(n, kMaxBlocks);
  if (dtype == 0) {
    threefry_update_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, k, coeff,
        scale, offset);
  } else if (dtype == 1) {
    threefry_update_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        n, k, coeff, scale, offset);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: one device float, added to; scratch: threefry_sumsq_scratch_words()
// device words, zero before the first launch and left zero by each.
extern "C" int threefry_sumsq_launch(long long n, unsigned int k0,
                                     unsigned int k1,
                                     unsigned long long offset, float* acc,
                                     void* scratch, void* stream) {
  if (n <= 0) return 0;
  unsigned int* counter = static_cast<unsigned int*>(scratch);
  float* partials = reinterpret_cast<float*>(counter + 1);
  threefry_sumsq_kernel<<<blocks_for(n, kSumBlocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, make_key(k0, k1), offset, partials, counter, acc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_sumsq_scratch_words() { return 1 + kSumBlocks; }

// bits (uint32) and z (float): n device elements each.
extern "C" int threefry_noise_launch(unsigned int* bits, float* z,
                                     long long n, unsigned int k0,
                                     unsigned int k1,
                                     unsigned long long offset,
                                     void* stream) {
  if (n <= 0) return 0;
  threefry_noise_kernel<<<blocks_for(n, kMaxBlocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bits, z, n, make_key(k0, k1), offset);
  return static_cast<int>(cudaGetLastError());
}

// z: 2^23 device floats; z[m] is the gaussian of every bits with
// bits >> 9 == m.
extern "C" int threefry_normal_table_launch(float* z, void* stream) {
  threefry_normal_table_kernel<<<(1u << 23) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(z);
  return static_cast<int>(cudaGetLastError());
}
