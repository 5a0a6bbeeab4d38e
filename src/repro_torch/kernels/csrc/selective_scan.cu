// Mamba's selective scan for Hopper (sm_90a): the recurrence of one Mamba
// block from its post-conv activation to its gated output, over a whole
// sequence in one launch.
//
// No Pallas kernel computes this. The reference's scan is jnp
// (src/repro/models/ssm.py): _mamba_ssm_params (:84) materialises dA and
// dBx as (B, L, d_in, N) f32, _ssm_scan_chunk (:70) is an associative scan
// inside a lax.scan over chunks (:96-126), then the C contraction and the
// D and silu(z) gate (:113, :122-123). PyTorch has no associative scan,
// and the recurrence in plain PyTorch is a loop over tokens with several
// launches a token (about 100k across the seven Mamba layers of a jamba
// unit at a 4096-token prefill), so it is a kernel, as jax.random.normal
// became threefry.cu. The plain version is kernels/ref.py:
// selective_scan_ref, held against this kernel on the card.
//
// The function, for batch b, channel c and token t, in f32:
//   delta = softplus(dt[b,t,c] + dt_bias[c])
//         = max(v, 0) + log1p(exp(-|v|))           (jax.nn.softplus's form)
//   h[n]  = exp(delta * A[c,n]) * h[n] + (delta * x[b,t,c]) * B[b,t,n],
//           A[c,n] = -exp(A_log[c,n]), h starting at h0[b,c,:]
//   o     = sum_n h[n] * C[b,t,n] (in n order) + x[b,t,c] * D[c]
//   y     = T(T(o) * T(silu(z[b,t,c])))            (T: the model type)
// and h_last[b,c,:] = h after the last token. x, z and y are the model
// type (float32 or bfloat16), everything else f32. exp and log1p are the
// full-precision expf and log1pf, not the __ intrinsics, so that f32
// stays within 1e-5 of the plain version.
//
// Bound on this card: per (token, channel) the kernel moves x, z and y in
// the model type and dt in f32 (10 bytes in bf16; B and C are per token,
// shared by every channel), and issues N exponentials, 2 transcendentals
// for softplus and 2 for silu(z) on the SFU (MUFU, 16 a clock an SM): at
// N = 16 about 20 MUFU operations against 10 bytes, so the SFU issue rate
// bounds it above the byte rate (chip_smoke.py: SCAN_MUFU_OPS).
//
// Design, simple and right first. One thread owns one (b, channel) and
// keeps its N states and its N values of A in registers; a block is 64
// consecutive channels of one batch row (d_in 16384: 256 blocks on the 132
// SMs), so the loads of x, z and dt and the stores of y across a warp are
// coalesced. Tokens go in chunks of kChunk: the block stages the chunk's B
// and C rows (the same for all its channels) and each thread its own dt, x
// and z of the chunk in shared memory, all loads of a chunk issued before
// any is used, so a chunk pays one load latency and not one a token. The
// kernel is templated on N in {4 (the SMOKE config), 16 (published)}; the
// launch refuses any other N. No atomics: two launches give bit-equal
// results. h_last may alias h0 (decode's in-place state): each thread
// reads its own h0 before it writes its h_last, and no other thread
// touches them. Known limit: at B = 1 the grid is 16384 threads, about 4
// warps an SM, each on a serial chain of tokens; splitting the sequence
// into chunks scanned in parallel is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 64;  // threads (channels) a block
constexpr int kChunk = 32;     // tokens staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// T(T(o) * T(silu(z))): in f32 the product o * silu(z); in bf16 both
// factors rounded to bf16 first, as the reference's bf16 product takes
// them.
template <typename T>
__device__ __forceinline__ T gate(float o, float zv) {
  const float g = zv / (1.0f + expf(-zv));
  return from_f32<T>(to_f32(from_f32<T>(o)) * to_f32(from_f32<T>(g)));
}

template <typename T, int N>
__global__ void __launch_bounds__(kChannels)
    selective_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const T* __restrict__ z,
                          const float* __restrict__ Bc,
                          const float* __restrict__ Cc,
                          const float* __restrict__ A_log,
                          const float* __restrict__ Dp,
                          const float* __restrict__ dt_bias, const float* h0,
                          T* __restrict__ y, float* h_last, int S, int d_in) {
  __shared__ float s_bc[kChunk][2 * N];  // each staged token's B, then C
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_x[kChunk][kChannels];
  __shared__ float s_z[kChunk][kChannels];
  const int tid = threadIdx.x;
  const int c = blockIdx.x * kChannels + tid;
  const bool live = c < d_in;             // the last block may be ragged
  const long long row0 = static_cast<long long>(blockIdx.y) * S;
  const long long hrow = (static_cast<long long>(blockIdx.y) * d_in + c) * N;
  float A[N], h[N];
  float Dc = 0.0f, bias = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    A[n] = live ? -expf(A_log[static_cast<long long>(c) * N + n]) : 0.0f;
    h[n] = live ? h0[hrow + n] : 0.0f;
  }
  if (live) {
    Dc = Dp[c];
    bias = dt_bias[c];
  }
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int len = min(kChunk, S - t0);
    const float* bsrc = Bc + (row0 + t0) * N;
    const float* csrc = Cc + (row0 + t0) * N;
    for (int i = tid; i < len * N; i += kChannels) {
      s_bc[i / N][i % N] = bsrc[i];
      s_bc[i / N][N + i % N] = csrc[i];
    }
    if (live) {
      const long long e0 = (row0 + t0) * d_in + c;
#pragma unroll 8
      for (int t = 0; t < len; ++t) {
        const long long e = e0 + static_cast<long long>(t) * d_in;
        s_dt[t][tid] = dt[e];
        s_x[t][tid] = to_f32(x[e]);
        s_z[t][tid] = to_f32(z[e]);
      }
    }
    __syncthreads();
    if (live) {
      T* yrow = y + (row0 + t0) * d_in + c;
      for (int t = 0; t < len; ++t) {
        const float v = s_dt[t][tid] + bias;
        const float delta = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
        const float xv = s_x[t][tid];
        const float dx = delta * xv;
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(delta * A[n]) * h[n] + dx * s_bc[t][n];
          acc += h[n] * s_bc[t][N + n];
        }
        yrow[static_cast<long long>(t) * d_in] =
            gate<T>(acc + xv * Dc, s_z[t][tid]);
      }
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[hrow + n] = h[n];
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* z,
                   const void* Bc, const void* Cc, const void* A_log,
                   const void* D, const void* dt_bias, const void* h0,
                   void* y, void* h_last, int B, int S, int d_in,
                   cudaStream_t st) {
  const dim3 grid((d_in + kChannels - 1) / kChannels, B);
  selective_scan_kernel<T, N><<<grid, kChannels, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(z), static_cast<const float*>(Bc),
      static_cast<const float*>(Cc), static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<const float*>(dt_bias),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), S, d_in);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* z,
                       const void* Bc, const void* Cc, const void* A_log,
                       const void* D, const void* dt_bias, const void* h0,
                       void* y, void* h_last, int B, int S, int d_in, int N,
                       cudaStream_t st) {
  if (N == 4) {
    return launch<T, 4>(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, y, h_last,
                        B, S, d_in, st);
  }
  if (N == 16) {
    return launch<T, 16>(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, y, h_last,
                         B, S, d_in, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x, z, y: (B, S, d_in) contiguous in one dtype (0 = float32, 1 =
// bfloat16); dt: (B, S, d_in) f32; Bc, Cc: (B, S, N) f32; A_log: (d_in,
// N) f32; D, dt_bias: (d_in,) f32; h0, h_last: (B, d_in, N) f32, h_last
// may be h0. N is 4 or 16. Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* z, const void* Bc,
                                     const void* Cc, const void* A_log,
                                     const void* D, const void* dt_bias,
                                     const void* h0, void* y, void* h_last,
                                     int B, int S, int d_in, int N, int dtype,
                                     void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || d_in <= 0 ||
      static_cast<long long>(B) * S * d_in > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_n<float>(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0, y,
                            h_last, B, S, d_in, N, st);
  } else if (dtype == 1) {
    err = dispatch_n<__nv_bfloat16>(x, dt, z, Bc, Cc, A_log, D, dt_bias, h0,
                                    y, h_last, B, S, d_in, N, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
