// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// attention with GQA, online softmax, f32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel). Same function: masked scores are
// -1e30, kv head = h / (H / Hkv), out = acc / max(l, 1e-30). Zeroth-order
// training has no backward pass, so the forward is all the port needs.
//
// Design. One block of 256 threads per (batch * head, 64-row query tile).
// The TPU kernel walked kv blocks along a sequential grid axis and carried
// (m, l, acc) in scratch between grid steps; blocks here run in no order, so
// the kv walk is a loop inside the block and (m, l, acc) live in registers.
// Q, K and V tiles are converted to f32 in shared memory (row stride D + 4
// floats: float4 aligned, and the rows a warp reads fall in distinct banks).
// Four threads share a query row: each computes 16 of the 64 scores of a kv
// tile and owns D / 4 output columns; row max and row sum are combined with
// two warp shuffles, and the probabilities pass through shared memory to the
// P.V product. Kv tiles wholly outside the causal / window band are never
// loaded. A ragged last tile (S not a multiple of 64) is zero-filled and
// masked.
//
// Bound on this card: at the training shapes (S = 512, d = 128) the work is
// 4 * d flops per unmasked (query, key) pair against one read of q, k, v and
// one write of o, so the card's bf16 tensor-core rate bounds it; this first
// version multiplies with scalar f32 FMAs from shared memory and is far from
// that bound. wgmma / TMA tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per query row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + 2 * kBK) * (D + 4) + kBQ * (kBK + 4));
}

// Rows [row0, row0 + ROWS) of a (S, D) matrix into a tile of stride D + 4,
// as f32, zero past row S.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * (D + 4) + c] =
        row < S ? to_f32(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                 int S, float scale, int causal, int window) {
  constexpr int LD = D + 4;
  constexpr int LDP = kBK + 4;
  constexpr int NCOL = kBK / 4;  // scores per thread per kv tile
  constexpr int NV = D / 16;     // float4 output slots per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q_lo = blockIdx.x * kBQ;
  const size_t plane = static_cast<size_t>(S) * D;
  const T* qp = q + bh * plane;
  const T* kp = k + kvh * plane;
  const T* vp = v + kvh * plane;
  T* op = o + bh * plane;

  const int r = threadIdx.x >> 2;  // query row within the tile
  const int qd = threadIdx.x & 3;  // this thread's quarter of the columns
  const int row = q_lo + r;

  load_tile<T, D, kBQ>(Qs, qp, q_lo, S);

  // the kv tiles that can hold an unmasked score for a row of this tile
  const int k_end = causal ? min(S, q_lo + kBQ) : S;
  int k_begin = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;
    k_begin = first > 0 ? (first / kBK) * kBK : 0;
  }

  float m_i = kNegInf;
  float l_i = 0.f;
  float4 acc[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k_lo = k_begin; k_lo < k_end; k_lo += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D, kBK>(Ks, kp, k_lo, S);
    load_tile<T, D, kBK>(Vs, vp, k_lo, S);
    __syncthreads();

    float s[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * LD + dd]);
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(&Ks[(qd + 4 * j) * LD + dd]);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int col = k_lo + qd + 4 * j;
      bool ok = col < S;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      s[j] = ok ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      Ps[r * LDP + qd + 4 * j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_i = l_i * alpha + sum;
    m_i = m_new;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      acc[m].x *= alpha;
      acc[m].y *= alpha;
      acc[m].z *= alpha;
      acc[m].w *= alpha;
    }
    __syncwarp();  // a row's P is written and read by the same warp

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p = Ps[r * LDP + c];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[c * LD + 4 * (qd + 4 * m)]);
        acc[m].x = fmaf(p, vv.x, acc[m].x);
        acc[m].y = fmaf(p, vv.y, acc[m].y);
        acc[m].z = fmaf(p, vv.z, acc[m].z);
        acc[m].w = fmaf(p, vv.w, acc[m].w);
      }
    }
  }

  if (row >= S) return;
  const float l = fmaxf(l_i, 1e-30f);
  T* dst = op + static_cast<size_t>(row) * D;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = 4 * (qd + 4 * m);
    dst[c + 0] = from_f32<T>(acc[m].x / l);
    dst[c + 1] = from_f32<T>(acc[m].y / l);
    dst[c + 2] = from_f32<T>(acc[m].z / l);
    dst[c + 3] = from_f32<T>(acc[m].w / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, H, S, D); k, v: (B, Hkv, S, D), contiguous. dtype: 0 = float32,
// 1 = bfloat16. D in {64, 128}. Returns cudaGetLastError() after launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int S, int D, int dtype,
                                      float scale, int causal, int window,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, H, Hkv, S, scale, causal, window, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, H, Hkv, S, scale, causal, window,
                              s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, Hkv, S, scale, causal,
                                     window, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, Hkv, S, scale, causal,
                                      window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
