// RMSNorm kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm (body
// _rmsnorm_kernel): over the last dim D of x,
//     y = x * rsqrt(mean(x^2) + eps) * scale
// with the math in f32, in that order, and y in x's type. scale is (D,) f32.
//
// Design. The TPU kernel normalised blocks of 128 rows in VMEM and padded
// the row count to a whole block. Here rows are independent. A row of
// D <= 1024 (the qk-norm's rows of d_head = 128) is owned by G lanes, 16 or
// 32: at D = 128 a bf16 row is 16 lanes of 16 bytes, so a half-warp owns a
// row (two rows a warp, the sum reduced by shuffles over 8, 4, 2, 1 lanes),
// and f32 rows of 128 fill a warp. One block of 256 threads owns a row when
// D is wider (the block norms' rows of d_model = 5120), its warps' sums
// reduced through shared memory. Loads and stores are 16 bytes a thread
// (4 f32 or 8 bf16) when D is a multiple of that width and every pointer is
// 16-byte aligned, and one element a thread otherwise. A row past the last
// is masked, so any row count runs with no padding copy.
//
// rmsnorm_pair_launch norms two tensors of the same row width D <= 1024,
// each with its own scale, in one grid: the q-norm and k-norm of an
// attention layer. rmsnorm_launch takes the same kernel with an empty
// second tensor for D <= 1024, and the block-per-row kernel above that.
//
// Bound on this card: bytes. x is read once from device memory and y
// written once (the second pass over a row re-reads it from L1/L2, where
// the first pass left it: 10 KB for a bf16 row of 5120), at 3 flops an
// element.
//
// Backward (rmsnorm_bwd_launch; the TPU reference has none: its gradient is
// XLA's autodiff of the jnp norm). With r = rsqrt(mean(x^2) + eps),
// x^ = x * r and g = dy * scale:
//     dx     = r * (g - x^ * mean(g * x^)) = r * g - x * (r^3 * sum(g*x) / D)
//     dscale = sum over rows of dy * x^          (f32, (D,))
// in three launches, deterministic (no atomics): (1) dx in the forward's
// geometry (G lanes a row up to D = 1024, a block a row above), each row's
// sum(x^2) and sum(g*x) in one pass and dx in a second, and the row's r into
// an f32 scratch; (2) blocks of 32 columns by 8 row lanes sum dy * x * r
// over chunks of kChunkRows rows into a (chunks, D) f32 scratch; (3) one
// thread a column sums its chunks in order into dscale. Bound: bytes, x and
// dy read and dx written once (launch 2 re-reads x and dy, from L2 at the
// model's shapes), about 10 flops an element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowsMaxD = 1024;

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

// V consecutive elements, loaded and stored as one access of V*sizeof(T)
// bytes (16 bytes, or one element when V = 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// This thread's share of sum(x^2) over one row, threads tid, tid + n, ...
template <typename T, int V>
__device__ __forceinline__ float row_sumsq(const T* __restrict__ xr, int D,
                                           int tid, int n) {
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(xr);
  float ss = 0.0f;
  for (int i = tid; i < D / V; i += n) {
    const Pack<T, V> p = xp[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(p.v[j]);
      ss = fmaf(f, f, ss);
    }
  }
  return ss;
}

// y = (x * r) * scale over one row, threads tid, tid + n, ...
template <typename T, int V>
__device__ __forceinline__ void row_scale(const T* __restrict__ xr,
                                          const float* __restrict__ s,
                                          T* __restrict__ yr, int D, float r,
                                          int tid, int n) {
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(xr);
  Pack<T, V>* yp = reinterpret_cast<Pack<T, V>*>(yr);
  for (int i = tid; i < D / V; i += n) {
    const Pack<T, V> p = xp[i];
    float sv[V];
    if constexpr (V % 4 == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(s + i * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        const float4 t = s4[j];
        sv[4 * j] = t.x;
        sv[4 * j + 1] = t.y;
        sv[4 * j + 2] = t.z;
        sv[4 * j + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) sv[j] = s[i * V + j];
    }
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o.v[j] = from_f32<T>((to_f32(p.v[j]) * r) * sv[j]);
    }
    yp[i] = o;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ s,
                     T* __restrict__ y, int D, float eps) {
  __shared__ float warp_ss[kThreads / 32];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const T* xr = x + row * D;
  const float ss = warp_sum(row_sumsq<T, V>(xr, D, threadIdx.x, kThreads));
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const float t = warp_sum(lane < kThreads / 32 ? warp_ss[lane] : 0.0f);
    if (lane == 0) warp_ss[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(warp_ss[0] / static_cast<float>(D) + eps);
  row_scale<T, V>(xr, s, y + row * D, D, r, threadIdx.x, kThreads);
}

// The rows of two tensors (x0: rows0 rows, then x1), G lanes a row (16 or
// 32), kThreads / G rows to a block. Lanes of a row past the last still
// take part in the shuffles, with nothing loaded or stored.
template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads)
rmsnorm_pair_kernel(const T* __restrict__ x0, const float* __restrict__ s0,
                    T* __restrict__ y0, long long rows0,
                    const T* __restrict__ x1, const float* __restrict__ s1,
                    T* __restrict__ y1, long long rows1, int D, float eps) {
  const int lane = threadIdx.x % G;
  long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool first = row < rows0;
  if (!first) row -= rows0;
  const bool live = first || row < rows1;
  const T* xr = (first ? x0 : x1) + row * D;
  float ss = live ? row_sumsq<T, V>(xr, D, lane, G) : 0.0f;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
  row_scale<T, V>(xr, first ? s0 : s1, (first ? y0 : y1) + row * D, D, r,
                  lane, G);
}

// True when every pointer is 16-byte aligned.
template <typename... P>
bool aligned16(P... p) {
  return ((reinterpret_cast<uintptr_t>(p) | ...) % 16) == 0;
}

template <typename T, int V, int G>
cudaError_t launch_pair(const void* x0, const void* s0, void* y0,
                        long long rows0, const void* x1, const void* s1,
                        void* y1, long long rows1, int D, float eps,
                        cudaStream_t st) {
  const long long rows = rows0 + rows1;
  const long long blocks = (rows + kThreads / G - 1) / (kThreads / G);
  rmsnorm_pair_kernel<T, V, G><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(
      static_cast<const T*>(x0), static_cast<const float*>(s0),
      static_cast<T*>(y0), rows0, static_cast<const T*>(x1),
      static_cast<const float*>(s1), static_cast<T*>(y1), rows1, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pair(const void* x0, const void* s0, void* y0,
                          long long rows0, const void* x1, const void* s1,
                          void* y1, long long rows1, int D, float eps,
                          cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x0, s0, y0, x1, s1, y1) && D % V == 0) {
    if (D / V <= 16) {
      return launch_pair<T, V, 16>(x0, s0, y0, rows0, x1, s1, y1, rows1, D,
                                   eps, st);
    }
    return launch_pair<T, V, 32>(x0, s0, y0, rows0, x1, s1, y1, rows1, D, eps,
                                 st);
  }
  return launch_pair<T, 1, 32>(x0, s0, y0, rows0, x1, s1, y1, rows1, D, eps,
                               st);
}

template <typename T, int V>
cudaError_t launch_block(const void* x, const void* s, void* y,
                         long long rows, int D, float eps, cudaStream_t st) {
  rmsnorm_block_kernel<T, V><<<static_cast<unsigned>(rows), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<T*>(y), D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* s, void* y, long long rows,
                     int D, float eps, cudaStream_t st) {
  if (D <= kWarpRowsMaxD) {
    return dispatch_pair<T>(x, s, y, rows, x, s, y, 0, D, eps, st);
  }
  constexpr int V = 16 / sizeof(T);
  if (aligned16(x, s, y) && D % V == 0) {
    return launch_block<T, V>(x, s, y, rows, D, eps, st);
  }
  return launch_block<T, 1>(x, s, y, rows, D, eps, st);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kChunkRows = 64;  // rows a block of launch 2 sums

// The V scale values of pack i.
template <int V>
__device__ __forceinline__ void load_scale(const float* __restrict__ s, int i,
                                           float (&sv)[V]) {
  if constexpr (V % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(s + i * V);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 t = s4[j];
      sv[4 * j] = t.x;
      sv[4 * j + 1] = t.y;
      sv[4 * j + 2] = t.z;
      sv[4 * j + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) sv[j] = s[i * V + j];
  }
}

// This thread's share of (sum(x^2), sum(dy*scale*x)) over one row.
template <typename T, int V>
__device__ __forceinline__ float2 row_sums_bwd(const T* __restrict__ xr,
                                               const T* __restrict__ dyr,
                                               const float* __restrict__ s,
                                               int D, int tid, int n) {
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(xr);
  const Pack<T, V>* gp = reinterpret_cast<const Pack<T, V>*>(dyr);
  float ss = 0.0f, sg = 0.0f;
  for (int i = tid; i < D / V; i += n) {
    const Pack<T, V> p = xp[i];
    const Pack<T, V> q = gp[i];
    float sv[V];
    load_scale<V>(s, i, sv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(p.v[j]);
      ss = fmaf(f, f, ss);
      sg = fmaf(to_f32(q.v[j]) * sv[j], f, sg);
    }
  }
  return make_float2(ss, sg);
}

// dx = r * (dy * scale) - x * c over one row, threads tid, tid + n, ...
template <typename T, int V>
__device__ __forceinline__ void row_dx(const T* __restrict__ xr,
                                       const T* __restrict__ dyr,
                                       const float* __restrict__ s,
                                       T* __restrict__ dxr, int D, float r,
                                       float c, int tid, int n) {
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(xr);
  const Pack<T, V>* gp = reinterpret_cast<const Pack<T, V>*>(dyr);
  Pack<T, V>* dp = reinterpret_cast<Pack<T, V>*>(dxr);
  for (int i = tid; i < D / V; i += n) {
    const Pack<T, V> p = xp[i];
    const Pack<T, V> q = gp[i];
    float sv[V];
    load_scale<V>(s, i, sv);
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o.v[j] = from_f32<T>(r * (to_f32(q.v[j]) * sv[j]) -
                           to_f32(p.v[j]) * c);
    }
    dp[i] = o;
  }
}

// (r, r^3 * sum(g*x) / D) of a row from its sums.
__device__ __forceinline__ float2 bwd_factors(float2 sums, int D, float eps) {
  const float r = rsqrtf(sums.x / static_cast<float>(D) + eps);
  return make_float2(r, r * r * r * sums.y / static_cast<float>(D));
}

// Launch 1 for wide rows: one block a row.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ s, T* __restrict__ dx,
                         float* __restrict__ rstd, int D, float eps) {
  __shared__ float2 warp_sums[kThreads / 32];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const T* xr = x + row * D;
  const T* gr = dy + row * D;
  float2 t = row_sums_bwd<T, V>(xr, gr, s, D, threadIdx.x, kThreads);
  t.x = warp_sum(t.x);
  t.y = warp_sum(t.y);
  if (lane == 0) warp_sums[warp] = t;
  __syncthreads();
  if (warp == 0) {
    const float2 w = lane < kThreads / 32 ? warp_sums[lane]
                                          : make_float2(0.0f, 0.0f);
    const float a = warp_sum(w.x), b = warp_sum(w.y);
    if (lane == 0) warp_sums[0] = make_float2(a, b);
  }
  __syncthreads();
  const float2 f = bwd_factors(warp_sums[0], D, eps);
  if (threadIdx.x == 0) rstd[row] = f.x;
  row_dx<T, V>(xr, gr, s, dx + row * D, D, f.x, f.y, threadIdx.x, kThreads);
}

// Launch 1 for rows of D <= 1024: G lanes a row, kThreads / G rows a block.
template <typename T, int V, int G>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const float* __restrict__ s, T* __restrict__ dx,
                        float* __restrict__ rstd, long long rows, int D,
                        float eps) {
  const int lane = threadIdx.x % G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * D;
  const T* gr = dy + (live ? row : 0) * D;
  float2 t = live ? row_sums_bwd<T, V>(xr, gr, s, D, lane, G)
                  : make_float2(0.0f, 0.0f);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
  }
  if (!live) return;
  const float2 f = bwd_factors(t, D, eps);
  if (lane == 0) rstd[row] = f.x;
  row_dx<T, V>(xr, gr, s, dx + row * D, D, f.x, f.y, lane, G);
}

// Launch 2: partial[chunk][c] = sum over the chunk's rows of dy*x*r, for
// the 32 columns of this block; 8 row lanes, summed through shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ dy,
                              const float* __restrict__ rstd,
                              float* __restrict__ partial, long long rows,
                              int D) {
  __shared__ float acc_s[kThreads / 32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * kChunkRows;
  const long long r1 = min(rows, r0 + kChunkRows);
  float acc = 0.0f;
  if (col < D) {
    for (long long row = r0 + ty; row < r1; row += kThreads / 32) {
      const long long e = row * D + col;
      acc = fmaf(to_f32(dy[e]) * to_f32(x[e]), rstd[row], acc);
    }
  }
  acc_s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < D) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < kThreads / 32; ++j) t += acc_s[j][tx];
    partial[static_cast<long long>(blockIdx.y) * D + col] = t;
  }
}

// Launch 3: dscale[c] = sum of partial[0..chunks)[c], in chunk order.
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_reduce_kernel(const float* __restrict__ partial,
                             float* __restrict__ dscale, int chunks, int D) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  float t = 0.0f;
  for (int j = 0; j < chunks; ++j)
    t += partial[static_cast<long long>(j) * D + col];
  dscale[col] = t;
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* s, const void* dy,
                         void* dx, float* dscale, float* rstd,
                         float* partial, long long rows, int D, float eps,
                         cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  const float* sp = static_cast<const float*>(s);
  T* dp = static_cast<T*>(dx);
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(x, s, dy, dx) && D % V == 0;
  if (D <= kWarpRowsMaxD) {
    const int G = vec && D / V <= 16 ? 16 : 32;
    const long long blocks = (rows + kThreads / G - 1) / (kThreads / G);
    const unsigned nb = static_cast<unsigned>(blocks);
    if (vec && G == 16)
      rmsnorm_bwd_rows_kernel<T, V, 16><<<nb, kThreads, 0, st>>>(
          xp, gp, sp, dp, rstd, rows, D, eps);
    else if (vec)
      rmsnorm_bwd_rows_kernel<T, V, 32><<<nb, kThreads, 0, st>>>(
          xp, gp, sp, dp, rstd, rows, D, eps);
    else
      rmsnorm_bwd_rows_kernel<T, 1, 32><<<nb, kThreads, 0, st>>>(
          xp, gp, sp, dp, rstd, rows, D, eps);
  } else if (vec) {
    rmsnorm_bwd_block_kernel<T, V><<<static_cast<unsigned>(rows), kThreads,
                                     0, st>>>(xp, gp, sp, dp, rstd, D, eps);
  } else {
    rmsnorm_bwd_block_kernel<T, 1><<<static_cast<unsigned>(rows), kThreads,
                                     0, st>>>(xp, gp, sp, dp, rstd, D, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunks = static_cast<int>((rows + kChunkRows - 1) / kChunkRows);
  rmsnorm_dscale_partial_kernel<T><<<dim3((D + 31) / 32, chunks), kThreads, 0,
                                     st>>>(xp, gp, rstd, partial, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_reduce_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0,
                                 st>>>(partial, dscale, chunks, D);
  return cudaGetLastError();
}

}  // namespace

// x, y: (rows, D) contiguous; scale: (D,) f32. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int D, int dtype, float eps,
                              void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(x, scale, y, rows, D, eps, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, scale, y, rows, D, eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Two tensors of row width D <= 1024 and one dtype in one launch: xq, yq
// (rows_q, D) with scale sq, and xk, yk (rows_k, D) with scale sk.
extern "C" int rmsnorm_pair_launch(const void* xq, const void* sq, void* yq,
                                   long long rows_q, const void* xk,
                                   const void* sk, void* yk, long long rows_k,
                                   int D, int dtype, float eps, void* stream) {
  if (rows_q < 0 || rows_k < 0 || rows_q + rows_k <= 0 || D <= 0 ||
      D > kWarpRowsMaxD || rows_q + rows_k > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_pair<float>(xq, sq, yq, rows_q, xk, sk, yk, rows_k, D, eps,
                               st);
  } else if (dtype == 1) {
    err = dispatch_pair<__nv_bfloat16>(xq, sq, yq, rows_q, xk, sk, yk, rows_k,
                                       D, eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The rows a block of the backward's second launch sums: the scratch of
// rmsnorm_bwd_launch holds ceil(rows / this) rows of D floats.
extern "C" int rmsnorm_bwd_chunk_rows() { return kChunkRows; }

// The backward of rmsnorm_launch: x, dy, dx (rows, D) contiguous in one
// dtype (0 = float32, 1 = bfloat16); scale (D,) f32; dscale (D,) f32
// output; rstd a (rows,) f32 scratch, partial a (ceil(rows /
// rmsnorm_bwd_chunk_rows()), D) f32 scratch. Three launches; returns
// cudaGetLastError() after them.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* rstd, void* partial, long long rows,
                                  int D, int dtype, float eps, void* stream) {
  if (rows <= 0 || D <= 0 || rows > 0x7FFFFFFFLL ||
      (rows + kChunkRows - 1) / kChunkRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dscale);
  float* rs = static_cast<float*>(rstd);
  float* pt = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_bwd<float>(x, scale, dy, dx, ds, rs, pt, rows, D, eps, st);
  } else if (dtype == 1) {
    err = dispatch_bwd<__nv_bfloat16>(x, scale, dy, dx, ds, rs, pt, rows, D,
                                      eps, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
