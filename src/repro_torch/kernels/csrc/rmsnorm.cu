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
// Backward (rmsnorm_bwd_launch, rmsnorm_pair_bwd_launch; the TPU reference
// has none: its gradient is XLA's autodiff of the jnp norm). With
// r = 1 / sqrt(mean(x^2) + eps), x^ = x * r and g = dy * scale:
//     dx     = r * (g - x^ * mean(g * x^)) = r * g - x * (r^3 * sum(g*x) / D)
//     dscale = sum over rows of dy * x^          (f32, (D,))
// in one pass that reads x and dy from device memory once. A thread keeps
// its 16-byte packs of a row (x and dy) in registers between the row's two
// sums and its dx (and, holding at most two, loads its next row's
// meanwhile), in the forward's geometry: G = 16 or 32 lanes a row for
// narrow rows (256 / G rows a block), the 256 threads of a block a row
// above, up to kRegMaxD = 8192; wider rows take a branch that
// rereads the row from L2 for dx. Each thread also sums dy * x * r for the
// columns it owns over its rows in f32 registers (the reread branch: in its
// block's row of a global scratch). The grid is sized to the card (as many
// clusters of 8 blocks as it holds at once, or fewer where that leaves each
// block as many runs of rows) and blocks loop over runs of rows, so any row
// count runs. dscale is summed deterministically, with no atomics: the row
// groups of a block in a fixed tree through shared memory; the 8 blocks of
// a thread-block cluster through distributed shared memory, block q summing
// slice q of the columns over the cluster's ranks in order into one partial
// a cluster; then a second, small launch sums the clusters' partials in a
// fixed order into dscale. Partials: 4 * D bytes a cluster and tensor,
// written once and read once (0.66 MB at 512 rows of 5120 on 32 clusters,
// where the pass moves 15.7 MB). The qk-norm's q and k (one row
// width, each its own scale and dscale) share one grid. Every float
// operation is pinned (__fmul_rn, fmaf, ...) so that
// tests/rmsnorm_bwd_emulation.py repeats it in numpy. Bound: bytes, x and
// dy read and dx written once, about 10 flops an element.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

namespace {

namespace cg = cooperative_groups;

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

constexpr int kCluster = 8;          // blocks a cluster, and its slices
constexpr int kLaneRowsMaxD = 512;   // G lanes a row for one tensor
constexpr int kLaneRowsMaxD1 = 128;  // the same, one element a pack
constexpr int kRegMaxD = 8192;       // widest row held in registers
constexpr int kMaxBlocksPerSM = 2048 / kThreads;
constexpr int kWideBlocksPerSM = 2;  // the reread branch's grid

// One tensor of a backward launch: x, dy, dx (rows, D) and its scale and
// dscale (D,).
template <typename T>
struct Bwd {
  const T* x;
  const float* s;
  const T* dy;
  T* dx;
  float* ds;
  long long rows;
};

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

// This thread's share of (sum(x^2), sum(dy*scale*x)) over one pack.
template <typename T, int V>
__device__ __forceinline__ void pack_sums(const Pack<T, V>& p,
                                          const Pack<T, V>& q,
                                          const float (&sv)[V], float2& t) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float f = to_f32(p.v[j]);
    t.x = fmaf(f, f, t.x);
    t.y = fmaf(__fmul_rn(to_f32(q.v[j]), sv[j]), f, t.y);
  }
}

// dx = r * (dy * scale) - x * c over one pack, and acc += dy * (x * r).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> pack_dx(const Pack<T, V>& p,
                                              const Pack<T, V>& q,
                                              const float (&sv)[V], float r,
                                              float c, float (&acc)[V]) {
  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xf = to_f32(p.v[j]), gf = to_f32(q.v[j]);
    o.v[j] = from_f32<T>(fmaf(-xf, c, __fmul_rn(r, __fmul_rn(gf, sv[j]))));
    acc[j] = fmaf(gf, __fmul_rn(xf, r), acc[j]);
  }
  return o;
}

// (r, r^3 * sum(g*x) / D) of a row from its sums.
__device__ __forceinline__ float2 bwd_factors(float2 sums, int D, float eps) {
  const float d = static_cast<float>(D);
  const float r =
      __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sums.x, d), eps)));
  return make_float2(
      r, __fmul_rn(__fmul_rn(__fmul_rn(r, r), r), __fdiv_rn(sums.y, d)));
}

// A butterfly over the G lanes of a row (G <= 32): every lane ends with the
// same sums.
template <int G>
__device__ __forceinline__ float2 lane_sums(float2 t) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    t.x = __fadd_rn(t.x, __shfl_xor_sync(0xffffffffu, t.x, o));
    t.y = __fadd_rn(t.y, __shfl_xor_sync(0xffffffffu, t.y, o));
  }
  return t;
}

// A row's sums over the 256 threads of a block: a butterfly in each warp,
// then the 8 warps' sums in order. wsum alternates between two buffers
// from one row to the next, so one barrier a row suffices.
__device__ __forceinline__ float2 block_sums(float2 t,
                                             float2 (*wsum)[kThreads / 32],
                                             int& parity) {
  t = lane_sums<32>(t);
  if (threadIdx.x % 32 == 0) wsum[parity][threadIdx.x / 32] = t;
  __syncthreads();
  float2 w = wsum[parity][0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) {
    w.x = __fadd_rn(w.x, wsum[parity][i].x);
    w.y = __fadd_rn(w.y, wsum[parity][i].y);
  }
  parity ^= 1;
  return w;
}

// Makes a 16-byte bf16 pack opaque to the compiler, so that it keeps the
// pack's 16 bytes of registers across a row's reduction and converts it to
// f32 again for dx, rather than keeping 32 bytes of f32 alive.
template <typename T, int V>
__device__ __forceinline__ void keep_packed(Pack<T, V>& p) {
  if constexpr (sizeof(T) == 2 && V == 8) {
    uint4 w;
    memcpy(&w, &p, sizeof(w));
    asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
    memcpy(&p, &w, sizeof(w));
  }
}

// Columns of slice q of the cluster's sum: [q * W, min(D, (q + 1) * W)).
__device__ __forceinline__ int2 slice(int D) {
  const int W = (D + kCluster - 1) / kCluster;
  const int q = blockIdx.x % kCluster;
  return make_int2(min(D, q * W), min(D, (q + 1) * W));
}

// Block q of a cluster sums slice q of the cluster's NT block partials
// (rank r's tensor t at src[r] + t * tstride; in device memory, read past
// L1, with GLOBAL) over the ranks in order, into the cluster's partial
// cpart[(cluster * NT + t) * Dp + c].
template <int NT, bool GLOBAL>
__device__ __forceinline__ void cluster_sum(const float* const (&src)[kCluster],
                                            int tstride, int D, int Dp,
                                            float* __restrict__ cpart) {
  const int2 cols = slice(D);
  const long long cid = blockIdx.x / kCluster;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    for (int c = cols.x + threadIdx.x; c < cols.y; c += kThreads) {
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float* p = src[r] + t * tstride + c;
        const float w = GLOBAL ? __ldcg(p) : *p;
        v = r == 0 ? w : __fadd_rn(v, w);
      }
      cpart[(cid * NT + t) * Dp + c] = v;
    }
  }
}

// Where a row group's row of run u lies: which tensor, whether the row
// exists, and its element offset.
struct RowAt {
  bool first, live;
  long long off;
};

template <typename T, bool PAIR>
__device__ __forceinline__ RowAt row_at(const Bwd<T>& a, const Bwd<T>& b,
                                        long long u, int ng, int group,
                                        int D) {
  long long row = u * ng + group;
  RowAt w;
  w.first = !PAIR || row < a.rows;
  if (!w.first) row -= a.rows;
  w.live = row < (w.first ? a.rows : b.rows);
  w.off = (w.live ? row : 0) * D;
  return w;
}

// This lane's packs of the row at w: lane, lane + G, ... (at most PL).
template <typename T, int V, int G, int PL, bool PAIR>
__device__ __forceinline__ void load_row(const Bwd<T>& a, const Bwd<T>& b,
                                         const RowAt& w, int lane, int np,
                                         Pack<T, V> (&px)[PL],
                                         Pack<T, V> (&pg)[PL]) {
  const Pack<T, V>* xp =
      reinterpret_cast<const Pack<T, V>*>((w.first ? a.x : b.x) + w.off);
  const Pack<T, V>* gp =
      reinterpret_cast<const Pack<T, V>*>((w.first ? a.dy : b.dy) + w.off);
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    const int p = lane + k * G;
    if (w.live && p < np) {
      px[k] = xp[p];
      pg[k] = gp[p];
    }
  }
}

// Rows held in registers: G lanes a row (G = 16 or 32 up to kWarpRowsMaxD,
// or G = 256, a block a row, up to kRegMaxD), NG = 256 / G rows a block,
// each lane holding packs lane, lane + G, ... (at most PL) of its row. Run
// u is rows u * NG ... u * NG + NG - 1; block b takes runs b, b + grid, ...
// With PAIR, the rows of a (a.rows) then b share the grid, each tensor
// with its own column sums, which live in the lane's registers. The
// block's column sums (its row groups' in a tree through shared memory)
// then stay in shared memory (buf) for the cluster's sum.
template <typename T, int V, int G, int PL, bool PAIR>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(Bwd<T> a, Bwd<T> b, int D, float eps,
                   float* __restrict__ cpart, int Dp) {
  constexpr int NG = kThreads / G;  // row groups a block
  constexpr int NT = PAIR ? 2 : 1;
  constexpr int DMAX = G * PL * V;  // widest row of this instance
  __shared__ __align__(16) float buf[(NG > 1 ? NG / 2 : 1) * NT * DMAX];
  __shared__ float2 wsum[2][kThreads / 32];
  const int lane = threadIdx.x % G, group = threadIdx.x / G;
  const int np = D / V;
  const long long runs = (a.rows + (PAIR ? b.rows : 0) + NG - 1) / NG;
  float acc[NT][PL][V];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int k = 0; k < PL; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[t][k][j] = 0.0f;
  int parity = 0;
  for (long long u = blockIdx.x; u < runs; u += gridDim.x) {
    const RowAt w = row_at<T, PAIR>(a, b, u, NG, group, D);
    Pack<T, V> px[PL], pg[PL];
    load_row<T, V, G, PL, PAIR>(a, b, w, lane, np, px, pg);
    const float* sp = w.first ? a.s : b.s;
    float2 sums = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      const int p = lane + k * G;
      if (w.live && p < np) {
        float sv[V];
        load_scale<V>(sp, p, sv);
        pack_sums<T, V>(px[k], pg[k], sv, sums);
        keep_packed<T, V>(px[k]);
        keep_packed<T, V>(pg[k]);
      }
    }
    if constexpr (G <= 32) {
      sums = lane_sums<G>(sums);
    } else {
      sums = block_sums(sums, wsum, parity);
    }
    const float2 f = bwd_factors(sums, D, eps);
    Pack<T, V>* dp =
        reinterpret_cast<Pack<T, V>*>((w.first ? a.dx : b.dx) + w.off);
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      const int p = lane + k * G;
      if (w.live && p < np) {
        float sv[V];
        load_scale<V>(sp, p, sv);
        dp[p] = w.first
                    ? pack_dx<T, V>(px[k], pg[k], sv, f.x, f.y, acc[0][k])
                    : pack_dx<T, V>(px[k], pg[k], sv, f.x, f.y, acc[NT - 1][k]);
      }
    }
  }
  // the row groups' sums: groups h .. 2h - 1 hand theirs to groups 0 .. h - 1
  if constexpr (NG > 1) {
#pragma unroll
    for (int h = NG / 2; h > 0; h >>= 1) {
      if (group >= h && group < 2 * h) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int k = 0; k < PL; ++k) {
            const int p = lane + k * G;
            if (p < np) {
#pragma unroll
              for (int j = 0; j < V; ++j)
                buf[((group - h) * NT + t) * DMAX + p * V + j] = acc[t][k][j];
            }
          }
      }
      __syncthreads();
      if (group < h) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int k = 0; k < PL; ++k) {
            const int p = lane + k * G;
            if (p < np) {
#pragma unroll
              for (int j = 0; j < V; ++j)
                acc[t][k][j] = __fadd_rn(
                    acc[t][k][j], buf[(group * NT + t) * DMAX + p * V + j]);
            }
          }
      }
      __syncthreads();
    }
  }
  if (group == 0) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int k = 0; k < PL; ++k) {
        const int p = lane + k * G;
        if (p < np) {
#pragma unroll
          for (int j = 0; j < V; ++j) buf[t * DMAX + p * V + j] = acc[t][k][j];
        }
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* src[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) src[r] = cluster.map_shared_rank(buf, r);
  cluster_sum<NT, false>(src, DMAX, D, Dp, cpart);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Rows wider than kRegMaxD: a block a row, the row read from device memory
// for its sums and reread (from L2, where the first pass left it: 64 KB at
// 16384 bf16 columns) for dx; each thread's column sums go to the block's
// row of bpart (Dp floats), which the cluster then sums from there.
template <typename T, int V>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
rmsnorm_bwd_wide_kernel(Bwd<T> a, int D, float eps, float* __restrict__ bpart,
                        float* __restrict__ cpart, int Dp) {
  __shared__ float2 wsum[2][kThreads / 32];
  const int np = D / V;
  float* bp = bpart + static_cast<long long>(blockIdx.x) * Dp;
  int parity = 0;
  bool started = false;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(a.x + row * D);
    const Pack<T, V>* gp = reinterpret_cast<const Pack<T, V>*>(a.dy + row * D);
    Pack<T, V>* dp = reinterpret_cast<Pack<T, V>*>(a.dx + row * D);
    float2 sums = make_float2(0.0f, 0.0f);
    for (int p = threadIdx.x; p < np; p += kThreads) {
      float sv[V];
      load_scale<V>(a.s, p, sv);
      pack_sums<T, V>(xp[p], gp[p], sv, sums);
    }
    const float2 f = bwd_factors(block_sums(sums, wsum, parity), D, eps);
    for (int p = threadIdx.x; p < np; p += kThreads) {
      float sv[V], acc[V];
      load_scale<V>(a.s, p, sv);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = started ? bp[p * V + j] : 0.0f;
      dp[p] = pack_dx<T, V>(xp[p], gp[p], sv, f.x, f.y, acc);
#pragma unroll
      for (int j = 0; j < V; ++j) bp[p * V + j] = acc[j];
    }
    started = true;
  }
  if (!started) {
    for (int c = threadIdx.x; c < D; c += kThreads) bp[c] = 0.0f;
  }
  __threadfence();
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const long long base = blockIdx.x / kCluster * kCluster;
  const float* src[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) src[r] = bpart + (base + r) * Dp;
  cluster_sum<1, true>(src, 0, D, Dp, cpart);
}

// The second launch: dscale of tensor blockIdx.y (ds0 or ds1) over columns
// blockIdx.x * 128 ..., from the clusters' partials. Warp ty sums partials
// ty, ty + 8, ... of 4 columns a lane in order; the 8 warps' sums are then
// added in warp order.
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_sum_kernel(const float* __restrict__ cpart, int nclusters,
                          int nt, int D, int Dp, float* __restrict__ ds0,
                          float* __restrict__ ds1) {
  __shared__ float4 red[kThreads / 32][32];
  const int t = blockIdx.y, tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col = blockIdx.x * 128 + 4 * tx;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col < D) {
#pragma unroll 4
    for (int j = ty; j < nclusters; j += kThreads / 32) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          cpart + (static_cast<long long>(j) * nt + t) * Dp + col));
      s.x = __fadd_rn(s.x, v.x);
      s.y = __fadd_rn(s.y, v.y);
      s.z = __fadd_rn(s.z, v.z);
      s.w = __fadd_rn(s.w, v.w);
    }
  }
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < D) {
    float4 v = red[0][tx];
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k) {
      const float4 w = red[k][tx];
      v.x = __fadd_rn(v.x, w.x);
      v.y = __fadd_rn(v.y, w.y);
      v.z = __fadd_rn(v.z, w.z);
      v.w = __fadd_rn(v.w, w.w);
    }
    const float o[4] = {v.x, v.y, v.z, v.w};
    float* ds = t == 0 ? ds0 : ds1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < D) ds[col + e] = o[e];
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// The clusters of a kernel that the card holds at once.
template <typename K>
int active_clusters(K kernel) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return n;
}

// The grid for `units` runs of rows at most `clusters` clusters hold: as
// few whole clusters as give each block the fewest runs.
long long bwd_grid(long long units, long long clusters) {
  const long long cap = kCluster * std::max(1LL, clusters);
  const long long runs = (units + cap - 1) / cap;  // runs a block
  const long long blocks = (units + runs - 1) / runs;
  return (blocks + kCluster - 1) / kCluster * kCluster;
}

int padded(int D) { return (D + 3) / 4 * 4; }

// With plan non-null, write {V, G, PL, grid, reread} there and launch
// nothing.
cudaError_t planned(int* plan, int V, int G, int PL, long long grid,
                    int reread) {
  const int v[5] = {V, G, PL, static_cast<int>(grid), reread};
  memcpy(plan, v, sizeof(v));
  return cudaSuccess;
}

// The second launch, after the first's error check.
cudaError_t launch_dscale_sum(cudaError_t err, const float* cpart,
                              long long grid, int nt, int D, float* ds0,
                              float* ds1, cudaStream_t st) {
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_sum_kernel<<<dim3((D + 127) / 128, nt), kThreads, 0, st>>>(
      cpart, static_cast<int>(grid / kCluster), nt, D, padded(D), ds0, ds1);
  return cudaGetLastError();
}

template <typename T, int V, int G, int PL, bool PAIR>
cudaError_t launch_bwd_rows(const Bwd<T>& a, const Bwd<T>& b, int D,
                            float eps, float* scratch, long long floats,
                            cudaStream_t st, int* plan) {
  const auto kernel = rmsnorm_bwd_kernel<T, V, G, PL, PAIR>;
  static const int clusters = active_clusters(kernel);
  constexpr int NG = kThreads / G;
  const long long grid = bwd_grid((a.rows + b.rows + NG - 1) / NG, clusters);
  if (plan) return planned(plan, V, G, PL, grid, 0);
  if (grid / kCluster * (PAIR ? 2 : 1) * padded(D) > floats) {
    return cudaErrorInvalidValue;
  }
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(a, b, D, eps,
                                                            scratch, padded(D));
  return launch_dscale_sum(cudaGetLastError(), scratch, grid, PAIR ? 2 : 1, D,
                           a.ds, b.ds, st);
}

template <typename T, int V>
cudaError_t launch_bwd_wide(const Bwd<T>& a, int D, float eps,
                            float* scratch, long long floats, cudaStream_t st,
                            int* plan) {
  const long long grid =
      bwd_grid(a.rows, 1LL * sm_count() * kWideBlocksPerSM / kCluster);
  if (plan) return planned(plan, V, kThreads, 0, grid, 1);
  const long long cp = grid / kCluster * padded(D);
  if (cp + grid * padded(D) > floats) return cudaErrorInvalidValue;
  rmsnorm_bwd_wide_kernel<T, V><<<static_cast<unsigned>(grid), kThreads, 0,
                                  st>>>(a, D, eps, scratch + cp, scratch,
                                        padded(D));
  return launch_dscale_sum(cudaGetLastError(), scratch, grid, 1, D, a.ds,
                           nullptr, st);
}

// G = 16 lanes a row when a row is at most 16 packs, else 32, with PL
// packs a lane; one element a "pack" unless vec. The pair takes rows up to
// kWarpRowsMaxD; a single tensor up to kLaneRowsMaxD (16-byte packs) or
// kLaneRowsMaxD1 (one element a pack), above which a block a row keeps
// more of the card busy.
template <typename T, bool PAIR>
cudaError_t dispatch_bwd_rows(const Bwd<T>& a, const Bwd<T>& b, bool vec,
                              int D, float eps, float* scratch,
                              long long floats, cudaStream_t st, int* plan) {
  constexpr int V = 16 / sizeof(T);
#define RMSNORM_BWD_ROWS(VV, GG, PP)                                       \
  return launch_bwd_rows<T, VV, GG, PP, PAIR>(a, b, D, eps, scratch, floats, \
                                              st, plan)
  if (vec) {
    const int np = D / V;
    if (np <= 16) RMSNORM_BWD_ROWS(V, 16, 1);
    if (np <= 32) RMSNORM_BWD_ROWS(V, 32, 1);
    if (np <= 64) RMSNORM_BWD_ROWS(V, 32, 2);
    if constexpr (PAIR || sizeof(T) == 4) {
      if (np <= 128) RMSNORM_BWD_ROWS(V, 32, 4);
    }
    if constexpr (PAIR && sizeof(T) == 4) RMSNORM_BWD_ROWS(V, 32, 8);
    return cudaErrorInvalidValue;
  }
  if (D <= 128) RMSNORM_BWD_ROWS(1, 32, 4);
  if constexpr (PAIR) RMSNORM_BWD_ROWS(1, 32, 32);
  return cudaErrorInvalidValue;
#undef RMSNORM_BWD_ROWS
}

// One tensor: rows of D <= kLaneRowsMaxD as above, a block a row up to
// kRegMaxD (PL packs a thread), the reread branch above.
template <typename T>
cudaError_t dispatch_bwd(const Bwd<T>& a, int D, float eps, float* scratch,
                         long long floats, cudaStream_t st, int* plan) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(a.x, a.s, a.dy, a.dx) && D % V == 0;
  const Bwd<T> none{};
  if (D <= (vec ? kLaneRowsMaxD : kLaneRowsMaxD1)) {
    return dispatch_bwd_rows<T, false>(a, none, vec, D, eps, scratch, floats,
                                       st, plan);
  }
#define RMSNORM_BWD_BLOCK(VV, PP)                                          \
  return launch_bwd_rows<T, VV, kThreads, PP, false>(                      \
      a, none, D, eps, scratch, floats, st, plan)
  if (D <= kRegMaxD) {
    if (vec) {
      const int np = (D / V + kThreads - 1) / kThreads;  // packs a thread
      if constexpr (sizeof(T) == 2) {
        if (np <= 1) RMSNORM_BWD_BLOCK(V, 1);
        if (np <= 2) RMSNORM_BWD_BLOCK(V, 2);
        if (np <= 3) RMSNORM_BWD_BLOCK(V, 3);
        RMSNORM_BWD_BLOCK(V, 4);
      } else {
        if (np <= 2) RMSNORM_BWD_BLOCK(V, 2);
        if (np <= 3) RMSNORM_BWD_BLOCK(V, 3);
        if (np <= 4) RMSNORM_BWD_BLOCK(V, 4);
        if (np <= 6) RMSNORM_BWD_BLOCK(V, 6);
        RMSNORM_BWD_BLOCK(V, 8);
      }
    }
    if (D <= 8 * kThreads) RMSNORM_BWD_BLOCK(1, 8);
    RMSNORM_BWD_BLOCK(1, 32);
  }
#undef RMSNORM_BWD_BLOCK
  if (vec) return launch_bwd_wide<T, V>(a, D, eps, scratch, floats, st, plan);
  return launch_bwd_wide<T, 1>(a, D, eps, scratch, floats, st, plan);
}

template <typename T>
Bwd<T> bwd_tensor(const void* x, const void* s, const void* dy, void* dx,
                  void* ds, long long rows) {
  return Bwd<T>{static_cast<const T*>(x), static_cast<const float*>(s),
                static_cast<const T*>(dy), static_cast<T*>(dx),
                static_cast<float*>(ds), rows};
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

// The f32 scratch (floats) of a backward launch over `rows` rows of width D
// (pair: the qk-norm's q and k rows together): the clusters' partials,
// and for rows wider than kRegMaxD the blocks' too. An upper bound over the
// kernels the launch may choose (at most kMaxBlocksPerSM blocks an SM).
extern "C" long long rmsnorm_bwd_scratch_floats(long long rows, int D,
                                                int pair) {
  if (rows <= 0 || D <= 0) return 0;
  if (D > kRegMaxD) {
    const long long grid =
        bwd_grid(rows, 1LL * sm_count() * kWideBlocksPerSM / kCluster);
    return (grid / kCluster + grid) * padded(D);
  }
  const int rows_a_block =
      D <= (pair ? kWarpRowsMaxD : kLaneRowsMaxD1) ? kThreads / 32 : 1;
  return bwd_grid((rows + rows_a_block - 1) / rows_a_block,
                  1LL * sm_count() * kMaxBlocksPerSM / kCluster) /
         kCluster * (pair ? 2 : 1) * padded(D);
}

// The backward of rmsnorm_launch: x, dy, dx (rows, D) contiguous in one
// dtype (0 = float32, 1 = bfloat16); scale (D,) f32; dscale (D,) f32,
// written whole; scratch an f32 buffer of `floats` >=
// rmsnorm_bwd_scratch_floats(rows, D, 0) floats, 16-byte aligned. Two
// launches: the pass over the rows, and the sum of its clusters'
// partials into dscale. With `plan` non-null nothing is launched and
// plan receives the first launch's {V (elements a pack), G (lanes a
// row), PL (packs a lane at most), grid, 1 if the row is reread for dx
// else 0}. Returns cudaGetLastError() after the launches.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* dy, void* dx, void* dscale,
                                  void* scratch, long long floats,
                                  long long rows, int D, int dtype, float eps,
                                  void* stream, int* plan) {
  if (rows <= 0 || D <= 0 || reinterpret_cast<uintptr_t>(scratch) % 16 ||
      floats < rmsnorm_bwd_scratch_floats(rows, D, 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_bwd<float>(
        bwd_tensor<float>(x, scale, dy, dx, dscale, rows), D, eps, sc,
        floats, st, plan);
  } else if (dtype == 1) {
    err = dispatch_bwd<__nv_bfloat16>(
        bwd_tensor<__nv_bfloat16>(x, scale, dy, dx, dscale, rows), D, eps,
        sc, floats, st, plan);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename T>
cudaError_t bwd_pair(const void* xq, const void* sq, const void* dyq,
                     void* dxq, void* dsq, long long rows_q, const void* xk,
                     const void* sk, const void* dyk, void* dxk, void* dsk,
                     long long rows_k, void* scratch, long long floats, int D,
                     float eps, cudaStream_t st, int* plan) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(xq, sq, dyq, dxq, xk, sk, dyk, dxk) && D % V == 0;
  return dispatch_bwd_rows<T, true>(
      bwd_tensor<T>(xq, sq, dyq, dxq, dsq, rows_q),
      bwd_tensor<T>(xk, sk, dyk, dxk, dsk, rows_k), vec, D, eps,
      static_cast<float*>(scratch), floats, st, plan);
}

// The backward of rmsnorm_pair_launch: q's rows (xq, dyq, dxq: (rows_q,
// D), scale sq, dscale dsq) and k's (rows_k) share one grid, D <= 1024;
// scratch >= rmsnorm_bwd_scratch_floats(rows_q + rows_k, D, 1) floats;
// plan as for rmsnorm_bwd_launch. Returns cudaGetLastError() after the
// launches.
extern "C" int rmsnorm_pair_bwd_launch(
    const void* xq, const void* sq, const void* dyq, void* dxq, void* dsq,
    long long rows_q, const void* xk, const void* sk, const void* dyk,
    void* dxk, void* dsk, long long rows_k, void* scratch, long long floats,
    int D, int dtype, float eps, void* stream, int* plan) {
  if (rows_q < 0 || rows_k < 0 || rows_q + rows_k <= 0 || D <= 0 ||
      D > kWarpRowsMaxD || reinterpret_cast<uintptr_t>(scratch) % 16 ||
      floats < rmsnorm_bwd_scratch_floats(rows_q + rows_k, D, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd_pair<float>(xq, sq, dyq, dxq, dsq, rows_q, xk, sk, dyk, dxk,
                          dsk, rows_k, scratch, floats, D, eps, st, plan);
  } else if (dtype == 1) {
    err = bwd_pair<__nv_bfloat16>(xq, sq, dyq, dxq, dsq, rows_q, xk, sk, dyk,
                                  dxk, dsk, rows_k, scratch, floats, D, eps,
                                  st, plan);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
