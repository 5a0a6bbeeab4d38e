// Flash-attention backward for Hopper (sm_90a), on the CUDA cores.
//
// The gradient of flash_attention.cu's forward (causal and/or sliding-window
// attention with GQA): given q, k, v, the output o, each row's log-sum-exp
// (the forward's lse output) and dO, it computes dq, dk and dv. The TPU
// reference has no backward kernel: its gradients come from XLA's autodiff
// of the einsum attention (src/repro/models/attention.py:gqa_attention).
// The function is FlashAttention-2's backward, with the probabilities
// recomputed from the lse and never stored:
//
//   P   = exp(q·kᵀ·scale - lse)      (0 where masked)
//   dV  = Pᵀ·dO                       summed over the heads of a kv group
//   dP  = dO·vᵀ,  Δ = rowsum(dO ∘ o)
//   dS  = P ∘ (dP - Δ)
//   dQ  = dS·k·scale,  dK = dSᵀ·q·scale   (dK summed over the group)
//
// Three launches, all deterministic (no atomics):
//  1. flash_bwd_delta_kernel: Δ for every row, one warp a row, into a
//     (B, H, S) f32 scratch.
//  2. flash_bwd_dkdv_kernel: one block per (batch, kv head, 64-row key
//     tile). The block holds its K and V tile and loops over the G query
//     heads of its kv group and over the query tiles the causal mask and
//     window let see its keys, accumulating dK and dV in registers; each is
//     written once. GQA needs no second reduction.
//  3. flash_bwd_dq_kernel: one block per (batch, head, 64-row query tile),
//     looping over the key tiles its rows see, accumulating dQ in
//     registers.
//
// Math in f32 throughout: inputs (f32 or bf16) are widened as they are
// copied into shared memory, and gradients are written in the inputs'
// type. Every product is a 64-row tile product out of shared memory on the
// CUDA cores (mm_acc below: each of 256 threads owns a 4 x 4 or 4 x 8
// piece of the result, its rows and columns 16 apart so that a warp reads
// distinct banks or one broadcast address). Tiles are padded by one float
// a row for the same reason.
//
// Bound on an H100 SXM (its 700 W limit). At S = 512 a call reads q, k, v,
// o, dO and the lse and writes dq, dk and dv once: at qwen3-14b's
// (1, 40, 512, 128) with 8 kv heads in bf16 about 25 MB, 7.5 us at
// 3.35 TB/s, against 10·d flops per unmasked (query, key) pair (S, dP,
// dV, dK and dQ at 2·d each; dP and S are computed twice, once by each of
// kernels 2 and 3, which the bound does not count), 6.8 us of bf16
// tensor-core work at 989 TFLOP/s. This
// kernel runs on the CUDA cores and reads its operands from shared memory
// one float at a time: it is bound by shared-memory issue, far from
// either. Moving its products to the tensor cores (mma.sync or wgmma) is
// later work.
//
// q, k, v, o and dO come with (batch, head, row) element strides and a unit
// stride along d, as the forward takes them: the model hands V and the
// incoming gradient over as strided views of (B, S, heads, d) buffers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kB = 64;         // rows of a query tile and of a key tile
constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 tile

struct Strides {
  long long b, h, r;  // element strides along (batch, head, row)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Rows [row0, row0 + kB) of an (S, D) matrix with row stride sr, widened to
// f32, into a shared tile of row stride D + 1; rows at or past S are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long sr, int row0, int S) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? to_f32(src[row * sr + c]) : 0.f;
  }
}

// c += A·B for this thread's piece of a (64 x TN·TX) result: A(i, k) =
// A[i·a_i + k·a_k], B(k, j) = B[k·b_k + j·b_j]. Thread t owns rows
// t / TX + 16·m (m < 4) and columns t % TX + TX·n (n < TN).
template <int TN, int TX>
__device__ __forceinline__ void mm_acc(float (&c)[4][TN],
                                       const float* __restrict__ A, int a_i,
                                       int a_k, const float* __restrict__ Bm,
                                       int b_k, int b_j, int K) {
  constexpr int TY = kThreads / TX;
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[TN];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = A[(ty + TY * m) * a_i + k * a_k];
#pragma unroll
    for (int n = 0; n < TN; ++n) b[n] = Bm[k * b_k + (tx + TX * n) * b_j];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) c[m][n] = fmaf(a[m], b[n], c[m][n]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[4][N]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) c[m][n] = 0.f;
}

// Shared tiles of both block kernels: Q, dO, K and V (64 x (D + 1)), P and
// dS (64 x 65), and the lse and Δ of the query tile's rows.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB);
}

// For the query tile at q_lo and the key tile at k_lo (Qs, dOs, Ks, Vs and
// the tile's lse and Δ in shared memory): P and dS into Ps and dSs, both
// [query][key] with row stride kB + 1. Masked pairs and rows or columns at
// or past S get P = dS = 0.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* dl_s,
                                       float* Ps, float* dSs, int q_lo,
                                       int k_lo, int S, float scale,
                                       int causal, int window) {
  float s[4][4], dp[4][4];
  zero(s);
  zero(dp);
  // S = Q·Kᵀ and dP = dO·Vᵀ: B(k, j) = K[j][k]
  mm_acc<4, 16>(s, Qs, D + 1, 1, Ks, 1, D + 1, D);
  mm_acc<4, 16>(dp, dOs, D + 1, 1, Vs, 1, D + 1, D);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = ty + 16 * m;
    const int row = q_lo + i;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = tx + 16 * n;
      const int col = k_lo + j;
      bool ok = row < S && col < S;
      if (causal) ok = ok && col <= row;
      if (window > 0) ok = ok && (row - col) < window;
      const float p = ok ? expf(s[m][n] * scale - lse_s[i]) : 0.f;
      Ps[i * (kB + 1) + j] = p;
      dSs[i * (kB + 1) + j] = p * (dp[m][n] - dl_s[i]);
    }
  }
}

// Δ = rowsum(dO ∘ o) for every (batch, head, row), one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides so, Strides sd,
                       int H, int S, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(r % S);
  const long long bh = r / S;
  const int b = static_cast<int>(bh / H);
  const int h = static_cast<int>(bh % H);
  const T* op = o + b * so.b + h * so.h + i * so.r;
  const T* dp = dout + b * sd.b + h * sd.h + i * sd.r;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f32(dp[c]), to_f32(op[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                      Strides sd, int H, int Hkv, int S, float scale,
                      int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int TN = D / 16;  // columns of d per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int k_lo = blockIdx.x * kB;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int G = H / Hkv;
  load_tile<T, D>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
  load_tile<T, D>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);

  // the query tiles with a row that sees a key of this tile
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? min(S, k_lo + kB - 1 + window) : S;

  float acc_dk[4][TN], acc_dv[4][TN];
  zero(acc_dk);
  zero(acc_dv);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dl_h = delta + (static_cast<long long>(b) * H + h) * S;
    for (int q_lo = q_begin; q_lo < q_end; q_lo += kB) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_tile<T, D>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
      load_tile<T, D>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
      if (threadIdx.x < kB) {
        const int row = q_lo + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse_h[row] : 0.f;
        dl_s[threadIdx.x] = row < S ? dl_h[row] : 0.f;
      }
      __syncthreads();
      scores<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q_lo, k_lo, S, scale,
                causal, window);
      __syncthreads();
      // dV += Pᵀ·dO and dK += dSᵀ·Q: A(i, k) = P[k][i]
      mm_acc<TN, 16>(acc_dv, Ps, 1, kB + 1, dOs, LD, 1, kB);
      mm_acc<TN, 16>(acc_dk, dSs, 1, kB + 1, Qs, LD, 1, kB);
    }
  }

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long base = (static_cast<long long>(b) * Hkv + kvh) * S * D;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = k_lo + ty + 16 * m;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const long long e = base + static_cast<long long>(row) * D + tx + 16 * n;
      dk[e] = from_f32<T>(acc_dk[m][n] * scale);
      dv[e] = from_f32<T>(acc_dv[m][n]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sd, int H,
                    int Hkv, int S, float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int q_lo = blockIdx.x * kB;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / Hkv);
  load_tile<T, D>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
  load_tile<T, D>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
  if (threadIdx.x < kB) {
    const long long bh = static_cast<long long>(b) * H + h;
    const int row = q_lo + threadIdx.x;
    lse_s[threadIdx.x] = row < S ? lse[bh * S + row] : 0.f;
    dl_s[threadIdx.x] = row < S ? delta[bh * S + row] : 0.f;
  }

  // the key tiles that hold a key some row of this tile sees
  const int k_end = causal ? min(S, q_lo + kB) : S;
  int k_begin = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;
    k_begin = first > 0 ? (first / kB) * kB : 0;
  }

  float acc[4][TN];
  zero(acc);
  for (int k_lo = k_begin; k_lo < k_end; k_lo += kB) {
    __syncthreads();  // the previous tile's K, V and dS are read
    load_tile<T, D>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
    load_tile<T, D>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);
    __syncthreads();
    scores<D>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q_lo, k_lo, S, scale,
              causal, window);
    __syncthreads();
    // dQ += dS·K
    mm_acc<TN, 16>(acc, dSs, kB + 1, 1, Ks, LD, 1, kB);
  }

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long base = (static_cast<long long>(b) * H + h) * S * D;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = q_lo + ty + 16 * m;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < TN; ++n)
      dq[base + static_cast<long long>(row) * D + tx + 16 * n] =
          from_f32<T>(acc[m][n] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* delta, const Strides (&st)[5], int B, int H, int Hkv, int S,
           float scale, int causal, int window, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * H * S;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks),
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(o), dop, delta, st[3], st[4], H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  flash_bwd_dkdv_kernel<T, D><<<dim3(tiles, B * Hkv), kThreads, smem,
                                stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      st[0], st[1], st[2], st[4], H, Hkv, S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<dim3(tiles, B * H), kThreads, smem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), st[0], st[1], st[2],
      st[4], H, Hkv, S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout: (B, H, S, D); k, v: (B, Hkv, S, D), each given by its pointer
// and its element strides along (batch, head, row); the stride along D is
// 1. lse: the forward's (B, H, S) f32 log-sum-exp. dq (B, H, S, D), dk and
// dv (B, Hkv, S, D): contiguous outputs in the inputs' type. delta: a
// (B, H, S) f32 scratch. dtype: 0 = float32, 1 = bfloat16. D in {64, 128}.
// Three launches on the stream; returns cudaGetLastError() after them.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr, long long v_sb,
    long long v_sh, long long v_sr, long long o_sb, long long o_sh,
    long long o_sr, long long d_sb, long long d_sh, long long d_sr, int B,
    int H, int Hkv, int S, int D, int dtype, float scale, int causal,
    int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[5] = {{q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
                         {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr},
                         {d_sb, d_sh, d_sr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, dout, l, dq, dk, dv, dl, st, B, H,
                             Hkv, S, scale, causal, window, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, dout, l, dq, dk, dv, dl, st, B, H,
                              Hkv, S, scale, causal, window, s);
  if (dtype == 1 && D == 64)
    return launch<bf16, 64>(q, k, v, o, dout, l, dq, dk, dv, dl, st, B, H,
                            Hkv, S, scale, causal, window, s);
  if (dtype == 1 && D == 128)
    return launch<bf16, 128>(q, k, v, o, dout, l, dq, dk, dv, dl, st, B, H,
                             Hkv, S, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
