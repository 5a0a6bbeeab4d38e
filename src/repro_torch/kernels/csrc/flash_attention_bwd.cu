// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
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
// Bound on an H100 SXM (its 700 W limit). At S = 512 a call reads q, k, v,
// o, dO and the lse and writes dq, dk and dv once: at qwen3-14b's
// (1, 40, 512, 128) with 8 kv heads in bf16 about 25 MB, 7.5 us at
// 3.35 TB/s, against 10·d flops per unmasked (query, key) pair (S, dP, dV,
// dK and dQ at 2·d each; S and dP are computed twice, once by each of the
// dK/dV and dQ kernels, which the bound does not count), 6.8 us of bf16
// tensor-core work at 989 TFLOP/s. Both are a few microseconds; what sets
// the pace is how well the MMAs are fed from shared memory and how evenly
// the causal triangle's work spreads over the 132 SMs.
//
// bf16 (what the training paths run): four launches, all deterministic (no
// atomics; two launches on the same inputs are bit-equal).
//  1. flash_bwd_delta_bf16_kernel: Δ for every row, D/8 threads a row, each
//     reading 16 bytes of o and of dO, into the scratch's first (B, H, S)
//     floats.
//  2. flash_bwd_dkdv_bf16_kernel: one block of 4 warps per (batch, query
//     head, 64-row key tile); each warp owns 16 key rows. It computes
//     Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - Δ) land in
//     the m16n8 accumulator layout and feed dV += Pᵀ·dO and dK += dSᵀ·Q
//     straight from registers as A operands, as the forward feeds P into
//     P·V. K and V of the key tile stay resident in shared memory (the A
//     operands, by ldmatrix); Q and dO are the B operands (ldmatrix for
//     Sᵀ and dPᵀ, ldmatrix.trans for dK and dV) and stream through a
//     two-stage cp.async ring together with the tile's lse and Δ, which are
//     indexed by the query column here. A block walks the query tiles that
//     see its keys. Causal key tiles launch heaviest first (key tile 0
//     sees every query), the first half of the grid's rows in descending
//     work and the second half in ascending work (tile_rank), so that the
//     block joining a first-wave block on its SM is light where that one
//     is heavy.
//     Grid split: at qwen3-14b's 8 kv heads, one block per (kv head, key
//     tile) is 64 blocks for 132 SMs, and key tile 0's block walks 5 heads
//     × 8 query tiles alone. So a block takes one query head of its kv
//     group: 320 blocks at qwen3-14b, the longest walking 8 query tiles.
//     Where the group has G > 1 heads each block writes its f32 dK and dV
//     partials to the scratch, and
//  3. flash_bwd_dkdv_sum_kernel sums the G partials in head order, scales
//     dK and writes both in bf16. With G = 1 (path 5) there is no split:
//     the block writes dK and dV in bf16 itself and this launch is skipped.
//  4. flash_bwd_dq_bf16_kernel: one block of 4 warps per (batch, head,
//     64-row query tile), 16 query rows a warp, in tile_rank's order. It
//     recomputes S = Q·Kᵀ and dP = dO·Vᵀ with Q and dO fragments held in
//     registers, keeps dS in registers as the A operand of dQ += dS·K (as
//     bf16 hi + lo, two MMAs a step; K by ldmatrix.trans, read once for
//     both), and streams K and V through a two-stage cp.async
//     ring. dQ is accumulated in registers and written once: no atomics,
//     which is why dQ has its own kernel and recomputes S and dP.
//  All products are mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate).
//  Shared tiles are bf16 rows padded by 16 bytes, so the eight rows an
//  ldmatrix reads fall in distinct banks; 103 KB a block at d = 128 (two
//  blocks an SM), 55 KB at d = 64. At d = 128 a warp takes 32 query columns
//  (dK/dV) or 32 keys (dQ) of a tile at a time, to keep its accumulators,
//  scores and fragments in registers without spilling; 64 at d = 64. Rows
//  at or past S are zero-filled by the copies and masked.
//
//  Precision: q, k, v and dO are bf16 already, and S, dP, dV, dK and dQ are
//  summed in f32. Only P (for dV) and dS (for dK and dQ) are rounded, to
//  serve as A operands, each product choosing between one bf16 cast and
//  the forward's hi + lo split (flash_attention.cu) by the CPU emulation of
//  this rounding in tests/test_torch_flash_bwd.py, against the tolerance
//  2^-7·max|g| of each gradient. One cast leaves each gradient 0.20-0.33
//  of the tolerance off before the final rounding to bf16 at the card's
//  shapes. After it, over 12,000 random small cases, one cast of P (dV)
//  and of dK's dS reaches the tolerance at most (1.000 of it: a one-ulp
//  flip of the largest element), while one cast of dQ's dS breaks it once
//  (1.036, test_flash_bwd_dq_rounding_needs_the_ds_split), which the split
//  does not. So P and dK's dS are cast once (a_operand<false>) and dQ's dS
//  is split (a_operand<true>): two MMAs for each dQ step.
//
// f32 (no training path runs it; the small f32 rounds and tests do): three
// launches on the CUDA cores, as in the first port. Δ one warp a row; dK/dV
// one block of 256 threads per (batch, kv head, 64-row key tile) looping
// over the group's heads; dQ one block per (batch, head, 64-row query
// tile). Every product is a 64-row tile product out of f32 shared tiles
// (mm_acc: each thread owns a 4 x 4 or 4 x 8 piece of the result, its rows
// and columns 16 apart so that a warp reads distinct banks or one
// broadcast address), bound by shared-memory issue.
//
// q, k, v, o and dO come with (batch, head, row) element strides and a unit
// stride along d, as the forward takes them: the model hands V and the
// incoming gradient over as strided views of (B, S, heads, d) buffers. In
// bf16 every pointer and stride is on 16 bytes (the wrapper copies what is
// not).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, r;  // element strides along (batch, head, row)
};

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int kB = 64;         // rows of a query tile and of a key tile
constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 tile

// Rows [row0, row0 + kB) of an (S, D) matrix with row stride sr into a
// shared tile of row stride D + 1; rows at or past S are 0.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long sr, int row0, int S) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < S ? src[row * sr + c] : 0.f;
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
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ o,
                       const float* __restrict__ dout,
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
  const float* op = o + b * so.b + h * so.h + i * so.r;
  const float* dp = dout + b * sd.b + h * sd.h + i * sd.r;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(dp[c], op[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sd, int H, int Hkv, int S,
                      float scale, int causal, int window) {
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
  load_tile<D>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
  load_tile<D>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);

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
      load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
      load_tile<D>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
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
      dk[e] = acc_dk[m][n] * scale;
      dv[e] = acc_dv[m][n];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
  load_tile<D>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
  load_tile<D>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
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
    load_tile<D>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
    load_tile<D>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);
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
          acc[m][n] * scale;
  }
}

template <int D>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dq, float* dk, float* dv, float* delta,
               const Strides (&st)[5], int B, int H, int Hkv, int S,
               float scale, int causal, int window, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>(delta_blocks), kThreads,
                              0, stream>>>(o, dout, delta, st[3], st[4], H, S,
                                           rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  flash_bwd_dkdv_kernel<D><<<dim3(tiles, B * Hkv), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, st[0], st[1], st[2], st[4], H, Hkv,
      S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3(tiles, B * H), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, st[0], st[1], st[2], st[4], H, Hkv, S,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;  // key rows of a dK/dV block, query rows
                                    // of a dQ block, rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSumThreads = 256;

// row stride of a shared tile, in bf16 elements: 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;
}

// dK/dV: K, V, two stages of Q and of dO, two stages of the lse and Δ rows;
// dQ: Q, dO, two stages of K and of V
template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * 6 * kTile * tc_ld<D>() + sizeof(float) * 4 * kTile;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 6 * kTile * tc_ld<D>();
}

// The work rank (0: the most work) of the causal tile that block row y of
// T takes: the first half of the rows in descending work, the second half
// in ascending work, so that a block of the first wave and the one that
// joins it on its SM carry about the same work together.
__device__ __forceinline__ int tile_rank(int y, int T) {
  const int half = (T + 1) / 2;
  return y < half ? y : T - 1 - (y - half);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid (src-size 0)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared; zero-filled where !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a·b for one m16n8k16 tile: bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> hi = bf16(x) and, if SPLIT, lo = bf16(x - hi); the lower
// column in the lower half, as an mma fragment holds it
template <bool SPLIT>
__device__ __forceinline__ void pack(float x0, float x1, uint32_t& hi,
                                     uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  if (SPLIT)
    lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                      x1 - __high2float(h)));
}

// An A operand (16 rows x 16 columns) from two m16n8 accumulator fragments
// (columns 0-7 and 8-15)
template <bool SPLIT>
__device__ __forceinline__ void a_operand(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  pack<SPLIT>(c0[0], c0[1], hi[0], lo[0]);
  pack<SPLIT>(c0[2], c0[3], hi[1], lo[1]);
  pack<SPLIT>(c1[0], c1[1], hi[2], lo[2]);
  pack<SPLIT>(c1[2], c1[3], hi[3], lo[3]);
}

// c += A·b with A = hi (+ lo if SPLIT)
template <bool SPLIT>
__device__ __forceinline__ void mma_a(float (&c)[4], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], uint32_t b0,
                                      uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  if (SPLIT) mma_bf16(c, lo, b0, b1);
}

// kTile rows of D bf16 from row0 on (row stride sr) into a shared tile of
// stride tc_ld<D>(), 16 bytes per cp.async; rows at or past S read nothing
// and are zero-filled.
template <int D>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src,
                                        long long sr, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(kTile * CH % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kTile * CH / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / CH;
    const int c = e % CH;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async_16(smem_addr(dst + r * tc_ld<D>() + c * 8),
                src + (ok ? row : 0) * sr + c * 8, ok);
  }
}

// acc (16 x D, this warp's m16n8 fragments) times mul, in bf16 through the
// warp's own 16 rows of the shared tile W, then 16-byte stores to rows
// row0.. (< S) of dst with row stride D.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float mul, bf16* W, bf16* dst,
                                           int row0, int S) {
  constexpr int LD = tc_ld<D>();
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(W + g * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(W + (g + 8) * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int CH = D / 8;
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH;
    const int ch = e % CH;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) * D +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(W + r * LD + ch * 8);
  }
}

// Δ = rowsum(dO ∘ o) for every (batch, head, row): D/8 threads a row, 16
// bytes of each a thread.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            float* __restrict__ delta, Strides so, Strides sd,
                            int H, int S, long long rows) {
  constexpr int TPR = D / 8;       // threads a row
  constexpr int GPB = 256 / TPR;   // rows a block
  const int ch = threadIdx.x % TPR;
  const long long r =
      static_cast<long long>(blockIdx.x) * GPB + threadIdx.x / TPR;
  uint4 ov = make_uint4(0u, 0u, 0u, 0u), dv = ov;
  if (r < rows) {
    const int i = static_cast<int>(r % S);
    const long long bh = r / S;
    const int b = static_cast<int>(bh / H);
    const int h = static_cast<int>(bh % H);
    ov = *reinterpret_cast<const uint4*>(o + b * so.b + h * so.h + i * so.r +
                                         ch * 8);
    dv = *reinterpret_cast<const uint4*>(dout + b * sd.b + h * sd.h +
                                         i * sd.r + ch * 8);
  }
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = fmaf(__low2float(d2[j]), __low2float(o2[j]), acc);
    acc = fmaf(__high2float(d2[j]), __high2float(o2[j]), acc);
  }
  // the TPR threads of a row are neighbouring lanes of one warp
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && ch == 0) delta[r] = acc;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ part, Strides sq, Strides sk,
                           Strides sv, Strides sd, int B, int H, int Hkv,
                           int S, float scale, int causal, int window) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;               // k-steps over d
  constexpr int QN = D == 128 ? 32 : 64;   // query columns a step
  constexpr int NQ = QN / 8;               // n-tiles of a step's scores
  constexpr int NO = D / 8;                // n-tiles of dK and dV
  extern __shared__ float4 smem_f4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_f4);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;        // two stages
  bf16* dOs = Qs + 2 * kTile * LD;   // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTile * LD);
  float* dl_s = lse_s + 2 * kTile;

  const int G = H / Hkv;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;  // the block's query head
  const int kvh = h / G;
  // causal: key tile 0 sees every query, the heaviest
  const int k_lo = tile_rank(blockIdx.y, gridDim.y) * kTile;

  // the query tiles with a row that sees a key of this tile
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? min(S, k_lo + kTile - 1 + window) : S;
  const int n_it = (q_end - q_begin + kTile - 1) / kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int kw = k_lo + 16 * warp;  // this warp's first key row

  // Q, dO, lse and Δ of iteration it into stage st. The head's addresses
  // are recomputed from b and h at every call: the empty asm hides that
  // they do not change, since hoisted out of the loop they hold four more
  // 64-bit pointers across it and the d = 128 kernel spills.
  auto load_q = [&](int it, int st) {
    const int q_lo = q_begin + it * kTile;
    int hh = h, bb = b;
    asm volatile("" : "+r"(hh), "+r"(bb));
    tc_load<D>(Qs + st * kTile * LD, q + bb * sq.b + hh * sq.h, sq.r, q_lo,
               S);
    tc_load<D>(dOs + st * kTile * LD, dout + bb * sd.b + hh * sd.h, sd.r,
               q_lo, S);
    const int i = threadIdx.x % kTile;
    const int row = q_lo + i;
    const float* src = (threadIdx.x < kTile ? lse : delta) +
                       (static_cast<long long>(bb) * H + hh) * S +
                       (row < S ? row : 0);
    float* dst = (threadIdx.x < kTile ? lse_s : dl_s) + st * kTile + i;
    cp_async_4(smem_addr(dst), src, row < S);
  };

  tc_load<D>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
  tc_load<D>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);
  load_q(0, 0);
  cp_async_commit();

  float acc_dk[NO][4], acc_dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  // this lane's ldmatrix addresses (shared, bytes): the A operands (the
  // warp's 16 rows of K and V), the B operands (rows of Q and dO of stage
  // 0; .trans for dK and dV); + 32 bytes a k-step of 16 columns
  constexpr int ROW = LD * sizeof(bf16);
  const int a_row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
  const uint32_t k_a = smem_addr(Ks + a_row * LD + (lane / 16) * 8);
  const uint32_t v_a = smem_addr(Vs + a_row * LD + (lane / 16) * 8);
  const uint32_t q_b = smem_addr(Qs + ((lane / 16) * 8 + (lane % 8)) * LD +
                                 ((lane / 8) % 2) * 8);
  const uint32_t q_t = smem_addr(Qs + (((lane / 8) % 2) * 8 + (lane % 8)) *
                                          LD + (lane / 16) * 8);
  constexpr uint32_t DO = 2 * kTile * ROW;  // from Qs to dOs

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();  // stage it & 1 has landed ...
    __syncthreads();      // ... for every thread, and iteration it - 1's
                          // stage is no longer read
    if (it + 1 < n_it) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int st = it & 1;
    const int q_lo = q_begin + it * kTile;
    const float* lse_t = lse_s + st * kTile;
    const float* dl_t = dl_s + st * kTile;

#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += QN) {
      const int c_lo = q_lo + qc;  // the step's first query
      if (c_lo >= S) break;
      if (causal && c_lo + QN - 1 < kw) continue;  // all before the keys
      if (window > 0 && c_lo - (kw + 15) >= window) break;  // all too late
      const uint32_t step = (st * kTile + qc) * ROW;  // the step's rows

      // Sᵀ = K·Qᵀ for this warp's 16 keys and the step's QN queries
      float s[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, k_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, q_b + step + np * 16 * ROW + kk * 32);
          mma_bf16(s[2 * np], a, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
        }
      }

      // Pᵀ = exp(Sᵀ·scale - lse[query]); the mask only where the step
      // crosses the band's edge or S
      const bool inside = c_lo + QN <= S && (!causal || kw + 15 <= c_lo) &&
                          (window <= 0 || c_lo + QN - 1 - kw < window);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 l = *reinterpret_cast<const float2*>(
            lse_t + qc + n * 8 + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f((s[n][e] * scale - (e % 2 ? l.y : l.x)) * kLog2e);
          if (!inside) {
            const int key = kw + g + 8 * (e / 2);
            const int qry = c_lo + n * 8 + 2 * c + (e % 2);
            bool ok = qry < S;
            if (causal) ok = ok && key <= qry;
            if (window > 0) ok = ok && (qry - key) < window;
            p = ok ? p : 0.f;
          }
          s[n][e] = p;
        }
      }

      // dV += Pᵀ·dO
#pragma unroll
      for (int j = 0; j < QN / 16; ++j) {
        uint32_t ph[4], pl[4];
        a_operand<false>(s[2 * j], s[2 * j + 1], ph, pl);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bo[4];
          ldmatrix_x4_trans(bo, q_t + DO + step + j * 16 * ROW + dp * 32);
          mma_a<false>(acc_dv[2 * dp], ph, pl, bo[0], bo[1]);
          mma_a<false>(acc_dv[2 * dp + 1], ph, pl, bo[2], bo[3]);
        }
      }

      // dPᵀ = V·dOᵀ, then dSᵀ = Pᵀ ∘ (dPᵀ - Δ[query]) into s
      float t[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, v_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bo[4];
          ldmatrix_x4(bo, q_b + DO + step + np * 16 * ROW + kk * 32);
          mma_bf16(t[2 * np], a, bo[0], bo[1]);
          mma_bf16(t[2 * np + 1], a, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float2 dl = *reinterpret_cast<const float2*>(
            dl_t + qc + n * 8 + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= t[n][e] - (e % 2 ? dl.y : dl.x);
      }

      // dK += dSᵀ·Q (scaled at the end)
#pragma unroll
      for (int j = 0; j < QN / 16; ++j) {
        uint32_t dh[4], dlo[4];
        a_operand<false>(s[2 * j], s[2 * j + 1], dh, dlo);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, q_t + step + j * 16 * ROW + dp * 32);
          mma_a<false>(acc_dk[2 * dp], dh, dlo, bq[0], bq[1]);
          mma_a<false>(acc_dk[2 * dp + 1], dh, dlo, bq[2], bq[3]);
        }
      }
    }
  }

  if (G == 1) {
    // dK·scale and dV in bf16, staged through this warp's own rows of Ks
    // and Vs (no other warp reads them)
    const long long base = (static_cast<long long>(b) * Hkv + kvh) * S * D;
    store_rows<D>(acc_dk, scale, Ks + 16 * warp * LD, dk + base, kw, S);
    store_rows<D>(acc_dv, 1.f, Vs + 16 * warp * LD, dv + base, kw, S);
    return;
  }
  // f32 partials, [G][B][Hkv][S][D] for dK, then the same for dV
  const long long plane = static_cast<long long>(B) * Hkv * S * D;
  float* pk = part + (h % G) * plane +
              (static_cast<long long>(b) * Hkv + kvh) * S * D;
  float* pv = pk + G * plane;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = kw + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long e = static_cast<long long>(row) * D + n * 8 + 2 * c;
      *reinterpret_cast<float2*>(pk + e) =
          make_float2(acc_dk[n][2 * half], acc_dk[n][2 * half + 1]);
      *reinterpret_cast<float2*>(pv + e) =
          make_float2(acc_dv[n][2 * half], acc_dv[n][2 * half + 1]);
    }
  }
}

// dK = scale·Σ_p part_dk[p] and dV = Σ_p part_dv[p], p in order, four
// elements a thread; n4: the float4s of one of dk, dv
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int P, long long n4, float scale) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const long long j = is_v ? i - n4 : i;
  const float4* src = reinterpret_cast<const float4*>(part) +
                      (is_v ? static_cast<long long>(P) * n4 : 0) + j;
  float4 acc = src[0];
  for (int p = 1; p < P; ++p) {
    const float4 x = src[p * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = is_v ? 1.f : scale;
  uint2 out;
  *reinterpret_cast<__nv_bfloat162*>(&out.x) =
      __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
  *reinterpret_cast<__nv_bfloat162*>(&out.y) =
      __floats2bfloat162_rn(acc.z * mul, acc.w * mul);
  *(reinterpret_cast<uint2*>(is_v ? dv : dk) + j) = out;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, Strides sq, Strides sk,
                         Strides sv, Strides sd, int H, int Hkv, int S,
                         float scale, int causal, int window) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;               // k-steps over d
  constexpr int KN = D == 128 ? 32 : 64;   // keys a step
  constexpr int NK = KN / 8;               // n-tiles of a step's scores
  constexpr int NO = D / 8;                // n-tiles of dQ
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;       // two stages
  bf16* Vs = Ks + 2 * kTile * LD;    // two stages

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  // causal: the last query tile sees every key, the heaviest
  const int q_lo = (gridDim.y - 1 - tile_rank(blockIdx.y, gridDim.y)) *
                   kTile;
  const bf16* kp = k + b * sk.b + kvh * sk.h;
  const bf16* vp = v + b * sv.b + kvh * sv.h;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int qw = q_lo + 16 * warp;  // this warp's first query row
  const int row0 = qw + g;

  // the key tiles that hold a key some row of this tile sees
  const int k_end = causal ? min(S, q_lo + kTile) : S;
  int k_begin = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;
    k_begin = first > 0 ? (first / kTile) * kTile : 0;
  }
  const int n_tiles = (k_end - k_begin + kTile - 1) / kTile;

  tc_load<D>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
  tc_load<D>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
  tc_load<D>(Ks, kp, sk.r, k_begin, S);
  tc_load<D>(Vs, vp, sv.r, k_begin, S);
  cp_async_commit();

  float lse_r[2], dl_r[2];
  const long long bh = static_cast<long long>(b) * H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < S ? lse[bh * S + row] : 0.f;
    dl_r[r] = row < S ? delta[bh * S + row] : 0.f;
  }

  uint32_t qf[KD][4], df[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // this lane's ldmatrix addresses (shared, bytes) into K of stage 0: the
  // B operands of S and dP (K and V rows), and of dQ (.trans); V is
  // 2·kTile rows on; + 32 bytes a k-step of 16 columns
  constexpr int ROW = LD * sizeof(bf16);
  const uint32_t k_b = smem_addr(Ks + ((lane / 16) * 8 + (lane % 8)) * LD +
                                 ((lane / 8) % 2) * 8);
  const uint32_t k_t = smem_addr(Ks + (((lane / 8) % 2) * 8 + (lane % 8)) *
                                          LD + (lane / 16) * 8);
  constexpr uint32_t VO = 2 * kTile * ROW;  // from Ks to Vs

  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = k_begin + t * kTile;
    cp_async_wait_all();  // K and V of tile t have landed ...
    __syncthreads();      // ... for every thread; tile t - 1 is read
    if (t + 1 < n_tiles) {
      const int nx = (t + 1) & 1;
      tc_load<D>(Ks + nx * kTile * LD, kp, sk.r, k_lo + kTile, S);
      tc_load<D>(Vs + nx * kTile * LD, vp, sv.r, k_lo + kTile, S);
      cp_async_commit();
    }
    if (t == 0) {
      const int r = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], smem_addr(Qs + r * LD + kk * 16 +
                                      (lane / 16) * 8));
        ldmatrix_x4(df[kk], smem_addr(dOs + r * LD + kk * 16 +
                                      (lane / 16) * 8));
      }
    }

#pragma unroll 1
    for (int kc = 0; kc < kTile; kc += KN) {
      const int c_lo = k_lo + kc;  // the step's first key
      if (c_lo >= S) break;
      if (causal && c_lo > qw + 15) break;  // all after the rows
      if (window > 0 && qw - (c_lo + KN - 1) >= window) continue;  // too old
      const uint32_t step = ((t & 1) * kTile + kc) * ROW;  // the step's rows

      // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows and KN keys
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, k_b + step + np * 16 * ROW + kk * 32);
          ldmatrix_x4(vb, k_b + VO + step + np * 16 * ROW + kk * 32);
          mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
          mma_bf16(dp[2 * np], df[kk], vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], df[kk], vb[2], vb[3]);
        }
      }

      // dS = P ∘ (dP - Δ), P = exp(S·scale - lse); the mask only where the
      // step crosses the band's edge or S
      const bool inside = c_lo + KN <= S &&
                          (!causal || c_lo + KN - 1 <= qw) &&
                          (window <= 0 || qw + 15 - c_lo < window);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          float p = exp2f((s[n][e] * scale - lse_r[r]) * kLog2e);
          if (!inside) {
            const int row = row0 + 8 * r;
            const int col = c_lo + n * 8 + 2 * c + (e % 2);
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && (row - col) < window;
            p = ok ? p : 0.f;
          }
          s[n][e] = p * (dp[n][e] - dl_r[r]);
        }
      }

      // dQ += dS·K (scaled at the end)
#pragma unroll
      for (int j = 0; j < KN / 16; ++j) {
        uint32_t dh[4], dlo[4];
        a_operand<true>(s[2 * j], s[2 * j + 1], dh, dlo);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, k_t + step + j * 16 * ROW + dd * 32);
          mma_a<true>(acc[2 * dd], dh, dlo, kb[0], kb[1]);
          mma_a<true>(acc[2 * dd + 1], dh, dlo, kb[2], kb[3]);
        }
      }
    }
  }

  // dQ·scale in bf16 through this warp's own rows of Qs (read into its
  // registers at the first tile)
  store_rows<D>(acc, scale, Qs + 16 * warp * LD,
                dq + static_cast<long long>(blockIdx.x) * S * D, qw, S);
}

// floats of the scratch: Δ (B, H, S), then, in bf16 where a kv group has
// G > 1 heads, the f32 partials of dK and dV from a 16-byte boundary
long long scratch_floats(int B, int H, int Hkv, int S, int D, int dtype) {
  const long long rows = static_cast<long long>(B) * H * S;
  const int G = H / Hkv;
  if (dtype != 1 || G == 1) return rows;
  return (rows + 3) / 4 * 4 +
         2LL * G * static_cast<long long>(B) * Hkv * S * D;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, void* dq, void* dk,
                void* dv, float* scratch, const Strides (&st)[5], int B,
                int H, int Hkv, int S, float scale, int causal, int window,
                cudaStream_t stream) {
  // cp.async and the Δ loads move 16 bytes: rows must start on 16
  const void* ptrs[5] = {q, k, v, o, dout};
  for (int t = 0; t < 5; ++t) {
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16 || st[t].b % 8 ||
        st[t].h % 8 || st[t].r % 8)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const long long rows = static_cast<long long>(B) * H * S;
  constexpr int rpb = 256 / (D / 8);  // rows a block
  flash_bwd_delta_bf16_kernel<D><<<static_cast<unsigned>((rows + rpb - 1) /
                                                          rpb),
                                   256, 0, stream>>>(
      static_cast<const bf16*>(o), dop, scratch, st[3], st[4], H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int G = H / Hkv;
  float* part = G > 1 ? scratch + (rows + 3) / 4 * 4 : nullptr;
  const int tiles = (S + kTile - 1) / kTile;
  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_bf16_kernel<D><<<dim3(B * H, tiles), kTcThreads,
                                  smem_kv, stream>>>(
      qp, kp, vp, dop, lse, scratch, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, st[0], st[1], st[2], st[4], B, H, Hkv, S,
      scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 1) {
    const long long n4 = static_cast<long long>(B) * Hkv * S * D / 4;
    flash_bwd_dkdv_sum_kernel<<<static_cast<unsigned>(
                                    (2 * n4 + kSumThreads - 1) / kSumThreads),
                                kSumThreads, 0, stream>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), G, n4, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<D><<<dim3(B * H, tiles), kTcThreads, smem_q,
                                stream>>>(
      qp, kp, vp, dop, lse, scratch, static_cast<bf16*>(dq), st[0], st[1],
      st[2], st[4], H, Hkv, S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}

static_assert(kTile == kB, "the f32 and bf16 kernels tile S alike");

}  // namespace

// The floats of the scratch flash_attention_bwd_launch takes, for these
// shapes and dtype.
extern "C" long long flash_attention_bwd_scratch_floats(int B, int H, int Hkv,
                                                        int S, int D,
                                                        int dtype) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv) return 0;
  return scratch_floats(B, H, Hkv, S, D, dtype);
}

// The dynamic shared memory, in bytes, of a launch of the bf16 dK/dV
// (kernel 0) or dQ (kernel 1) kernel at head dim D; -1 where not taken.
extern "C" int flash_attention_bwd_smem_bytes(int kernel, int D) {
  if (kernel == 0 && D == 64) return static_cast<int>(dkdv_smem_bytes<64>());
  if (kernel == 0 && D == 128) return static_cast<int>(dkdv_smem_bytes<128>());
  if (kernel == 1 && D == 64) return static_cast<int>(dq_smem_bytes<64>());
  if (kernel == 1 && D == 128) return static_cast<int>(dq_smem_bytes<128>());
  return -1;
}

// The blocks of that kernel that fit an SM; -1 where not taken.
extern "C" int flash_attention_bwd_blocks_per_sm(int kernel, int D) {
  const int smem = flash_attention_bwd_smem_bytes(kernel, D);
  if (kernel == 0 && D == 64)
    return blocks_per_sm(flash_bwd_dkdv_bf16_kernel<64>, kTcThreads, smem);
  if (kernel == 0 && D == 128)
    return blocks_per_sm(flash_bwd_dkdv_bf16_kernel<128>, kTcThreads, smem);
  if (kernel == 1 && D == 64)
    return blocks_per_sm(flash_bwd_dq_bf16_kernel<64>, kTcThreads, smem);
  if (kernel == 1 && D == 128)
    return blocks_per_sm(flash_bwd_dq_bf16_kernel<128>, kTcThreads, smem);
  return -1;
}

// q, o, dout: (B, H, S, D); k, v: (B, Hkv, S, D), each given by its pointer
// and its element strides along (batch, head, row); the stride along D is
// 1 (bf16: pointers and strides on 16 bytes). lse: the forward's (B, H, S)
// f32 log-sum-exp. dq (B, H, S, D), dk and dv (B, Hkv, S, D): contiguous
// outputs in the inputs' type. scratch: f32, of
// flash_attention_bwd_scratch_floats(B, H, Hkv, S, D, dtype) floats.
// dtype: 0 = float32, 1 = bfloat16. D in {64, 128}. Three or four launches
// on the stream; returns cudaGetLastError() after them.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, long long q_sb, long long q_sh, long long q_sr,
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
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q),
                *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v),
                *fo = static_cast<const float*>(o),
                *fd = static_cast<const float*>(dout);
    float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
          *gv = static_cast<float*>(dv);
    if (D == 64)
      return launch_f32<64>(fq, fk, fv, fo, fd, l, gq, gk, gv, sc, st, B, H,
                            Hkv, S, scale, causal, window, s);
    if (D == 128)
      return launch_f32<128>(fq, fk, fv, fo, fd, l, gq, gk, gv, sc, st, B, H,
                             Hkv, S, scale, causal, window, s);
  }
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, o, dout, l, dq, dk, dv, sc, st, B, H, Hkv,
                           S, scale, causal, window, s);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, o, dout, l, dq, dk, dv, sc, st, B, H,
                            Hkv, S, scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
