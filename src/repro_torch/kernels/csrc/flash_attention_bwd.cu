// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
//
// The gradient of flash_attention.cu's forward (causal and/or sliding-window
// attention with GQA): given q, k, v, the output o, each row's log-sum-exp
// (the forward's lse output) and dO, it computes dq, dk and dv. The TPU
// reference has no backward kernel: its gradients come from XLA's autodiff
// of the einsum attention (src/repro/models/attention.py:gqa_attention, and
// mla_attention at MLA's head dims). The function is FlashAttention-2's
// backward, with the probabilities recomputed from the lse and never stored:
//
//   P   = exp(q·kᵀ·scale - lse)      (0 where masked)
//   dV  = Pᵀ·dO                       summed over the heads of a kv group
//   dP  = dO·vᵀ,  Δ = rowsum(dO ∘ o)
//   dS  = P ∘ (dP - Δ)
//   dQ  = dS·k·scale,  dK = dSᵀ·q·scale   (dK summed over the group)
//
// Head dims. Every kernel is a template on the pair <DQK, DV>: q and k (so
// dq and dk) are DQK wide, v, o and dO (so dv) DV wide, and the scale is
// the caller's, 1/√DQK. The instances are (64, 64) and (128, 128), the GQA
// models', and (192, 128), MLA's (deepseek-v2: nope 128 + rope 64, v 128).
//
// Bound on an H100 SXM (its 700 W limit). At S = 512 a call reads q, k, v,
// o, dO and the lse and writes dq, dk and dv once: at qwen3-14b's
// (1, 40, 512, 128) with 8 kv heads in bf16 about 25 MB, 7.5 us at
// 3.35 TB/s, against 2·(3·DQK + 2·DV) flops per unmasked (query, key) pair
// (S, dK and dQ at 2·DQK each, dP and dV at 2·DV; 10·d where the dims are
// equal; S and dP are computed twice, once by each of the dK/dV and dQ
// kernels, which the bound does not count), 6.8 us of bf16 tensor-core
// work at 989 TFLOP/s. Both are a few microseconds; what sets the pace is
// how well the MMAs are fed from shared memory and how evenly the causal
// triangle's work spreads over the 132 SMs.
//
// bf16 (what the training paths run): four launches, all deterministic (no
// atomics; two launches on the same inputs are bit-equal).
//  1. flash_bwd_delta_bf16_kernel: Δ for every row, DV/8 threads a row,
//     each reading 16 bytes of o and of dO, into the scratch's first
//     (B, H, S) floats.
//  2. flash_bwd_dkdv_bf16_kernel: one block per (batch, query head, 64-row
//     key tile); each of its 4 row warps owns 16 key rows. It computes
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
//     dK and writes both in bf16. With G = 1 (path 5, MLA) there is no
//     split: the block writes dK and dV in bf16 itself and this launch is
//     skipped.
//  4. flash_bwd_dq_bf16_kernel: one block of 4 warps per (batch, head,
//     64-row query tile), 16 query rows a warp, in tile_rank's order. It
//     recomputes S = Q·Kᵀ and dP = dO·Vᵀ, keeps dS in registers as the A
//     operand of dQ += dS·K (as bf16 hi + lo, two MMAs a step; K by
//     ldmatrix.trans, read once for both), and streams K and V through a
//     two-stage cp.async ring. dQ is accumulated in registers and written
//     once: no atomics, which is why dQ has its own kernel and recomputes S
//     and dP.
//  All products are mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate).
//  Shared tiles are bf16 rows padded by 16 bytes, so the eight rows an
//  ldmatrix reads fall in distinct banks: 103 KB a block at (128, 128) (two
//  blocks an SM), 55 KB at (64, 64), 127 KB at (192, 128) (one block an
//  SM). A warp takes 64 query columns (dK/dV) or 64 keys (dQ) of a tile at
//  a time at (64, 64), 32 at (128, 128) and in (192, 128)'s dK/dV, 16 in
//  its dQ, to keep its accumulators, scores and fragments in registers
//  without spilling. Rows at or past S are zero-filled by the copies and
//  masked.
//
//  Registers at (192, 128). A warp that held all of dK (16 x 192) and dV
//  (16 x 128) would hold 160 f32 accumulators a thread, where (128, 128)'s
//  128 already take 254 registers. So there the dK/dV block has 8 warps,
//  two a 16-row slice of keys (dkdv_roles): both compute that slice's Sᵀ
//  and dPᵀ, and they split the 20 16-column chunks of [dV | dK] between
//  them, role 0 dV and dK's first 32 columns, role 1 dK's other 160; 80
//  accumulators each. The dQ kernel (96 accumulators for dQ's 192 columns)
//  reads Q's and dO's fragments from shared memory at each k-step instead
//  of holding them (48 + 32 registers), as the forward does at DQK = 192,
//  and steps 16 keys at a time.
//
//  Precision: q, k, v and dO are bf16 already, and S, dP, dV, dK and dQ are
//  summed in f32. Only P (for dV) and dS (for dK and dQ) are rounded, to
//  serve as A operands, each product choosing between one bf16 cast and
//  the forward's hi + lo split (flash_attention.cu) by the CPU emulation of
//  this rounding in tests/flash_bwd_emulation.py, against the tolerance
//  2^-7·max|g| of each gradient. One cast leaves each gradient 0.20-0.33
//  of the tolerance off before the final rounding to bf16 at the card's
//  shapes. After it, over 12,000 random small cases, one cast of P (dV)
//  and of dK's dS reaches the tolerance at most (1.000 of it: a one-ulp
//  flip of the largest element), while one cast of dQ's dS breaks it once
//  (1.036, test_flash_bwd_dq_rounding_needs_the_ds_split), which the split
//  does not. So P and dK's dS are cast once (a_operand<false>) and dQ's dS
//  is split (a_operand<true>): two MMAs for each dQ step. The (192, 128)
//  instance rounds the same way (tests/test_torch_flash_bwd.py).
//
// f32 (no training path runs it; the small f32 rounds and tests do): three
// launches on the CUDA cores, as in the first port. Δ one warp a row; dK/dV
// one block of 256 threads per (batch, kv head, 64-row key tile) looping
// over the group's heads; dQ one block per (batch, head, 64-row query
// tile). Every product is a 64-row tile product out of f32 shared tiles
// (mm_acc: each thread owns a 4 x 4 to 4 x 12 piece of the result, its rows
// and columns 16 apart so that a warp reads distinct banks or one
// broadcast address), bound by shared-memory issue.
//
// q, k, v, o and dO come with (batch, head, row) element strides and a unit
// stride along the head dim, as the forward takes them: the model hands V
// and the incoming gradient over as strided views of (B, S, heads, d)
// buffers (MLA's v a slice of each head's nope + v row). In bf16 every
// pointer and stride is on 16 bytes (the wrapper copies what is not).

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

// Shared tiles of both block kernels: Q and K (64 x (DQK + 1)), dO and V
// (64 x (DV + 1)), P and dS (64 x 65), and the lse and Δ of the query
// tile's rows.
template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kB * (DQK + 1) + 2 * kB * (DV + 1) +
                          2 * kB * (kB + 1) + 2 * kB);
}

// For the query tile at q_lo and the key tile at k_lo (Qs, dOs, Ks, Vs and
// the tile's lse and Δ in shared memory): P and dS into Ps and dSs, both
// [query][key] with row stride kB + 1. Masked pairs and rows or columns at
// or past S get P = dS = 0.
template <int DQK, int DV>
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
  mm_acc<4, 16>(s, Qs, DQK + 1, 1, Ks, 1, DQK + 1, DQK);
  mm_acc<4, 16>(dp, dOs, DV + 1, 1, Vs, 1, DV + 1, DV);
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

// Δ = rowsum(dO ∘ o) for every (batch, head, row) of DV, one warp a row.
template <int DV>
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
  for (int c = lane; c < DV; c += 32) acc = fmaf(dp[c], op[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sd, int H, int Hkv, int S,
                      float scale, int causal, int window) {
  constexpr int LDK = DQK + 1;  // Q and K tiles
  constexpr int LDV = DV + 1;   // dO and V tiles
  constexpr int TK = DQK / 16;  // columns of dK per thread
  constexpr int TV = DV / 16;   // columns of dV per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LDK;
  float* Ks = dOs + kB * LDV;
  float* Vs = Ks + kB * LDK;
  float* Ps = Vs + kB * LDV;
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int k_lo = blockIdx.x * kB;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y % Hkv;
  const int G = H / Hkv;
  load_tile<DQK>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
  load_tile<DV>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);

  // the query tiles with a row that sees a key of this tile
  const int q_begin = causal ? k_lo : 0;
  const int q_end = window > 0 ? min(S, k_lo + kB - 1 + window) : S;

  float acc_dk[4][TK], acc_dv[4][TV];
  zero(acc_dk);
  zero(acc_dv);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (static_cast<long long>(b) * H + h) * S;
    const float* dl_h = delta + (static_cast<long long>(b) * H + h) * S;
    for (int q_lo = q_begin; q_lo < q_end; q_lo += kB) {
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_tile<DQK>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
      load_tile<DV>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
      if (threadIdx.x < kB) {
        const int row = q_lo + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse_h[row] : 0.f;
        dl_s[threadIdx.x] = row < S ? dl_h[row] : 0.f;
      }
      __syncthreads();
      scores<DQK, DV>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q_lo, k_lo, S,
                      scale, causal, window);
      __syncthreads();
      // dV += Pᵀ·dO and dK += dSᵀ·Q: A(i, k) = P[k][i]
      mm_acc<TV, 16>(acc_dv, Ps, 1, kB + 1, dOs, LDV, 1, kB);
      mm_acc<TK, 16>(acc_dk, dSs, 1, kB + 1, Qs, LDK, 1, kB);
    }
  }

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long row0 = (static_cast<long long>(b) * Hkv + kvh) * S;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = k_lo + ty + 16 * m;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < TK; ++n)
      dk[(row0 + row) * DQK + tx + 16 * n] = acc_dk[m][n] * scale;
#pragma unroll
    for (int n = 0; n < TV; ++n)
      dv[(row0 + row) * DV + tx + 16 * n] = acc_dv[m][n];
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sd, int H,
                    int Hkv, int S, float scale, int causal, int window) {
  constexpr int LDK = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int TK = DQK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LDK;
  float* Ks = dOs + kB * LDV;
  float* Vs = Ks + kB * LDK;
  float* Ps = Vs + kB * LDV;
  float* dSs = Ps + kB * (kB + 1);
  float* lse_s = dSs + kB * (kB + 1);
  float* dl_s = lse_s + kB;

  const int q_lo = blockIdx.x * kB;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / Hkv);
  load_tile<DQK>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
  load_tile<DV>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
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

  float acc[4][TK];
  zero(acc);
  for (int k_lo = k_begin; k_lo < k_end; k_lo += kB) {
    __syncthreads();  // the previous tile's K, V and dS are read
    load_tile<DQK>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
    load_tile<DV>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);
    __syncthreads();
    scores<DQK, DV>(Qs, dOs, Ks, Vs, lse_s, dl_s, Ps, dSs, q_lo, k_lo, S,
                    scale, causal, window);
    __syncthreads();
    // dQ += dS·K
    mm_acc<TK, 16>(acc, dSs, kB + 1, 1, Ks, LDK, 1, kB);
  }

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const long long base = (static_cast<long long>(b) * H + h) * S * DQK;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = q_lo + ty + 16 * m;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < TK; ++n)
      dq[base + static_cast<long long>(row) * DQK + tx + 16 * n] =
          acc[m][n] * scale;
  }
}

template <int DQK, int DV>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dq, float* dk, float* dv, float* delta,
               const Strides (&st)[5], int B, int H, int Hkv, int S,
               float scale, int causal, int window, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_delta_kernel<DV><<<static_cast<unsigned>(delta_blocks), kThreads,
                               0, stream>>>(o, dout, delta, st[3], st[4], H,
                                            S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t smem = smem_bytes<DQK, DV>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kB - 1) / kB;
  flash_bwd_dkdv_kernel<DQK, DV><<<dim3(tiles, B * Hkv), kThreads, smem,
                                   stream>>>(
      q, k, v, dout, lse, delta, dk, dv, st[0], st[1], st[2], st[4], H, Hkv,
      S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<DQK, DV><<<dim3(tiles, B * H), kThreads, smem,
                                 stream>>>(
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

// The warps that share a 16-row slice of a dK/dV block's keys: 2 where dK
// and dV together are wider than 256 columns (MLA's 192 + 128), so that
// each holds half of their accumulators; else 1.
template <int DQK, int DV>
__host__ __device__ constexpr int dkdv_roles() {
  return DQK + DV > 256 ? 2 : 1;
}

// dK/dV: K, V, two stages of Q and of dO, two stages of the lse and Δ rows;
// dQ: Q, dO, two stages of K and of V
template <int DQK, int DV>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(bf16) * 3 * kTile * (tc_ld<DQK>() + tc_ld<DV>()) +
         sizeof(float) * 4 * kTile;
}

template <int DQK, int DV>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 3 * kTile * (tc_ld<DQK>() + tc_ld<DV>());
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
// stride tc_ld<D>(), 16 bytes per cp.async from each of NT threads; rows
// at or past S read nothing and are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src,
                                        long long sr, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(kTile * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kTile * CH / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CH;
    const int c = e % CH;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async_16(smem_addr(dst + r * tc_ld<D>() + c * 8),
                src + (ok ? row : 0) * sr + c * 8, ok);
  }
}

// A warp's m16n8 fragments [N0, N1) (16 rows) times mul, in bf16, into its
// 16 rows of the shared tile W (row stride LD), fragment N0 at column col0.
template <int LD, int N0, int N1, int NA>
__device__ __forceinline__ void stage_rows(const float (&acc)[NA][4],
                                           float mul, bf16* W, int col0) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
#pragma unroll
  for (int n = N0; n < N1; ++n) {
    bf16* w = W + col0 + (n - N0) * 8 + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(w + g * LD) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(w + (g + 8) * LD) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// ROWS rows of D bf16 from the shared tile W (stride tc_ld<D>()) to rows
// row0.. (< S) of dst (row stride D), 16-byte stores shared by NT threads,
// this one being thread t of them.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(const bf16* W, bf16* dst, int row0,
                                          int S, int t) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int e = t; e < ROWS * CH; e += NT) {
    const int r = e / CH;
    const int ch = e % CH;
    if (row0 + r < S)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row0 + r) * D +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(W + r * tc_ld<D>() + ch * 8);
  }
}

// Δ = rowsum(dO ∘ o) for every (batch, head, row) of DV: DV/8 threads a
// row, 16 bytes of each a thread.
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16_kernel(const bf16* __restrict__ o,
                            const bf16* __restrict__ dout,
                            float* __restrict__ delta, Strides so, Strides sd,
                            int H, int S, long long rows) {
  constexpr int TPR = DV / 8;      // threads a row
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

// The 16-column chunks of [dV | dK] (CV of dV, then dK's) that role ROLE
// of a dK/dV block accumulates, NC of them from c0: dV's [c0, v1), dK's
// [k0, c1) (dK chunk k0 - CV first).
template <int ROLE, int NC, int CV>
struct Chunks {
  static constexpr int c0 = ROLE * NC;
  static constexpr int c1 = c0 + NC;
  static constexpr int v1 = c1 < CV ? c1 : CV;
  static constexpr int k0 = c0 > CV ? c0 : CV;
};

// acc[2·(jc - C0)] and acc[2·(jc - C0) + 1] += A·B for the chunks jc in
// [J0, J1) of a role whose chunks start at C0. A (16 x 16 a j-step) is the
// fragments s of the step's queries, cast to bf16 once or split into
// hi + lo (SPLIT); B the same queries' rows of a tile of ROW bytes a row,
// by ldmatrix.trans from bt, chunk jc at its column 16·(jc - JB).
template <bool SPLIT, int C0, int J0, int J1, int JB, int ROW, int NQ,
          int NA>
__device__ __forceinline__ void acc_chunks(float (&acc)[NA][4],
                                           const float (&s)[NQ][4],
                                           uint32_t bt) {
  if constexpr (J1 > J0) {
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) {
      uint32_t hi[4], lo[4];
      a_operand<SPLIT>(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int jc = J0; jc < J1; ++jc) {
        uint32_t bo[4];
        ldmatrix_x4_trans(bo, bt + j * 16 * ROW + (jc - JB) * 32);
        mma_a<SPLIT>(acc[2 * (jc - C0)], hi, lo, bo[0], bo[1]);
        mma_a<SPLIT>(acc[2 * (jc - C0) + 1], hi, lo, bo[2], bo[3]);
      }
    }
  }
}

// A role's dV (as is) and dK (times scale) in bf16 into its warp's 16 rows
// of the shared tiles Wv and Wk (row strides LDV and LDK).
template <typename C, int CV, int LDK, int LDV, int NA>
__device__ __forceinline__ void stage_role(const float (&acc)[NA][4],
                                           float scale, bf16* Wk, bf16* Wv) {
  stage_rows<LDV, 0, 2 * (C::v1 - C::c0)>(acc, 1.f, Wv, 16 * C::c0);
  stage_rows<LDK, 2 * (C::k0 - C::c0), 2 * (C::c1 - C::c0)>(
      acc, scale, Wk, 16 * (C::k0 - CV));
}

// A role's f32 dV and dK partials for its warp's key rows kw .. kw + 15
// (< S), into pv and pk (row strides DV and DQK).
template <typename C, int CV, int DQK, int DV, int NA>
__device__ __forceinline__ void write_partials(const float (&acc)[NA][4],
                                               float* pk, float* pv, int kw,
                                               int S) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = kw + g + 8 * half;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < 2 * (C::c1 - C::c0); ++n) {
      const bool is_v = n < 2 * (C::v1 - C::c0);
      const int col = is_v ? 16 * C::c0 + 8 * n + 2 * c
                           : 16 * (C::k0 - CV) +
                                 8 * (n - 2 * (C::k0 - C::c0)) + 2 * c;
      *reinterpret_cast<float2*>(is_v ? pv + row * DV + col
                                      : pk + row * DQK + col) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads * dkdv_roles<DQK, DV>(),
                                  2 / dkdv_roles<DQK, DV>())
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
  constexpr int R = dkdv_roles<DQK, DV>();
  constexpr int NT = kTcThreads * R;
  constexpr int LDK = tc_ld<DQK>();          // Q and K tiles
  constexpr int LDV = tc_ld<DV>();           // dO and V tiles
  constexpr int KDQ = DQK / 16;              // k-steps of Sᵀ
  constexpr int KDV = DV / 16;               // k-steps of dPᵀ
  constexpr int QN = DQK == 64 ? 64 : 32;    // query columns a step
  constexpr int NQ = QN / 8;                 // n-tiles of a step's scores
  constexpr int CV = DV / 16;                // chunks of dV
  constexpr int NC = (DQK + DV) / 16 / R;    // chunks a role
  static_assert((DQK + DV) / 16 % R == 0, "whole chunks a role");
  using C0 = Chunks<0, NC, CV>;
  using CL = Chunks<R - 1, NC, CV>;          // the last role's (R = 2)
  extern __shared__ float4 smem_f4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_f4);
  bf16* Vs = Ks + kTile * LDK;
  bf16* Qs = Vs + kTile * LDV;        // two stages
  bf16* dOs = Qs + 2 * kTile * LDK;   // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTile * LDV);
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
  const int wr = R == 1 ? warp : warp % kWarps;  // the warp's 16 key rows
  const int role = R == 1 ? 0 : warp / kWarps;   // its chunks of [dV | dK]
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int c = lane % 4;
  const int kw = k_lo + 16 * wr;  // this warp's first key row

  // Q, dO, lse and Δ of iteration it into stage st. The head's addresses
  // are recomputed from b and h at every call: the empty asm hides that
  // they do not change, since hoisted out of the loop they hold four more
  // 64-bit pointers across it and the d = 128 kernel spills.
  auto load_q = [&](int it, int st) {
    const int q_lo = q_begin + it * kTile;
    int hh = h, bb = b;
    asm volatile("" : "+r"(hh), "+r"(bb));
    tc_load<DQK, NT>(Qs + st * kTile * LDK, q + bb * sq.b + hh * sq.h, sq.r,
                     q_lo, S);
    tc_load<DV, NT>(dOs + st * kTile * LDV, dout + bb * sd.b + hh * sd.h,
                    sd.r, q_lo, S);
    if (R == 1 || threadIdx.x < 2 * kTile) {
      const int i = threadIdx.x % kTile;
      const int row = q_lo + i;
      const float* src = (threadIdx.x < kTile ? lse : delta) +
                         (static_cast<long long>(bb) * H + hh) * S +
                         (row < S ? row : 0);
      float* dst = (threadIdx.x < kTile ? lse_s : dl_s) + st * kTile + i;
      cp_async_4(smem_addr(dst), src, row < S);
    }
  };

  tc_load<DQK, NT>(Ks, k + b * sk.b + kvh * sk.h, sk.r, k_lo, S);
  tc_load<DV, NT>(Vs, v + b * sv.b + kvh * sv.h, sv.r, k_lo, S);
  load_q(0, 0);
  cp_async_commit();

  // this role's chunks of [dV | dK]: dV's n-tiles, then dK's
  float acc[2 * NC][4];
#pragma unroll
  for (int n = 0; n < 2 * NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // this lane's ldmatrix addresses (shared, bytes): the A operands (the
  // warp's 16 rows of K and V), the B operands (rows of Q and dO of stage
  // 0; .trans for dK and dV); + 32 bytes a k-step of 16 columns
  constexpr int ROWK = LDK * sizeof(bf16);
  constexpr int ROWV = LDV * sizeof(bf16);
  const int a_row = 16 * wr + (lane % 8) + ((lane / 8) % 2) * 8;
  const uint32_t k_a = smem_addr(Ks + a_row * LDK + (lane / 16) * 8);
  const uint32_t v_a = smem_addr(Vs + a_row * LDV + (lane / 16) * 8);
  const int b_row = (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 8;
  const int t_row = ((lane / 8) % 2) * 8 + (lane % 8);
  const int t_col = (lane / 16) * 8;
  const uint32_t q_b = smem_addr(Qs + b_row * LDK + b_col);
  const uint32_t q_t = smem_addr(Qs + t_row * LDK + t_col);
  // dO's, a fixed offset from Q's where the widths are equal
  constexpr uint32_t DO = 2 * kTile * ROWK;  // from Qs to dOs
  const uint32_t o_b =
      DQK == DV ? q_b + DO : smem_addr(dOs + b_row * LDV + b_col);
  const uint32_t o_t =
      DQK == DV ? q_t + DO : smem_addr(dOs + t_row * LDV + t_col);

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
      // the step's rows of Q and of dO
      const uint32_t sq_ = (st * kTile + qc) * ROWK;
      const uint32_t so_ = (st * kTile + qc) * ROWV;

      // Sᵀ = K·Qᵀ for this warp's 16 keys and the step's QN queries
      float s[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KDQ; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, k_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, q_b + sq_ + np * 16 * ROWK + kk * 32);
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

      // dV += Pᵀ·dO over this role's dV chunks
      if (R == 1 || role == 0)
        acc_chunks<false, C0::c0, C0::c0, C0::v1, 0, ROWV>(acc, s,
                                                           o_t + so_);
      else
        acc_chunks<false, CL::c0, CL::c0, CL::v1, 0, ROWV>(acc, s,
                                                           o_t + so_);

      // dPᵀ = V·dOᵀ, then dSᵀ = Pᵀ ∘ (dPᵀ - Δ[query]) into s
      float t[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KDV; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, v_a + kk * 32);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bo[4];
          ldmatrix_x4(bo, o_b + so_ + np * 16 * ROWV + kk * 32);
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

      // dK += dSᵀ·Q over this role's dK chunks (scaled at the end)
      if (R == 1 || role == 0)
        acc_chunks<false, C0::c0, C0::k0, C0::c1, CV, ROWK>(acc, s,
                                                            q_t + sq_);
      else
        acc_chunks<false, CL::c0, CL::k0, CL::c1, CV, ROWK>(acc, s,
                                                            q_t + sq_);
    }
  }

  const long long row0 = (static_cast<long long>(b) * Hkv + kvh) * S;
  if (G == 1) {
    // dK·scale and dV in bf16, staged through the warp's own rows of Ks
    // and Vs. With one role no other warp reads them; with two, the two
    // warps of a row slice read them until both are done.
    bf16* Wk = Ks + 16 * wr * LDK;
    bf16* Wv = Vs + 16 * wr * LDV;
    if constexpr (R == 1) {
      stage_role<C0, CV, LDK, LDV>(acc, scale, Wk, Wv);
      __syncwarp();
      copy_rows<DQK, 16, 32>(Wk, dk + row0 * DQK, kw, S, lane);
      copy_rows<DV, 16, 32>(Wv, dv + row0 * DV, kw, S, lane);
    } else {
      __syncthreads();
      if (role == 0)
        stage_role<C0, CV, LDK, LDV>(acc, scale, Wk, Wv);
      else
        stage_role<CL, CV, LDK, LDV>(acc, scale, Wk, Wv);
      __syncthreads();
      copy_rows<DQK, kTile, NT>(Ks, dk + row0 * DQK, k_lo, S, threadIdx.x);
      copy_rows<DV, kTile, NT>(Vs, dv + row0 * DV, k_lo, S, threadIdx.x);
    }
    return;
  }
  // f32 partials, [G][B][Hkv][S][DQK] for dK, then [G][B][Hkv][S][DV] for
  // dV
  const long long cells = static_cast<long long>(B) * Hkv * S;
  float* pk = part + ((h % G) * cells + row0) * DQK;
  float* pv = part + G * cells * DQK + ((h % G) * cells + row0) * DV;
  if (R == 1 || role == 0)
    write_partials<C0, CV, DQK, DV>(acc, pk, pv, kw, S);
  else
    write_partials<CL, CV, DQK, DV>(acc, pk, pv, kw, S);
}

// dK = scale·Σ_p part_dk[p] and dV = Σ_p part_dv[p], p in order, four
// elements a thread; rows: B·Hkv·S. The float4 counts of dk and dv are
// derived from rows and the pair (ptxas holds this kernel to 32 registers,
// and two more 64-bit arguments spilled).
template <int DQK, int DV>
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int P, long long rows, float scale) {
  const long long n4k = rows * (DQK / 4), n4v = rows * (DV / 4);
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= n4k + n4v) return;
  const bool is_v = i >= n4k;
  const long long j = is_v ? i - n4k : i;
  const long long n4 = is_v ? n4v : n4k;
  const float4* src = reinterpret_cast<const float4*>(part) +
                      (is_v ? static_cast<long long>(P) * n4k : 0) + j;
  float4 acc = src[0];
  for (int p = 1; p < P; ++p) {
    const float4 x = src[p * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = is_v ? 1.f : scale;
  *(reinterpret_cast<uint2*>(is_v ? dv : dk) + j) =
      make_uint2(as_u32(__floats2bfloat162_rn(acc.x * mul, acc.y * mul)),
                 as_u32(__floats2bfloat162_rn(acc.z * mul, acc.w * mul)));
}

template <int DQK, int DV>
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
  constexpr int LDK = tc_ld<DQK>();        // Q and K tiles
  constexpr int LDV = tc_ld<DV>();         // dO and V tiles
  constexpr int KDQ = DQK / 16;            // k-steps of S
  constexpr int KDV = DV / 16;             // k-steps of dP
  // keys a step: at (192, 128) 16, where 32 spilled 16 bytes at 255
  // registers beside dQ's 96 accumulators
  constexpr int KN = DQK == 64 ? 64 : DQK == DV ? 32 : 16;
  constexpr int NK = KN / 8;               // n-tiles of a step's scores
  constexpr int NO = DQK / 8;              // n-tiles of dQ
  // Q's and dO's fragments stay in registers across the key tiles where
  // the dims are equal; at (192, 128) they would take 80 registers beside
  // dQ's 96 accumulators, so each k-step reads them from Qs and dOs again
  constexpr bool kHold = DQK == DV;
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);
  bf16* dOs = Qs + kTile * LDK;
  bf16* Ks = dOs + kTile * LDV;       // two stages
  bf16* Vs = Ks + 2 * kTile * LDK;    // two stages

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

  tc_load<DQK, kTcThreads>(Qs, q + b * sq.b + h * sq.h, sq.r, q_lo, S);
  tc_load<DV, kTcThreads>(dOs, dout + b * sd.b + h * sd.h, sd.r, q_lo, S);
  tc_load<DQK, kTcThreads>(Ks, kp, sk.r, k_begin, S);
  tc_load<DV, kTcThreads>(Vs, vp, sv.r, k_begin, S);
  cp_async_commit();

  float lse_r[2], dl_r[2];
  const long long bh = static_cast<long long>(b) * H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < S ? lse[bh * S + row] : 0.f;
    dl_r[r] = row < S ? delta[bh * S + row] : 0.f;
  }

  // the warp's A rows of Q and dO, as ldmatrix addresses
  const int a_row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
  const uint32_t q_a = smem_addr(Qs + a_row * LDK + (lane / 16) * 8);
  const uint32_t d_a = smem_addr(dOs + a_row * LDV + (lane / 16) * 8);
  uint32_t qf[kHold ? KDQ : 1][4], df[kHold ? KDV : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // this lane's ldmatrix addresses (shared, bytes) into K and V of stage
  // 0: the B operands of S and dP (K and V rows), and of dQ (.trans);
  // + 32 bytes a k-step of 16 columns
  constexpr int ROWK = LDK * sizeof(bf16);
  constexpr int ROWV = LDV * sizeof(bf16);
  const int b_row = (lane / 16) * 8 + (lane % 8);
  const int b_col = ((lane / 8) % 2) * 8;
  const uint32_t k_b = smem_addr(Ks + b_row * LDK + b_col);
  const uint32_t k_t = smem_addr(Ks + (((lane / 8) % 2) * 8 + (lane % 8)) *
                                          LDK + (lane / 16) * 8);
  constexpr uint32_t VO = 2 * kTile * ROWK;  // from Ks to Vs
  const uint32_t v_b =
      DQK == DV ? k_b + VO : smem_addr(Vs + b_row * LDV + b_col);

  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = k_begin + t * kTile;
    cp_async_wait_all();  // K and V of tile t have landed ...
    __syncthreads();      // ... for every thread; tile t - 1 is read
    if (t + 1 < n_tiles) {
      const int nx = (t + 1) & 1;
      tc_load<DQK, kTcThreads>(Ks + nx * kTile * LDK, kp, sk.r,
                               k_lo + kTile, S);
      tc_load<DV, kTcThreads>(Vs + nx * kTile * LDV, vp, sv.r, k_lo + kTile,
                              S);
      cp_async_commit();
    }
    if constexpr (kHold) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KDQ; ++kk) {
          ldmatrix_x4(qf[kk], q_a + kk * 32);
          ldmatrix_x4(df[kk], d_a + kk * 32);
        }
      }
    }

#pragma unroll 1
    for (int kc = 0; kc < kTile; kc += KN) {
      const int c_lo = k_lo + kc;  // the step's first key
      if (c_lo >= S) break;
      if (causal && c_lo > qw + 15) break;  // all after the rows
      if (window > 0 && qw - (c_lo + KN - 1) >= window) continue;  // too old
      // the step's rows of K and of V
      const uint32_t sk_ = ((t & 1) * kTile + kc) * ROWK;
      const uint32_t sv_ = ((t & 1) * kTile + kc) * ROWV;

      // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows and KN keys
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      if constexpr (kHold) {
        // both in one pass over the held fragments
#pragma unroll
        for (int kk = 0; kk < KDQ; ++kk) {
#pragma unroll
          for (int np = 0; np < NK / 2; ++np) {
            uint32_t kb[4], vb[4];
            ldmatrix_x4(kb, k_b + sk_ + np * 16 * ROWK + kk * 32);
            ldmatrix_x4(vb, v_b + sv_ + np * 16 * ROWV + kk * 32);
            mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
            mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
            mma_bf16(dp[2 * np], df[kk], vb[0], vb[1]);
            mma_bf16(dp[2 * np + 1], df[kk], vb[2], vb[3]);
          }
        }
      } else {
        // S, then dP, each fragment read from shared memory at its k-step;
        // in two passes, so that dP's accumulators are not live while S
        // is summed
#pragma unroll
        for (int kk = 0; kk < KDQ; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, q_a + kk * 32);
#pragma unroll
          for (int np = 0; np < NK / 2; ++np) {
            uint32_t kb[4];
            ldmatrix_x4(kb, k_b + sk_ + np * 16 * ROWK + kk * 32);
            mma_bf16(s[2 * np], qa, kb[0], kb[1]);
            mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KDV; ++kk) {
          uint32_t da[4];
          ldmatrix_x4(da, d_a + kk * 32);
#pragma unroll
          for (int np = 0; np < NK / 2; ++np) {
            uint32_t vb[4];
            ldmatrix_x4(vb, v_b + sv_ + np * 16 * ROWV + kk * 32);
            mma_bf16(dp[2 * np], da, vb[0], vb[1]);
            mma_bf16(dp[2 * np + 1], da, vb[2], vb[3]);
          }
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
        for (int dd = 0; dd < KDQ; ++dd) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, k_t + sk_ + j * 16 * ROWK + dd * 32);
          mma_a<true>(acc[2 * dd], dh, dlo, kb[0], kb[1]);
          mma_a<true>(acc[2 * dd + 1], dh, dlo, kb[2], kb[3]);
        }
      }
    }
  }

  // dQ·scale in bf16 through this warp's own rows of Qs (which only this
  // warp reads)
  bf16* W = Qs + 16 * warp * LDK;
  stage_rows<LDK, 0, NO>(acc, scale, W, 0);
  __syncwarp();
  copy_rows<DQK, 16, 32>(W, dq + static_cast<long long>(blockIdx.x) * S * DQK,
                         qw, S, lane);
}

// floats of the scratch: Δ (B, H, S), then, in bf16 where a kv group has
// G > 1 heads, the f32 partials of dK (D wide) and dV (Dv wide) from a
// 16-byte boundary
long long scratch_floats(int B, int H, int Hkv, int S, int D, int Dv,
                         int dtype) {
  const long long rows = static_cast<long long>(B) * H * S;
  const int G = H / Hkv;
  if (dtype != 1 || G == 1) return rows;
  return (rows + 3) / 4 * 4 +
         static_cast<long long>(G) * B * Hkv * S * (D + Dv);
}

template <int DQK, int DV>
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
  constexpr int rpb = 256 / (DV / 8);  // rows a block
  flash_bwd_delta_bf16_kernel<DV><<<static_cast<unsigned>((rows + rpb - 1) /
                                                           rpb),
                                    256, 0, stream>>>(
      static_cast<const bf16*>(o), dop, scratch, st[3], st[4], H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int G = H / Hkv;
  float* part = G > 1 ? scratch + (rows + 3) / 4 * 4 : nullptr;
  const int tiles = (S + kTile - 1) / kTile;
  constexpr size_t smem_kv = dkdv_smem_bytes<DQK, DV>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_bf16_kernel<DQK, DV><<<
      dim3(B * H, tiles), kTcThreads * dkdv_roles<DQK, DV>(), smem_kv,
      stream>>>(qp, kp, vp, dop, lse, scratch, static_cast<bf16*>(dk),
                static_cast<bf16*>(dv), part, st[0], st[1], st[2], st[4], B,
                H, Hkv, S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G > 1) {
    const long long cells = static_cast<long long>(B) * Hkv * S;
    const long long n4 = cells * (DQK + DV) / 4;
    flash_bwd_dkdv_sum_kernel<DQK, DV><<<
        static_cast<unsigned>((n4 + kSumThreads - 1) / kSumThreads),
        kSumThreads, 0, stream>>>(part, static_cast<bf16*>(dk),
                                  static_cast<bf16*>(dv), G, cells, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  constexpr size_t smem_q = dq_smem_bytes<DQK, DV>();
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<DQK, DV><<<dim3(B * H, tiles), kTcThreads, smem_q,
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

template <int DQK_, int DV_>
struct Pair {
  static constexpr int dqk = DQK_;
  static constexpr int dv = DV_;
};

// f(Pair<DQK, DV>{}) for the head-dim pairs the kernels are built for, and
// `missing` for any other
template <typename F>
int with_pair(int D, int Dv, int missing, F f) {
  if (D == 64 && Dv == 64) return f(Pair<64, 64>{});
  if (D == 128 && Dv == 128) return f(Pair<128, 128>{});
  if (D == 192 && Dv == 128) return f(Pair<192, 128>{});
  return missing;
}

static_assert(kTile == kB, "the f32 and bf16 kernels tile S alike");

}  // namespace

// The floats of the scratch flash_attention_bwd_launch takes, for these
// shapes, head dims and dtype.
extern "C" long long flash_attention_bwd_scratch_floats(int B, int H, int Hkv,
                                                        int S, int D, int Dv,
                                                        int dtype) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv) return 0;
  return scratch_floats(B, H, Hkv, S, D, Dv, dtype);
}

// The dynamic shared memory, in bytes, of a launch of the bf16 dK/dV
// (kernel 0) or dQ (kernel 1) kernel at head dims (D, Dv); -1 where not
// taken.
extern "C" int flash_attention_bwd_smem_bytes(int kernel, int D, int Dv) {
  if (kernel != 0 && kernel != 1) return -1;
  return with_pair(D, Dv, -1, [&](auto p) {
    using P = decltype(p);
    return static_cast<int>(kernel == 0 ? dkdv_smem_bytes<P::dqk, P::dv>()
                                        : dq_smem_bytes<P::dqk, P::dv>());
  });
}

// The blocks of that kernel that fit an SM; -1 where not taken.
extern "C" int flash_attention_bwd_blocks_per_sm(int kernel, int D, int Dv) {
  const int smem = flash_attention_bwd_smem_bytes(kernel, D, Dv);
  if (smem < 0) return -1;
  return with_pair(D, Dv, -1, [&](auto p) {
    using P = decltype(p);
    return kernel == 0
               ? blocks_per_sm(flash_bwd_dkdv_bf16_kernel<P::dqk, P::dv>,
                               kTcThreads * dkdv_roles<P::dqk, P::dv>(), smem)
               : blocks_per_sm(flash_bwd_dq_bf16_kernel<P::dqk, P::dv>,
                               kTcThreads, smem);
  });
}

// q, dq: (B, H, S, D); k, dk: (B, Hkv, S, D); v, dv: (B, Hkv, S, Dv); o,
// dout: (B, H, S, Dv). The inputs are each given by a pointer and element
// strides along (batch, head, row), the stride along the head dim 1 (bf16:
// pointers and strides on 16 bytes). lse: the forward's (B, H, S) f32
// log-sum-exp. dq, dk and dv: contiguous outputs in the inputs' type.
// scratch: f32, of flash_attention_bwd_scratch_floats(B, H, Hkv, S, D, Dv,
// dtype) floats. dtype: 0 = float32, 1 = bfloat16. (D, Dv) in {(64, 64),
// (128, 128), (192, 128)}. Three or four launches on the stream; returns
// cudaGetLastError() after them.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, long long q_sb, long long q_sh, long long q_sr,
    long long k_sb, long long k_sh, long long k_sr, long long v_sb,
    long long v_sh, long long v_sr, long long o_sb, long long o_sh,
    long long o_sr, long long d_sb, long long d_sh, long long d_sr, int B,
    int H, int Hkv, int S, int D, int Dv, int dtype, float scale, int causal,
    int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[5] = {{q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
                         {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr},
                         {d_sb, d_sh, d_sr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  return with_pair(
      D, Dv, static_cast<int>(cudaErrorInvalidValue), [&](auto p) {
        using P = decltype(p);
        if (dtype == 1)
          return launch_bf16<P::dqk, P::dv>(q, k, v, o, dout, l, dq, dk, dv,
                                            sc, st, B, H, Hkv, S, scale,
                                            causal, window, s);
        return launch_f32<P::dqk, P::dv>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(o),
            static_cast<const float*>(dout), l, static_cast<float*>(dq),
            static_cast<float*>(dk), static_cast<float*>(dv), sc, st, B, H,
            Hkv, S, scale, causal, window, s);
      });
}
