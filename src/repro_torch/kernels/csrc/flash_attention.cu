// Flash-attention forward for Hopper (sm_90a): causal and/or sliding-window
// attention with GQA, online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel). Same function: masked scores are
// the finite -1e30 (never -inf), kv head = h / (H / Hkv), out = acc /
// max(l, 1e-30) in q's type. Zeroth-order training has no backward pass,
// so the forward is all the port needs. Blocks run in no order, so the TPU
// kernel's sequential kv grid axis is a loop inside the block and (m, l,
// acc) live in registers. Kv tiles wholly outside the causal / window band
// are never loaded.
//
// Under autograd the forward also writes each row's log-sum-exp,
// lse = m + log(l) in f32, (B, H, S) contiguous, which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from. Both kernels
// keep m in natural units (the bf16 kernel takes its exponentials as exp2f
// of (s - m)·log2(e)), so the lse needs no change of base. The pointer is
// null on the zeroth-order paths, which then compute and write what they
// did before it existed.
//
// Bound on this card. At the training shapes (S = 512, d = 128) a call
// reads q, k, v once and writes o once: 7.3 MB at qwen3-14b's (1,40,512,128)
// with 8 kv heads, 2.2 us at 3.35 TB/s, against 4·d flops per unmasked
// (query, key) pair, 2.7 us of bf16 tensor-core work at 989 TFLOP/s. So
// bytes bound it, but a query tile is a few hundred MMAs: latency and
// occupancy, not the tensor-core rate, set the pace.
//
// bf16 kernel (what both training paths run): flash_fwd_bf16_kernel.
//  - One block of 4 warps per (batch * head, 64-row query tile); each warp
//    owns 16 query rows. Query tiles launch heaviest first (the grid's slow
//    axis runs the causal tiles from the last one down), so the long tiles
//    start in the first wave.
//  - Tensor cores through mma.sync.aligned.m16n8k16 (bf16 in, f32
//    accumulate), fragments loaded with ldmatrix (.trans for V). mma.sync
//    rather than wgmma/TMA: a 64-row tile over at most eight 64-row kv
//    tiles is too little work per block for the asynchronous warpgroup
//    machinery to pay; what counts here is keeping two blocks per SM busy.
//  - Q, K and V stay bf16 in shared memory (rows padded by 16 bytes, so the
//    eight rows an ldmatrix reads fall in distinct banks). K and V tiles
//    come in by cp.async into a two-stage ring, K and V in groups of their
//    own: K of tile j+1 loads while tile j computes, V of tile j+1 from
//    tile j's P·V on. Rows at or past S are zero-filled by the copy
//    (src-size 0) and masked, so a ragged S needs no padding copy. 85 KB of
//    shared memory at d = 128: two blocks per SM.
//  - P stays in registers: the m16n8 accumulator fragment of S = Q·K^T is
//    rescaled by the online softmax (row max and row sum by quad shuffles)
//    and reused as the A operand of P·V.
//  - P·V keeps P at f32-level precision, as the Pallas kernel and the plain
//    version do. P cast to bf16 would move each output by up to 2^-9 of
//    Σ p·|v| / l, which breaks one bf16 ulp wherever the output is near 0.
//    So P = P_hi + P_lo with both parts bf16 (P_lo = bf16(p - P_hi)), and
//    each P·V step runs two MMAs: about 16 mantissa bits in P, for 1.5x
//    the MMA work of one bf16 pass.
//  - q, k, v and o come with (batch, head, row) element strides and a unit
//    stride on d: the model passes V as a transpose of its (B, S, Hkv, d)
//    projection and has o written straight into a (B, S, H, d) buffer.
//
// f32 kernel (no training path runs it; the small f32 round and the f32
// tests do): flash_fwd_kernel, scalar f32 FMAs out of shared memory, as in
// the first port. One block of 256 threads per 64-row query tile, four
// threads to a query row; Q, K, V widened to f32 in shared memory.
//
// Head dims. Both kernels are templates on <DQK, DV>: q and k are DQK wide,
// v and o DV wide, and the scale is the caller's (1/sqrt(DQK)). They are
// built for (64, 64), (128, 128) and MLA's (192, 128) (deepseek-v2: 128
// nope + 64 rope dims scored, v 128 wide; the Pallas kernel blocks q, k and
// v at one d). Q and K tiles take the DQK stride, V tiles the DV stride,
// and o is staged through the Q tile's rows. At (192, 128) the bf16 kernel
// keeps 16 output n-tiles (64 registers) but not Q's 12 k-steps of
// fragments (48 more, which spilled): it reads them from shared memory at
// each k-step. It takes 111,616 bytes of shared memory (Q 64x200, two K
// stages 64x200, two V stages 64x136): still two blocks per SM. The f32
// kernel takes 151,552 bytes there (Q and K at 196, V at 132, P 64x68):
// one block. The bound at (1,128,512,192/128), causal: 84 MB of q, k, v
// and o, 0.025 ms at the byte rate, against 0.011 ms of tensor-core work;
// at S = 4096 the 687 GFLOP of tensor-core work, 0.695 ms.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// element strides of q, k, v, o along (batch, head, row); d has stride 1
struct Layout {
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------------------
// f32: scalar kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // 4 threads per query row

// Q, K (stride DQK + 4), V (stride DV + 4), P
template <int DQK, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (DQK + 4) + kBK * (DV + 4) +
                          kBQ * (kBK + 4));
}

// Rows [row0, row0 + ROWS) of an (S, D) matrix with row stride sr into a
// tile of stride D + 4, zero past row S.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long sr, int row0, int S) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = row0 + r;
    dst[r * (D + 4) + c] = row < S ? src[row * sr + c] : 0.f;
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Layout L, int H, int Hkv, int S,
                 float scale, int causal, int window) {
  constexpr int LD = DQK + 4;    // Q and K tiles
  constexpr int LDV = DV + 4;    // V tiles
  constexpr int LDP = kBK + 4;
  constexpr int NCOL = kBK / 4;  // scores per thread per kv tile
  constexpr int NV = DV / 16;    // float4 output slots per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LDV;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / Hkv);
  const int q_lo = blockIdx.x * kBQ;
  const float* qp = q + b * L.q[0] + h * L.q[1];
  const float* kp = k + b * L.k[0] + kvh * L.k[1];
  const float* vp = v + b * L.v[0] + kvh * L.v[1];
  float* op = o + b * L.o[0] + h * L.o[1];

  const int r = threadIdx.x >> 2;  // query row within the tile
  const int qd = threadIdx.x & 3;  // this thread's quarter of the columns
  const int row = q_lo + r;

  load_tile<DQK, kBQ>(Qs, qp, L.q[2], q_lo, S);

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
    load_tile<DQK, kBK>(Ks, kp, L.k[2], k_lo, S);
    load_tile<DV, kBK>(Vs, vp, L.v[2], k_lo, S);
    __syncthreads();

    float s[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DQK; dd += 4) {
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
            *reinterpret_cast<const float4*>(&Vs[c * LDV + 4 * (qd + 4 * m)]);
        acc[m].x = fmaf(p, vv.x, acc[m].x);
        acc[m].y = fmaf(p, vv.y, acc[m].y);
        acc[m].z = fmaf(p, vv.z, acc[m].z);
        acc[m].w = fmaf(p, vv.w, acc[m].w);
      }
    }
  }

  if (row >= S) return;
  const float l = fmaxf(l_i, 1e-30f);
  if (lse != nullptr && qd == 0)
    lse[static_cast<long long>(blockIdx.y) * S + row] = m_i + logf(l);
  float* dst = op + row * L.o[2];
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    const int c = 4 * (qd + 4 * m);
    dst[c + 0] = acc[m].x / l;
    dst[c + 1] = acc[m].y / l;
    dst[c + 2] = acc[m].z / l;
    dst[c + 3] = acc[m].w / l;
  }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Layout& L, int B, int H, int Hkv, int S,
               float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, L, H, Hkv,
      S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kTcBQ = 16 * kWarps;  // query rows of a block
constexpr int kTcBK = 64;           // kv rows of a tile
constexpr float kLog2e = 1.4426950408889634f;

// row stride of a shared tile, in bf16 elements: 16 bytes of padding
template <int D>
__host__ __device__ constexpr int tc_ld() {
  return D + 8;
}

// Q, then two stages of K (stride tc_ld<DQK>), then two stages of V
// (stride tc_ld<DV>)
template <int DQK, int DV>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * ((kTcBQ + 2 * kTcBK) * tc_ld<DQK>() +
                         2 * kTcBK * tc_ld<DV>());
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi); the lower column in the
// lower half, as an mma fragment holds it
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

// ROWS rows of D bf16 from row0 on (row stride sr) into a shared tile of
// stride tc_ld<D>(), 16 bytes per cp.async; rows at or past S read nothing
// and are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void tc_load(bf16* dst, const bf16* src,
                                        long long sr, int row0, int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % kTcThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / kTcThreads; ++i) {
    const int e = threadIdx.x + i * kTcThreads;
    const int r = e / CH;
    const int c = e % CH;
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async_16(smem_addr(dst + r * tc_ld<D>() + c * 8),
                src + (ok ? row : 0) * sr + c * 8, ok);
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Layout L, int H, int Hkv,
                      int S, float scale, int causal, int window) {
  constexpr int LD = tc_ld<DQK>();   // Q and K tiles (and o's staging)
  constexpr int LDV = tc_ld<DV>();   // V tiles
  constexpr int KD = DQK / 16;     // k-steps of Q·K^T
  constexpr int NS = kTcBK / 8;    // n-tiles of a score tile
  constexpr int NO = DV / 8;       // n-tiles of the output
  static_assert(DV <= DQK, "o is staged through the Q tile's rows");
  extern __shared__ float4 smem_f4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_f4);
  bf16* Ks = Qs + kTcBQ * LD;
  bf16* Vs = Ks + 2 * kTcBK * LD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // heaviest first
  const bf16* qp = q + b * L.q[0] + h * L.q[1];
  const bf16* kp = k + b * L.k[0] + kvh * L.k[1];
  const bf16* vp = v + b * L.v[0] + kvh * L.v[1];
  bf16* op = o + b * L.o[0] + h * L.o[1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int c = lane % 4;  // fragment column pair
  const int w_lo = q_lo + 16 * warp;  // this warp's first query row
  const int row0 = w_lo + g;

  // the kv tiles that can hold an unmasked score for a row of this tile
  const int k_end = causal ? min(S, q_lo + kTcBQ) : S;
  int k_begin = 0;
  if (window > 0) {
    const int first = q_lo - window + 1;
    k_begin = first > 0 ? (first / kTcBK) * kTcBK : 0;
  }
  const int n_tiles = (k_end - k_begin + kTcBK - 1) / kTcBK;

  // cp.async groups: Q with K of the first tile, then V of the first tile;
  // in the loop, K and V of the next tile one group each
  tc_load<DQK, kTcBQ>(Qs, qp, L.q[2], q_lo, S);
  tc_load<DQK, kTcBK>(Ks, kp, L.k[2], k_begin, S);
  cp_async_commit();
  tc_load<DV, kTcBK>(Vs, vp, L.v[2], k_begin, S);
  cp_async_commit();

  // Q's fragments stay in registers across the kv tiles where they fit
  // beside the accumulators. At DQK = 192 they would take 48 of them and
  // ptxas spills under two blocks an SM, so there each k-step reads its
  // fragment from Qs again (one ldmatrix beside the four of K).
  constexpr bool kQRegs = DQK <= 128;
  const int q_row = 16 * warp + (lane % 8) + ((lane / 8) % 2) * 8;
  uint32_t qf[kQRegs ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k_lo = k_begin + t * kTcBK;
    const int next = (t + 1) & 1;  // the stage of tile t + 1
    cp_async_wait<1>();  // K of tile t (V of tile t may still be in flight)
    __syncthreads();     // ... and every warp is done with tile t - 1's K
    if (t + 1 < n_tiles) {
      tc_load<DQK, kTcBK>(Ks + next * kTcBK * LD, kp, L.k[2], k_lo + kTcBK,
                          S);
      cp_async_commit();
    }

    if constexpr (kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(Qs + q_row * LD + kk * 16 +
                                        (lane / 16) * 8));
      }
    }
    const bf16* Kt = Ks + (t & 1) * kTcBK * LD;
    const bf16* Vt = Vs + (t & 1) * kTcBK * LDV;

    // S = Q·K^T for this warp's 16 rows and the tile's 64 columns
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qk[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qk[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qk, smem_addr(Qs + q_row * LD + kk * 16 +
                                  (lane / 16) * 8));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        const int n = np * 16 + (lane / 16) * 8 + (lane % 8);
        ldmatrix_x4(kb, smem_addr(Kt + n * LD + kk * 16 +
                                  ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], qk, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qk, kb[2], kb[3]);
      }
    }

    // scale and mask; the mask is evaluated only where the tile crosses
    // the band's edge or S
    const bool inside = k_lo + kTcBK <= S &&
                        (!causal || k_lo + kTcBK - 1 <= w_lo) &&
                        (window <= 0 || w_lo + 15 - k_lo < window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (!inside) {
          const int row = row0 + (e / 2) * 8;
          const int col = k_lo + n * 8 + 2 * c + (e % 2);
          bool ok = col < S;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && (row - col) < window;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }

    // online softmax: a wholly masked row so far has m = -1e30 and sums
    // exp(0) terms, which alpha = exp(-1e30 - m) wipes out once a real
    // score arrives
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f((m_i[r] - m_new) * kLog2e);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m_i[e / 2]) * kLog2e);
        s[n][e] = p;
        l_i[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // V of tile t; then every warp is done with tile t - 1's V
    if (t + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      tc_load<DV, kTcBK>(Vs + next * kTcBK * LDV, vp, L.v[2], k_lo + kTcBK,
                         S);
      cp_async_commit();
    }

    // acc += P·V, P = P_hi + P_lo from the score fragments in registers
#pragma unroll
    for (int j = 0; j < kTcBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_bf16(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_bf16(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t vb[4];
        const int r = j * 16 + ((lane / 8) % 2) * 8 + (lane % 8);
        ldmatrix_x4_trans(vb, smem_addr(Vt + r * LDV + dp * 16 +
                                        (lane / 16) * 8));
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30), as a product with the reciprocal (on an
  // H100 a division per element cost about 2 us a call at S = 512; the two
  // differ by an f32 ulp), staged through this warp's own rows of Qs (read
  // into its registers at the first tile, DQK >= DV wide) for 16-byte
  // stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = 1.f / fmaxf(l_i[r], 1e-30f);
  }
  if (lse != nullptr && c == 0) {
    float* lrow = lse + static_cast<long long>(blockIdx.x) * S;
    if (row0 < S) lrow[row0] = m_i[0] + logf(fmaxf(l_i[0], 1e-30f));
    if (row0 + 8 < S) lrow[row0 + 8] = m_i[1] + logf(fmaxf(l_i[1], 1e-30f));
  }
  bf16* Ow = Qs + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * LD + n * 8 + 2 * c) =
        __floats2bfloat162_rn(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CH = DV / 8;
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH;
    const int ch = e % CH;
    if (w_lo + r < S)
      *reinterpret_cast<uint4*>(op + (w_lo + r) * L.o[2] + ch * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * LD + ch * 8);
  }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const Layout& L, int B, int H, int Hkv, int S,
                float scale, int causal, int window, cudaStream_t stream) {
  // cp.async and the output stores move 16 bytes: rows must start on 16
  const void* ptrs[4] = {q, k, v, o};
  const long long* strides[4] = {L.q, L.k, L.v, L.o};
  for (int t = 0; t < 4; ++t) {
    if (reinterpret_cast<uintptr_t>(ptrs[t]) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    for (int i = 0; i < 3; ++i)
      if (strides[t][i] % 8)
        return static_cast<int>(cudaErrorMisalignedAddress);
  }
  constexpr size_t smem = tc_smem_bytes<DQK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  flash_fwd_bf16_kernel<DQK, DV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, L, H, Hkv, S,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// The dynamic shared memory a launch asks for, and how many blocks of the
// kernel fit on one SM with it, for head dims (D, Dv) and dtype (as in
// flash_attention_launch); -1 where the pair or dtype is not taken.
extern "C" int flash_attention_smem_bytes(int D, int Dv, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  return with_pair(D, Dv, -1, [&](auto p) {
    using P = decltype(p);
    return static_cast<int>(dtype == 0 ? smem_bytes<P::dqk, P::dv>()
                                       : tc_smem_bytes<P::dqk, P::dv>());
  });
}

extern "C" int flash_attention_blocks_per_sm(int D, int Dv, int dtype) {
  const int smem = flash_attention_smem_bytes(D, Dv, dtype);
  if (smem < 0) return -1;
  return with_pair(D, Dv, -1, [&](auto p) {
    using P = decltype(p);
    return dtype == 0
               ? blocks_per_sm(flash_fwd_kernel<P::dqk, P::dv>, kThreads, smem)
               : blocks_per_sm(flash_fwd_bf16_kernel<P::dqk, P::dv>,
                               kTcThreads, smem);
  });
}

// q: (B, H, S, D); k: (B, Hkv, S, D); v: (B, Hkv, S, Dv); o: (B, H, S, Dv),
// each given by its pointer and its element strides along (batch, head,
// row); the stride along the head dim is 1. lse: null, or (B, H, S)
// contiguous f32 that receives each row's log-sum-exp. dtype: 0 = float32,
// 1 = bfloat16 (pointers and strides on 16 bytes). (D, Dv) in {(64, 64),
// (128, 128), (192, 128)}. Returns cudaGetLastError() after launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb,
    long long q_sh, long long q_sr, long long k_sb, long long k_sh,
    long long k_sr, long long v_sb, long long v_sh, long long v_sr,
    long long o_sb, long long o_sh, long long o_sr, int B, int H, int Hkv,
    int S, int D, int Dv, int dtype, float scale, int causal, int window,
    void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = {{q_sb, q_sh, q_sr}, {k_sb, k_sh, k_sr},
                    {v_sb, v_sh, v_sr}, {o_sb, o_sh, o_sr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return with_pair(
      D, Dv, static_cast<int>(cudaErrorInvalidValue), [&](auto p) {
        using P = decltype(p);
        return dtype == 0
                   ? launch_f32<P::dqk, P::dv>(q, k, v, o, l, L, B, H, Hkv, S,
                                               scale, causal, window, s)
                   : launch_bf16<P::dqk, P::dv>(q, k, v, o, l, L, B, H, Hkv,
                                                S, scale, causal, window, s);
      });
}
