// The gradient of Mamba's selective scan for Hopper (sm_90a): the backward
// of selective_scan.cu's function, over a whole sequence in two launches.
//
// No Pallas kernel computes this. The reference's gradient is XLA's
// autodiff of its jnp scan (src/repro/models/ssm.py: _ssm_scan_chunk :70,
// _mamba_ssm_params :84 and the gate of :113-123), which its first-order
// rounds (repro/core/baselines.py: fedavg_round :139, fedlora_round :173)
// take through jax.grad. In plain PyTorch the reverse recurrence is a loop
// over tokens with several launches a token, as the forward is
// (kernels/ref.py: selective_scan_bwd_ref, the plain version this kernel
// is held against on the card).
//
// The function. With the forward's δ = softplus(v), v = dt + dt_bias,
// A = -exp(A_log), a_t = exp(δ_t·A), h_t = a_t·h_{t-1} + (δ_t·x_t)·B_t,
// o_t = Σ_n h_t·C_t + x_t·D and y = T(T(o)·T(silu(z))), and dy given:
//   do = T(dy·T(silu(z)))  (in T, as the reference's autodiff rounds it),
//   dz = T(T(dy·T(o))·silu'(z)), dD = Σ do·x, dx = do·D + δ·Σ_n G·B,
//   G_t = do_t·C_t + a_{t+1}·G_{t+1} (from dh_last), dh0 = a_0·G_0,
//   dC_t = Σ_c do_t·h_t, dB_t = Σ_c G_t·δ_t·x_t,
//   dδ = Σ_n G·h_{t-1}·a·A + x·Σ_n G·B, dA = Σ_t G·h_{t-1}·a·δ,
//   ddt = dδ·sigmoid(v), ddt_bias = Σ ddt, dA_log = dA·A.
// Sums over c (dB, dC) run over a warp's channels, then the block's warps,
// then a cluster's blocks, then the clusters (the second launch, which also
// sums dA_log, dD and ddt_bias over batch rows), each in a fixed order: no
// atomics, two launches are bit-equal.
//
// Bound on this card: per (token, channel) it reads x, z and dy in the
// model type and dt in f32, and writes dx and dz in the model type and
// ddt in f32 (16 bytes in bf16), and needs N exponentials (a_t), 2
// transcendentals for softplus, 1 for sigmoid(v) and 2 for silu'(z) on the
// SFU (MUFU, 16 a clock an SM): at N = 16 the SFU bounds it
// (chip_smoke.py: scan_bwd_mufu_ops, scan_bwd_bytes). This kernel issues
// about 2N + 7: h is recomputed twice (below; each chunk's last sub-chunk
// once), and silu(z)'s exponential and reciprocal are taken again for dz.
//
// Design. The forward under autograd saved h at the start of each
// kChunk-token chunk (selective_scan.cu, kSave). Blocks and lanes are the
// forward's: thread (c, g) owns states [g·N/G, (g+1)·N/G) of channel c, the
// G lanes of a channel adjacent in one warp, a block kThreads / G channels
// of one batch row, A in registers. Each block walks the chunks last to
// first, carrying G (dh) in registers:
//   1. stage: thread (t, o) takes row t of the chunk, channels [8o, 8o + 8),
//      from shared memory, where its own cp.async copies put them (so it
//      waits for them alone), and computes δ = softplus(v) (the forward's
//      arithmetic), do (silu(z) beside it) and sigmoid(v) from softplus's
//      exp(-|v|): {δ, do} into their own array, sigmoid(v) over dt in
//      place. One block barrier.
//   2. recompute: the chunk's h from its saved start in the forward's
//      grouped form (a group's exponentials first, then its recurrence),
//      with scan_step and the precise expf, so h equals the forward's bit
//      for bit, up to the last sub-chunk's start (that sub-chunk recomputes
//      itself); each thread keeps its h at every kSub-token sub-chunk start
//      in its own slots of shared memory, which it alone reads back: no
//      barrier.
//   3. for each sub-chunk, last first: its h and decays recomputed from the
//      slot into registers, then the reverse pass over its tokens carrying
//      dh. Per token each lane's 2N/G terms of dB and dC are summed over
//      the warp's channels by a shuffle reduce-scatter (a lane ends with
//      one output), and its partials of dδ, Σ_n G·B and Σ_n h·C (o; the
//      forward's partials, summed over the lanes as a tree) over the
//      channel's G lanes by another, lane g ending with the sub-chunk's
//      token g, whose dx, ddt and dz it writes (x, z, dy and sigmoid(v)
//      read from the stage). One block barrier a sub-chunk: then the
//      block's warps' dB and dC are added in warp order into the chunk's
//      block partial (a thread an output; two buffers alternate, so no
//      second barrier). After the last sub-chunk the stage and the chunk
//      start's slot, which no thread reads again, are refilled with the
//      next chunk's (the one before it) by cp.async, in 16-byte pieces
//      where the rows are aligned: they land while the block passes the
//      cluster barrier and the next stage begins.
//   4. after the next chunk's staging barrier: the cluster's blocks wait at
//      a cluster barrier (arrived at when each finished the chunk), and
//      rank q adds slice q of the chunk's block partials over the cluster's
//      ranks in order through distributed shared memory into one partial a
//      cluster; two buffers alternate, so this one split arrive/wait a
//      chunk is all the cluster synchronises.
// dA sums over tokens in registers, dD and ddt_bias over a lane's tokens
// (their G lanes of a channel added in order at the end); dh0 is the
// carried G. The grid's x dimension is rounded up to whole clusters; a
// block past d_in computes on zeros and writes none of its channels.
//
// What tools/scan_bwd_ab.py --sweep chose (PERF.md §6, PR 31): clusters of
// 2, since at 4 blocks an SM the card holds only 124 clusters of 4 and 62
// of 8 (512 blocks need 128 and 64: the rest run in a second wave, 40%
// slower); the sums by shuffles, which beat a transpose through shared
// memory; one refill at the chunk's end, which beat refilling each
// sub-chunk's rows as they free (copy code inside the loop costs
// registers and spills); 4-token sub-chunks (8 spill).
//
// Traps:
//  - Every block runs the whole sequence: at B = 1 and d_in 16384 the 512
//    blocks of 128 threads fill 132 SMs only at 4 an SM, so the registers
//    are capped at 128 (kBwdMinBlocks) and shared memory must stay within
//    56 KB a block. A chunk's h (64 KB a block at N = 16) does not fit:
//    h is recomputed twice, the chunk once (keeping the 8 sub-chunk starts,
//    16 KB) and each sub-chunk into registers. The stage is not double
//    buffered: a second stage would not fit beside them.
//  - The recompute must be the forward's (scan_step, expf).
//  - z, B and C arrive as strided views (a half of in_proj's output,
//    slices of x_proj's), read through their row strides as in the
//    forward; dx, ddt, dz, dB and dC are written contiguous. The stage is
//    copied in 16-byte pieces where every row and pointer allows (d_in and
//    z's stride multiples of 8, B's and C's of 4), else element by element
//    (bf16 then through registers).
//  - The per-cluster partials of dB and dC are (B, S, clusters, 2N) f32:
//    134 MB at (1,4096,16384,16) with clusters of 2, written once and read
//    once by the second launch (per-block partials, PR 30's, were 268 MB).
// Every output is computed (the autograd Function asks for all of them).
// chip_smoke.py prints ptxas -v and selective_scan_bwd_plan.

#define SELECTIVE_SCAN_KERNEL_ONLY
#include "selective_scan.cu"

#include <cooperative_groups.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kSub = 4;           // tokens a reverse sub-chunk
constexpr int kBwdMinBlocks = 4;  // blocks an SM the registers leave room for
constexpr int kCluster = 2;       // blocks a cluster summing dB and dC
constexpr int kRecGroup = 8;      // tokens a recompute group
constexpr int kExBufs = 2;        // sub-chunks' dB/dC exchanges in flight

template <typename T, int N, int G>
struct BwdGeometry {
  using Geo = Geometry<N, G>;
  static constexpr int NS = Geo::kStates, CB = Geo::kChannels;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSubs = kChunk / kSub;        // sub-chunks a chunk
  static constexpr int kPer = kSub / G;              // tokens a lane finishes
  static constexpr int kOct = CB / 8;               // stage: 8-channel units
  static constexpr int V = 2 * NS;                   // a lane's dB, dC terms
  static constexpr int kSlice = kChunk / kCluster;   // rows a cluster rank sums
  static_assert(kSub % G == 0 && kChunk % kSub == 0, "sub-chunks");
  static_assert(kRecGroup % kSub == 0 && kChunk % kRecGroup == 0, "groups");
  static_assert(CB % 8 == 0 && kChunk * kOct == kThreads,
                "a thread stages one row's 8 channels");
  static_assert(V <= 32 / G, "a warp's channels reduce-scatter a lane's terms");
  static_assert(kChunk % kCluster == 0, "cluster slices");
  static_assert(NS == 1 || NS % 4 == 0, "16-byte shared accesses");
  // dynamic shared memory, in bytes, each part a multiple of 16
  static constexpr int kX = kChunk * CB * static_cast<int>(sizeof(T));  // x
  static constexpr int kV = kChunk * CB * 4;          // dt, then sigmoid(v)
  static constexpr int kBc = kChunk * 2 * N * 4;      // B, then C
  static constexpr int kDd = kChunk * CB * 8;         // {δ, do}
  static constexpr int kHs = kSubs * kThreads * NS * 4;  // sub-chunk starts
  // the warps' dB and dC of kExBufs sub-chunks; a barrier every half of them
  static constexpr int kPair = kExBufs / 2;
  static_assert(kExBufs % 2 == 0 && kSubs % kPair == 0, "exchanges");
  static constexpr int kEx = kExBufs * kSub * kWarps * 32 * 4;
  static constexpr int kCs = 2 * kChunk * 2 * N * 4;  // block partials
  static constexpr int oX = 0, oZ = oX + kX, oDy = oZ + kX, oV = oDy + kX,
                       oBc = oV + kV, oDd = oBc + kBc, oHs = oDd + kDd,
                       oEx = oHs + kHs, oCs = oEx + kEx;
  static constexpr int kBytes = oCs + kCs;
  // block barriers a full chunk: the stage's and one a sub-chunk
  static constexpr int kBarriers = 1 + kSubs / kPair;
};

template <int K>
__device__ __forceinline__ void store_shared(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
}

// BYTES from global to shared memory, asynchronously; zeros where !valid
// (src must still be a mapped address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// One element from global to shared memory, zero where !valid: 4 bytes
// asynchronously, 2 bytes through registers
template <typename E>
__device__ __forceinline__ void copy_elem(E* dst, const E* src, bool valid) {
  if constexpr (sizeof(E) == 4) {
    cp_async<4>(dst, src, valid);
  } else {
    *dst = valid ? *src : from_f32<E>(0.0f);
  }
}

// 4 consecutive elements of shared memory (aligned to them) as floats
template <typename T>
__device__ __forceinline__ void load4(float (&v)[4], const T* p) {
  if constexpr (sizeof(T) == 4) {
    load_shared<4>(v, reinterpret_cast<const float*>(p));
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// K values to K/2 between lanes that differ in bit M: the lane with the bit
// set keeps the upper half, its partner the lower; each kept value is the
// keeper's plus the partner's (one lane computes each sum)
template <int K, int M>
__device__ __forceinline__ void halve(const float (&v)[K], float (&out)[K / 2],
                                      int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    const float send = up ? v[i] : v[K / 2 + i];
    const float keep = up ? v[K / 2 + i] : v[i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// The channel's G lanes' K values reduce-scattered (lane bits M, M/2, ...,
// 1): lane g ends with values [g·K/G, (g+1)·K/G), summed over the G lanes
template <int K, int M>
__device__ __forceinline__ void lane_scatter(const float (&v)[K], float* out,
                                             int lane) {
  if constexpr (M == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = v[i];
  } else {
    float w[K / 2];
    halve<K, M>(v, w, lane);
    lane_scatter<K / 2, M / 2>(w, out, lane);
  }
}

// A lane's K terms summed over the warp's 32/G channels (lane bits 16, 8,
// ..., G): halved while there are two or more, then all-reduced. The lane
// ends with term (lane & (32 - 32/K)) / (32/K) of its lane group's.
template <int G, int K, int M = 16>
__device__ __forceinline__ float channel_sum(const float (&v)[K], int lane) {
  if constexpr (M < G) {
    static_assert(K == 1, "terms left over");
    return v[0];
  } else if constexpr (K == 1) {
    const float w[1] = {v[0] + __shfl_xor_sync(0xffffffffu, v[0], M)};
    return channel_sum<G, 1, M / 2>(w, lane);
  } else {
    float w[K / 2];
    halve<K, M>(v, w, lane);
    return channel_sum<G, K / 2, M / 2>(w, lane);
  }
}

template <typename T, int N, int G>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kBwdMinBlocks) selective_scan_bwd_kernel(
        const T* __restrict__ x, const float* __restrict__ dt,
        const T* __restrict__ z, long long zs, const float* __restrict__ Bc,
        long long bs, const float* __restrict__ Cc, long long cs,
        const float* __restrict__ A_log, const float* __restrict__ Dp,
        const float* __restrict__ dt_bias, const float* __restrict__ hs,
        const T* __restrict__ dy, const float* __restrict__ dh_last,
        T* __restrict__ dx, float* __restrict__ ddt, T* __restrict__ dz,
        float* __restrict__ dh0, float* __restrict__ part_bc,
        float* __restrict__ part_A, float* __restrict__ part_D,
        float* __restrict__ part_bias, int S, int d_in, int vec) {
  using Bwd = BwdGeometry<T, N, G>;
  constexpr int NS = Bwd::NS, CB = Bwd::CB, V = Bwd::V, kPer = Bwd::kPer;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T (*s_x)[CB] = reinterpret_cast<T (*)[CB]>(smem + Bwd::oX);
  T (*s_z)[CB] = reinterpret_cast<T (*)[CB]>(smem + Bwd::oZ);
  T (*s_dy)[CB] = reinterpret_cast<T (*)[CB]>(smem + Bwd::oDy);
  float (*s_v)[CB] = reinterpret_cast<float (*)[CB]>(smem + Bwd::oV);
  float (*s_bc)[2 * N] = reinterpret_cast<float (*)[2 * N]>(smem + Bwd::oBc);
  float2 (*s_dd)[CB] = reinterpret_cast<float2 (*)[CB]>(smem + Bwd::oDd);
  float* s_hs = reinterpret_cast<float*>(smem + Bwd::oHs);  // [j][tid][NS]
  float* s_ex = reinterpret_cast<float*>(smem + Bwd::oEx);  // [b][w][i][32]
  float* s_cs = reinterpret_cast<float*>(smem + Bwd::oCs);  // [b][t][2N]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // 32-bit indices (B·S and d_in fit, the launch checks); element offsets
  // in global memory are taken in 64 bits where they are formed
  const int base = blockIdx.x * CB;
  const int row0 = blockIdx.y * S;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  // the recompute's and reverse pass's thread: channel c, lane g
  const int cl = tid / G, g = tid % G;
  const int c = base + cl;
  const bool live = c < d_in;
  const float Dc = live ? Dp[c] : 0.0f;
  // this thread's states of dh_last, dh0 and part_A
  const auto hrow = [&] {
    return (static_cast<long long>(blockIdx.y) * d_in + c) * N + g * NS;
  };
  float A[NS], dh[NS], dA[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = live ? -expf(A_log[static_cast<long long>(c) * N + g * NS + n])
                : 0.0f;
    dh[n] = live && dh_last != nullptr ? dh_last[hrow() + n] : 0.0f;
    dA[n] = 0.0f;
  }
  float accD = 0.0f, accBias = 0.0f;

  // Chunk k's stage rows [lo, hi) below len copied in: x, dt, z and dy of
  // row su's 8 channels by this thread (which alone stages them), in
  // 16-byte pieces where `vec` (aligned rows), else element by element; B
  // and C rows by any thread
  auto copy_rows = [&](int k, int lo, int hi, int len) {
    const int su = tid / Bwd::kOct, c8 = 8 * (tid % Bwd::kOct);
    const long long r0 = static_cast<long long>(row0) + k * kChunk;
    if (su >= lo && su < hi && su < len) {
      const long long r = r0 + su;
      if (vec) {
        constexpr int kE = 16 / static_cast<int>(sizeof(T));
#pragma unroll
        for (int e = 0; e < 8; e += kE) {
          const bool v = base + c8 + e < d_in;
          const int cc = v ? base + c8 + e : 0;
          cp_async<16>(&s_x[su][c8 + e], x + r * d_in + cc, v);
          cp_async<16>(&s_z[su][c8 + e], z + r * zs + cc, v);
          cp_async<16>(&s_dy[su][c8 + e], dy + r * d_in + cc, v);
        }
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const bool v = base + c8 + e < d_in;
          const int cc = v ? base + c8 + e : 0;
          cp_async<16>(&s_v[su][c8 + e], dt + r * d_in + cc, v);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool v = base + c8 + e < d_in;
          const int cc = v ? base + c8 + e : 0;
          copy_elem<T>(&s_x[su][c8 + e], x + r * d_in + cc, v);
          copy_elem<T>(&s_z[su][c8 + e], z + r * zs + cc, v);
          copy_elem<T>(&s_dy[su][c8 + e], dy + r * d_in + cc, v);
          copy_elem<float>(&s_v[su][c8 + e], dt + r * d_in + cc, v);
        }
      }
    }
#pragma unroll 1
    for (int e = tid; e < (hi - lo) * 2 * N; e += kThreads) {
      const int t = lo + e / (2 * N), jb = e % (2 * N);
      if (t < len && (!vec || jb % 4 == 0)) {
        const long long r = r0 + t;
        const float* src = jb < N ? Bc + r * bs + jb : Cc + r * cs + (jb - N);
        if (vec) {
          cp_async<16>(&s_bc[t][jb], src, true);
        } else {
          cp_async<4>(&s_bc[t][jb], src, true);
        }
      }
    }
  };
  auto copy_start = [&](int k) {
    const float* src = hs + ((static_cast<long long>(blockIdx.y) * n_chunks
                              + k) * d_in + (live ? c : 0)) * N + g * NS;
    cp_async<4 * NS>(s_hs + tid * NS, src, live);
  };

  // 1. δ, do and sigmoid(v) of the thread's own (token, channel)s, 4
  // channels at a time
  auto stage = [&](int len) {
    const int su = tid / Bwd::kOct, c8 = 8 * (tid % Bwd::kOct);
    if (su < len) {
#pragma unroll
      for (int c4 = c8; c4 < c8 + 8; c4 += 4) {
        float v[4], zv[4], dyv[4], sg[4], dd[8];
        load_shared<4>(v, &s_v[su][c4]);
        load4<T>(zv, &s_z[su][c4]);
        load4<T>(dyv, &s_dy[su][c4]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = base + c4 + e < d_in;
          const float ve = v[e] + (ok ? __ldg(dt_bias + base + c4 + e) : 0.0f);
          const float ev = expf(-fabsf(ve));
          const float delta = fmaxf(ve, 0.0f) + log1pf(ev);
          const float r = 1.0f / (1.0f + ev);
          sg[e] = ve >= 0.0f ? r : ev * r;
          const float gz = to_f32(from_f32<T>(zv[e] / (1.0f + expf(-zv[e]))));
          const float dov = to_f32(from_f32<T>(dyv[e] * gz));
          dd[2 * e] = ok ? delta : 0.0f;
          dd[2 * e + 1] = ok ? dov : 0.0f;
        }
        store_shared<4>(&s_v[su][c4], sg);
        store_shared<8>(reinterpret_cast<float*>(&s_dd[su][c4]), dd);
      }
    }
  };

  // 2. U tokens of the chunk from t in the forward's form; h after every
  // kSub-th token into the slot of the sub-chunk it starts
  float h[NS];
  auto recompute = [&](auto u, int t) {
    constexpr int U = decltype(u)::value;
    float dl[U], dxv[U], b[U][NS], e[U][NS];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      dl[i] = s_dd[t + i][cl].x;
      dxv[i] = dl[i] * to_f32(s_x[t + i][cl]);
      load_shared<NS>(b[i], &s_bc[t + i][g * NS]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) e[i][n] = expf(dl[i] * A[n]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = scan_step(e[i][n], h[n], dxv[i], b[i][n]);
      }
      if ((i + 1) % kSub == 0) {
        store_shared<NS>(s_hs + (((t + i + 1) / kSub) * kThreads + tid) * NS,
                         h);
      }
    }
  };

  // 3. sub-chunk j (tokens ts .. ts + ul - 1) of the chunk at t0: recompute,
  // reverse pass, the warp's dB and dC into exchange j % kExBufs, dx, ddt,
  // dz
  auto sub = [&](auto full, int j, int t0, int ul) {
    constexpr bool kFull = decltype(full)::value;
    const int ts = j * kSub;
    float hh[kSub + 1][NS], ee[kSub][NS], dl[kSub], dxv[kSub];
    load_shared<NS>(hh[0], s_hs + (j * kThreads + tid) * NS);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      if (kFull || i < ul) {
        dl[i] = s_dd[ts + i][cl].x;
        dxv[i] = dl[i] * to_f32(s_x[ts + i][cl]);
#pragma unroll
        for (int n = 0; n < NS; ++n) ee[i][n] = expf(dl[i] * A[n]);
      }
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      if (kFull || i < ul) {
        float b[NS];
        load_shared<NS>(b, &s_bc[ts + i][g * NS]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          hh[i + 1][n] = scan_step(ee[i][n], hh[i][n], dxv[i], b[n]);
        }
      }
    }
    float da[kSub], sb[kSub], op[kSub];
    float* ex = s_ex + ((j % kExBufs) * Bwd::kWarps + warp) * kSub * 32;
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      da[i] = sb[i] = op[i] = 0.0f;
      if (kFull || i < ul) {
        const float2 dd = s_dd[ts + i][cl];     // δ, do
        const float dov = dd.y, dxi = dd.x * to_f32(s_x[ts + i][cl]);
        float b[NS], cc[NS], red[V];
        load_shared<NS>(b, &s_bc[ts + i][g * NS]);
        load_shared<NS>(cc, &s_bc[ts + i][N + g * NS]);
        float a = 0.0f, s = 0.0f, o = 0.0f;
#pragma unroll
        for (int n = 0; n < NS; ++n) o = __fmaf_rn(hh[i + 1][n], cc[n], o);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          dh[n] = fmaf(dov, cc[n], dh[n]);
          red[n] = dxi * dh[n];                 // dB's term
          red[NS + n] = dov * hh[i + 1][n];     // dC's term
          s = fmaf(b[n], dh[n], s);
          const float qn = dh[n] * hh[i][n] * ee[i][n];
          a = fmaf(qn, A[n], a);
          dA[n] = fmaf(qn, dd.x, dA[n]);
          dh[n] *= ee[i][n];
        }
        da[i] = a;
        sb[i] = s;
        op[i] = o;
        // the token's dB and dC over the warp's channels into ex[i]: lane
        // (c', g) ends with term c' >> (3 - log2 V) of lane group g's
        const float e = channel_sum<G, V>(red, lane);
        if ((lane & ((32 - G) & ~(32 - 32 / V))) == 0) ex[i * 32 + lane] = e;
      }
    }
    // dx, ddt and dz of lane g's tokens ts + g·kPer + i, their partials
    // summed over the channel's G lanes by a shuffle reduce-scatter
    float fa[kPer], fs[kPer], fo[kPer];
    lane_scatter<kSub, G / 2>(da, fa, lane);
    lane_scatter<kSub, G / 2>(sb, fs, lane);
    lane_scatter<kSub, G / 2>(op, fo, lane);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int tl = g * kPer + i, t = ts + tl;
      if ((kFull || tl < ul) && live) {
        const long long r = static_cast<long long>(row0 + t0 + t) * d_in + c;
        const float2 dd = s_dd[t][cl];
        const float xv = to_f32(s_x[t][cl]), zv = to_f32(s_z[t][cl]);
        const float dyv = to_f32(s_dy[t][cl]);
        const float o = fo[i] + __fmul_rn(xv, Dc);
        const float sig = 1.0f / (1.0f + expf(-zv));
        const float dgate = to_f32(from_f32<T>(dyv * to_f32(from_f32<T>(o))));
        dz[r] = from_f32<T>(dgate * (sig * (1.0f + zv * (1.0f - sig))));
        const float dv = fmaf(xv, fs[i], fa[i]) * s_v[t][cl];
        dx[r] = from_f32<T>(fmaf(dd.x, fs[i], dd.y * Dc));
        ddt[r] = dv;
        accD += dd.y * xv;
        accBias += dv;
      }
    }
  };

  // after the barrier that follows sub-chunk j: its block partial of dB and
  // dC (the warps added in order) into the chunk's rows of buffer kb
  auto block_sum = [&](int j, int kb, int ul) {
#pragma unroll 1
    for (int o = tid; o < kSub * 2 * N; o += kThreads) {
      const int i = o / (2 * N), w = o % (2 * N);
      if (i < ul) {
        const int gw = (w % N) / NS, v = (w / N) * NS + w % NS;
        const float* ex = s_ex
                          + ((j % kExBufs) * Bwd::kWarps * kSub + i) * 32
                          + v * (32 / V) + gw;
        float s = ex[0];
#pragma unroll
        for (int wp = 1; wp < Bwd::kWarps; ++wp) s += ex[wp * kSub * 32];
        s_cs[(kb * kChunk + j * kSub + i) * 2 * N + w] = s;
      }
    }
  };

  // 4. slice `rank` of chunk k's block partials (buffer kb, len rows)
  // summed over the cluster's ranks in order into the cluster's partial
  auto cluster_sum = [&](int k, int kb, int len) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = blockIdx.x % kCluster, n_cl = gridDim.x / kCluster;
#pragma unroll 1
    for (int o = tid; o < Bwd::kSlice * 2 * N; o += kThreads) {
      const int t = rank * Bwd::kSlice + o / (2 * N), w = o % (2 * N);
      if (t < len) {
        float* mine = s_cs + (kb * kChunk + t) * 2 * N + w;
        float s = *cluster.map_shared_rank(mine, 0);
#pragma unroll
        for (int r = 1; r < kCluster; ++r) {
          s += *cluster.map_shared_rank(mine, r);
        }
        part_bc[(static_cast<long long>(row0 + k * kChunk + t) * n_cl
                 + blockIdx.x / kCluster) * 2 * N + w] = s;
      }
    }
  };

  using Full = std::integral_constant<bool, true>;
  using Part = std::integral_constant<bool, false>;
  {
    const int k = n_chunks - 1;
    copy_rows(k, 0, kChunk, static_cast<int>(S - k * kChunk));
    copy_start(k);
    cp_async_commit();
  }
#pragma unroll 1
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, S - t0);
    const int n_subs = (len + kSub - 1) / kSub;
    cp_async_wait_all();
    stage(len);
    __syncthreads();
    if (k + 1 < n_chunks) {  // the chunk after this one, summed
      cluster_wait();
      cluster_sum(k + 1, (k + 1) & 1, min(kChunk, S - t0 - kChunk));
    }
    load_shared<NS>(h, s_hs + tid * NS);
    {  // up to the last sub-chunk's start: that sub-chunk recomputes itself
      const int lr = (n_subs - 1) * kSub;
      int t = 0;
#pragma unroll 1
      for (; t + kRecGroup <= lr; t += kRecGroup) {
        recompute(std::integral_constant<int, kRecGroup>(), t);
      }
#pragma unroll 1
      for (; t + kSub <= lr; t += kSub) {
        recompute(std::integral_constant<int, kSub>(), t);
      }
    }
#pragma unroll 1
    for (int j = n_subs - 1; j >= 0; --j) {
      const int ul = min(kSub, len - j * kSub);
      if (ul == kSub) {
        sub(Full(), j, t0, ul);
      } else {
        sub(Part(), j, t0, ul);
      }
      if (j % Bwd::kPair == 0) {  // the exchanges since the last barrier
        __syncthreads();
#pragma unroll 1
        for (int jj = min(j + Bwd::kPair, n_subs) - 1; jj >= j; --jj) {
          block_sum(jj, static_cast<int>(k & 1), min(kSub, len - jj * kSub));
        }
      }
    }
    if (k > 0) {  // the stage and the slot-0 start: no thread reads them again
      copy_rows(k - 1, 0, kChunk, kChunk);
      copy_start(k - 1);
      cp_async_commit();
    }
    cluster_arrive();
  }
  cluster_wait();
  cluster_sum(0, 0, min(kChunk, S));
  cluster_arrive();  // no block leaves while another reads its shared memory
  if (live) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      dh0[hrow() + n] = dh[n];
      part_A[hrow() + n] = dA[n];
    }
  }
  // dD and ddt_bias: the channel's G lanes in lane order
  float sD = __shfl_sync(0xffffffffu, accD, lane - g);
  float sB = __shfl_sync(0xffffffffu, accBias, lane - g);
#pragma unroll
  for (int i = 1; i < G; ++i) {
    sD += __shfl_sync(0xffffffffu, accD, lane - g + i);
    sB += __shfl_sync(0xffffffffu, accBias, lane - g + i);
  }
  if (g == 0 && live) {
    const long long at = static_cast<long long>(blockIdx.y) * d_in + c;
    part_D[at] = sD;
    part_bias[at] = sB;
  }
  cluster_wait();
}

// The second launch: dB and dC summed over the clusters in cluster order,
// dA_log, dD and ddt_bias over the batch rows in order.
__global__ void selective_scan_bwd_sum_kernel(
    const float* __restrict__ part_bc, int clusters, long long rows, int N,
    const float* __restrict__ part_A, const float* __restrict__ part_D,
    const float* __restrict__ part_bias, const float* __restrict__ A_log,
    float* __restrict__ dBc, float* __restrict__ dCc,
    float* __restrict__ dA_log, float* __restrict__ dD,
    float* __restrict__ ddt_bias, int B, int d_in) {
  const long long n_bc = rows * 2 * N, n_a = static_cast<long long>(d_in) * N;
  const long long total = n_bc + n_a + d_in;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const long long r = i / (2 * N);
      const int w = static_cast<int>(i % (2 * N));
      const float* p = part_bc + r * clusters * 2 * N + w;
      float s = 0.0f;
#pragma unroll 8
      for (int k = 0; k < clusters; ++k) {
        s += p[static_cast<long long>(k) * 2 * N];
      }
      if (w < N) {
        dBc[r * N + w] = s;
      } else {
        dCc[r * N + w - N] = s;
      }
    } else if (i < n_bc + n_a) {
      const long long j = i - n_bc;
      float s = 0.0f;
      for (int b = 0; b < B; ++b) s += part_A[b * n_a + j];
      dA_log[j] = s * -expf(A_log[j]);
    } else {
      const long long j = i - n_bc - n_a;
      float sd = 0.0f, sb = 0.0f;
      for (int b = 0; b < B; ++b) {
        sd += part_D[b * static_cast<long long>(d_in) + j];
        sb += part_bias[b * static_cast<long long>(d_in) + j];
      }
      dD[j] = sd;
      ddt_bias[j] = sb;
    }
  }
}

template <typename T, int N>
auto bwd_kernel_of() {
  return selective_scan_bwd_kernel<T, N, lanes<N>()>;
}

// blocks across d_in, rounded up to whole clusters
template <int N>
int bwd_blocks(int d_in) {
  constexpr int CB = Geometry<N, lanes<N>()>::kChannels;
  const int blocks = (d_in + CB - 1) / CB;
  return (blocks + kCluster - 1) / kCluster * kCluster;
}

template <int N>
long long scratch_floats(int B, int S, int d_in) {
  return static_cast<long long>(B) * S * (bwd_blocks<N>(d_in) / kCluster)
             * 2 * N
         + static_cast<long long>(B) * d_in * (N + 2);
}

template <typename T, int N>
cudaError_t bwd_launch(const void* x, const void* dt, const void* z,
                       long long zs, const void* Bc, long long bs,
                       const void* Cc, long long cs, const void* A_log,
                       const void* D, const void* dt_bias, const void* hs,
                       const void* dy, const void* dh_last, void* dx,
                       void* ddt, void* dz, void* dBc, void* dCc,
                       void* dA_log, void* dD, void* ddt_bias, void* dh0,
                       void* scratch, int B, int S, int d_in,
                       cudaStream_t st) {
  using Bwd = BwdGeometry<T, N, lanes<N>()>;
  const auto kernel = bwd_kernel_of<T, N>();
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd::kBytes);
  if (attr != cudaSuccess) return attr;
  const int blocks = bwd_blocks<N>(d_in);
  // the stage in 16-byte copies: rows and pointers 16-byte aligned
  const auto al = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int vec = d_in % 8 == 0 && zs % 8 == 0 && bs % 4 == 0 && cs % 4 == 0
                  && al(x) && al(z) && al(dy) && al(dt) && al(Bc) && al(Cc);
  float* part_bc = static_cast<float*>(scratch);
  float* part_A = part_bc + static_cast<long long>(B) * S
                                * (blocks / kCluster) * 2 * N;
  float* part_D = part_A + static_cast<long long>(B) * d_in * N;
  float* part_bias = part_D + static_cast<long long>(B) * d_in;
  kernel<<<dim3(blocks, B), kThreads, Bwd::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(z), zs, static_cast<const float*>(Bc), bs,
      static_cast<const float*>(Cc), cs, static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<const float*>(dt_bias),
      static_cast<const float*>(hs), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<T*>(dz),
      static_cast<float*>(dh0), part_bc, part_A, part_D, part_bias, S, d_in,
      vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * S;
  const long long total = rows * 2 * N + static_cast<long long>(d_in) * N
                          + d_in;
  const int sum_grid = static_cast<int>(std::min<long long>(
      (total + 255) / 256, 132LL * 16));
  selective_scan_bwd_sum_kernel<<<sum_grid, 256, 0, st>>>(
      part_bc, blocks / kCluster, rows, N, part_A, part_D, part_bias,
      static_cast<const float*>(A_log), static_cast<float*>(dBc),
      static_cast<float*>(dCc), static_cast<float*>(dA_log),
      static_cast<float*>(dD), static_cast<float*>(ddt_bias), B, d_in);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch_n(int N, const void* x, const void* dt,
                           const void* z, long long zs, const void* Bc,
                           long long bs, const void* Cc, long long cs,
                           const void* A_log, const void* D,
                           const void* dt_bias, const void* hs,
                           const void* dy, const void* dh_last, void* dx,
                           void* ddt, void* dz, void* dBc, void* dCc,
                           void* dA_log, void* dD, void* ddt_bias, void* dh0,
                           void* scratch, int B, int S, int d_in,
                           cudaStream_t st) {
  if (N == 4) {
    return bwd_launch<T, 4>(x, dt, z, zs, Bc, bs, Cc, cs, A_log, D, dt_bias,
                            hs, dy, dh_last, dx, ddt, dz, dBc, dCc, dA_log,
                            dD, ddt_bias, dh0, scratch, B, S, d_in, st);
  }
  if (N == 16) {
    return bwd_launch<T, 16>(x, dt, z, zs, Bc, bs, Cc, cs, A_log, D,
                             dt_bias, hs, dy, dh_last, dx, ddt, dz, dBc, dCc,
                             dA_log, dD, ddt_bias, dh0, scratch, B, S, d_in,
                             st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int N>
cudaError_t bwd_plan_of(int* plan) {
  using Bwd = BwdGeometry<T, N, lanes<N>()>;
  const auto kernel = bwd_kernel_of<T, N>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd::kBytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0, clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, Bwd::kBytes);
  }
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = Bwd::kBytes;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  const int out[10] = {lanes<N>(), Bwd::CB, kSub, kThreads, attr.numRegs,
                       Bwd::kBytes, blocks, kCluster, Bwd::kBarriers,
                       clusters};
  for (int i = 0; i < 10; ++i) plan[i] = out[i];
  return cudaSuccess;
}

}  // namespace

// The forward's inputs as selective_scan_launch takes them (z, Bc and Cc
// through their row strides), hs: the forward's h_chunks, (B,
// ceil(S / kChunk), d_in, N) f32; dy: (B, S, d_in) in x's dtype,
// contiguous; dh_last: null (zero) or (B, d_in, N) f32. Outputs, all
// contiguous: dx, dz (B, S, d_in) in x's dtype, ddt (B, S, d_in) f32, dBc,
// dCc (B, S, N) f32, dA_log (d_in, N), dD, ddt_bias (d_in,), dh0 (B, d_in,
// N) f32; scratch: selective_scan_bwd_scratch_floats(B, S, d_in, N)
// floats. Two launches (the second sums the first's per-cluster partials).
// Returns cudaGetLastError() after them.
extern "C" int selective_scan_bwd_launch(
    const void* x, const void* dt, const void* z, const void* Bc,
    const void* Cc, const void* A_log, const void* D, const void* dt_bias,
    const void* hs, const void* dy, const void* dh_last, void* dx, void* ddt,
    void* dz, void* dBc, void* dCc, void* dA_log, void* dD, void* ddt_bias,
    void* dh0, void* scratch, long long z_stride, long long bc_stride,
    long long cc_stride, int B, int S, int d_in, int N, int dtype,
    void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || d_in <= 0 || z_stride < 0 ||
      bc_stride < 0 || cc_stride < 0 ||
      static_cast<long long>(B) * S * d_in > (1LL << 40) ||
      static_cast<long long>(B) * S >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd_dispatch_n<float>(N, x, dt, z, z_stride, Bc, bc_stride, Cc,
                                cc_stride, A_log, D, dt_bias, hs, dy, dh_last,
                                dx, ddt, dz, dBc, dCc, dA_log, dD, ddt_bias,
                                dh0, scratch, B, S, d_in, st);
  } else if (dtype == 1) {
    err = bwd_dispatch_n<__nv_bfloat16>(
        N, x, dt, z, z_stride, Bc, bc_stride, Cc, cc_stride, A_log, D,
        dt_bias, hs, dy, dh_last, dx, ddt, dz, dBc, dCc, dA_log, dD,
        ddt_bias, dh0, scratch, B, S, d_in, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The floats of a backward launch's scratch: the per-cluster partials of
// dB and dC, (B, S, clusters, 2N), then dA's (B, d_in, N), dD's and
// ddt_bias's (B, d_in) each. 0 for an N with no instance.
extern "C" long long selective_scan_bwd_scratch_floats(int B, int S, int d_in,
                                                       int N) {
  if (N == 4) return scratch_floats<4>(B, S, d_in);
  if (N == 16) return scratch_floats<16>(B, S, d_in);
  return 0;
}

// The backward's geometry of the (N, dtype) instance into plan[10]: lanes a
// channel, channels a block, tokens a reverse sub-chunk, threads a block,
// registers a thread, dynamic shared memory a block (bytes), blocks an SM,
// blocks a cluster, block barriers a full chunk (the cluster's one split
// barrier a chunk besides), and the clusters the card holds at once.
extern "C" int selective_scan_bwd_plan(int N, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && N == 4) err = bwd_plan_of<float, 4>(plan);
  if (dtype == 0 && N == 16) err = bwd_plan_of<float, 16>(plan);
  if (dtype == 1 && N == 4) err = bwd_plan_of<__nv_bfloat16, 4>(plan);
  if (dtype == 1 && N == 16) err = bwd_plan_of<__nv_bfloat16, 16>(plan);
  return static_cast<int>(err);
}
