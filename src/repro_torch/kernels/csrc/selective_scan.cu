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
//   o     = sum_n h[n] * C[b,t,n] + x[b,t,c] * D[c]
//   y     = T(T(o) * T(silu(z[b,t,c])))            (T: the model type)
// and h_last[b,c,:] = h after the last token. x, z and y are the model
// type (float32 or bfloat16), everything else f32. exp and log1p are the
// full-precision expf and log1pf, not the __ intrinsics, so that f32
// stays within 1e-5 of the plain version. The sum over n runs in lane
// groups (below): each lane sums its N/G states in n order, then the G
// lanes' partials are added in g order; at G = 1 that is the plain n
// order. It is the only difference from the plain version's arithmetic.
//
// Bound on this card: per (token, channel) the kernel moves x, z and y in
// the model type and dt in f32 (10 bytes in bf16; B and C are per token,
// shared by every channel), and issues N exponentials, 2 transcendentals
// for softplus and 2 for silu(z) on the SFU (MUFU, 16 a clock an SM): at
// N = 16 about 20 MUFU operations against 10 bytes, so the SFU issue rate
// bounds it above the byte rate (chip_smoke.py: scan_mufu_ops). Each
// full-precision expf is 8 instructions around its one MUFU.EX2, so the
// issue slots (4 warp instructions a clock an SM) come close behind.
//
// Design. Thread (c, g) of a lane group owns states [g·N/G, (g+1)·N/G) of
// channel c and keeps them and their A in registers; a block is kThreads
// threads, kThreads / G consecutive channels of one batch row. At G = 4,
// d_in 16384 and B = 1 that is 65,536 threads (512 blocks of 128), about
// 15.5 warps an SM, four times the earlier one-thread-a-channel form,
// whose 4 warps an SM each ran a serial chain of softplus, 16 exponentials,
// 16 dependent adds and the gate a token and kept neither the SFU nor
// memory busy (5.3-5.4x its bound). Every block runs the whole sequence,
// so all of them must be resident at once: kMinBlocks caps the registers
// at 128 a thread (4 blocks an SM; at 3, 396 blocks run and the rest wait
// a whole second pass). Tokens go in chunks of kChunk, each in three
// phases separated by two block barriers:
//   1. stage: thread (c1, q), c1 = tid % channels, q = tid / channels,
//      takes the chunk's tokens q, q + G, ... of channel c1 (coalesced
//      across a warp), computes softplus once per (token, channel) and
//      stores {delta, delta·x} for the scan and {x·D, z} for the gate in
//      shared memory; the chunk's B and C rows are staged beside them.
//      Right after the barrier the thread issues the next chunk's loads
//      into its registers (32-bit offsets from a per-chunk base), so they
//      fly during the scan and the gate.
//   2. scan: each thread walks the chunk's tokens for its N/G states in
//      groups of kGroup tokens: the group's operands first, then its
//      kGroup·N/G exponentials (they depend on delta, not on h), then the
//      recurrence, storing each token's partial sum of h·C at [t][tid].
//   3. gate: thread (c1, q) again, for its tokens: the G partials (one
//      16-byte read at G = 4) added in g order, + x·D, silu(z), rounded as
//      gate<T> does, y stored coalesced.
// A chunk of kChunk tokens takes branch-free copies of phases 1 and 3 and
// of the loads (kFull); only a sequence's last chunk checks its tokens.
// No atomics: two launches are bit-equal. h_last may alias h0 (decode's
// in-place state): each thread reads its own states of h0 before it writes
// them to h_last, and no other thread touches them; a lane group's stores
// are one contiguous run of N floats. z, B and C are read in place with a
// row stride (z is a half of in_proj's output, B and C slices of
// x_proj's), x, dt, y, h0 and h_last are contiguous.
//
// Why not split the sequence instead: chunks scanned in parallel need a
// second pass that carries h across chunk boundaries, which pays the N
// exponentials again (a chunk's local scan from zero, then its replay from
// the carried h), 2N + 4 = 36 MUFU operations a (token, channel) against
// 20, unless it stores the S·N decays. The lane groups keep one
// exponential per (token, channel, state) and still fill the card at
// B = 1; softplus and the gate leave the serial chain.
//
// The values won a sweep at path 10's shapes (tools/scan_ab.py --sweep,
// PERF.md §6): G = 4 against 2 (8 warps an SM, 5-7% slower at 4096
// tokens) and 8 (13% slower: 1,024 blocks, two passes at 4 an SM; capped
// at 64 registers for 8 an SM it spills and runs 40% slower); 128 threads
// and 32-token chunks against 256 threads and 16-token chunks (3% slower);
// groups of 8 tokens against 4, 2 and 1. At N = 4 (the SMOKE config) G = 4
// as well, one state a thread.
// On the H100 each instance holds 104-115 registers a thread (the kSave
// instances 108-120), 36,864 (N = 16) or 33,792 (N = 4) bytes of static
// shared memory a block and 4 blocks an SM (chip_smoke.py prints ptxas -v
// and selective_scan_plan).
//
// Under autograd (kSave, a non-null h_chunks) the kernel also writes h at
// the start of each kChunk-token chunk, (B, ceil(S / kChunk), d_in, N)
// f32: the backward (selective_scan_bwd.cu) recomputes each chunk's h from
// there. The recurrence step is scan_step, the one the backward calls:
// its multiply-add is written out (__fmaf_rn), so that the two kernels
// round h alike and the backward's h equals this kernel's bit for bit.
// Without h_chunks the kSave = false instance runs, as before.
// selective_scan_bwd.cu includes this file with SELECTIVE_SCAN_KERNEL_ONLY
// defined, for its constants and helpers, without the C entry points.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kChunk = 32;     // tokens staged in shared memory at once
constexpr int kGroup = 8;      // tokens a thread scans between its stores
// blocks an SM the registers must leave room for: at G = 4, d_in 16384
// and B = 1 the grid's 512 blocks then run at once on the 132 SMs
constexpr int kMinBlocks = 4;
// lanes a channel's states are split over, at d_state 16 and at 4
constexpr int kLanesN16 = 4;
constexpr int kLanesN4 = 4;

template <int N>
constexpr int lanes() {
  return N == 16 ? kLanesN16 : kLanesN4;
}

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

// K consecutive floats of shared memory, in 16- or 8-byte reads where K
// allows (p aligned to them)
template <int K>
__device__ __forceinline__ void load_shared(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = p[i];
  }
}

// h = e·h + (δ·x)·B and the partial sum acc + h·C, rounded as written: one
// product, then one fused multiply-add each (what nvcc contracts the
// plain expressions to, so the outputs equal the uncontracted source's)
__device__ __forceinline__ float scan_step(float e, float h, float dx,
                                           float b) {
  return __fmaf_rn(e, h, __fmul_rn(dx, b));
}

template <int N, int G>
struct Geometry {
  static_assert(N % G == 0 && kThreads % G == 0 && kChunk % G == 0, "G");
  static constexpr int kStates = N / G;               // states a thread
  static constexpr int kChannels = kThreads / G;      // channels a block
  static constexpr int kTokens = kChunk / G;          // phase-1/3 tokens
  // a chunk's B and C rows: a thread loads column tid % 2N of every
  // kBcRows-th row, at most kRows rows (kExact: each thread all kRows)
  static_assert(kThreads % (2 * N) == 0, "B and C staging");
  static constexpr int kBcRows = kThreads / (2 * N);
  static constexpr int kRows = (kChunk + kBcRows - 1) / kBcRows;
  static constexpr bool kExact = kRows * kBcRows == kChunk;
};

template <typename T, int N, int G, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    selective_scan_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const T* __restrict__ z, long long zs,
                          const float* __restrict__ Bc, long long bs,
                          const float* __restrict__ Cc, long long cs,
                          const float* __restrict__ A_log,
                          const float* __restrict__ Dp,
                          const float* __restrict__ dt_bias, const float* h0,
                          T* __restrict__ y, float* h_last,
                          float* __restrict__ h_chunks, int S, int d_in) {
  using Geo = Geometry<N, G>;
  constexpr int NS = Geo::kStates, CB = Geo::kChannels;
  __shared__ float2 s_dd[kChunk][CB];                    // {delta, delta·x}
  __shared__ float2 s_xz[kChunk][CB];                    // {x·D, z}
  __shared__ __align__(16) float s_bc[kChunk][2 * N];    // B, then C
  __shared__ __align__(16) float s_part[kChunk][kThreads];  // [t][c·G + g]
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * CB;
  const long long row0 = static_cast<long long>(blockIdx.y) * S;
  // phase 2's thread: channel c, lane g
  const int cl = tid / G, g = tid % G;
  const long long c = base + cl;
  const bool live = c < d_in;             // the last block may be ragged
  // phases 1 and 3: channel c1, tokens q, q + G, ...
  const int c1l = tid % CB, q = tid / CB;
  const long long c1 = base + c1l;
  const bool live1 = c1 < d_in;
  const long long hrow = (static_cast<long long>(blockIdx.y) * d_in + c) * N
                         + g * NS;
  float A[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = live ? -expf(A_log[c * N + g * NS + n]) : 0.0f;
    h[n] = live ? h0[hrow + n] : 0.0f;
  }
  const float bias = live1 ? dt_bias[c1] : 0.0f;
  const float Dc = live1 ? Dp[c1] : 0.0f;
  // The chunk at t0's inputs into this thread's registers: dt, x and z of
  // its phase-1 tokens of channel c1 (a channel past d_in reads the last
  // one; its values go unused), and column jb of its B and C rows. The
  // offsets between its tokens fit in 32 bits (the launch checks).
  float pdt[Geo::kTokens], pbc[Geo::kRows];
  T px[Geo::kTokens], pz[Geo::kTokens];
  const long long cld = live1 ? c1 : d_in - 1;
  const int dG = G * d_in, zG = G * static_cast<int>(zs);
  const int jb = tid % (2 * N), tb = tid / (2 * N);
  const float* bcol = jb < N ? Bc + jb : Cc + (jb - N);
  const long long bcs = jb < N ? bs : cs;
  const int bcG = Geo::kBcRows * static_cast<int>(bcs);
  auto load = [&](auto full, int t0, int len) {
    constexpr bool kFull = decltype(full)::value;
    const long long r = row0 + t0 + q;
    const float* pd = dt + r * d_in + cld;
    const T* pxr = x + r * d_in + cld;
    const T* pzr = z + r * zs + cld;
#pragma unroll
    for (int k = 0; k < Geo::kTokens; ++k) {
      if (kFull || q + k * G < len) {
        pdt[k] = pd[k * dG];
        px[k] = pxr[k * dG];
        pz[k] = pzr[k * zG];
      }
    }
    const float* pb = bcol + (row0 + t0 + tb) * bcs;
#pragma unroll
    for (int k = 0; k < Geo::kRows; ++k) {
      if ((kFull && Geo::kExact) || tb + k * Geo::kBcRows < len) {
        pbc[k] = pb[k * bcG];
      }
    }
  };
  // 1. delta once per (token, channel); x·D and z kept for phase 3 (by
  // this thread: it alone reads them, so they need no barrier). A channel
  // past d_in (its inputs the last channel's) stores a zero delta. kFull:
  // the chunk holds kChunk tokens, no token is checked.
  auto stage = [&](auto full, int len) {
    constexpr bool kFull = decltype(full)::value;
#pragma unroll
    for (int k = 0; k < Geo::kTokens; ++k) {
      const int t = q + k * G;
      if (kFull || t < len) {
        const float v = pdt[k] + bias, xv = to_f32(px[k]);
        const float delta = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
        s_dd[t][c1l] = live1 ? make_float2(delta, delta * xv)
                             : make_float2(0.0f, 0.0f);
        s_xz[t][c1l] = make_float2(xv * Dc, to_f32(pz[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < Geo::kRows; ++k) {
      const int t = tb + k * Geo::kBcRows;
      if ((kFull && Geo::kExact) || t < len) s_bc[t][jb] = pbc[k];
    }
  };
  // 2. U tokens of this lane's states from token t: the operands first,
  // then the U·NS exponentials (independent of h), then the recurrence
  // and each token's partial of sum h·C
  auto scan = [&](auto u, int t) {
    constexpr int U = decltype(u)::value;
    float2 dd[U];
    float b[U][NS], cc[U][NS], e[U][NS];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      dd[i] = s_dd[t + i][cl];
      load_shared<NS>(b[i], &s_bc[t + i][g * NS]);
      load_shared<NS>(cc[i], &s_bc[t + i][N + g * NS]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) e[i][n] = expf(dd[i].x * A[n]);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = scan_step(e[i][n], h[n], dd[i].y, b[i][n]);
        acc = __fmaf_rn(h[n], cc[i][n], acc);
      }
      s_part[t + i][tid] = acc;
    }
  };
  // 3. the partials in g order, x·D and the gate; y stored
  auto finish = [&](auto full, int t0, int len) {
    constexpr bool kFull = decltype(full)::value;
    T* yrow = y + (row0 + t0) * d_in + c1;
#pragma unroll
    for (int k = 0; k < Geo::kTokens; ++k) {
      const int t = q + k * G;
      if (kFull || t < len) {
        float p[G];
        load_shared<G>(p, &s_part[t][c1l * G]);
        float o = p[0];
#pragma unroll
        for (int i = 1; i < G; ++i) o += p[i];
        const float2 xz = s_xz[t][c1l];
        yrow[static_cast<long long>(t) * d_in] = gate<T>(o + xz.x, xz.y);
      }
    }
  };
  using Full = std::integral_constant<bool, true>;
  using Part = std::integral_constant<bool, false>;
  int t0 = 0, len = min(kChunk, S);
  if (len == kChunk) {
    load(Full(), 0, len);
  } else {
    load(Part(), 0, len);
  }
  const long long n_chunks = (S + kChunk - 1) / kChunk;
  while (t0 < S) {
    if constexpr (kSave) {      // h at the chunk's start, for the backward
      if (live) {
        float* hc = h_chunks + ((blockIdx.y * n_chunks + t0 / kChunk) * d_in
                                + c) * N + g * NS;
#pragma unroll
        for (int n = 0; n < NS; ++n) hc[n] = h[n];
      }
    }
    if (len == kChunk) {
      stage(Full(), len);
    } else {
      stage(Part(), len);
    }
    __syncthreads();
    const int t1 = t0 + len, len1 = min(kChunk, S - t1);
    if (len1 == kChunk) {
      load(Full(), t1, len1);
    } else if (len1 > 0) {
      load(Part(), t1, len1);
    }
    int t = 0;
    for (; t + kGroup <= len; t += kGroup) {
      scan(std::integral_constant<int, kGroup>(), t);
    }
    for (; t < len; ++t) scan(std::integral_constant<int, 1>(), t);
    __syncthreads();
    if (live1 && len == kChunk) {
      finish(Full(), t0, len);
    } else if (live1) {
      finish(Part(), t0, len);
    }
    // the next chunk's stage writes s_dd and s_bc, which every thread
    // finished reading before the barrier above; its scan writes s_part
    // only after its own first barrier, which every thread reaches after
    // this finish
    t0 = t1;
    len = len1;
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NS; ++n) h_last[hrow + n] = h[n];
  }
}

template <typename T, int N, bool kSave = false>
auto kernel_of() {
  return selective_scan_kernel<T, N, lanes<N>(), kSave>;
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* z,
                   long long zs, const void* Bc, long long bs, const void* Cc,
                   long long cs, const void* A_log, const void* D,
                   const void* dt_bias, const void* h0, void* y, void* h_last,
                   void* h_chunks, int B, int S, int d_in, cudaStream_t st) {
  constexpr int CB = Geometry<N, lanes<N>()>::kChannels;
  const dim3 grid((d_in + CB - 1) / CB, B);
  const auto kernel = h_chunks ? kernel_of<T, N, true>() : kernel_of<T, N>();
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(z), zs, static_cast<const float*>(Bc), bs,
      static_cast<const float*>(Cc), cs, static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<const float*>(dt_bias),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(h_chunks), S, d_in);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* dt, const void* z,
                       long long zs, const void* Bc, long long bs,
                       const void* Cc, long long cs, const void* A_log,
                       const void* D, const void* dt_bias, const void* h0,
                       void* y, void* h_last, void* h_chunks, int B, int S,
                       int d_in, int N, cudaStream_t st) {
  if (N == 4) {
    return launch<T, 4>(x, dt, z, zs, Bc, bs, Cc, cs, A_log, D, dt_bias, h0,
                        y, h_last, h_chunks, B, S, d_in, st);
  }
  if (N == 16) {
    return launch<T, 16>(x, dt, z, zs, Bc, bs, Cc, cs, A_log, D, dt_bias,
                         h0, y, h_last, h_chunks, B, S, d_in, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int N>
cudaError_t plan_of(int* plan) {
  using Geo = Geometry<N, lanes<N>()>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of<T, N>());
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_of<T, N>(), kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int out[7] = {lanes<N>(), Geo::kChannels, kChunk, kThreads,
                      attr.numRegs, static_cast<int>(attr.sharedSizeBytes),
                      blocks};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return cudaSuccess;
}

}  // namespace

#ifndef SELECTIVE_SCAN_KERNEL_ONLY
// x, dt, y: (B, S, d_in) contiguous, x and y in one dtype (0 = float32, 1
// = bfloat16), dt f32; z: (B, S, d_in) in x's dtype, row (b, t) at (b·S +
// t)·z_stride elements, each row contiguous; Bc, Cc: (B, S, N) f32 rows
// likewise at bc_stride and cc_stride; A_log: (d_in, N) f32; D, dt_bias:
// (d_in,) f32; h0, h_last: (B, d_in, N) f32 contiguous, h_last may be h0;
// h_chunks: null, or (B, ceil(S / kChunk), d_in, N) f32 receiving h at
// each chunk's start (kChunk tokens: selective_scan_plan's plan[2]).
// N is 4 or 16. Returns cudaGetLastError() after the launch.
extern "C" int selective_scan_launch(const void* x, const void* dt,
                                     const void* z, const void* Bc,
                                     const void* Cc, const void* A_log,
                                     const void* D, const void* dt_bias,
                                     const void* h0, void* y, void* h_last,
                                     void* h_chunks,
                                     long long z_stride, long long bc_stride,
                                     long long cc_stride, int B, int S,
                                     int d_in, int N, int dtype,
                                     void* stream) {
  // the offsets between a thread's tokens within a chunk are 32-bit
  const long long span = kChunk * std::max(std::max<long long>(d_in, z_stride),
                                           std::max(bc_stride, cc_stride));
  if (B <= 0 || B > 65535 || S <= 0 || d_in <= 0 || z_stride < 0 ||
      bc_stride < 0 || cc_stride < 0 || span >= (1LL << 31) ||
      static_cast<long long>(B) * S * d_in > (1LL << 40)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_n<float>(x, dt, z, z_stride, Bc, bc_stride, Cc, cc_stride,
                            A_log, D, dt_bias, h0, y, h_last, h_chunks, B, S,
                            d_in, N, st);
  } else if (dtype == 1) {
    err = dispatch_n<__nv_bfloat16>(x, dt, z, z_stride, Bc, bc_stride, Cc,
                                    cc_stride, A_log, D, dt_bias, h0, y,
                                    h_last, h_chunks, B, S, d_in, N, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The launch geometry of the (N, dtype) instance into plan[7]: lanes a
// channel (G), channels a block, tokens a chunk, threads a block,
// registers a thread, static shared memory a block (bytes), and the blocks
// an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a
// CUDA error code, cudaErrorInvalidValue for an N or dtype with no
// instance.
extern "C" int selective_scan_plan(int N, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && N == 4) err = plan_of<float, 4>(plan);
  if (dtype == 0 && N == 16) err = plan_of<float, 16>(plan);
  if (dtype == 1 && N == 4) err = plan_of<__nv_bfloat16, 4>(plan);
  if (dtype == 1 && N == 16) err = plan_of<__nv_bfloat16, 16>(plan);
  return static_cast<int>(err);
}
#endif  // SELECTIVE_SCAN_KERNEL_ONLY
