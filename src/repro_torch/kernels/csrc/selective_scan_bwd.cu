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
// Sums over c (dB, dC) run over the block's channels in a fixed order and
// then over the blocks in block order (the second launch, which also sums
// dA_log, dD and ddt_bias over batch rows): no atomics, two launches are
// bit-equal.
//
// Bound on this card: per (token, channel) it reads x, z and dy in the
// model type and dt in f32, and writes dx and dz in the model type and
// ddt in f32 (16 bytes in bf16), and needs N exponentials (a_t), 2
// transcendentals for softplus, 1 for sigmoid(v) and 2 for silu'(z) on the
// SFU (MUFU, 16 a clock an SM): at N = 16 the SFU bounds it
// (chip_smoke.py: scan_bwd_mufu_ops, scan_bwd_bytes). This kernel issues
// about 2N + 8: h is recomputed twice (below).
//
// Design. The forward under autograd saved h at the start of each
// kChunk-token chunk (selective_scan.cu, kSave). Blocks and lanes are the
// forward's: thread (c, g) owns states [g·N/G, (g+1)·N/G) of channel c, a
// block kThreads / G channels of one batch row, A in registers. Each block
// walks the chunks last to first, carrying G (dh) in registers, in phases
// split by block barriers:
//   1. stage: δ and δ·x once per (token, channel), the chunk's B and C
//      rows, into shared memory (the forward's arithmetic);
//   2. recompute: the chunk's h from its saved start with the forward's
//      exact arithmetic (the same expf/log1pf, scan_step, the partials of
//      Σ h·C in its lane order), so h and o equal the forward's bit for
//      bit; h at each kSub-token sub-chunk's start kept in shared memory;
//   3. gate: do and dz a (token, channel) over the block, do into shared
//      memory, dz stored, Σ do·x in a register;
//   4. for each sub-chunk, last first: its h and decays recomputed again
//      from the sub-chunk's start into registers, then the reverse pass
//      over its tokens carrying dh: each lane's terms of dB and dC and its
//      partials of dδ and of Σ_n G·B into shared memory; barrier; then
//      dB and dC of the sub-chunk summed over the block's channels (a
//      thread an output) into per-block partials, and dx, ddt and
//      Σ ddt a (token, channel) over the block (the G lanes' partials in
//      lane order); barrier.
// dA sums over tokens in registers, dD and ddt_bias too (their G threads
// of a channel added in order at the end); dh0 is the carried G.
//
// Traps:
//  - The forward needs every block resident (each runs the whole
//    sequence); this kernel's blocks are independent, but at B = 1 and
//    d_in 16384 its 512 blocks of 128 threads fill 132 SMs only at 4 an SM:
//    a second wave doubles the time. kBwdMinBlocks = 4 caps the registers
//    at 128 a thread; the 53,248 bytes of dynamic shared memory a block
//    (N = 16) leave 4 blocks in the SM's 228 KB.
//  - h for every token of a 32-token chunk, 32 channels x 16 states, is 64
//    KB a block, more than a quarter of the SM: phase 4 recomputes h a
//    kSub = 4-token sub-chunk at a time into registers (5 x N/G values of
//    h, 4 x N/G decays), from starts that phase 2 kept, paying N more
//    exponentials a (token, channel).
//  - z, B and C arrive as strided views (a half of in_proj's output,
//    slices of x_proj's), read through their row strides as in the
//    forward; dx, ddt, dz, dB and dC are written contiguous.
//  - The per-block partials of dB and dC are (B, S, blocks, 2N) f32: 268 MB
//    at (1,4096,16384,16), written once and read once by the second launch.
// Every output is computed (the autograd Function asks for all of them).
// On the H100 (chip_smoke.py prints ptxas -v and selective_scan_bwd_plan)
// the N = 16 instances hold 118 registers, the N = 4 ones 87-102, none
// spills, and 4 blocks run an SM (5 for bf16 at N = 4).

#define SELECTIVE_SCAN_KERNEL_ONLY
#include "selective_scan.cu"

namespace {

constexpr int kSub = 4;          // tokens a reverse sub-chunk
constexpr int kBwdMinBlocks = 4;

template <int N, int G>
struct BwdGeometry {
  using Geo = Geometry<N, G>;
  static constexpr int NS = Geo::kStates, CB = Geo::kChannels;
  static constexpr int kSubs = kChunk / kSub;          // sub-chunks a chunk
  static_assert(kChunk % kSub == 0, "sub-chunks");
  // phase 4's elementwise half takes one (token, channel) a thread
  static_assert(kSub * CB == kThreads, "a sub-chunk's (token, channel)s");
  static constexpr int kOuts = kSub * 2 * N;          // dB, dC a sub-chunk
  static_assert(kOuts <= kThreads, "a thread an output of dB and dC");
  static_assert(NS == 1 || NS % 4 == 0, "16-byte shared accesses");
  // dynamic shared memory, in floats (each part a multiple of 4)
  static constexpr int kDd = 2 * kChunk * CB;               // {δ, δ·x}
  static constexpr int kBc = kChunk * 2 * N;                // B, then C
  static constexpr int kDo = kChunk * CB;                   // do
  static constexpr int kHsub = kSubs * kThreads * NS;       // sub-starts
  static constexpr int kRed = kSub * kThreads * 2 * NS;     // dB, dC terms
  static constexpr int kLane = kSub * kThreads * 2;         // {dδ_a, Σ G·B}
  static constexpr int kPart = kChunk * kThreads;           // Σ h·C parts
  static constexpr int kUnion = kPart > kRed + kLane ? kPart : kRed + kLane;
  static constexpr int kFloats = kDd + kBc + kDo + kHsub + kUnion;
  static constexpr int kBytes = kFloats * 4;
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

template <typename T, int N, int G>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    selective_scan_bwd_kernel(
        const T* __restrict__ x, const float* __restrict__ dt,
        const T* __restrict__ z, long long zs, const float* __restrict__ Bc,
        long long bs, const float* __restrict__ Cc, long long cs,
        const float* __restrict__ A_log, const float* __restrict__ Dp,
        const float* __restrict__ dt_bias, const float* __restrict__ hs,
        const T* __restrict__ dy, const float* __restrict__ dh_last,
        T* __restrict__ dx, float* __restrict__ ddt, T* __restrict__ dz,
        float* __restrict__ dh0, float* __restrict__ part_bc,
        float* __restrict__ part_A, float* __restrict__ part_D,
        float* __restrict__ part_bias, int S, int d_in) {
  using Geo = Geometry<N, G>;
  using Bwd = BwdGeometry<N, G>;
  constexpr int NS = Bwd::NS, CB = Bwd::CB;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2 (*s_dd)[CB] = reinterpret_cast<float2 (*)[CB]>(smem);
  float (*s_bc)[2 * N] = reinterpret_cast<float (*)[2 * N]>(smem + Bwd::kDd);
  float (*s_do)[CB] =
      reinterpret_cast<float (*)[CB]>(smem + Bwd::kDd + Bwd::kBc);
  float* s_hsub = smem + Bwd::kDd + Bwd::kBc + Bwd::kDo;
  float* s_u = s_hsub + Bwd::kHsub;
  float (*s_part)[kThreads] = reinterpret_cast<float (*)[kThreads]>(s_u);
  float* s_red = s_u;                                    // [i][tid][2·NS]
  float2* s_lane = reinterpret_cast<float2*>(s_u + Bwd::kRed);  // [i][tid]

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * CB;
  const long long row0 = static_cast<long long>(blockIdx.y) * S;
  const long long n_chunks = (S + kChunk - 1) / kChunk;
  // phases 2 and 4: channel c, lane g
  const int cl = tid / G, g = tid % G;
  const long long c = base + cl;
  const bool live = c < d_in;
  // phases 1, 3 and 4's elementwise half: channel c1, slot q
  const int c1l = tid % CB, q = tid / CB;
  const long long c1 = base + c1l;
  const bool live1 = c1 < d_in;
  const long long cld = live1 ? c1 : d_in - 1;
  const long long hrow = (static_cast<long long>(blockIdx.y) * d_in + c) * N
                         + g * NS;
  float A[NS], dh[NS], dA[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    A[n] = live ? -expf(A_log[c * N + g * NS + n]) : 0.0f;
    dh[n] = live && dh_last != nullptr ? dh_last[hrow + n] : 0.0f;
    dA[n] = 0.0f;
  }
  const float bias = live1 ? dt_bias[c1] : 0.0f;
  const float Dc = live1 ? Dp[c1] : 0.0f;
  float accD = 0.0f, accBias = 0.0f;
  const int jb = tid % (2 * N), tb = tid / (2 * N);
  const float* bcol = jb < N ? Bc + jb : Cc + (jb - N);
  const long long bcs = jb < N ? bs : cs;

  for (long long k = n_chunks - 1; k >= 0; --k) {
    const long long t0 = k * kChunk;
    const int len = static_cast<int>(min(static_cast<long long>(kChunk),
                                         S - t0));
    // 1. δ and δ·x (the forward's stage), B and C rows
#pragma unroll
    for (int kk = 0; kk < Geo::kTokens; ++kk) {
      const int t = q + kk * G;
      if (t < len) {
        const long long r = row0 + t0 + t;
        const float v = dt[r * d_in + cld] + bias;
        const float xv = to_f32(x[r * d_in + cld]);
        const float delta = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
        s_dd[t][c1l] = live1 ? make_float2(delta, delta * xv)
                             : make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int kk = 0; kk < Geo::kRows; ++kk) {
      const int t = tb + kk * Geo::kBcRows;
      if (t < len) s_bc[t][jb] = bcol[(row0 + t0 + t) * bcs];
    }
    __syncthreads();
    // 2. the chunk's h from its saved start, the partials of Σ h·C, and h
    // at each sub-chunk's start
    {
      float h[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = live ? hs[((blockIdx.y * n_chunks + k) * d_in + c) * N
                         + g * NS + n]
                    : 0.0f;
      }
      for (int t = 0; t < len; ++t) {
        if (t % kSub == 0) {
          store_shared<NS>(s_hsub + ((t / kSub) * kThreads + tid) * NS, h);
        }
        const float2 dd = s_dd[t][cl];
        float b[NS], cc[NS];
        load_shared<NS>(b, &s_bc[t][g * NS]);
        load_shared<NS>(cc, &s_bc[t][N + g * NS]);
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float e = expf(dd.x * A[n]);
          h[n] = scan_step(e, h[n], dd.y, b[n]);
          acc = __fmaf_rn(h[n], cc[n], acc);
        }
        s_part[t][tid] = acc;
      }
    }
    __syncthreads();
    // 3. the gate's backward: o as the forward forms it (the partials in
    // lane order, then x·D), do into shared memory, dz stored
#pragma unroll
    for (int kk = 0; kk < Geo::kTokens; ++kk) {
      const int t = q + kk * G;
      if (t < len) {
        const long long r = row0 + t0 + t;
        float p[G];
        load_shared<G>(p, &s_part[t][c1l * G]);
        float o = p[0];
#pragma unroll
        for (int i = 1; i < G; ++i) o += p[i];
        const float xv = to_f32(x[r * d_in + cld]);
        const float zv = to_f32(z[r * zs + cld]);
        const float dyv = to_f32(dy[r * d_in + cld]);
        o = o + __fmul_rn(xv, Dc);
        const float ez = expf(-zv);
        const float gv = to_f32(from_f32<T>(zv / (1.0f + ez)));
        const float dov = to_f32(from_f32<T>(dyv * gv));
        const float dgate = to_f32(from_f32<T>(dyv * to_f32(from_f32<T>(o))));
        const float sig = 1.0f / (1.0f + ez);
        if (live1) {
          dz[r * d_in + c1] =
              from_f32<T>(dgate * (sig * (1.0f + zv * (1.0f - sig))));
          accD += dov * xv;
        }
        s_do[t][c1l] = live1 ? dov : 0.0f;
      }
    }
    __syncthreads();
    // 4. the sub-chunks, last first
    const int n_subs = (len + kSub - 1) / kSub;
    for (int j = n_subs - 1; j >= 0; --j) {
      const int ts = j * kSub, ul = min(kSub, len - ts);
      float hh[kSub + 1][NS], ee[kSub][NS];
      load_shared<NS>(hh[0], s_hsub + (j * kThreads + tid) * NS);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i < ul) {
          const float2 dd = s_dd[ts + i][cl];
          float b[NS];
          load_shared<NS>(b, &s_bc[ts + i][g * NS]);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            ee[i][n] = expf(dd.x * A[n]);
            hh[i + 1][n] = scan_step(ee[i][n], hh[i][n], dd.y, b[n]);
          }
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        if (i < ul) {
          const int t = ts + i;
          const float2 dd = s_dd[t][cl];
          const float dov = s_do[t][cl];
          float b[NS], cc[NS], red[2 * NS];
          load_shared<NS>(b, &s_bc[t][g * NS]);
          load_shared<NS>(cc, &s_bc[t][N + g * NS]);
          float da = 0.0f, sb = 0.0f;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            dh[n] = fmaf(dov, cc[n], dh[n]);
            red[n] = dd.y * dh[n];                 // dB's term
            red[NS + n] = dov * hh[i + 1][n];      // dC's term
            sb = fmaf(b[n], dh[n], sb);
            const float qn = dh[n] * hh[i][n] * ee[i][n];
            da = fmaf(qn, A[n], da);
            dA[n] = fmaf(qn, dd.x, dA[n]);
            dh[n] *= ee[i][n];
          }
          store_shared<2 * NS>(s_red + (i * kThreads + tid) * 2 * NS, red);
          s_lane[i * kThreads + tid] = make_float2(da, sb);
        }
      }
      __syncthreads();
      // dB and dC of the sub-chunk's tokens over the block's channels
      if (tid < Bwd::kOuts) {
        const int i = tid / (2 * N), w = tid % (2 * N);
        if (i < ul) {
          const int n = w % N;
          const int slot = (w / N) * NS + n % NS;
          const float* src = s_red + (i * kThreads + n / NS) * 2 * NS + slot;
          float s = 0.0f;
#pragma unroll 8
          for (int cc = 0; cc < CB; ++cc) s += src[cc * G * 2 * NS];
          part_bc[((row0 + t0 + ts + i) * gridDim.x + blockIdx.x) * 2 * N
                  + w] = s;
        }
      }
      // dx, ddt: token ts + q of channel c1
      if (q < ul && live1) {
        const int t = ts + q;
        const long long r = row0 + t0 + t;
        float2 pl[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          pl[i] = s_lane[q * kThreads + c1l * G + i];
        }
        float da = pl[0].x, sb = pl[0].y;
#pragma unroll
        for (int i = 1; i < G; ++i) {
          da += pl[i].x;
          sb += pl[i].y;
        }
        const float delta = s_dd[t][c1l].x;
        const float xv = to_f32(x[r * d_in + c1]);
        const float v = dt[r * d_in + c1] + bias;
        const float ddelta = fmaf(xv, sb, da);
        const float dv = ddelta * (1.0f / (1.0f + expf(-v)));
        dx[r * d_in + c1] = from_f32<T>(fmaf(delta, sb, s_do[t][c1l] * Dc));
        ddt[r * d_in + c1] = dv;
        accBias += dv;
      }
      __syncthreads();
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      dh0[hrow + n] = dh[n];
      part_A[hrow + n] = dA[n];
    }
  }
  // dD and ddt_bias: the G threads of a channel, in slot order
  float2* s_fin = reinterpret_cast<float2*>(s_u);        // [q][c1]
  s_fin[q * CB + c1l] = make_float2(accD, accBias);
  __syncthreads();
  if (q == 0 && live1) {
    float2 s = s_fin[c1l];
#pragma unroll
    for (int i = 1; i < G; ++i) {
      s.x += s_fin[i * CB + c1l].x;
      s.y += s_fin[i * CB + c1l].y;
    }
    const long long at = static_cast<long long>(blockIdx.y) * d_in + c1;
    part_D[at] = s.x;
    part_bias[at] = s.y;
  }
}

// The second launch: dB and dC summed over the blocks in block order,
// dA_log, dD and ddt_bias over the batch rows in order.
__global__ void selective_scan_bwd_sum_kernel(
    const float* __restrict__ part_bc, int blocks, long long rows, int N,
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
      const float* p = part_bc + r * blocks * 2 * N + w;
      float s = 0.0f;
      for (int k = 0; k < blocks; ++k) s += p[static_cast<long long>(k) * 2 * N];
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

template <int N>
long long scratch_floats(int B, int S, int d_in) {
  constexpr int CB = Geometry<N, lanes<N>()>::kChannels;
  const long long blocks = (d_in + CB - 1) / CB;
  return static_cast<long long>(B) * S * blocks * 2 * N
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
  using Bwd = BwdGeometry<N, lanes<N>()>;
  constexpr int CB = Bwd::CB;
  const auto kernel = bwd_kernel_of<T, N>();
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd::kBytes);
  if (attr != cudaSuccess) return attr;
  const int blocks = (d_in + CB - 1) / CB;
  float* part_bc = static_cast<float*>(scratch);
  float* part_A = part_bc + static_cast<long long>(B) * S * blocks * 2 * N;
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
      static_cast<float*>(dh0), part_bc, part_A, part_D, part_bias, S,
      d_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(B) * S;
  const long long total = rows * 2 * N + static_cast<long long>(d_in) * N
                          + d_in;
  const int sum_grid = static_cast<int>(std::min<long long>(
      (total + 255) / 256, 132LL * 16));
  selective_scan_bwd_sum_kernel<<<sum_grid, 256, 0, st>>>(
      part_bc, blocks, rows, N, part_A, part_D, part_bias,
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
  using Bwd = BwdGeometry<N, lanes<N>()>;
  const auto kernel = bwd_kernel_of<T, N>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd::kBytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, Bwd::kBytes);
  }
  if (err != cudaSuccess) return err;
  const int out[7] = {lanes<N>(), Bwd::CB, kSub, kThreads, attr.numRegs,
                      Bwd::kBytes, blocks};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
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
// floats. Two launches (the second sums the first's per-block partials).
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
      static_cast<long long>(B) * S * d_in > (1LL << 40)) {
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

// The floats of a backward launch's scratch: the per-block partials of dB
// and dC, (B, S, blocks, 2N), then dA's (B, d_in, N), dD's and ddt_bias's
// (B, d_in) each. 0 for an N with no instance.
extern "C" long long selective_scan_bwd_scratch_floats(int B, int S, int d_in,
                                                       int N) {
  if (N == 4) return scratch_floats<4>(B, S, d_in);
  if (N == 16) return scratch_floats<16>(B, S, d_in);
  return 0;
}

// The backward's geometry of the (N, dtype) instance into plan[7]: lanes a
// channel, channels a block, tokens a reverse sub-chunk, threads a block,
// registers a thread, dynamic shared memory a block (bytes), blocks an SM.
extern "C" int selective_scan_bwd_plan(int N, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && N == 4) err = bwd_plan_of<float, 4>(plan);
  if (dtype == 0 && N == 16) err = bwd_plan_of<float, 16>(plan);
  if (dtype == 1 && N == 4) err = bwd_plan_of<__nv_bfloat16, 4>(plan);
  if (dtype == 1 && N == 16) err = bwd_plan_of<__nv_bfloat16, 16>(plan);
  return static_cast<int>(err);
}
