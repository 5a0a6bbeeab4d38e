// The sLSTM recurrence for Hopper (sm_90a): one sLSTM block's scalar-memory
// recurrence, from its input pre-activations to its hidden states, over a
// whole sequence in one launch.
//
// No Pallas kernel computes this. The reference's recurrence is jnp
// (src/repro/models/ssm.py): _slstm_step (:319) under a lax.scan over the
// tokens in slstm_forward (:338-355) and once in slstm_decode (:358). In
// plain PyTorch it is a loop of about fifteen launches a token (the Mamba
// scan's such loop ran 57.0 ms at 512 tokens against the kernel's 0.22),
// so it is a kernel. The plain version is kernels/ref.py: slstm_ref, held
// against this kernel on the card.
//
// The function, for batch b, head h and column e of the head, in f32, over
// t = 0 .. S-1 (D = H * dh; x_pre's last dimension is (gate, head, column)):
//   rec[g]  = sum_d hprev[d] * r[g, h, d, e]                (g: z, i, f, o)
//   pre[g]  = (x_pre[b, t, g*D + h*dh + e] + bias[g*D + h*dh + e]) + rec[g]
//   lf      = log_sigmoid(pre_f) = min(x, 0) - log1p(exp(-|x|))
//   m'      = max(lf + m, pre_i)
//   i_g     = exp(pre_i - m'),  f_g = exp(lf + m - m')
//   c       = f_g * c + i_g * tanh(pre_z)
//   n       = max(f_g * n + i_g, exp(-m'))
//   h       = sigmoid(pre_o) * c / n
// with hs[b, t, h*dh + e] = T(h) (T: x_pre's type, float32 or bfloat16) and
// the final c, n, m, h written in f32. The recurrent h stays f32 from token
// to token; only hs is rounded. exp, log1p and tanh are the full-precision
// expf, log1pf and tanhf (not the __ intrinsics): with the forget bias at 3.0
// log_sigmoid runs near saturation, and its two-sided form keeps it exact
// there. The gate arithmetic is rounded op by op as the plain version's
// (__fmul_rn and __fadd_rn: no contraction into fused multiply-adds); the
// only other difference from the plain version is the order of the sum
// over d (below).
//
// Bound on this card: per token the recurrent product is 8 * dh^2 * H
// operations a batch row (2.1 MFLOP at dh 256, H 4), on the f32 cores at
// 67 TFLOP/s; the bytes (x_pre and hs in the model type, r once, the
// states) come to less (chip_smoke.py: slstm_bytes and slstm_ops). That
// bound assumes every SM at work; the recurrence is serial in t, so what
// sets the time is a token's latency along the chain, and the first form
// of this kernel (one cluster a (batch row, head), one all-thread cluster
// barrier a token, the gate arithmetic on one warp) ran at 41-49x the bound.
// tools/slstm_sweep.py split its 1.31 us token step at dh 256 (H100): the
// cluster barrier with the stores of h into every block about 0.55 us, the
// product about 0.33, the gate arithmetic about 0.10.
//
// Design. A cluster is a head and a group of R batch rows: r is the same
// for every batch row, so each thread's rows of r, in registers for the
// whole sequence, serve the group's rows. Two instances a head dim: B = 1
// takes R = 1 and CB = kCols1 = 16 columns a block (16 blocks at dh 256,
// a non-portable cluster size), B > 1 groups of R = kRows = 2 rows and CB
// = kCols = 32 (8 blocks at dh 256; a ragged last group masks its rows,
// the caller's tensors are not padded); dh 16 and 32 take one block of CB
// = dh. The grid is (dh / CB * H, ceil(B / R)): path 11's B = 4 runs 8
// clusters of 8 in one wave, where one cluster a (batch row, head) took 16
// in two. Block q owns columns [q*CB, (q+1)*CB) of the head for the four
// gates, 4*CB outputs: thread (ot, k), ot = tid % NOT, k = tid / NOT (NOT
// = 4*CB / kOuts), holds rows [k*L, (k+1)*L) of its kOuts outputs ot + u
// * NOT, KS = NT / NOT splits, L = dh / KS (32 at dh 256, B = 1; 64 at B >
// 1), so each broadcast h load feeds 2 * 4 FMAs. Every block keeps the
// head's whole h of the group's rows in shared memory, double-buffered. A
// token t:
//   1. every thread waits on this block's mbarrier of buffer t & 1 (from t
//      = 1), which completes when every block's h of token t - 1 has
//      landed in it;
//   2. each thread sums h[bb][d] * r[d][o] over its rows for each of the
//      group's nb rows (the rows unrolled for each nb <= R), in four
//      interleaved partials added as (a0 + a1) + (a2 + a3), h read as
//      broadcast float4s; the sums land in part[t & 1][k][bb][o];
//   3. one block barrier (the ring's x_pre of token t has landed before
//      it); then one thread a (row, column) of the group, nb * CB threads,
//      adds the KS splits in k order, adds (x + bias) + rec, runs the gate
//      arithmetic on its c, n, m (in registers for the whole sequence),
//      stores hs (coalesced over a warp's columns, fire and forget), and
//      writes its new h into buffer (t + 1) & 1 of every block of the
//      cluster by st.async, each store completing 4 bytes of that block's
//      mbarrier of the buffer (no cluster barrier in the token loop);
//      meanwhile the top threads refill the x_pre ring (cp.async, kAhead
//      slots: token t + kAhead - 1 into the slot token t - 1 used) and the
//      last warp arms the barrier's next phase.
// The mbarriers: one a buffer (NBAR; tools/slstm_sweep.py --sweep times
// one a (buffer, source block), each thread waiting only on the blocks its
// rows come from), each with one arrival a phase, the local arm
// (arrive.expect_tx of the phase's bytes). Buffer t & 1's barrier completes a phase for token t at t = 1,
// 3, ... (buffer 1) and 2, 4, ... (buffer 0): token t waits on parity
// ((t - 1) >> 1) & 1. A phase is armed in the prologue (the first of each
// buffer) and after the block barrier of the token that consumed the
// previous one (every wait on that buffer has passed by then). A peer's
// complete_tx may come before the local arm of its phase: the tx-count
// goes below zero, and the pending arrival keeps the phase open. No thread
// falls two phases behind: the phase after next needs this block's h of
// token t + 1, which its threads send only after they all passed the
// block barrier of token t + 1.
// Write after read: a peer writes buffer (t + 1) & 1 of this block at its
// token t only after it received every block's h of token t - 1; this
// block sends that only after the block barrier of token t - 1, when all
// its threads have read buffer (t + 1) & 1 (= (t - 1) & 1) for token t - 1.
// part and the x_pre ring are written only after a block barrier that
// every reader of the slot's previous use passed (part is
// double-buffered; the ring's refill follows the block barrier of the
// token after the slot's reader). One cluster barrier after h0 is staged
// and the barriers armed (before any peer can write), and one before exit
// (no block exits while a peer may still write into its shared memory);
// the last token sends nothing. Fixed summation orders and no atomics: two
// launches are bit-equal. The final state may alias the initial one
// (decode's in-place state): c, n and m are read and written by the same
// thread, and h0 is read into shared memory before the first cluster
// barrier, long before any block writes h_out.
//
// A token's dependent chain at dh 256, B = 1 (16 blocks of 256 threads, L
// 32 and 2 outputs a thread), in the cycles of tools/slstm_sweep.py
// --timeline (clock64 stamps in thread 0; the stamps themselves slow the
// step by about a fifth): the wait, about 160; the product, 16 FMAs a
// thread in 8 chains and 8 float4 loads, about 175-255; the partials'
// stores and the block barrier, about 60; the sum of 8 splits and the gate
// arithmetic (precise expf, log1pf, tanhf and two divisions), about 740;
// 16 st.async a gate thread, about 400; the loop, 140-220: about 1,750 a
// step. At B = 4 (8 blocks, 2 rows a cluster) the product of two rows
// takes about 830 and 8 st.async about 260. What each part costs end to
// end (the sweep's diagnostics) is in PERF.md.
//
// The backward's record (the SAVE instances, launched under autograd by
// slstm_save_launch): at token t the gate thread also writes, into
// saved[b, t, :, column] (B, S, 8, D) f32, the four pre-activations and
// c, n, m and h as they were before the token (h0 at t = 0): 32 bytes a
// (token, column), 16 MiB at (1, 512, 1024). slstm_bwd.cu runs the chain
// backward from it, taking each max as this kernel took it, and dr's
// product reads h there. The other instances are the inference ones,
// unchanged by the record: its stores are compiled out.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// The design's choices (tools/slstm_sweep.py --sweep edits them).
constexpr int kRows = 2;    // batch rows a cluster at B > 1 (1 at B = 1)
constexpr int kCols = 32;   // columns a block at B > 1 and dh >= 64
constexpr int kCols1 = 16;  // columns a block at B = 1 and dh >= 64
constexpr int kThreads = 256;       // threads a block (fewer at dh 16)
constexpr int kOuts = 2;    // outputs a thread: each h load feeds kOuts FMAs
constexpr int kAhead = 4;   // slots of the x_pre ring: kAhead - 1 tokens ahead

static_assert(kAhead >= 2, "the ring holds the token read and one ahead");

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
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
  return __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

// log(sigmoid(x)) = -softplus(-x) = min(x, 0) - log1p(exp(-|x|))
__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
               : "memory");
}

// The one arrival of the barrier's phase, expecting `bytes` of stores.
__device__ __forceinline__ void bar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Until the barrier's phase of this parity has completed. A wait of some
// 10 s (2^34 cycles) means a phase that never completes: the launch
// fails with a trap instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done) {
      if (start < 0) start = clock64();
      else if (clock64() - start > (1LL << 34)) __trap();
    }
  }
}

// v into block `rank`'s shared memory at the address `addr` names in this
// block, completing 4 bytes of that block's barrier at `bar`.
__device__ __forceinline__ void send(uint32_t addr, uint32_t bar,
                                     uint32_t rank, float v) {
  uint32_t ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(addr), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// f(std::integral_constant<int, nb>()) for the runtime nb in [1, N].
template <int N, typename F>
__device__ __forceinline__ void with_rows(int nb, const F& f) {
  if constexpr (N > 1) {
    if (nb < N) {
      with_rows<N - 1>(nb, f);
      return;
    }
  }
  f(std::integral_constant<int, N>());
}

// The geometry of the instance with CB columns a block at head dim DH.
template <int CB_, int DH_>
struct Geo {
  static constexpr int CB = CB_, DH = DH_;
  static constexpr int CS = DH / CB;      // blocks a cluster
  static constexpr int NO = 4 * CB;       // outputs a block: 4 gates x CB
  static constexpr int NOT = NO / kOuts;  // threads a split
  static constexpr int NT = kThreads < DH * NOT / 4 ? kThreads : DH * NOT / 4;
  static constexpr int KS = NT / NOT;     // splits of the sum over d
  static constexpr int L = DH / KS;       // rows of r a thread holds
  static constexpr int NBAR = 1;          // mbarriers a buffer
  static constexpr int BAR_BYTES = (2 * NBAR * 8 + 15) / 16 * 16;
  static_assert(DH % CB == 0 && NO % kOuts == 0 && NT % NOT == 0
                && KS >= 1, "geometry");
  static_assert(L % 4 == 0, "a thread's rows are read as float4 pieces");
  static_assert(CB % 8 == 0, "the ring's 16-byte pieces");
};

// The dynamic shared memory of a launch of R batch rows a cluster: the
// barriers, two h buffers of R rows, two sets of partial sums, the x_pre
// ring.
template <typename T, typename G, int R>
constexpr size_t smem_bytes() {
  return G::BAR_BYTES
         + sizeof(float) * (2 * R * G::DH + 2 * G::KS * R * G::NO)
         + sizeof(T) * kAhead * R * 4 * G::CB;
}

template <typename T, int CB, int DH, int R, bool SAVE>
__global__ void __launch_bounds__(Geo<CB, DH>::NT, 1)
slstm_kernel(const T* __restrict__ x_pre, const float* __restrict__ bias,
             const float* __restrict__ r, const float* c0, const float* n0,
             const float* m0, const float* h0, T* __restrict__ hs,
             float* c_out, float* n_out, float* m_out, float* h_out,
             float* __restrict__ saved, int B, int S, int H) {
  using G = Geo<CB, DH>;
  constexpr int NO = G::NO, NOT = G::NOT, KS = G::KS, L = G::L, NT = G::NT;
  constexpr int NBAR = G::NBAR;
  static_assert(R * CB <= NT, "a gate thread a (row, column)");
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [2][NBAR]
  float* hbuf = reinterpret_cast<float*>(smem + G::BAR_BYTES);  // [2][R][DH]
  float* part = hbuf + 2 * R * DH;               // [2][KS][R][NO]
  T* ring = reinterpret_cast<T*>(part + 2 * KS * R * NO);
  // ring: [kAhead][R][4][CB]

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / G::CS;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);  // the group's rows (a ragged last)
  const int tid = threadIdx.x;
  const int D = H * DH;
  const int col0 = q * CB;
  const int ot = tid % NOT, k = tid / NOT;

  // this thread's rows [k*L, (k+1)*L) of its outputs o = ot + u * NOT:
  // column col0 + o % CB of gate o / CB, in registers for the whole
  // sequence (a warp reads consecutive columns of a row: coalesced)
  float rr[kOuts][L];
#pragma unroll
  for (int u = 0; u < kOuts; ++u) {
    const int o = ot + u * NOT;
    const float* src = r + (static_cast<size_t>(o / CB) * H + head) * DH * DH
                       + static_cast<size_t>(k) * L * DH + col0 + o % CB;
#pragma unroll
    for (int j = 0; j < L; ++j) rr[u][j] = src[static_cast<size_t>(j) * DH];
  }
  for (int i = tid; i < nb * DH; i += NT) {
    hbuf[i] = h0[(static_cast<size_t>(b0 + i / DH) * H + head) * DH + i % DH];
  }

  // the gate thread of row gb and column ge of the block, if it has one
  const int gb = tid / CB, ge = tid % CB;
  const bool gate = gb < nb;
  const size_t sidx = (static_cast<size_t>(b0 + gb) * H + head) * DH + col0
                      + ge;
  const int colD = head * DH + col0 + ge;  // its column of D
  const size_t row = 4 * static_cast<size_t>(D);  // x_pre's row of a token
  T* hrow = hs + static_cast<size_t>(b0 + gb) * S * D + colD;
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  float bz = 0.f, bi = 0.f, bf = 0.f, bo = 0.f;
  if (gate) {
    c = c0[sidx];
    n = n0[sidx];
    m = m0[sidx];
    bz = bias[colD];
    bi = bias[D + colD];
    bf = bias[2 * D + colD];
    bo = bias[3 * D + colD];
    if constexpr (SAVE) hv = h0[sidx];  // h before token 0, for the record
  }
  // this gate thread's column of the record (SAVE): saved[b, t, k, colD]
  float* srow = SAVE && gate ? saved + static_cast<size_t>(b0 + gb) * S * 8
                                          * D + colD
                             : nullptr;

  // x_pre of token tt (nb rows x 4 gates x CB columns) into its ring slot,
  // by the top threads: 16-byte cp.async where x_pre is 16-byte aligned,
  // else element by element
  const T* xhead = x_pre + static_cast<size_t>(b0) * S * row + head * DH
                   + col0;
  const bool vec = reinterpret_cast<uintptr_t>(x_pre) % 16 == 0;
  auto load_x = [&](int tt) {
    T* slot = ring + (tt % kAhead) * R * 4 * CB;
    constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a piece
    constexpr int P = CB / E;                            // pieces a CB
    if (vec) {
      for (int i = NT - 1 - tid; i < nb * 4 * P; i += NT) {
        const int bb = i / (4 * P), g = i / P % 4, p = i % P;
        cp_async16(smem_addr(slot + (bb * 4 + g) * CB + p * E),
                   xhead + (static_cast<size_t>(bb) * S + tt) * row
                       + static_cast<size_t>(g) * D + p * E);
      }
    } else {
      for (int i = NT - 1 - tid; i < nb * 4 * CB; i += NT) {
        const int bb = i / (4 * CB), g = i / CB % 4, e = i % CB;
        slot[(bb * 4 + g) * CB + e] =
            xhead[(static_cast<size_t>(bb) * S + tt) * row
                  + static_cast<size_t>(g) * D + e];
      }
    }
  };

  // a phase's bytes at each barrier: nb rows of the columns it receives
  const uint32_t phase_bytes = nb * (DH / NBAR) * sizeof(float);
  if (tid < 2 * NBAR) {
    bar_init(smem_addr(bars + tid));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_arm(smem_addr(bars + tid), phase_bytes);
  }
  for (int tt = 0; tt < kAhead - 1; ++tt) {
    if (tt < S) load_x(tt);
    cp_commit();
  }
  cluster.sync();  // h0 staged, the barriers armed, every block running

  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    const uint32_t parity = ((t - 1) >> 1) & 1;
    const float* hc = hbuf + cur * R * DH + k * L;
    const uint32_t wait_bar = smem_addr(bars + cur * NBAR);
    if (t > 0) bar_wait(wait_bar, parity);
    with_rows<R>(nb, [&](auto nbc) {
      constexpr int NB = decltype(nbc)::value;
      float a[NB][kOuts][4];
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
        for (int u = 0; u < kOuts; ++u) {
          a[bb][u][0] = a[bb][u][1] = a[bb][u][2] = a[bb][u][3] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < L; j += 4) {
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          const float4 h4 = *reinterpret_cast<const float4*>(hc + bb * DH + j);
#pragma unroll
          for (int u = 0; u < kOuts; ++u) {
            a[bb][u][0] = fmaf(h4.x, rr[u][j + 0], a[bb][u][0]);
            a[bb][u][1] = fmaf(h4.y, rr[u][j + 1], a[bb][u][1]);
            a[bb][u][2] = fmaf(h4.z, rr[u][j + 2], a[bb][u][2]);
            a[bb][u][3] = fmaf(h4.w, rr[u][j + 3], a[bb][u][3]);
          }
        }
      }
      float* pp = part + ((cur * KS + k) * R) * NO + ot;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
        for (int u = 0; u < kOuts; ++u) {
          pp[bb * NO + u * NOT] =
              (a[bb][u][0] + a[bb][u][1]) + (a[bb][u][2] + a[bb][u][3]);
        }
      }
    });
    cp_wait<kAhead - 2>();  // this thread's pieces of token t's x_pre
    __syncthreads();
    // every wait on buffer cur has passed: arm its phase of token t + 2
    // (by the last warp, off the gate threads' path)
    if (t > 0 && tid >= NT - NBAR) {
      bar_arm(smem_addr(bars + cur * NBAR + (NT - 1 - tid)), phase_bytes);
    }
    if (t + kAhead - 1 < S) load_x(t + kAhead - 1);
    cp_commit();
    if (gate) {
      const float* ps = part + (cur * KS * R + gb) * NO + ge;
      float rec[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float s = ps[g * CB];
#pragma unroll
        for (int kk = 1; kk < KS; ++kk) s += ps[kk * R * NO + g * CB];
        rec[g] = s;
      }
      const T* xs = ring + ((t % kAhead) * R + gb) * 4 * CB + ge;
      const float xz = to_f32(xs[0]), xi = to_f32(xs[CB]);
      const float xf = to_f32(xs[2 * CB]), xo = to_f32(xs[3 * CB]);
      const float pz = __fadd_rn(__fadd_rn(xz, bz), rec[0]);
      const float pi = __fadd_rn(__fadd_rn(xi, bi), rec[1]);
      const float pf = __fadd_rn(__fadd_rn(xf, bf), rec[2]);
      const float po = __fadd_rn(__fadd_rn(xo, bo), rec[3]);
      if constexpr (SAVE) {  // the backward's record of token t
        float* sr = srow + static_cast<size_t>(t) * 8 * D;
        sr[0] = pz;
        sr[D] = pi;
        sr[2 * D] = pf;
        sr[3 * D] = po;
        sr[4 * D] = c;
        sr[5 * D] = n;
        sr[6 * D] = m;
        sr[7 * D] = hv;
      }
      const float lf = log_sigmoid(pf);
      const float lfm = __fadd_rn(lf, m);
      const float mn = fmaxf(lfm, pi);
      const float ig = expf(__fsub_rn(pi, mn));
      const float fg = expf(__fsub_rn(lfm, mn));
      c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, tanhf(pz)));
      n = fmaxf(__fadd_rn(__fmul_rn(fg, n), ig), expf(-mn));
      const float og = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
      hv = __fdiv_rn(__fmul_rn(og, c), n);
      m = mn;
      hrow[static_cast<size_t>(t) * D] = from_f32<T>(hv);
      if (t + 1 < S) {  // into buffer (t + 1) & 1 of every block
        const int nxt = cur ^ 1;
        const uint32_t dst =
            smem_addr(hbuf + (nxt * R + gb) * DH + col0 + ge);
        const uint32_t bar = smem_addr(bars + nxt * NBAR);
#pragma unroll 4
        for (int i = 0; i < G::CS; ++i) send(dst, bar, (q + i) % G::CS, hv);
      }
    }
  }
  if (gate) {
    c_out[sidx] = c;
    n_out[sidx] = n;
    m_out[sidx] = m;
    h_out[sidx] = hv;
  }
  cluster.sync();  // no block exits while a peer may write into it
}

// Whether the kernel has an instance for a head dim: 16 and 32 (one block
// a head, CB = dh), 64, 128 and 256 (clusters of dh / CB blocks).
bool takes(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128 || dh == 256;
}

// The columns a block of the instance of R batch rows a cluster.
template <int DH, int R>
constexpr int cols_of() {
  return DH <= 32 ? DH : R == 1 ? kCols1 : kCols;
}

// Calls f.template operator()<DH>() for the head dim.
template <typename F>
cudaError_t with_instance(int dh, F&& f) {
  switch (dh) {
    case 16:
      return f.template operator()<16>();
    case 32:
      return f.template operator()<32>();
    case 64:
      return f.template operator()<64>();
    case 128:
      return f.template operator()<128>();
    case 256:
      return f.template operator()<256>();
    default:
      return cudaErrorInvalidValue;
  }
}

// The instance's launch attributes, set once: its dynamic shared memory
// and, above 8 blocks a cluster, the non-portable cluster size.
template <typename T, int CB, int DH, int R, bool SAVE = false>
cudaError_t prepare() {
  static cudaError_t err = [] {
    using G = Geo<CB, DH>;
    cudaError_t e = cudaFuncSetAttribute(
        slstm_kernel<T, CB, DH, R, SAVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, G, R>()));
    if (e == cudaSuccess && G::CS > 8) {
      e = cudaFuncSetAttribute(slstm_kernel<T, CB, DH, R, SAVE>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    return e;
  }();
  return err;
}

template <typename T, int CB, int DH, int R>
cudaLaunchConfig_t config_of(int H, int B, cudaStream_t st,
                             cudaLaunchAttribute* attr) {
  using G = Geo<CB, DH>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::CS * H, (B + R - 1) / R, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<T, G, R>();
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = G::CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
struct Launch {
  const void *x_pre, *bias, *r, *c0, *n0, *m0, *h0;
  void *hs, *c_out, *n_out, *m_out, *h_out;
  int B, S, H;
  cudaStream_t st;
  void* saved;  // the backward's record, or null: the inference instance

  template <int CB, int DH, int R, bool SAVE>
  cudaError_t launch_as() const {
    cudaError_t err = prepare<T, CB, DH, R, SAVE>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of<T, CB, DH, R>(H, B, st, &attr);
    err = cudaLaunchKernelEx(
        &cfg, slstm_kernel<T, CB, DH, R, SAVE>,
        static_cast<const T*>(x_pre), static_cast<const float*>(bias),
        static_cast<const float*>(r), static_cast<const float*>(c0),
        static_cast<const float*>(n0), static_cast<const float*>(m0),
        static_cast<const float*>(h0), static_cast<T*>(hs),
        static_cast<float*>(c_out), static_cast<float*>(n_out),
        static_cast<float*>(m_out), static_cast<float*>(h_out),
        static_cast<float*>(saved), B, S, H);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }

  template <int CB, int DH, int R>
  cudaError_t launch() const {
    return saved ? launch_as<CB, DH, R, true>()
                 : launch_as<CB, DH, R, false>();
  }

  // B = 1 takes the instance of one row a cluster, with kCols1 columns a
  // block; B > 1 groups of kRows rows, with kCols
  template <int DH>
  cudaError_t operator()() const {
    return B == 1 ? launch<cols_of<DH, 1>(), DH, 1>()
                  : launch<cols_of<DH, kRows>(), DH, kRows>();
  }
};

// The geometry of the R-row instance of (CB, DH) into plan[0..7].
template <typename T, int CB, int DH, int R>
cudaError_t plan_of(int* plan) {
  using G = Geo<CB, DH>;
  cudaError_t err = prepare<T, CB, DH, R>();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<T, G, R>();
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, slstm_kernel<T, CB, DH, R, false>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, slstm_kernel<T, CB, DH, R, false>, G::NT, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config_of<T, CB, DH, R>(1, 1, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, slstm_kernel<T, CB, DH, R, false>, &cfg);
  if (err != cudaSuccess) return err;
  plan[0] = G::CS;
  plan[1] = CB;
  plan[2] = G::NT;
  plan[3] = G::KS;
  plan[4] = fa.numRegs;
  plan[5] = static_cast<int>(smem);
  plan[6] = blocks;
  plan[7] = clusters;
  return cudaSuccess;
}

template <typename T>
struct Plan {
  int* plan;

  template <int DH>
  cudaError_t operator()() const {
    cudaError_t err = plan_of<T, cols_of<DH, kRows>(), DH, kRows>(plan);
    if (err == cudaSuccess) {
      err = plan_of<T, cols_of<DH, 1>(), DH, 1>(plan + 12);
    }
    if (err != cudaSuccess) return err;
    plan[8] = kRows;
    plan[9] = kAhead;
    plan[10] = Geo<cols_of<DH, kRows>(), DH>::NBAR;
    plan[11] = kOuts;
    return cudaSuccess;
  }
};

}  // namespace

#ifndef SLSTM_KERNEL_ONLY  // slstm_bwd.cu includes the helpers above only

namespace {

// Both entry points: the inference instances, or with a record the SAVE
// ones.
int launch_entry(const void* x_pre, const void* bias, const void* r,
                 const void* c0, const void* n0, const void* m0,
                 const void* h0, void* hs, void* c_out, void* n_out,
                 void* m_out, void* h_out, void* saved, int B, int S, int H,
                 int dh, int dtype, void* stream) {
  if (B <= 0 || (B + kRows - 1) / kRows > 65535 || S <= 0 || H <= 0
      || !takes(dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = with_instance(dh, Launch<float>{x_pre, bias, r, c0, n0, m0, h0, hs,
                                          c_out, n_out, m_out, h_out, B, S,
                                          H, st, saved});
  } else if (dtype == 1) {
    err = with_instance(dh, Launch<__nv_bfloat16>{
                                x_pre, bias, r, c0, n0, m0, h0, hs, c_out,
                                n_out, m_out, h_out, B, S, H, st, saved});
  }
  return static_cast<int>(err);
}

}  // namespace

// x_pre (B, S, 4 * H * dh) in the model type (dtype 0: float32, 1:
// bfloat16), bias (4 * H * dh) f32, r (4, H, dh, dh) f32, c0, n0, m0, h0
// (B, H, dh) f32, all contiguous; hs (B, S, H * dh) in
// the model type and c_out, n_out, m_out, h_out (B, H, dh) f32 out (they
// may alias c0, n0, m0, h0). Returns a CUDA error code:
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int slstm_launch(const void* x_pre, const void* bias,
                            const void* r, const void* c0, const void* n0,
                            const void* m0, const void* h0, void* hs,
                            void* c_out, void* n_out, void* m_out,
                            void* h_out, int B, int S, int H, int dh,
                            int dtype, void* stream) {
  return launch_entry(x_pre, bias, r, c0, n0, m0, h0, hs, c_out, n_out, m_out,
                      h_out, nullptr, B, S, H, dh, dtype, stream);
}

// slstm_launch with the backward's record: saved (B, S, 8, H * dh) f32,
// contiguous, receives each token's pre-activations and the state before
// it (the SAVE instances; the same geometry, hs and final state as
// slstm_launch's). The final state must not alias the initial one.
extern "C" int slstm_save_launch(const void* x_pre, const void* bias,
                                 const void* r, const void* c0,
                                 const void* n0, const void* m0,
                                 const void* h0, void* hs, void* c_out,
                                 void* n_out, void* m_out, void* h_out,
                                 void* saved, int B, int S, int H, int dh,
                                 int dtype, void* stream) {
  if (saved == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_entry(x_pre, bias, r, c0, n0, m0, h0, hs, c_out, n_out, m_out,
                      h_out, saved, B, S, H, dh, dtype, stream);
}

// The launch geometry of the (dh, dtype) instances into plan[20]: that of
// kRows batch rows a cluster (B > 1) in plan[0..7], blocks a cluster (a
// head), columns a block, threads a block, splits of the sum over d,
// registers a thread, dynamic shared memory a block (bytes), blocks an SM
// holds, clusters the card holds at once (cudaOccupancyMaxActiveClusters);
// then batch rows a cluster, slots of the x_pre ring, mbarriers a buffer,
// outputs a thread; then the one-row instance's (B = 1) eight fields in
// plan[12..19]. Returns a CUDA error code.
extern "C" int slstm_plan(int dh, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = with_instance(dh, Plan<float>{plan});
  if (dtype == 1) err = with_instance(dh, Plan<__nv_bfloat16>{plan});
  return static_cast<int>(err);
}

#endif  // SLSTM_KERNEL_ONLY
