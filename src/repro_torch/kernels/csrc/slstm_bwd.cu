// The sLSTM recurrence's backward for Hopper (sm_90a): the gradient of
// slstm.cu's recurrence over a whole sequence in one launch, from the
// forward's record of each token back to the first.
//
// No Pallas kernel computes this: the reference's gradient is XLA's
// autodiff of _slstm_step (src/repro/models/ssm.py:319) under the
// lax.scan of slstm_forward (:338-352). The plain version is
// kernels/ref.py: slstm_bwd_ref, held against this kernel on the card.
//
// The function, for batch b, head h and column e of the head, in f32, over
// t = S-1 .. 0, from the record saved[b, t, :, h*dh + e] (B, S, 8, D) f32
// that slstm.cu's SAVE instances write: pre_z, pre_i, pre_f, pre_o of token
// t, then c, n, m (and h, which dr's product reads) before it. The forward
// of the token is run again from it in slstm.cu's own arithmetic (the same
// rounded operations, so every value and both maxes come out as the forward
// took them):
//   lfm = log_sigmoid(pre_f) + m,  m' = max(lfm, pre_i),  e = exp(-m')
//   i_g = exp(pre_i - m'),  f_g = exp(lfm - m'),  zt = tanh(pre_z)
//   c' = f_g*c + i_g*zt,  nn = f_g*n + i_g,  n' = max(nn, e)
//   o = sigmoid(pre_o),  h' = o*c'/n'
// then, with g the cotangent of h' (dhs[b, t] in f32 plus the recurrent
// part from token t+1; at t = S-1 dh_T) and dc, dn, dm those of c', n', m'
// carried from token t+1 (dc_T, dn_T, dm_T at t = S-1):
//   dpre_o = g*c'/n' * o*(1-o),  dc' = dc + g*o/n',  dn' = dn - g*h'/n'
//   dnn = dn' (nn > e), 0 (nn < e), dn'/2 (a tie);  dm' = dm - e*(dn' - dnn)
//   df_g = dc'*c + dnn*n,  di_g = dc'*zt + dnn,  dpre_z = dc'*i_g*(1-zt^2)
//   dpre_i = di_g*i_g,  dm' -= di_g*i_g + df_g*f_g,  dlfm = df_g*f_g
//   m' = max(lfm, pre_i): dlfm += dm' (lfm > pre_i), dpre_i += dm'
//        (lfm < pre_i), half each at a tie (as jax.grad and torch.maximum)
//   dpre_f = dlfm * sigmoid(-pre_f)
//   carried to token t-1: dc = dc'*f_g, dn = dnn*f_g, dm = dlfm
//   the recurrent part of h_{t-1}'s cotangent: sum_{g,e'} r[g,h,d,e'] *
//   dpre_g[e'] (the transpose of the forward's product)
// written: dx[b, t, g*D + h*dh + e] = T(dpre_g) (T: the model type), dpre
// in f32 too where the caller asks (db and dr, which the wrapper takes from
// it: db a sum, dr one full-f32 product over B*S per (gate, head), as the
// reference leaves that product to XLA), and at the end dc0, dn0, dm0 and
// dh0 (the recurrent part carried past token 0), f32.
//
// Bound on this card: per token the transposed product is 8 * dh^2 * H
// operations a batch row (2.1 MFLOP at dh 256, H 4) on the f32 cores at 67
// TFLOP/s, the bytes (the record, dhs, dx) less; chip_smoke.py's
// slstm_bwd_ops and slstm_bwd_bytes. As in the forward the chain is serial
// in t, so a token's latency along it sets the time.
//
// Design: slstm.cu's (its header), turned around. A cluster is a head and
// a group of R batch rows (the forward's instances: R = 1 at B = 1 with 16
// columns a block, else R = kRows = 2 with 32; dh 16 and 32 one block). Block
// q owns columns [q*CB, (q+1)*CB) of the head: a gate thread a (row,
// column) carries dc, dn, dm in registers for the whole sequence. Each
// thread holds, in registers for the whole sequence, r[g, h, d, col] for
// KO = 4*CB/32 of the block's (gate, column) inputs (lane + 32*u) and the L
// rows d of its warp (L = 32, or 16 where a block has fewer than 32 rows a
// warp): the forward's layout of r, read transposed. A token (reverse step
// k = S-1-t):
//   1. each gate thread (from k = 1) waits on this block's mbarrier of
//      buffer k & 1, which completes when every block's partial of h_t's
//      recurrent cotangent for this block's columns has landed, and sums
//      the CS partials in block order; adds dhs (from the ring), runs the
//      token's forward again and the step above, writes dx (and dpre),
//      and leaves dpre_g in shared memory (double-buffered);
//   2. one block barrier (the ring's next token has landed before it);
//      the last thread arms the buffer's next phase; the top threads
//      refill the ring (cp.async, kAhead slots);
//   3. the product: each warp, for each of the group's rows, sums
//      r[g, d, e']*dpre_g[e'] over its lane's KO inputs for its L rows d,
//      then reduce-scatters the L sums over its 32 lanes by shuffles (a
//      fixed order: lane l ends with the block's partial for row d = w*L
//      + l * L/32), and sends it by st.async into buffer (k+1) & 1 of the
//      block that owns column d, slot [row][q][d % CB], completing 4 bytes
//      of that block's mbarrier. Every block receives CS * CB = dh values
//      a row and token, as many as the forward's handoff of h, from one
//      st.async a thread (the forward's gate threads send CS each).
// After the last token a final wait gives dh0. The mbarriers, their
// parities (step k waits on parity ((k-1) >> 1) & 1), the arming after the
// block barrier of the step that consumed a phase, the ring and the
// cluster barriers at entry and exit follow slstm.cu's reasoning with k in
// place of t; the partials a block sends at step k reach a peer only after
// that peer's gate threads passed the wait of step k (they follow this
// block's own block barrier of step k, which follows its wait of step k,
// which needs the peer's partials of step k - 1, sent after the peer's
// block barrier of step k - 1), so no buffer is written while it is read.
// Fixed summation orders and no atomics: two launches are bit-equal.

#define SLSTM_KERNEL_ONLY
#include "slstm.cu"

namespace {

constexpr int kFields = 7;  // the record's fields a step reads: pre, c, n, m

static_assert(kAhead >= 3, "the ring holds the step read and two ahead");

// The backward's geometry at CB columns a block, head dim DH, R batch rows
// a cluster.
template <int CB_, int DH_, int R_>
struct BGeo {
  static constexpr int CB = CB_, DH = DH_, R = R_;
  static constexpr int CS = DH / CB;   // blocks a cluster (the forward's)
  static constexpr int NO = 4 * CB;    // the block's (gate, column) inputs
  static constexpr int KO = NO / 32;   // inputs a lane
  static constexpr int GW = (R * CB + 31) / 32;           // gate warps
  static constexpr int W = DH / 32 > GW ? DH / 32 : GW;   // warps a block
  static constexpr int NT = 32 * W;
  static constexpr int L = DH / W;     // rows d of r a warp holds
  static constexpr int SH = L == 32 ? 0 : L == 16 ? 1 : 2;  // lanes a row: 2^SH
  static_assert(DH % CB == 0 && NO % 32 == 0 && DH % W == 0, "geometry");
  static_assert(L == 32 || L == 16 || L == 8, "a warp's rows");
  static_assert(CB % 8 == 0, "the ring's 16-byte pieces");
};

// bars [2], then rbuf [2][R][CS][CB], dp [2][R][NO], the record's ring
// [kAhead][R][kFields][CB] f32 and dhs's ring [kAhead][R][CB] in T.
template <typename T, typename G>
constexpr size_t bwd_smem_bytes() {
  return 16
         + sizeof(float) * (2 * G::R * G::DH + 2 * G::R * G::NO
                            + kAhead * G::R * kFields * G::CB)
         + sizeof(T) * kAhead * G::R * G::CB;
}

// The L sums of a[] over the warp's 32 lanes, scattered: lane l returns
// the sum of index l >> (5 - log2 L) (halving stages, then whole-value
// stages once one value is left; a fixed order of additions).
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* a, int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int Hf = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < Hf; ++i) {
        const float lo = a[i], hi = a[i + Hf];
        const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, O);
        a[i] = (up ? hi : lo) + got;
      }
      reduce_scatter<Hf, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      reduce_scatter<1, O / 2>(a, lane);
    }
  }
}

template <typename T, int CB, int DH, int R>
__global__ void __launch_bounds__(BGeo<CB, DH, R>::NT, 1)
slstm_bwd_kernel(const float* __restrict__ saved, const T* __restrict__ dhs,
                 const float* __restrict__ r, const float* dcT,
                 const float* dnT, const float* dmT, const float* dhT,
                 T* __restrict__ dx, float* __restrict__ dpre, float* dc0,
                 float* dn0, float* dm0, float* dh0, int B, int S, int H) {
  using G = BGeo<CB, DH, R>;
  constexpr int NO = G::NO, KO = G::KO, L = G::L, NT = G::NT, CS = G::CS;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);           // [2]
  float* rbuf = reinterpret_cast<float*>(smem + 16);  // [2][R][CS][CB]
  float* dp = rbuf + 2 * R * DH;                      // [2][R][NO]
  float* ring = dp + 2 * R * NO;                      // [kAhead][R][7][CB]
  T* gring = reinterpret_cast<T*>(ring + kAhead * R * kFields * CB);

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int head = blockIdx.x / CS;
  const int b0 = blockIdx.y * R;
  const int nb = min(R, B - b0);  // the group's rows (a ragged last)
  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int D = H * DH;
  const int col0 = q * CB;

  // this lane's inputs i = lane + 32*u (gate i / CB, column col0 + i % CB)
  // at the warp's rows d = w*L + j, for the whole sequence
  float rr[KO][L];
#pragma unroll
  for (int u = 0; u < KO; ++u) {
    const int i = lane + 32 * u;
    const float* src = r + (static_cast<size_t>(i / CB) * H + head) * DH * DH
                       + static_cast<size_t>(w) * L * DH + col0 + i % CB;
#pragma unroll
    for (int j = 0; j < L; ++j) rr[u][j] = src[static_cast<size_t>(j) * DH];
  }

  // the gate thread of row gb and column ge of the block, if it has one
  const int gb = tid / CB, ge = tid % CB;
  const bool gate = gb < nb;
  const size_t sidx = (static_cast<size_t>(b0 + gb) * H + head) * DH + col0
                      + ge;
  const int colD = head * DH + col0 + ge;
  const size_t xrow = 4 * static_cast<size_t>(D);
  T* dxrow = dx + static_cast<size_t>(b0 + gb) * S * xrow + colD;
  float* dprow = dpre ? dpre + static_cast<size_t>(b0 + gb) * S * xrow + colD
                      : nullptr;
  float dc = 0.f, dn = 0.f, dm = 0.f, gh = 0.f;
  if (gate) {
    if (dcT) dc = dcT[sidx];
    if (dnT) dn = dnT[sidx];
    if (dmT) dm = dmT[sidx];
    if (dhT) gh = dhT[sidx];
  }

  // the record of step k's token (fields 0-6, nb rows x CB columns) and its
  // dhs into ring slot k % kAhead, by the top threads: 16-byte cp.async
  // (the record is 16-byte aligned; dhs where it is, else element by
  // element)
  const float* sbase = saved + static_cast<size_t>(b0) * S * 8 * D
                       + head * DH + col0;
  const T* gbase = dhs + static_cast<size_t>(b0) * S * D + head * DH + col0;
  const bool gvec = reinterpret_cast<uintptr_t>(dhs) % 16 == 0;
  auto load = [&](int k) {
    const int t = S - 1 - k;
    float* slot = ring + (k % kAhead) * R * kFields * CB;
    T* gslot = gring + (k % kAhead) * R * CB;
    constexpr int PF = CB / 4;  // 16-byte pieces of a field's CB floats
    for (int i = NT - 1 - tid; i < nb * kFields * PF; i += NT) {
      const int bb = i / (kFields * PF), f = i / PF % kFields, p = i % PF;
      cp_async16(smem_addr(slot + (bb * kFields + f) * CB + p * 4),
                 sbase + ((static_cast<size_t>(bb) * S + t) * 8 + f) * D
                     + p * 4);
    }
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    constexpr int PG = CB / E;
    if (gvec) {
      for (int i = NT - 1 - tid; i < nb * PG; i += NT) {
        const int bb = i / PG, p = i % PG;
        cp_async16(smem_addr(gslot + bb * CB + p * E),
                   gbase + (static_cast<size_t>(bb) * S + t) * D + p * E);
      }
    } else {
      for (int i = NT - 1 - tid; i < nb * CB; i += NT) {
        const int bb = i / CB, e = i % CB;
        gslot[bb * CB + e] = gbase[(static_cast<size_t>(bb) * S + t) * D + e];
      }
    }
  };

  // a phase's bytes: nb rows of the dh partials this block receives
  const uint32_t phase_bytes = nb * DH * sizeof(float);
  if (tid < 2) {
    bar_init(smem_addr(bars + tid));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_arm(smem_addr(bars + tid), phase_bytes);
  }
  for (int k = 0; k < kAhead - 1; ++k) {
    if (k < S) load(k);
    cp_commit();
  }
  cp_wait<kAhead - 2>();  // step 0's slot
  cluster.sync();  // the barriers armed, step 0's slot landed, all running

  for (int k = 0; k < S; ++k) {
    const int t = S - 1 - k;
    const int cur = k & 1, nxt = cur ^ 1;
    if (gate) {
      if (k > 0) {  // h_t's recurrent cotangent: the CS partials, in order
        bar_wait(smem_addr(bars + cur), ((k - 1) >> 1) & 1);
        const float* pr = rbuf + (cur * R + gb) * DH + ge;
        float s = pr[0];
#pragma unroll
        for (int p = 1; p < CS; ++p) s += pr[p * CB];
        gh = s;
      }
      const float* sl = ring + ((k % kAhead) * R + gb) * kFields * CB + ge;
      const float pz = sl[0], pi = sl[CB], pf = sl[2 * CB], po = sl[3 * CB];
      const float c = sl[4 * CB], n = sl[5 * CB], m = sl[6 * CB];
      const float g = to_f32(gring[(k % kAhead) * R * CB + gb * CB + ge]) + gh;
      // the token's forward, as slstm.cu computes it
      const float lf = log_sigmoid(pf);
      const float lfm = __fadd_rn(lf, m);
      const float mn = fmaxf(lfm, pi);
      const float ig = expf(__fsub_rn(pi, mn));
      const float fg = expf(__fsub_rn(lfm, mn));
      const float zt = tanhf(pz);
      const float cn = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, zt));
      const float nn = __fadd_rn(__fmul_rn(fg, n), ig);
      const float e = expf(-mn);
      const float nw = fmaxf(nn, e);
      const float og = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
      const float hv = __fdiv_rn(__fmul_rn(og, cn), nw);
      // and its backward
      const float dpo = g * cn / nw * og * (1.f - og);
      const float dcn = dc + g * og / nw;
      const float dnw = dn - g * hv / nw;
      const float dnn = nn > e ? dnw : nn < e ? 0.f : 0.5f * dnw;
      const float dfg = dcn * c + dnn * n;
      const float dig = dcn * zt + dnn;
      const float dpz = dcn * ig * (1.f - zt * zt);
      float dpi = dig * ig;
      const float dff = dfg * fg;
      const float dmn = dm - e * (dnw - dnn) - dpi - dff;
      float dlfm = dff;
      if (lfm > pi) {
        dlfm += dmn;
      } else if (lfm < pi) {
        dpi += dmn;
      } else {
        dlfm += 0.5f * dmn;
        dpi += 0.5f * dmn;
      }
      const float dpf = dlfm / (1.f + expf(pf));
      dc = dcn * fg;
      dn = dnn * fg;
      dm = dlfm;
      const float d4[4] = {dpz, dpi, dpf, dpo};
      float* dps = dp + (cur * R + gb) * NO + ge;
      const size_t at = static_cast<size_t>(t) * xrow;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) {
        dps[gg * CB] = d4[gg];
        dxrow[at + static_cast<size_t>(gg) * D] = from_f32<T>(d4[gg]);
        if (dprow) dprow[at + static_cast<size_t>(gg) * D] = d4[gg];
      }
    }
    cp_wait<kAhead - 3>();  // this thread's pieces of step k + 1's slot
    __syncthreads();
    // every wait on buffer cur has passed: arm its phase of step k + 2
    if (k > 0 && tid == NT - 1) bar_arm(smem_addr(bars + cur), phase_bytes);
    if (k + kAhead - 1 < S) load(k + kAhead - 1);
    cp_commit();
    // the transposed product: this block's partial of h_{t-1}'s cotangent
    const uint32_t bar = smem_addr(bars + nxt);
    for (int bb = 0; bb < nb; ++bb) {
      const float* dps = dp + (cur * R + bb) * NO + lane;
      float x[KO];
#pragma unroll
      for (int u = 0; u < KO; ++u) x[u] = dps[32 * u];
      float a[L];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        float s = rr[0][j] * x[0];
#pragma unroll
        for (int u = 1; u < KO; ++u) s = fmaf(rr[u][j], x[u], s);
        a[j] = s;
      }
      reduce_scatter<L, 16>(a, lane);
      if ((lane & ((1 << G::SH) - 1)) == 0) {
        const int d = w * L + (lane >> G::SH);
        send(smem_addr(rbuf + ((nxt * R + bb) * CS + q) * CB + d % CB), bar,
             d / CB, a[0]);
      }
    }
  }
  if (gate) {  // past token 0: h0's cotangent, and the carried state's
    bar_wait(smem_addr(bars + (S & 1)), ((S - 1) >> 1) & 1);
    const float* pr = rbuf + ((S & 1) * R + gb) * DH + ge;
    float s = pr[0];
#pragma unroll
    for (int p = 1; p < CS; ++p) s += pr[p * CB];
    dh0[sidx] = s;
    dc0[sidx] = dc;
    dn0[sidx] = dn;
    dm0[sidx] = dm;
  }
  cluster.sync();  // no block exits while a peer may write into it
}

template <typename T, int CB, int DH, int R>
cudaError_t bwd_prepare() {
  static cudaError_t err = [] {
    using G = BGeo<CB, DH, R>;
    cudaError_t e = cudaFuncSetAttribute(
        slstm_bwd_kernel<T, CB, DH, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_smem_bytes<T, G>()));
    if (e == cudaSuccess && G::CS > 8) {
      e = cudaFuncSetAttribute(slstm_bwd_kernel<T, CB, DH, R>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    return e;
  }();
  return err;
}

template <typename T, int CB, int DH, int R>
cudaLaunchConfig_t bwd_config(int H, int B, cudaStream_t st,
                              cudaLaunchAttribute* attr) {
  using G = BGeo<CB, DH, R>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G::CS * H, (B + R - 1) / R, 1);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = bwd_smem_bytes<T, G>();
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
struct BwdLaunch {
  const void *saved, *dhs, *r, *dcT, *dnT, *dmT, *dhT;
  void *dx, *dpre, *dc0, *dn0, *dm0, *dh0;
  int B, S, H;
  cudaStream_t st;

  template <int CB, int DH, int R>
  cudaError_t launch() const {
    cudaError_t err = bwd_prepare<T, CB, DH, R>();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = bwd_config<T, CB, DH, R>(H, B, st, &attr);
    err = cudaLaunchKernelEx(
        &cfg, slstm_bwd_kernel<T, CB, DH, R>,
        static_cast<const float*>(saved), static_cast<const T*>(dhs),
        static_cast<const float*>(r), static_cast<const float*>(dcT),
        static_cast<const float*>(dnT), static_cast<const float*>(dmT),
        static_cast<const float*>(dhT), static_cast<T*>(dx),
        static_cast<float*>(dpre), static_cast<float*>(dc0),
        static_cast<float*>(dn0), static_cast<float*>(dm0),
        static_cast<float*>(dh0), B, S, H);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }

  // the forward's instances: B = 1 one row a cluster, else groups of kRows
  template <int DH>
  cudaError_t operator()() const {
    return B == 1 ? launch<cols_of<DH, 1>(), DH, 1>()
                  : launch<cols_of<DH, kRows>(), DH, kRows>();
  }
};

// The geometry of the R-row instance of (CB, DH) into plan[0..7].
template <typename T, int CB, int DH, int R>
cudaError_t bwd_plan_of(int* plan) {
  using G = BGeo<CB, DH, R>;
  cudaError_t err = bwd_prepare<T, CB, DH, R>();
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_bytes<T, G>();
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, slstm_bwd_kernel<T, CB, DH, R>);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, slstm_bwd_kernel<T, CB, DH, R>, G::NT, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bwd_config<T, CB, DH, R>(1, 1, nullptr,
                                                          &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters,
                                       slstm_bwd_kernel<T, CB, DH, R>, &cfg);
  if (err != cudaSuccess) return err;
  plan[0] = G::CS;
  plan[1] = CB;
  plan[2] = G::NT;
  plan[3] = G::L;
  plan[4] = fa.numRegs;
  plan[5] = static_cast<int>(smem);
  plan[6] = blocks;
  plan[7] = clusters;
  return cudaSuccess;
}

template <typename T>
struct BwdPlan {
  int* plan;

  template <int DH>
  cudaError_t operator()() const {
    cudaError_t err = bwd_plan_of<T, cols_of<DH, kRows>(), DH, kRows>(plan);
    if (err == cudaSuccess) {
      err = bwd_plan_of<T, cols_of<DH, 1>(), DH, 1>(plan + 8);
    }
    return err;
  }
};

}  // namespace

// saved (B, S, 8, H * dh) f32 (slstm_save_launch's record, 16-byte
// aligned), dhs (B, S, H * dh) in the model type (dtype 0: float32, 1:
// bfloat16), r (4, H, dh, dh) f32, the final state's cotangents dc, dn,
// dm, dh (B, H, dh) f32 (each null for zero), all contiguous; out: dx (B,
// S, 4 * H * dh) in the model type, dpre the same in f32 (null: not
// written), dc0, dn0, dm0, dh0 (B, H, dh) f32. Returns a CUDA error code:
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int slstm_bwd_launch(const void* saved, const void* dhs,
                                const void* r, const void* dc,
                                const void* dn, const void* dm,
                                const void* dh, void* dx, void* dpre,
                                void* dc0, void* dn0, void* dm0, void* dh0,
                                int B, int S, int H, int dh_, int dtype,
                                void* stream) {
  if (B <= 0 || (B + kRows - 1) / kRows > 65535 || S <= 0 || H <= 0
      || !takes(dh_) || reinterpret_cast<uintptr_t>(saved) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = with_instance(dh_, BwdLaunch<float>{saved, dhs, r, dc, dn, dm, dh,
                                              dx, dpre, dc0, dn0, dm0, dh0,
                                              B, S, H, st});
  } else if (dtype == 1) {
    err = with_instance(dh_, BwdLaunch<__nv_bfloat16>{
                                 saved, dhs, r, dc, dn, dm, dh, dx, dpre,
                                 dc0, dn0, dm0, dh0, B, S, H, st});
  }
  return static_cast<int>(err);
}

// The backward's launch geometry of the (dh, dtype) instances into
// plan[16]: that of kRows batch rows a cluster (B > 1) in plan[0..7],
// blocks a cluster (a head), columns a block, threads a block, rows d of r
// a warp holds, registers a thread, dynamic shared memory a block (bytes),
// blocks an SM holds, clusters the card holds at once; then the one-row
// instance's (B = 1) in plan[8..15]. Returns a CUDA error code.
extern "C" int slstm_bwd_plan(int dh, int dtype, int* plan) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = with_instance(dh, BwdPlan<float>{plan});
  if (dtype == 1) err = with_instance(dh, BwdPlan<__nv_bfloat16>{plan});
  return static_cast<int>(err);
}
